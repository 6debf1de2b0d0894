from repro_torch.data.synthetic import sharded_clusters

__all__ = ["sharded_clusters"]
