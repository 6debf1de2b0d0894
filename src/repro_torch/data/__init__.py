from repro_torch.data.synthetic import drifting_clusters, sharded_clusters

__all__ = ["drifting_clusters", "sharded_clusters"]
