from repro_torch.configs.knn_service import CONFIG, KnnServiceConfig

__all__ = ["CONFIG", "KnnServiceConfig"]
