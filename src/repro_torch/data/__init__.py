from repro_torch.data.synthetic import (bayes_labels, drifting_clusters,
                                       gaussian_clusters, labeled_mixture,
                                       sharded_clusters, uniform_points)

__all__ = ["bayes_labels", "drifting_clusters", "gaussian_clusters",
           "labeled_mixture", "sharded_clusters", "uniform_points"]
