from repro_torch.data.synthetic import (MarkovTokens, bayes_labels,
                                       drifting_clusters, gaussian_clusters,
                                       labeled_mixture, sharded_clusters,
                                       uniform_points)
from repro_torch.data.pipeline import Prefetcher

__all__ = ["MarkovTokens", "Prefetcher", "bayes_labels",
           "drifting_clusters", "gaussian_clusters", "labeled_mixture",
           "sharded_clusters", "uniform_points"]
