from repro_torch.data.synthetic import (bayes_labels, drifting_clusters,
                                       labeled_mixture, sharded_clusters)

__all__ = ["bayes_labels", "drifting_clusters", "labeled_mixture",
           "sharded_clusters"]
