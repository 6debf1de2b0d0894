"""Label prediction: the paper's endgame, "assign a label to p based on
the labels of the K-nearest points", served over the l-NN machinery.

Port of ``repro.predict``, in two modes with two bills:

* **Exact** (``predict="vote"|"regress"``, ``predict_mode="exact"``):
  Algorithm 2 runs as for an l-NN answer, then its winner mask is folded
  into a class histogram or a value sum (:func:`exact_predict`, one more
  sum over the shards: +1 round, +(touched - 1) messages).  The label
  equals a single-machine vote or mean over the true l nearest.
* **Ensemble** (``predict_mode="ensemble"``): each routed shard answers
  its own local-kNN vote over its first ``kl`` candidates
  (:func:`local_vote` / :func:`local_mean`, no collective), and the host
  aggregates (:func:`aggregate_vote` / :func:`aggregate_regress`): one
  message per touched shard and 1 round.  ``kl`` comes from
  :func:`local_k_for`; on one shard it is l, and the ensemble vote is
  the exact vote byte for byte.
"""

from repro_torch.predict.ensemble import (aggregate_regress, aggregate_vote,
                                          local_k_for, local_mean, local_vote)
from repro_torch.predict.vote import exact_predict

__all__ = [
    "aggregate_regress",
    "aggregate_vote",
    "exact_predict",
    "local_k_for",
    "local_mean",
    "local_vote",
]
