"""Algorithms 1 and 2 of the paper over k shards held on one device, and
their LM-serving faces: the distributed top-k sampler (``topk``) and the
kNN-LM datastore (``datastore``)."""

from repro_torch.core import datastore, topk
from repro_torch.core.knn import (KnnResult, gather_selected, knn_classify,
                                  knn_query, knn_query_batched, knn_regress,
                                  knn_simple, local_distance_top_l,
                                  local_top_l, squared_l2_distances)
from repro_torch.core.sampling import PruneResult, sample_prune
from repro_torch.core.selection import (SelectionResult, select_l_smallest,
                                        selected_mask)
from repro_torch.core.topk import (TopKResult, distributed_topk,
                                   greedy_sample, topk_sample)

__all__ = [
    "KnnResult", "gather_selected", "knn_classify", "knn_query",
    "knn_query_batched", "knn_regress", "knn_simple",
    "local_distance_top_l", "local_top_l", "squared_l2_distances",
    "PruneResult", "sample_prune",
    "SelectionResult", "select_l_smallest", "selected_mask",
    "TopKResult", "datastore", "distributed_topk", "greedy_sample",
    "topk", "topk_sample",
]
