"""Mutable sharded point store with epoch-swapped snapshots, its
placement and compaction, the routing summaries and the bucket index:
the ported parts of ``repro.store``."""

from repro_torch.store.mutable import (ID_SENTINEL, IngestStats, MutableStore,
                                       StoreFullError, StoreSnapshot)
from repro_torch.store.adaptive import AdaptiveMaintainer, compute_pivots
from repro_torch.store.compaction import (CompactionDecision, evaluate,
                                          redeal_slack, repack,
                                          scatter_operands)
from repro_torch.store.index import (IndexMaintainer, ShardIndex,
                                     bucket_keep, candidate_fraction,
                                     candidate_mask)
from repro_torch.store.placement import (AffinityPlacement, BalancePlacement,
                                         PlacementPolicy, PlacementView,
                                         lloyd_centroids, make_placement,
                                         repack_proximity)
from repro_torch.store.summaries import (ShardSummaries, SummaryMaintainer,
                                         build_summaries, lower_bounds,
                                         route_shards, routing_detail,
                                         summary_invariants, summary_slack,
                                         summary_slack_sampled, upper_bounds)

__all__ = [
    "MutableStore", "StoreSnapshot", "StoreFullError", "IngestStats",
    "ID_SENTINEL", "CompactionDecision", "evaluate", "redeal_slack",
    "repack", "scatter_operands",
    "AdaptiveMaintainer", "compute_pivots",
    "IndexMaintainer", "ShardIndex", "bucket_keep", "candidate_mask",
    "candidate_fraction",
    "PlacementPolicy", "PlacementView", "BalancePlacement",
    "AffinityPlacement", "make_placement", "lloyd_centroids",
    "repack_proximity",
    "ShardSummaries", "SummaryMaintainer", "build_summaries",
    "lower_bounds", "upper_bounds", "route_shards", "routing_detail",
    "summary_invariants", "summary_slack", "summary_slack_sampled",
]
