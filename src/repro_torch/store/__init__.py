"""Routing summaries and the bucket index of a static point set (the
parts of ``repro.store`` the static service needs)."""

from repro_torch.store.index import (IndexMaintainer, ShardIndex,
                                     bucket_keep, candidate_fraction,
                                     candidate_mask)
from repro_torch.store.summaries import (ShardSummaries, build_summaries,
                                         lower_bounds, route_shards,
                                         routing_detail, upper_bounds)

__all__ = ["IndexMaintainer", "ShardIndex", "ShardSummaries",
           "bucket_keep", "build_summaries", "candidate_fraction",
           "candidate_mask", "lower_bounds", "route_shards",
           "routing_detail", "upper_bounds"]
