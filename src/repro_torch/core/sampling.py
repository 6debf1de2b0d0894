"""Algorithm 2, steps 3-7 — the Lemma 2.3 sample-and-prune.

Port of ``repro.core.sampling``.  Every shard samples ``ceil(12 ln L)``
of its local top-L distances independently with replacement (sentinels
included, as the paper states); the sorted union of the ``k * s``
samples gives the prune radius r at 1-based index ``ceil(21 ln L)``,
clamped to the pool.  One more psum verifies that at least l elements
survive; if not, the prune is skipped, so the result is always exact
(Las Vegas).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.parallel.collectives import all_gather, psum

SAMPLE_C = 12
RADIUS_C = 21


class PruneResult(NamedTuple):
    valid: torch.Tensor       # (k, B, L) bool — survivors incl. finiteness
    radius: torch.Tensor      # (B,) radius applied (+inf if skipped)
    survivors: torch.Tensor   # (B,) int32 global survivor count
    applied: torch.Tensor     # (B,) bool — False if verification rejected r


def sample_count(l: int) -> int:
    """``ceil(12 ln l)`` samples per shard (Algorithm 2, Step 3)."""
    return max(1, math.ceil(SAMPLE_C * math.log(max(l, 2))))


def radius_index(l: int) -> int:
    """``ceil(21 ln l)``: 1-based index of r in the sorted pool (Step 5)."""
    return max(1, math.ceil(RADIUS_C * math.log(max(l, 2))))


def sample_prune(d: torch.Tensor, gen: torch.Generator, l) -> PruneResult:
    """Survivor mask for per-shard distances ``d`` of shape ``(k, B, L)``
    (+inf entries are the paper's fake sentinel points); ``l`` is the
    runtime neighbor count, an int or ``(B,)`` tensor, ``l <= L``."""
    k, B, L = d.shape
    s = sample_count(L)
    r_idx = radius_index(L)

    # Step 3: uniform samples with replacement, independently per shard.
    idx = torch.floor(torch.rand((k, B, s), generator=gen, device=d.device)
                      * L).to(torch.int64).clamp(max=L - 1)
    local_samples = d.gather(-1, idx)                            # (k, B, s)

    # Step 4: one gather round; Step 5: replicated sort, radius.
    pool = all_gather(local_samples).transpose(0, 1).reshape(B, k * s)
    pool_sorted = torch.sort(pool, dim=-1).values
    r = pool_sorted[:, min(r_idx, k * s) - 1]                    # (B,)

    # Step 7: survivors are finite points within radius r.
    finite = torch.isfinite(d)
    pruned = finite & (d <= r[None, :, None])

    # Verification psum: apply the prune only if >= l survive globally.
    l_arr = torch.as_tensor(l, dtype=torch.int32, device=d.device).expand(B)
    cnts = psum(torch.stack([pruned.sum(-1, dtype=torch.int32),
                             finite.sum(-1, dtype=torch.int32)], dim=-1))
    cnt, finite_cnt = cnts[..., 0], cnts[..., 1]
    ok = cnt >= l_arr
    return PruneResult(
        valid=torch.where(ok[None, :, None], pruned, finite),
        radius=torch.where(ok, r, float("inf")),
        survivors=torch.where(ok, cnt, finite_cnt),
        applied=ok)
