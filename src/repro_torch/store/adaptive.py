"""Multi-pivot shard summaries: the pivot part of ``repro.store.adaptive``.

Each shard carries up to ``m`` pivot balls whose union covers its live
points, beside the aggregate ball and the projection sketch; the routing
bounds take the min over pivots (``store/summaries.py``).  The port has
the exact build (:func:`compute_pivots`, :class:`AdaptiveMaintainer`
``_rebuild_shard``/``freeze``), which ``summary_pivots > 1`` and the
bucket index (``store/index.py``) use.  Scheduling, re-tightening and
splits belong to the mutable store and are not here.

The build runs in f64 torch on the points' device.  The farthest-point
choice and the assignment are the reference's: ``argmax``/``argmin``
take the first extreme, and distances to the pivots are taken one pivot
at a time, so no ``(n, m, dim)`` array is formed.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.store import summaries as summaries_mod


def pivot_set(pts: torch.Tensor, m: int):
    """Exact pivot set of one shard's points ``pts`` ((n, dim) f64
    tensor): ``(pivots (m, dim), radii (m,), count, assign (n,))`` —
    numpy f64 pivots and radii, ``assign`` the nearest pivot of each
    point as an int64 tensor on ``pts``' device.

    Farthest-point traversal picks up to ``m`` centers (stops early when
    every point coincides with a chosen pivot); each pivot's radius
    covers the points nearest to it.  Unused slots stay zero, radius 0.
    """
    n, dim = pts.shape
    pivots = np.zeros((m, dim))
    radii = np.zeros(m)
    if n == 0:
        return pivots, radii, 0, torch.zeros(0, dtype=torch.int64,
                                             device=pts.device)
    chosen = [int(torch.argmax(((pts - pts.mean(0)) ** 2).sum(-1)))]
    d = ((pts - pts[chosen[0]]) ** 2).sum(-1)
    while len(chosen) < m:
        far = int(torch.argmax(d))
        if float(d[far]) <= 0.0:
            break                     # every point already a chosen pivot
        chosen.append(far)
        d = torch.minimum(d, ((pts - pts[far]) ** 2).sum(-1))
    count = len(chosen)
    piv = pts[chosen]                                          # (count, dim)
    dists = torch.stack([((pts - piv[p]) ** 2).sum(-1).sqrt()
                         for p in range(count)], 1)            # (n, count)
    assign = torch.argmin(dists, 1)
    mine = torch.where(assign[:, None] == torch.arange(count,
                                                       device=pts.device),
                       dists, torch.zeros((), dtype=dists.dtype,
                                          device=pts.device))
    pivots[:count] = piv.cpu().numpy()
    radii[:count] = mine.amax(0).cpu().numpy()
    return pivots, radii, count, assign


def compute_pivots(points, m: int):
    """The reference's signature: ``(pivots (m, dim), radii (m,),
    count)`` for one shard's points (numpy or tensor)."""
    pts = torch.as_tensor(points).to(torch.float64)
    pivots, radii, count, _ = pivot_set(pts, m)
    return pivots, radii, count


class AdaptiveMaintainer(summaries_mod.SummaryMaintainer):
    """Summary maintainer with a pivot set per shard and each ball's live
    credits (exact after a rebuild)."""

    def __init__(self, k: int, dim: int, *, num_projections: int = 8,
                 seed: int = 0, num_pivots: int = 1):
        super().__init__(k, dim, num_projections=num_projections, seed=seed)
        if num_pivots < 1:
            raise ValueError(f"num_pivots must be >= 1, got {num_pivots}")
        self.num_pivots = int(num_pivots)
        m = self.num_pivots
        self._piv = np.zeros((k, m, dim))
        self._piv_r = np.zeros((k, m))
        self._piv_n = np.zeros(k, np.int64)
        self._piv_live = np.zeros((k, m), np.int64)

    def _reset_shard(self, j: int) -> None:
        super()._reset_shard(j)
        self._piv[j] = 0.0
        self._piv_r[j] = 0.0
        self._piv_n[j] = 0
        self._piv_live[j] = 0

    def _rebuild_shard(self, j: int, pj: torch.Tensor) -> None:
        super()._rebuild_shard(j, pj)
        piv, rad, cnt, assign = pivot_set(pj, self.num_pivots)
        self._piv[j] = piv
        self._piv_r[j] = rad
        self._piv_n[j] = cnt
        self._piv_live[j] = 0
        if cnt:
            self._piv_live[j, :cnt] = torch.bincount(
                assign, minlength=cnt).cpu().numpy()

    def freeze(self, generation: int) -> summaries_mod.ShardSummaries:
        # the single-pivot form freezes without pivot fields, as the
        # reference's does
        if self.num_pivots == 1:
            return super().freeze(generation)
        return super().freeze(generation)._replace(
            pivots=self._piv.copy(),
            pivot_radii=self._piv_r.copy(),
            pivot_count=self._piv_n.copy(),
            pivot_live=self._piv_live.copy())
