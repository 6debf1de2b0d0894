"""Adaptive summary maintenance: the port's ``repro.store.adaptive``.

* **Multi-pivot summaries.**  Each shard carries up to ``m`` pivot balls
  whose union covers its live points, beside the aggregate ball and the
  projection sketch; the routing bounds take the min over pivots
  (``store/summaries.py``).  Between exact rebuilds the pivot centres
  are fixed: an insert inflates the ball needing the least inflation or
  claims a free slot, a delete debits every ball that contains the point
  (the live credits stay a safe undercount).
* **Scheduled re-tightening.**  A shard that absorbed ``retighten_every``
  ops since its last exact rebuild is due; :meth:`retighten_due` hands
  out due shards round-robin and the store re-tightens at most one per
  flush.
* **Split trigger.**  :meth:`split_candidate` names the shard whose
  covering radius outgrew ``split_radius_factor`` times the gap to the
  nearest other centroid (and its radius at the last rebuild by
  ``_SPLIT_GROWTH``); the store then re-deals by proximity.

The incremental ops and the schedule are host f64 numpy, op for op as
the reference's, so they are bit-equal to it.

The build runs in f64 torch on the points' device.  The farthest-point
choice and the assignment are the reference's: ``argmax``/``argmin``
take the first extreme, and distances to the pivots are taken one pivot
at a time, so no ``(n, m, dim)`` array is formed.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.store import summaries as summaries_mod

# a shard re-arms the split trigger only when its radius exceeds its
# last exactly rebuilt value by this factor
_SPLIT_GROWTH = 1.1


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
    """Summary maintainer with a pivot set per shard, each ball's live
    credits (exact after a rebuild, a safe undercount after deletes) and
    the maintenance schedule; with ``num_pivots=1`` and both triggers at
    0 it is one fixed-centre ball per shard and no scheduled work."""

    def __init__(self, k: int, dim: int, *, num_projections: int = 8,
                 seed: int = 0, num_pivots: int = 1,
                 retighten_every: int = 0,
                 split_radius_factor: float = 0.0):
        super().__init__(k, dim, num_projections=num_projections, seed=seed)
        if num_pivots < 1:
            raise ValueError(f"num_pivots must be >= 1, got {num_pivots}")
        if retighten_every < 0:
            raise ValueError("retighten_every must be >= 0 (0 disables)")
        if split_radius_factor < 0:
            raise ValueError("split_radius_factor must be >= 0 (0 disables)")
        self.num_pivots = int(num_pivots)
        self.retighten_every = int(retighten_every)
        self.split_radius_factor = float(split_radius_factor)
        m = self.num_pivots
        self._piv = np.zeros((k, m, dim))
        self._piv_r = np.zeros((k, m))
        self._piv_n = np.zeros(k, np.int64)
        self._piv_live = np.zeros((k, m), np.int64)
        self._ops_since = np.zeros(k, np.int64)   # ops since exact rebuild
        self._rr = 0                              # round-robin scan cursor
        self._radius_at_rebuild = np.zeros(k)     # split growth guard

    # ---- incremental ops (store lock held) ------------------------------

    def insert(self, shard: int, point) -> None:
        super().insert(shard, point)
        j = int(shard)
        p = np.asarray(point, np.float64)
        c = int(self._piv_n[j])
        if c == 0:
            self._piv[j, 0] = p
            self._piv_r[j, 0] = 0.0
            self._piv_n[j] = 1
            self._piv_live[j, 0] = 1
        else:
            d = np.sqrt(((self._piv[j, :c] - p) ** 2).sum(-1))
            if (d > self._piv_r[j, :c]).all() and c < self.num_pivots:
                # outside every ball with a slot free: a new pivot
                self._piv[j, c] = p
                self._piv_r[j, c] = 0.0
                self._piv_n[j] = c + 1
                self._piv_live[j, c] = 1
            else:
                # join the ball needing the least inflation
                b = int(np.argmin(d - self._piv_r[j, :c]))
                self._piv_r[j, b] = max(self._piv_r[j, b], float(d[b]))
                self._piv_live[j, b] += 1
        self._ops_since[j] += 1

    def delete(self, shard: int, point) -> None:
        # the ball that credited this point is unknown, so debit every
        # occupied ball that contains it (radii never shrink between
        # rebuilds): the credits stay a safe undercount
        j = int(shard)
        c = int(self._piv_n[j])
        if c:
            p = np.asarray(point, np.float64)
            d = np.sqrt(((self._piv[j, :c] - p) ** 2).sum(-1))
            r = self._piv_r[j, :c]
            inside = d <= r + 1e-9 * (1.0 + r)
            if not inside.any():
                inside[:] = True     # covering says unreachable; stay safe
            row = self._piv_live[j, :c]
            row[inside] -= 1
            np.maximum(row, 0, out=row)
        super().delete(shard, point)
        if self._n[j] > 0:
            self._ops_since[j] += 1

    def _reset_shard(self, j: int) -> None:
        super()._reset_shard(j)
        self._piv[j] = 0.0
        self._piv_r[j] = 0.0
        self._piv_n[j] = 0
        self._piv_live[j] = 0
        self._ops_since[j] = 0
        self._radius_at_rebuild[j] = 0.0

    # ---- exact recompute -------------------------------------------------

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
        self._ops_since[j] = 0
        self._radius_at_rebuild[j] = self._radius[j]

    def retighten(self, j: int, points, valid, cap: int) -> None:
        """Exact recompute of shard ``j`` alone from the store mirrors."""
        j = int(j)
        pj = summaries_mod.shard_rows(points, valid, j, cap)
        if not len(pj):
            self._reset_shard(j)
            return
        self._rebuild_shard(j, pj)

    def copy_shard_from(self, j: int, other: "AdaptiveMaintainer",
                        oj: int) -> None:
        """Transplant shard ``oj``'s whole summary state from ``other``
        into shard ``j``: the background worker's re-tightening commit
        (``store/maintenance.py``), whose exact recompute ran off the
        lock on a k=1 scratch maintainer."""
        j, oj = int(j), int(oj)
        self._sum[j] = other._sum[oj]
        self._n[j] = other._n[oj]
        self._radius[j] = other._radius[oj]
        self._lo[j] = other._lo[oj]
        self._hi[j] = other._hi[oj]
        self._piv[j] = other._piv[oj]
        self._piv_r[j] = other._piv_r[oj]
        self._piv_n[j] = other._piv_n[oj]
        self._piv_live[j] = other._piv_live[oj]
        self._ops_since[j] = other._ops_since[oj]
        self._radius_at_rebuild[j] = other._radius_at_rebuild[oj]

    # ---- scheduling (store lock held) ------------------------------------

    def retighten_due(self) -> int | None:
        """The next shard (round-robin from a persistent cursor) that
        absorbed ``retighten_every`` ops since its last exact rebuild, or
        None."""
        if self.retighten_every <= 0:
            return None
        for step in range(self.k):
            j = (self._rr + step) % self.k
            if self._n[j] > 0 and self._ops_since[j] >= self.retighten_every:
                self._rr = (j + 1) % self.k
                return j
        return None

    def split_candidate(self) -> int | None:
        """The shard with the largest ``radius / gap`` ratio among those
        whose radius exceeds ``split_radius_factor`` times the gap to the
        nearest other occupied centroid and ``_SPLIT_GROWTH`` times its
        radius at the last exact rebuild, or None."""
        if self.split_radius_factor <= 0:
            return None
        occ = np.flatnonzero(self._n > 0)     # gaps measure ALL occupied
        cand = np.flatnonzero(self._n > 1)    # singletons never fire
        if occ.size < 2 or cand.size == 0:
            return None
        cents = self._sum[occ] / self._n[occ, None]
        cand_cents = self._sum[cand] / self._n[cand, None]
        gaps = np.sqrt(
            ((cand_cents[:, None] - cents[None]) ** 2).sum(-1))
        gaps[cand[:, None] == occ[None, :]] = np.inf       # self-distance
        gap = gaps.min(1)
        r = self._radius[cand]
        armed = r > _SPLIT_GROWTH * self._radius_at_rebuild[cand]
        ratio = r / np.maximum(gap, 1e-30)
        fire = armed & (ratio > self.split_radius_factor)
        if not fire.any():
            return None
        return int(cand[np.argmax(np.where(fire, ratio, -np.inf))])

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
