"""Per-shard summaries and the host router behind ``route="pruned"``.

The port's copy of ``repro.store.summaries``: the frozen
:class:`ShardSummaries`, the :class:`SummaryMaintainer` (exact
``rebuild``, the mutable store's incremental ``insert`` / ``delete`` /
``update``, ``placement_view`` and ``freeze``), :func:`build_summaries`,
the f64 routing bounds and decision (:func:`route_shards`), and the
covering probes :func:`summary_invariants`, :func:`summary_slack` and
:func:`summary_slack_sampled`.

**Summary contents** (one row per shard, host f64): the live-point
centroid and a covering radius; optionally up to ``m`` pivot balls whose
union covers the shard (``store/adaptive.py``); and a random-projection
sketch, the interval ``[min u.p, max u.p]`` of the shard's points along
``r`` fixed unit directions.  Each gives a triangle-inequality lower
bound on the distance from a query to any point of the shard; the ball
sources give upper bounds too.

**Routing decision**, per query row with its own l: the smallest shard
upper bound T at which the cumulative live count of the shards at or
below it reaches l bounds the l-th NN distance from above (min'd with the
same walk over pivot balls and their live credits).  A shard whose lower
bound exceeds ``T*(1+slack) + err`` holds no winner and is masked;
``err = 16*(dim+1)*2^-23*(|q|+R)^2`` (:func:`pipeline_error_bound`)
covers the f32 rounding of the computed distances the pipeline ranks by,
so pruned answers stay bit-identical to exact ones.  Rows with l = 0
(bucket padding) route nowhere.

**Incremental maintenance** (the mutable store, under its lock): an
insert or delete moves the centroid by d, so the covering radius grows
by d; deletes never shrink the radius or the projection intervals
(stale but still covering).  These ops run in host f64 numpy, op for op
as the reference's, so they are bit-equal to it.

**The exact build on the points' device.**  The reference builds in f64
numpy.
The port takes numpy or a torch tensor and builds shard by shard in f64
torch on the points' device, so a full-width set made on the card (2^22
x 64, 2 GB in f64) never goes through host memory.  The sums are taken
in another order than numpy's, so the summaries agree with the
reference's to f64 rounding, not bit for bit; the routing bounds are
computed on the host from them, in f64 numpy, as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_F32_EPS = float(np.finfo(np.float32).eps)       # 2^-23


class ShardSummaries(NamedTuple):
    """One generation's frozen routing metadata (host float64).

    ``live``: (k,) live points per shard; ``centroids``: (k, dim) live
    means (zeros for empty shards); ``radii``: (k,) covering radii;
    ``directions``: (r, dim) unit projection directions; ``proj_lo`` /
    ``proj_hi``: (k, r) projection intervals (+inf / -inf when empty).
    The pivot fields (None in the single-pivot form): ``pivots`` (k, m,
    dim), ``pivot_radii`` (k, m), ``pivot_count`` (k,) occupied slots,
    ``pivot_live`` (k, m) live credits of each ball.
    """

    generation: int
    live: np.ndarray
    centroids: np.ndarray
    radii: np.ndarray
    directions: np.ndarray
    proj_lo: np.ndarray
    proj_hi: np.ndarray
    pivots: np.ndarray | None = None
    pivot_radii: np.ndarray | None = None
    pivot_count: np.ndarray | None = None
    pivot_live: np.ndarray | None = None


def projection_directions(dim: int, num_projections: int,
                          seed: int = 0) -> np.ndarray:
    """(r, dim) fixed unit-norm directions, deterministic given the seed."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(num_projections, dim))
    return d / np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-30)


def shard_rows(points, valid, j: int, cap: int) -> torch.Tensor:
    """Shard ``j``'s live rows of ``points`` (numpy or tensor, rows
    ``[j*cap, (j+1)*cap)``) as an f64 tensor on the points' device."""
    rows = torch.as_tensor(points)[j * cap:(j + 1) * cap]
    if valid is not None:
        keep = torch.as_tensor(valid[j * cap:(j + 1) * cap])
        rows = rows[keep.to(device=rows.device, dtype=torch.bool)]
    return rows.to(torch.float64)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


class SummaryMaintainer:
    """Per-shard summary state; :meth:`rebuild` computes it exactly from
    the points and :meth:`freeze` emits the immutable view."""

    def __init__(self, k: int, dim: int, *, num_projections: int = 8,
                 seed: int = 0):
        self.k, self.dim = int(k), int(dim)
        self.num_projections = int(num_projections)
        self.seed = int(seed)
        self.directions = projection_directions(dim, num_projections, seed)
        r = self.directions.shape[0]
        self._sum = np.zeros((k, dim), np.float64)
        self._n = np.zeros(k, np.int64)
        self._radius = np.zeros(k, np.float64)
        self._lo = np.full((k, r), np.inf)
        self._hi = np.full((k, r), -np.inf)

    def _centroid(self, j: int) -> np.ndarray:
        n = self._n[j]
        return self._sum[j] / n if n else np.zeros(self.dim)

    def insert(self, shard: int, point) -> None:
        j = int(shard)
        p = np.asarray(point, np.float64)
        c_old = self._centroid(j)
        had = self._n[j] > 0
        self._sum[j] += p
        self._n[j] += 1
        c_new = self._centroid(j)
        drift = float(np.linalg.norm(c_new - c_old)) if had else 0.0
        self._radius[j] = max(self._radius[j] + drift,
                              float(np.linalg.norm(p - c_new)))
        pr = self.directions @ p
        np.minimum(self._lo[j], pr, out=self._lo[j])
        np.maximum(self._hi[j], pr, out=self._hi[j])

    def delete(self, shard: int, point) -> None:
        j = int(shard)
        p = np.asarray(point, np.float64)
        c_old = self._centroid(j)
        self._sum[j] -= p
        self._n[j] -= 1
        if self._n[j] <= 0:
            self._reset_shard(j)
            return
        # the radius grows by the centroid drift; the projection
        # intervals stay as they are (stale but still covering)
        drift = float(np.linalg.norm(self._centroid(j) - c_old))
        self._radius[j] += drift

    def update(self, shard: int, old_point, new_point) -> None:
        self.delete(shard, old_point)
        self.insert(shard, new_point)

    def _reset_shard(self, j: int) -> None:
        self._sum[j] = 0.0
        self._n[j] = 0
        self._radius[j] = 0.0
        self._lo[j] = np.inf
        self._hi[j] = -np.inf

    def rebuild(self, points, valid, cap: int) -> None:
        """Exact recompute from ``points`` ((n, dim) numpy or tensor) and
        ``valid`` ((n,) bool or None), shard j owning rows
        ``[j*cap, (j+1)*cap)``."""
        for j in range(self.k):
            pj = shard_rows(points, valid, j, cap)
            if not len(pj):
                self._reset_shard(j)
                continue
            self._rebuild_shard(j, pj)

    def _rebuild_shard(self, j: int, pj: torch.Tensor) -> None:
        """Exact per-shard recompute from its live points ``pj``
        (nonempty f64 tensor)."""
        self._sum[j] = _host(pj.sum(0))
        self._n[j] = len(pj)
        c = torch.from_numpy(self._centroid(j)).to(pj.device)
        self._radius[j] = float(((pj - c) ** 2).sum(-1).sqrt().max())
        pr = pj @ torch.from_numpy(self.directions.T.copy()).to(pj.device)
        self._lo[j] = _host(pr.amin(0))
        self._hi[j] = _host(pr.amax(0))

    def placement_view(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(centroids (k, dim), radii (k,), occupied (k,) bool) of the
        applied state, what affinity placement and the proximity re-deal
        consult (``store/placement.py``)."""
        n = np.maximum(self._n, 1)[:, None]
        return self._sum / n, self._radius.copy(), self._n > 0

    def freeze(self, generation: int) -> ShardSummaries:
        n = np.maximum(self._n, 1)[:, None]
        return ShardSummaries(
            generation=int(generation),
            live=self._n.copy(),
            centroids=self._sum / n,
            radii=self._radius.copy(),
            directions=self.directions,
            proj_lo=self._lo.copy(),
            proj_hi=self._hi.copy())


def build_summaries(points, k: int, *, valid=None, num_projections: int = 8,
                    seed: int = 0, generation: int = 0,
                    num_pivots: int = 1) -> ShardSummaries:
    """Summaries for a contiguously sharded static point set.

    ``points``: (n, dim) numpy array or tensor; shard j owns rows
    ``[j*n/k, (j+1)*n/k)``.  ``valid`` (optional (n,) bool) masks dead
    rows.  ``num_pivots > 1`` builds the multi-pivot form
    (``store/adaptive.py``).
    """
    n, dim = points.shape
    if n % k:
        raise ValueError(f"n={n} must be divisible by k={k}")
    if num_pivots > 1:
        from repro_torch.store import adaptive as adaptive_mod
        m = adaptive_mod.AdaptiveMaintainer(
            k, dim, num_projections=num_projections, seed=seed,
            num_pivots=num_pivots)
    else:
        m = SummaryMaintainer(k, dim, num_projections=num_projections,
                              seed=seed)
    m.rebuild(points, valid, n // k)
    return m.freeze(generation)


# ---- routing bounds (host f64, as in the reference) ----------------------

def _centroid_distances(s: ShardSummaries, q: np.ndarray) -> np.ndarray:
    """(B, k) query-to-centroid L2 distances."""
    return np.sqrt(((q[:, None, :] - s.centroids[None]) ** 2).sum(-1))


def _pivot_dists(s: ShardSummaries, q: np.ndarray) -> np.ndarray | None:
    """(B, k, m) query-to-pivot distances, or None without a pivot set."""
    if s.pivots is None:
        return None
    return np.sqrt(((q[:, None, None, :] - s.pivots[None]) ** 2).sum(-1))


def _pivot_bounds(s: ShardSummaries, q: np.ndarray,
                  dp: np.ndarray | None = None):
    """(lb, ub): (B, k) distance brackets from the pivot-ball union, or
    (None, None).  Shards with no occupied pivot give lb 0, ub +inf."""
    if s.pivots is None:
        return None, None
    m = s.pivots.shape[1]
    if dp is None:
        dp = _pivot_dists(s, q)
    occ = np.arange(m)[None, :] < s.pivot_count[:, None]     # (k, m)
    lb = np.where(occ[None], np.maximum(dp - s.pivot_radii[None], 0.0),
                  np.inf).min(-1)
    ub = np.where(occ[None], dp + s.pivot_radii[None], -np.inf).max(-1)
    has = s.pivot_count > 0
    return (np.where(has[None], lb, 0.0),
            np.where(has[None], ub, np.inf))


def _pivot_threshold(s: ShardSummaries, q: np.ndarray, ls: np.ndarray,
                     dp: np.ndarray | None = None) -> np.ndarray | None:
    """(B,) squared threshold from the pivot balls' live credits (balls
    in ascending upper-bound order until the credits reach l), or None
    without a pivot set.  Credits are safe undercounts, so this can only
    be >= the exact-count threshold."""
    if s.pivots is None or s.pivot_live is None:
        return None
    m = s.pivots.shape[1]
    if dp is None:
        dp = _pivot_dists(s, q)
    B = q.shape[0]
    occ = ((np.arange(m)[None, :] < s.pivot_count[:, None])
           & (s.pivot_live > 0))                             # (k, m)
    pub = np.where(occ[None], (dp + s.pivot_radii[None]) ** 2, np.inf)
    pub_flat = pub.reshape(B, -1)
    plive_flat = np.where(occ, s.pivot_live, 0).reshape(-1)
    order = np.argsort(pub_flat, axis=1, kind="stable")
    csum = np.cumsum(plive_flat[order], axis=1)
    reached = csum >= ls[:, None]
    has = reached.any(axis=1)
    first = np.where(has, reached.argmax(axis=1), 0)
    pub_sorted = np.take_along_axis(pub_flat, order, axis=1)
    return np.where(has, pub_sorted[np.arange(B), first], np.inf)


def lower_bounds(s: ShardSummaries, queries, dc=None, pb=None) -> np.ndarray:
    """(B, k) squared-distance lower bound from each query to each
    shard's nearest live point (+inf for empty shards): the max of the
    aggregate ball, pivot-set and projection-sketch bounds."""
    q = np.atleast_2d(np.asarray(queries, np.float64))
    if dc is None:
        dc = _centroid_distances(s, q)
    lb = np.maximum(dc - s.radii[None], 0.0)
    plb, _ = _pivot_bounds(s, q) if pb is None else pb
    if plb is not None:
        lb = np.maximum(lb, plb)
    empty = s.live == 0
    if s.directions.size:
        qp = q @ s.directions.T                              # (B, r)
        lo = np.where(empty[:, None], 0.0, s.proj_lo)
        hi = np.where(empty[:, None], 0.0, s.proj_hi)
        gap = np.maximum(np.maximum(lo[None] - qp[:, None, :],
                                    qp[:, None, :] - hi[None]), 0.0)
        lb = np.maximum(lb, gap.max(-1))
    out = lb ** 2
    out[:, empty] = np.inf
    return out


def upper_bounds(s: ShardSummaries, queries, dc=None, pb=None) -> np.ndarray:
    """(B, k) squared-distance upper bound covering every live point of
    each shard (+inf for empty shards): the min of the two ball covers."""
    q = np.atleast_2d(np.asarray(queries, np.float64))
    if dc is None:
        dc = _centroid_distances(s, q)
    ub = dc + s.radii[None]
    _, pub = _pivot_bounds(s, q) if pb is None else pb
    if pub is not None:
        ub = np.minimum(ub, pub)
    out = ub ** 2
    out[:, s.live == 0] = np.inf
    return out


def pipeline_error_bound(s: ShardSummaries, queries) -> np.ndarray:
    """(B,) bound on twice the f32 rounding of any computed (query, live
    point) squared distance: ``16*(dim+1)*eps*(|q| + R)^2`` with R the
    largest live ``|centroid| + radius``."""
    q = np.atleast_2d(np.asarray(queries, np.float64))
    dim = q.shape[1]
    live = s.live > 0
    if live.any():
        R = float((np.linalg.norm(s.centroids[live], axis=1)
                   + s.radii[live]).max())
    else:
        R = 0.0
    qn = np.linalg.norm(q, axis=1)
    return 16.0 * (dim + 1) * _F32_EPS * (qn + R) ** 2


def routing_detail(s: ShardSummaries, queries, ls, *,
                   slack: float = 1e-4) -> dict:
    """The routing decision with its working: ``lower`` / ``upper`` (B, k)
    squared bounds, ``threshold`` (B,) T, ``threshold_eff`` (B,)
    ``T*(1+slack) + err``, and ``keep`` (B, k) bool."""
    q = np.atleast_2d(np.asarray(queries, np.float64))
    B = q.shape[0]
    ls = np.broadcast_to(np.asarray(ls, np.int64), (B,))
    dc = _centroid_distances(s, q)
    dp = _pivot_dists(s, q)
    pb = _pivot_bounds(s, q, dp)
    lb = lower_bounds(s, q, dc, pb)
    ub = upper_bounds(s, q, dc, pb)
    order = np.argsort(ub, axis=1, kind="stable")
    csum = np.cumsum(s.live[order], axis=1)
    reached = csum >= ls[:, None]
    has = reached.any(axis=1)
    first = np.where(has, reached.argmax(axis=1), 0)
    ub_sorted = np.take_along_axis(ub, order, axis=1)
    T = np.where(has, ub_sorted[np.arange(B), first], np.inf)
    tp = _pivot_threshold(s, q, ls, dp)
    if tp is not None:
        T = np.minimum(T, tp)
    T_eff = T * (1.0 + slack) + pipeline_error_bound(s, q)
    keep = ((s.live[None, :] > 0) & (lb <= T_eff[:, None])
            & (ls[:, None] > 0))
    return {"lower": lb, "upper": ub, "threshold": T,
            "threshold_eff": T_eff, "keep": keep}


def route_shards(s: ShardSummaries, queries, ls, *,
                 slack: float = 1e-4) -> np.ndarray:
    """(B, k) bool: shard j may hold one of row b's ``ls[b]`` winners."""
    return routing_detail(s, queries, ls, slack=slack)["keep"]


# ---- covering probes (host f64, as in the reference) ---------------------

def _live_rows(points, valid, j: int, cap: int) -> np.ndarray:
    sl = slice(j * cap, (j + 1) * cap)
    return np.asarray(points[sl], np.float64)[np.asarray(valid[sl], bool)]


def summary_invariants(s: ShardSummaries, points: np.ndarray,
                       valid: np.ndarray, cap: int) -> dict:
    """Worst-case violation of the covering invariants over the live set
    (<= ~1e-9 for a correct maintainer: f64 rounding only)."""
    radius_viol = proj_viol = 0.0
    live_mismatch = 0
    for j in range(s.live.shape[0]):
        pj = _live_rows(points, valid, j, cap)
        live_mismatch = max(live_mismatch, abs(len(pj) - int(s.live[j])))
        if not len(pj):
            continue
        d = np.sqrt(((pj - s.centroids[j]) ** 2).sum(-1))
        radius_viol = max(radius_viol, float((d - s.radii[j]).max()))
        pr = pj @ s.directions.T
        proj_viol = max(proj_viol,
                        float((s.proj_lo[j] - pr).max()),
                        float((pr - s.proj_hi[j]).max()))
    return {"radius_violation": radius_viol,
            "projection_violation": proj_viol,
            "live_mismatch": live_mismatch}


def summary_slack(s: ShardSummaries, points: np.ndarray, valid: np.ndarray,
                  cap: int) -> np.ndarray:
    """(k,) covering-radius slack: the maintained radius minus the exact
    live radius about the maintained centroid (0.0 for empty shards), the
    pruning power incremental maintenance has cost since the last exact
    rebuild.  O(live*dim) host work, never on the dispatch path."""
    out = np.zeros(s.live.shape[0])
    for j in range(s.live.shape[0]):
        pj = _live_rows(points, valid, j, cap)
        if not len(pj):
            continue
        exact = float(np.sqrt(((pj - s.centroids[j]) ** 2).sum(-1)).max())
        out[j] = float(s.radii[j]) - exact
    return out


def summary_slack_sampled(s: ShardSummaries, points: np.ndarray,
                          valid: np.ndarray, cap: int, *,
                          sample: int = 64, rng=None) -> np.ndarray:
    """(k,) :func:`summary_slack` with the exact radius taken over at most
    ``sample`` live points drawn per shard: an over-estimate of the slack,
    for ranking shards, never a bound.  The draw is the reference's (the
    same rows for the same ``rng``); only the drawn rows are read in f64,
    so the probe costs O(k*sample*dim), not a conversion of every shard."""
    if rng is None:
        rng = np.random.default_rng(0)
    out = np.zeros(s.live.shape[0])
    for j in range(s.live.shape[0]):
        sl = slice(j * cap, (j + 1) * cap)
        rows = np.flatnonzero(np.asarray(valid[sl], bool))
        if not len(rows):
            continue
        if len(rows) > sample:
            rows = rows[rng.choice(len(rows), size=sample, replace=False)]
        pj = np.asarray(points[sl][rows], np.float64)
        exact = float(np.sqrt(((pj - s.centroids[j]) ** 2).sum(-1)).max())
        out[j] = float(s.radii[j]) - exact
    return out
