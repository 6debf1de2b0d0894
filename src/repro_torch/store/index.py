"""Per-shard approximate search index: bucket-pruned candidates.

The port's copy of ``repro.store.index``: the frozen
:class:`ShardIndex`, the :class:`IndexMaintainer` (exact ``rebuild``,
the mutable store's incremental ``insert`` / ``delete`` / ``update`` in
host f64 numpy, bit-equal to the reference's, and ``freeze``) and the
host keep rule (:func:`bucket_keep`, :func:`candidate_mask`,
:func:`candidate_fraction`).

Each shard's live points are covered by up to ``b`` balls ("buckets"),
built like the routing pivots (``store/adaptive.py``).  Per query, the
buckets in routing-kept shards are ordered by distance upper bound; T is
the smallest upper bound whose cumulative live count reaches
``target = max(l, ceil(oversample * l))``, and a bucket is kept when its
lower bound is <= T.  The kept buckets' slots are the candidates the
masked distance kernel sees (``core/knn.py`` ``point_candidates``).  The
tier is approximate: a true winner's bucket can look far.  An
``oversample`` so large that the walk never reaches its target keeps
every live bucket, and answers equal the exact ones byte for byte.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.store import adaptive as adaptive_mod
from repro_torch.store.summaries import shard_rows


class ShardIndex(NamedTuple):
    """One frozen generation of the bucket index.

    ``centers``: (k, b, dim) f64 ball centers; ``radii``: (k, b) f64
    covering radii; ``live``: (k, b) exact live count per bucket;
    ``count``: (k,) occupied bucket slots per shard; ``assign``: (k*cap,)
    int32 slot -> bucket within its shard, -1 for dead slots.
    """

    generation: int
    centers: np.ndarray
    radii: np.ndarray
    live: np.ndarray
    count: np.ndarray
    assign: np.ndarray

    @property
    def num_buckets(self) -> int:
        return self.centers.shape[1]


class IndexMaintainer:
    """The bucket index of one point set; :meth:`rebuild` computes it
    exactly, :meth:`freeze` emits the immutable view."""

    def __init__(self, k: int, cap: int, dim: int, num_buckets: int):
        if num_buckets < 1:
            raise ValueError(f"num_buckets must be >= 1, got {num_buckets}")
        self.k = int(k)
        self.cap = int(cap)
        self.dim = int(dim)
        self.num_buckets = int(num_buckets)
        b = self.num_buckets
        self._centers = np.zeros((k, b, dim))
        self._radii = np.zeros((k, b))
        self._live = np.zeros((k, b), np.int64)
        self._count = np.zeros(k, np.int64)
        self._assign = np.full(k * cap, -1, np.int32)

    # ---- incremental ops (store lock held) ------------------------------

    def insert(self, shard: int, slot: int, point) -> None:
        """Assign a new live slot to a bucket: claim a free bucket when the
        point lies outside every ball, else join the ball needing the
        least inflation."""
        j = int(shard)
        p = np.asarray(point, np.float64)
        c = int(self._count[j])
        if c == 0:
            self._centers[j, 0] = p
            self._radii[j, 0] = 0.0
            self._count[j] = 1
            self._live[j, 0] = 1
            self._assign[slot] = 0
            return
        d = np.sqrt(((self._centers[j, :c] - p) ** 2).sum(-1))
        if (d > self._radii[j, :c]).all() and c < self.num_buckets:
            self._centers[j, c] = p
            self._radii[j, c] = 0.0
            self._count[j] = c + 1
            self._live[j, c] = 1
            self._assign[slot] = c
        else:
            t = int(np.argmin(d - self._radii[j, :c]))
            self._radii[j, t] = max(self._radii[j, t], float(d[t]))
            self._live[j, t] += 1
            self._assign[slot] = t

    def delete(self, slot: int) -> None:
        """Debit the slot's bucket exactly; the ball stays covering for
        its remaining members."""
        t = int(self._assign[slot])
        if t >= 0:
            j = int(slot) // self.cap
            self._live[j, t] = max(self._live[j, t] - 1, 0)
            self._assign[slot] = -1

    def update(self, slot: int, point) -> None:
        """An overwrite keeps its bucket, whose ball inflates to cover the
        moved point."""
        t = int(self._assign[slot])
        if t < 0:
            return
        j = int(slot) // self.cap
        d = float(np.sqrt(
            ((np.asarray(point, np.float64) - self._centers[j, t]) ** 2)
            .sum()))
        self._radii[j, t] = max(self._radii[j, t], d)

    # ---- exact rebuild ---------------------------------------------------

    def rebuild(self, points, valid=None) -> None:
        """Exact per-shard rebuild: farthest-point bucket centers
        (``adaptive.pivot_set``), nearest-center assignment, exact radii
        and live counts.  ``points`` is (k*cap, dim) numpy or a tensor
        (built on its device); ``valid`` (optional (k*cap,) bool) masks
        dead slots."""
        if isinstance(valid, torch.Tensor):
            valid = valid.cpu().numpy()
        self._assign[:] = -1
        for j in range(self.k):
            sl = slice(j * self.cap, (j + 1) * self.cap)
            mine = (np.arange(self.cap) if valid is None
                    else np.flatnonzero(np.asarray(valid[sl], bool)))
            self._centers[j] = 0.0
            self._radii[j] = 0.0
            self._live[j] = 0
            if mine.size == 0:
                self._count[j] = 0
                continue
            pj = shard_rows(points, valid, j, self.cap)
            piv, rad, cnt, assign = adaptive_mod.pivot_set(
                pj, self.num_buckets)
            self._centers[j, :cnt] = piv[:cnt]
            self._radii[j, :cnt] = rad[:cnt]
            self._count[j] = cnt
            self._live[j, :cnt] = torch.bincount(
                assign, minlength=cnt).cpu().numpy()
            self._assign[sl][mine] = assign.cpu().numpy().astype(np.int32)

    def freeze(self, generation: int) -> ShardIndex:
        return ShardIndex(
            generation=int(generation),
            centers=self._centers.copy(),
            radii=self._radii.copy(),
            live=self._live.copy(),
            count=self._count.copy(),
            assign=self._assign.copy())


# ---- query-time candidate selection (host path) --------------------------

def bucket_keep(index: ShardIndex, queries, ls, shard_keep=None, *,
                oversample: float = 2.0) -> np.ndarray:
    """(B, k, b) bool: buckets that may hold a top-l winner, per query, in
    f64 on the host.  ``shard_keep`` (B, k) bool is the routing decision
    (None = all shards); rows with ``ls == 0`` keep nothing."""
    q = np.atleast_2d(np.asarray(queries, np.float64))
    B = q.shape[0]
    k, b, _ = index.centers.shape
    ls = np.asarray(ls, np.int64).reshape(B)
    d = np.sqrt(
        ((q[:, None, None, :] - index.centers[None]) ** 2).sum(-1))
    occ = ((np.arange(b)[None, :] < index.count[:, None])
           & (index.live > 0))
    if shard_keep is None:
        shard_keep = np.ones((B, k), bool)
    g = occ[None] & np.asarray(shard_keep, bool)[:, :, None]
    lb = np.where(g, np.maximum(d - index.radii[None], 0.0) ** 2, np.inf)
    ub = np.where(g, (d + index.radii[None]) ** 2, np.inf)
    target = np.maximum(ls, np.ceil(oversample * ls).astype(np.int64))
    ubf = ub.reshape(B, -1)
    livef = np.where(g, index.live[None], 0).reshape(B, -1)
    order = np.argsort(ubf, axis=1, kind="stable")
    csum = np.cumsum(np.take_along_axis(livef, order, axis=1), axis=1)
    reached = csum >= target[:, None]
    has = reached.any(axis=1)
    first = np.where(has, reached.argmax(axis=1), 0)
    ub_sorted = np.take_along_axis(ubf, order, axis=1)
    # no T when the total live is below the target: keep every live bucket
    T = np.where(has, ub_sorted[np.arange(B), first], np.inf)
    return g & (lb <= T[:, None, None]) & (ls > 0)[:, None, None]


def slot_decode(index: ShardIndex, cap: int):
    """``(colidx, has)``, both (k*cap,): each slot's flat bucket column
    ``shard*b + bucket`` and whether it is assigned; the server uploads
    them once and decodes each batch's keep on the device."""
    a = index.assign
    shard = np.arange(a.shape[0], dtype=np.int64) // cap
    return shard * index.num_buckets + np.maximum(a, 0), a >= 0


def candidate_mask(index: ShardIndex, keep_any: np.ndarray,
                   cap: int) -> np.ndarray:
    """(k*cap,) bool slot candidates from a (k, b) batch-union keep."""
    colidx, has = slot_decode(index, cap)
    return keep_any.reshape(-1)[colidx] & has


def candidate_fraction(index: ShardIndex, keep_any: np.ndarray) -> float:
    """Kept live points / total live, from the index's own live counts."""
    total = int(index.live.sum())
    if total == 0:
        return 1.0
    return float(index.live[keep_any].sum()) / total
