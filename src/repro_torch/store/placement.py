"""Locality-aware placement: which shard gets each point.

The port's copy of ``repro.store.placement``, in host numpy as there, so
every placement and re-deal is bit-equal to the reference's.

* **Placement policies** (:func:`make_placement`) pick the shard of each
  applied insert.  ``balance``: the emptiest shard with tail space.
  ``affinity``: the nearest live summary centroid among the shards whose
  live count is within ``guard_slack`` of the minimum, so an insert-only
  history never skews live counts beyond ``guard_slack + 1``; a point
  outside every eligible ball seeds an empty eligible shard instead.
* **Proximity re-deal** (:func:`repack_proximity`), the compaction-time
  counterpart (``redeal="proximity"``): a few Lloyd iterations seeded
  from the shard centroids, then points claim their nearest centroid's
  shard in descending regret order under the quota ``min(cap, ceil(n/k) +
  balance_slack)``; ids stay stable and every shard a dense prefix.

Placement never changes an answer, only how much routing can prune.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from repro_torch.store import compaction

_INT64_MAX = np.iinfo(np.int64).max


class PlacementView(NamedTuple):
    """What a policy may look at when placing one point (store lock held).

    ``live``/``used``: (k,) live counts and high-water marks; ``cap``:
    slots per shard; ``centroids``: (k, dim) float64 live means (zeros
    where empty); ``radii``: (k,) covering radii; ``occupied``: (k,) bool
    — whether the centroid/radius row describes any live point.  The
    store builds the centroid/radius/occupied triple only for policies
    that declare ``uses_centroids`` (it costs O(k·dim) per insert); a
    policy that opts out receives None in those three fields.
    """

    live: np.ndarray
    used: np.ndarray
    cap: int
    centroids: np.ndarray
    radii: np.ndarray
    occupied: np.ndarray


class PlacementPolicy:
    """One staged insert -> one destination shard.

    ``pick`` returns the shard index, or -1 if no shard has tail space
    (``used == cap`` everywhere) — the store then repacks and retries.
    Policies are consulted under the store lock with the view reflecting
    every previously applied op of the same flush, so a policy sees its
    own earlier placements.  ``uses_centroids`` (default True — safe for
    custom policies) tells the store whether to pay for the view's
    centroid/radius/occupied fields; only policies that never read them
    should set it False.
    """

    name: str = "base"
    uses_centroids: bool = True

    def pick(self, point: Optional[np.ndarray], view: PlacementView) -> int:
        raise NotImplementedError


def _balance_pick(view: PlacementView, eligible: np.ndarray) -> int:
    """Least-loaded eligible shard, smallest index on ties."""
    live = np.where(eligible, view.live, _INT64_MAX)
    return int(np.argmin(live))


class BalancePlacement(PlacementPolicy):
    """The original rule: emptiest shard with tail space, ignoring the
    point entirely (Duan/Qiao-style shard balance, nothing else)."""

    name = "balance"
    uses_centroids = False

    def pick(self, point, view: PlacementView) -> int:
        open_mask = view.used < view.cap
        if not open_mask.any():
            return -1
        return _balance_pick(view, open_mask)


class AffinityPlacement(PlacementPolicy):
    """Nearest-live-centroid placement under a balance guardrail.

    Eligibility: tail space AND ``live <= min(live) + guard_slack``.  An
    insert into an eligible shard leaves it at most ``guard_slack + 1``
    above the global minimum, which is the whole guardrail proof — no
    insert-only history can skew further, so the compaction imbalance
    trigger (a fraction of *capacity*) never fires off the back of
    affinity placement.  Delete-driven skew is out of a placement
    policy's hands; that regime stays the compactor's job.

    Among eligible shards: nearest occupied centroid wins, unless an
    empty eligible shard exists and the point is an outsider — farther
    from its nearest centroid than both that shard's covering radius and
    half the gap to the centroid's nearest occupied neighbor (the
    natural new-cluster test; radius alone misfires during cold start,
    when one-point shards have radius zero and *everything* looks
    outside).  Outsiders seed the empty shard (lowest index) so a
    previously unseen cluster claims fresh capacity instead of inflating
    a foreign shard's radius.  If the guardrail leaves nothing eligible
    (possible only with tombstones: the min-live shard may have no
    tail), fall back to the balance rule over open shards.
    """

    def __init__(self, guard_slack: int = 32):
        if guard_slack < 0:
            raise ValueError(f"guard_slack must be >= 0, got {guard_slack}")
        self.guard_slack = int(guard_slack)
        self.name = "affinity"

    def pick(self, point, view: PlacementView) -> int:
        open_mask = view.used < view.cap
        if not open_mask.any():
            return -1
        eligible = open_mask & (view.live <= view.live.min()
                                + self.guard_slack)
        if not eligible.any():
            return _balance_pick(view, open_mask)
        candidates = eligible & view.occupied
        if not candidates.any():
            return _balance_pick(view, eligible)
        p = np.asarray(point, np.float64)
        d = np.full(view.live.shape, np.inf)
        d[candidates] = np.sqrt(
            ((view.centroids[candidates] - p) ** 2).sum(-1))
        j = int(np.argmin(d))
        empties = eligible & ~view.occupied
        if empties.any() and d[j] > self._seed_threshold(view, j):
            return int(np.argmax(empties))
        return j

    @staticmethod
    def _seed_threshold(view: PlacementView, j: int) -> float:
        """How far outside shard j a point must sit to seed an empty
        shard instead: beyond the covering radius AND beyond half the
        gap to j's nearest occupied neighbor centroid."""
        half_gap = 0.0
        others = view.occupied.copy()
        others[j] = False
        if others.any():
            half_gap = 0.5 * float(np.sqrt(
                ((view.centroids[others] - view.centroids[j]) ** 2)
                .sum(-1)).min())
        return max(float(view.radii[j]), half_gap)


def make_placement(name, *, guard_slack: int = 32) -> PlacementPolicy:
    """Policy factory; accepts an already-built policy unchanged (the
    pluggable path for custom policies)."""
    if isinstance(name, PlacementPolicy):
        return name
    if name == "balance":
        return BalancePlacement()
    if name == "affinity":
        return AffinityPlacement(guard_slack=guard_slack)
    raise ValueError(
        f"unknown placement policy {name!r} (want 'balance', 'affinity', "
        f"or a PlacementPolicy instance)")


# ---- proximity re-deal (compaction-time counterpart) ---------------------

def _farthest_point_seeds(pts: np.ndarray, seeds: list, k: int) -> np.ndarray:
    """Complete ``seeds`` to k rows by greedy farthest-point traversal of
    ``pts`` — deterministic (argmax takes the first maximum)."""
    if not seeds:
        seeds = [pts[int(np.argmax(
            ((pts - pts.mean(0)) ** 2).sum(-1)))]]
    while len(seeds) < k:
        d = ((pts[:, None, :] - np.asarray(seeds)[None]) ** 2).sum(-1)
        seeds.append(pts[int(np.argmax(d.min(1)))])
    return np.asarray(seeds, np.float64)


def lloyd_centroids(pts: np.ndarray, k: int, *,
                    seed_centroids: Optional[np.ndarray] = None,
                    iters: int = 4) -> np.ndarray:
    """(k, dim) centroids after ``iters`` Lloyd steps, no RNG anywhere.

    Seeds: ``seed_centroids`` rows (the live shard centroids at repack
    time), completed farthest-point-first from the points when fewer than
    k are supplied.  Clusters that come up empty re-seed to the points
    currently farthest from their assigned centroid, each empty cluster
    taking a distinct point — identical seeds can never permanently
    collapse the iteration.
    """
    pts = np.asarray(pts, np.float64)
    seeds = [] if seed_centroids is None else [
        np.asarray(c, np.float64) for c in seed_centroids[:k]]
    cents = _farthest_point_seeds(pts, seeds, k)
    for _ in range(max(iters, 1)):
        d = ((pts[:, None, :] - cents[None]) ** 2).sum(-1)      # (n, k)
        assign = d.argmin(1)
        counts = np.bincount(assign, minlength=k)
        empty = np.flatnonzero(counts == 0)
        if empty.size:
            far = np.argsort(-d[np.arange(len(pts)), assign],
                             kind="stable")
            for i, c in enumerate(empty):
                cents[c] = pts[far[i % len(far)]]
            continue
        for j in range(k):
            cents[j] = pts[assign == j].mean(0)
    return cents


def repack_proximity(points: np.ndarray, ids: np.ndarray, valid: np.ndarray,
                     k: int, cap: int, *, id_sentinel: int,
                     seed_centroids: Optional[np.ndarray] = None,
                     balance_slack: int = 32,
                     lloyd_iters: int = 4) -> compaction.RepackResult:
    """Proximity re-deal: repack live points into cluster-coherent shards.

    Same contract as :func:`compaction.repack` — ids stable (only slots
    move), every shard's occupied region a dense prefix, deterministic —
    but destinations come from Lloyd centroids
    (:func:`lloyd_centroids`) instead of round-robin: shard j owns
    centroid j, and each point goes to the nearest centroid whose shard
    still has quota.  The balanced-capacity constraint is the quota
    ``min(cap, ceil(n/k) + balance_slack)``: no shard exceeds the even
    share by more than the slack, yet a natural cluster slightly larger
    than n/k stays whole instead of bleeding its tail into a foreign
    shard — one straggler point would otherwise inflate that shard's
    covering radius and void the very pruning the re-deal exists to buy.
    Points claim shards in descending regret order — the gap between
    their best and second-best centroid — so when quotas bind, the
    points that care most choose first.  Within a shard, points sit in
    ascending-id order.
    """
    dim = points.shape[1]
    total = k * cap
    live_slots = np.flatnonzero(valid)
    order = live_slots[np.argsort(ids[live_slots], kind="stable")]
    n = order.size
    assert n <= total

    new_pts = np.zeros((total, dim), points.dtype)
    new_ids = np.full(total, id_sentinel, np.int32)
    new_valid = np.zeros(total, bool)
    if n == 0:
        return compaction.RepackResult(
            points=new_pts, ids=new_ids, valid=new_valid, slot_of={},
            live=np.zeros(k, np.int64), used=np.zeros(k, np.int64))

    pts = np.asarray(points[order], np.float64)
    cents = lloyd_centroids(pts, k, seed_centroids=seed_centroids,
                            iters=lloyd_iters)
    d = ((pts[:, None, :] - cents[None]) ** 2).sum(-1)          # (n, k)
    pref = np.argsort(d, axis=1, kind="stable")                 # (n, k)
    if k > 1:
        d_sorted = np.take_along_axis(d, pref[:, :2], axis=1)
        regret = d_sorted[:, 1] - d_sorted[:, 0]
    else:
        regret = np.zeros(n)
    greedy = np.argsort(-regret, kind="stable")

    quota = np.full(k, min(cap, -(-n // k) + max(int(balance_slack), 0)),
                    np.int64)
    shard_of = np.empty(n, np.int64)
    for t in greedy:
        for j in pref[t]:
            if quota[j] > 0:
                quota[j] -= 1
                shard_of[t] = j
                break

    # points are already in ascending-id order, so a stable sort by shard
    # leaves each shard's members ascending by id
    by_shard = np.argsort(shard_of, kind="stable")
    live = np.bincount(shard_of, minlength=k).astype(np.int64)
    offsets = np.concatenate(([0], np.cumsum(live)[:-1]))
    dest = np.empty(n, np.int64)
    dest[by_shard] = (shard_of[by_shard] * cap
                      + (np.arange(n) - offsets[shard_of[by_shard]]))
    new_pts[dest] = points[order]
    new_ids[dest] = ids[order]
    new_valid[dest] = True
    slot_of = {int(i): int(s) for i, s in zip(ids[order], dest)}
    return compaction.RepackResult(points=new_pts, ids=new_ids,
                                   valid=new_valid, slot_of=slot_of,
                                   live=live, used=live.copy())
