"""Compaction / rebalance policy and repacking for the mutable store.

The port's copy of ``repro.store.compaction``, in host numpy as there, so
the store's decisions and layouts are bit-equal to the reference's.

Deletes only flip a slot's ``valid`` bit, so a shard's free space is its
untouched tail; and inserts land where placement sends them while
deletes land wherever the victim lives, so live counts drift apart.
:func:`evaluate` watches both with one scalar each:

  ``tombstone_density = dead_slots / occupied_slots``
  ``imbalance         = (max_live - min_live) / capacity``

Crossing either threshold repacks at that apply.  :func:`repack` deals
the live points round-robin in ascending-id order into dense, balanced
per-shard prefixes; ids are stable, only slots move.  A store built with
``redeal="proximity"`` repacks through ``store/placement.py``
``repack_proximity`` instead, under the same invariants, with the quota
slack clamped by :func:`redeal_slack` so a re-deal cannot re-arm the
imbalance trigger.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class CompactionDecision(NamedTuple):
    compact: bool
    reason: str | None
    tombstone_density: float
    imbalance: float


def evaluate(live: np.ndarray, used: np.ndarray, cap: int, *,
             tombstone_frac: float,
             imbalance_frac: float,
             registry=None) -> CompactionDecision:
    """Decide whether the store should repack.

    ``live``: (k,) live points per shard; ``used``: (k,) occupied slots
    per shard (the high-water mark — live + tombstones); ``cap``: slots
    per shard.  With ``registry`` (an obs MetricsRegistry), the two
    erosion scalars are published as gauges on every evaluation and a
    fired trigger is counted by kind — the compactor's inputs show up
    in ``snapshot()`` instead of only its effects.
    """
    used_total = int(used.sum())
    dead = used_total - int(live.sum())
    density = dead / used_total if used_total else 0.0
    imbalance = (int(live.max()) - int(live.min())) / cap if cap else 0.0
    if registry is not None:
        registry.gauge("store.tombstone_density").set(density)
        registry.gauge("store.imbalance").set(imbalance)
    if density > tombstone_frac:
        if registry is not None:
            registry.counter("store.compact_trigger.tombstone").inc()
        return CompactionDecision(
            True, f"tombstone_density {density:.3f} > {tombstone_frac}",
            density, imbalance)
    if imbalance > imbalance_frac:
        if registry is not None:
            registry.counter("store.compact_trigger.imbalance").inc()
        return CompactionDecision(
            True, f"imbalance {imbalance:.3f} > {imbalance_frac}",
            density, imbalance)
    return CompactionDecision(False, None, density, imbalance)


def redeal_slack(guard_slack: int, imbalance_frac: float, cap: int,
                 k: int) -> int:
    """Quota slack for a proximity re-deal, clamped so the repack cannot
    re-arm the compactor it serves.

    The slack shares the placement guardrail knob, but a re-deal may
    leave a worst-case skew of ``k·(slack+1)``; keeping
    ``slack < imbalance_frac·cap/k − 1`` bounds that below the imbalance
    trigger, so neither a compaction-time proximity re-deal nor an
    adaptive split (store/adaptive.py) can schedule the very repack that
    would immediately follow it.
    """
    return min(int(guard_slack),
               max(0, int(imbalance_frac * cap / k) - 1))


def scatter_operands(slots, points: np.ndarray, ids: np.ndarray,
                     valid: np.ndarray, total: int, dim: int, *,
                     id_sentinel: int):
    """Padded operand block for one batched slot scatter: ``(idx,
    upd_pts, upd_ids, upd_valid)`` carrying the *final* mirror value of
    each touched slot, padded to a power of two with out-of-range rows
    (index ``total``), the reference's layout.  The port's store scatters
    the first ``len(slots)`` rows and never the padding.
    """
    n = len(slots)
    pad = max(8, 1 << max(0, (n - 1).bit_length()))
    idx = np.full(pad, total, np.int32)
    idx[:n] = slots
    upd_pts = np.zeros((pad, dim), np.float32)
    upd_ids = np.full(pad, id_sentinel, np.int32)
    upd_valid = np.zeros(pad, bool)
    upd_pts[:n] = points[slots]
    upd_ids[:n] = ids[slots]
    upd_valid[:n] = valid[slots]
    return idx, upd_pts, upd_ids, upd_valid


def payload_operand(slots, payload: np.ndarray, padded_len: int) -> np.ndarray:
    """The label-payload column of one batched slot scatter, padded to
    the same length (and aligned to the same rows) as the ``idx`` block
    :func:`scatter_operands` built — padding rows carry zeros and are
    dropped with their out-of-range indices."""
    upd = np.zeros(padded_len, payload.dtype)
    upd[:len(slots)] = payload[list(slots)]
    return upd


def remap_payload(payload: np.ndarray, old_ids: np.ndarray,
                  old_valid: np.ndarray, new_ids: np.ndarray,
                  new_valid: np.ndarray) -> np.ndarray:
    """Carry a per-slot payload across a repack: every live id keeps its
    payload, whatever slot the re-deal moved it to.

    Vectorized id join (sort the old live ids once, searchsorted the new
    layout's ids into them) — O(live log live), no per-point dict walk.
    Free/dead slots in the new layout get zeros; they are masked by
    ``new_valid`` everywhere the payload is read.
    """
    out = np.zeros_like(payload)
    old_slots = np.flatnonzero(old_valid)
    if old_slots.size == 0:
        return out
    oid = old_ids[old_slots]
    order = np.argsort(oid)
    oid_sorted = oid[order]
    pay_sorted = payload[old_slots][order]
    new_slots = np.flatnonzero(new_valid)
    pos = np.searchsorted(oid_sorted, new_ids[new_slots])
    out[new_slots] = pay_sorted[pos]
    return out


class RepackResult(NamedTuple):
    points: np.ndarray     # (k*cap, dim) new point mirror
    ids: np.ndarray        # (k*cap,) new id mirror (sentinel in free slots)
    valid: np.ndarray      # (k*cap,) new validity mirror
    slot_of: dict          # id -> new slot
    live: np.ndarray       # (k,) live per shard (balanced to within 1)
    used: np.ndarray       # (k,) new high-water marks (== live)


def repack(points: np.ndarray, ids: np.ndarray, valid: np.ndarray,
           k: int, cap: int, *, id_sentinel: int) -> RepackResult:
    """Pack live slots into dense, balanced per-shard prefixes.

    Live points are dealt round-robin in ascending-id order: point t goes
    to shard ``t % k`` at local offset ``t // k``.  Deterministic (no RNG,
    no dependence on previous layout), balanced to within one point, and
    id-stable.
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

    t = np.arange(n)
    dest = (t % k) * cap + t // k
    new_pts[dest] = points[order]
    new_ids[dest] = ids[order]
    new_valid[dest] = True

    slot_of = {int(i): int(s) for i, s in zip(ids[order], dest)}
    live = np.bincount(dest // cap, minlength=k).astype(np.int64)
    return RepackResult(points=new_pts, ids=new_ids, valid=new_valid,
                        slot_of=slot_of, live=live, used=live.copy())
