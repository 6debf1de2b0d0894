"""Mutable, sharded point store with epoch-swapped snapshots.

Port of ``repro.store.mutable``, with both maintenance planes.

* **Capacity-padded shard buffers.**  Each of the k shards owns ``cap``
  slots of a ``(k*cap, dim)`` point buffer on the device, with parallel
  ``ids`` / ``valid`` buffers.  Shapes never change; a slot that holds no
  live point is masked by ``valid`` and competes as the paper's +inf
  padding point.
* **Host mirrors are the authority.**  ``_pts`` / ``_ids`` / ``_valid``,
  the slot map and the per-shard counts live in host numpy; a device
  snapshot is a pure function of them.
* **Write-ahead staging.**  :meth:`insert` / :meth:`delete` /
  :meth:`update` validate a whole batch and enqueue it (nothing is
  visible yet); :meth:`flush` replays the ops onto the mirrors in
  submission order, and the final value of each touched slot lands on
  the device in one scatter.  Auto-flush at ``staging_size`` pending ops.
* **Generations.**  Every apply publishes a new immutable
  :class:`StoreSnapshot`.  The scatter never writes into a published
  snapshot's tensors: it clones each buffer and ``index_copy_``\\ s the
  touched slots into the clone, on the current stream, so a batch in
  flight keeps reading the generation it captured.  A repack uploads
  copies of the mirrors whole.
* **Placement, compaction and adaptive maintenance**
  (``store/placement.py``, ``store/compaction.py``,
  ``store/adaptive.py``), and the bucket index (``store/index.py``),
  are updated op by op, rebuilt exactly on a repack and frozen with
  every generation; :meth:`serving_snapshot` hands out the (snapshot,
  summaries, index) triple under one lock.

Op replay, placement, compaction decisions, summaries and slot order are
the reference's, op by op, so the mirrors are bit-equal to a reference
store driven by the same stream.

* **Label payload** (``with_labels=True``, the prediction plane): an f32
  per-slot mirror rides the same replay, repack (remapped by id,
  ``compaction.remap_payload``) and clone + scatter as the points, so a
  generation's labels never tear from its points; the id -> label map is
  monotone like the id -> value map.

* **Background maintenance** (``maintenance="background"``,
  ``store/maintenance.py``): the flush publishes at once and skips the
  maintenance tail (auto-compaction, split, re-tightening); a worker
  thread plans, prepares off the lock and commits that work.  While a
  worker's capture is outstanding, every applied op is journaled so
  the commit can replay what raced it; an inline repack (forced, or
  :meth:`compact`) invalidates the capture instead.
  :meth:`maint_commit_clock` counts committed maintenance cycles, which
  the server brackets each dispatch with.
* **Observability**: :meth:`attach_obs` takes the server's
  :class:`repro_torch.obs.ObsPlane`; applies, repacks and maintenance
  cycles record spans into its tracer and timings into its registry.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.store import adaptive as adaptive_mod
from repro_torch.store import compaction
from repro_torch.store import index as index_mod
from repro_torch.store import maintenance as maintenance_mod
from repro_torch.store import placement as placement_mod
from repro_torch.store import summaries as summaries_mod

ID_SENTINEL = 2**31 - 1


class StoreFullError(RuntimeError):
    """Raised when an insert cannot fit even after compaction."""


class StoreSnapshot(NamedTuple):
    """One immutable generation of the store on its device.

    ``points``: (k*cap, dim) f32; ``ids``: (k*cap,) int32 global ids
    (ID_SENTINEL in dead and free slots); ``valid``: (k*cap,) bool live
    mask; ``live``: the live count at this generation; ``labels``:
    (k*cap,) f32 per-slot label payload, frozen with the generation (None
    unless the store was built ``with_labels=True``).
    """

    generation: int
    points: torch.Tensor
    ids: torch.Tensor
    valid: torch.Tensor
    live: int
    labels: Optional[torch.Tensor] = None


@dataclasses.dataclass
class IngestStats:
    inserted: int = 0
    deleted: int = 0
    updated: int = 0
    applies: int = 0               # flushes that produced a generation
    compactions: int = 0
    forced_compactions: int = 0    # repacks forced by a full shard mid-flush
    retightens: int = 0            # scheduled per-shard exact re-tightenings
    splits: int = 0                # radius-triggered proximity re-deals
    last_compact_reason: Optional[str] = None


@dataclasses.dataclass
class _Op:
    kind: str                      # "insert" | "delete" | "update"
    id: int
    point: Optional[np.ndarray] = None
    value: Optional[int] = None
    label: Optional[float] = None  # None on update = keep current label


class MutableStore:
    """Mutable sharded point store; see module docstring.

    ``shards`` (k) takes the place of the reference's mesh axis;
    ``device=None`` means the card and raises without one (tests pass
    ``device="cpu"``).  Thread-safe: mutations, flushes and snapshot
    reads may come from any thread.
    """

    def __init__(self, dim: int, *, capacity_per_shard: int, shards: int = 8,
                 device=None, staging_size: int = 64,
                 compact_tombstone_frac: float = 0.35,
                 compact_imbalance_frac: float = 0.5,
                 auto_compact: bool = True, with_values: bool = False,
                 with_labels: bool = False,
                 track_history: bool = False,
                 summary_projections: int = 8, summary_seed: int = 0,
                 placement="balance", placement_guard_slack: int = 32,
                 redeal: str = "round_robin",
                 summary_pivots: int = 1, retighten_every: int = 0,
                 split_radius_factor: float = 0.0,
                 split_cooldown: int = 2, maintenance: str = "inline",
                 maintenance_probe_sample: int = 64,
                 index_buckets: int = 0):
        if capacity_per_shard < 1:
            raise ValueError("capacity_per_shard must be >= 1")
        if shards < 1:
            raise ValueError("shards must be >= 1")
        if redeal not in ("round_robin", "proximity"):
            raise ValueError(f"redeal must be 'round_robin' or 'proximity', "
                             f"got {redeal!r}")
        if maintenance not in ("inline", "background"):
            raise ValueError(f"maintenance must be 'inline' or 'background', "
                             f"got {maintenance!r}")
        self.device = resolve_device(device)
        self.dim = int(dim)
        self.k = int(shards)
        self.cap = int(capacity_per_shard)
        self.total = self.k * self.cap
        self.staging_size = int(staging_size)
        self.compact_tombstone_frac = float(compact_tombstone_frac)
        self.compact_imbalance_frac = float(compact_imbalance_frac)
        self.auto_compact = bool(auto_compact)
        self.with_values = bool(with_values)
        self.with_labels = bool(with_labels)
        self.maintenance = str(maintenance)
        self._placement = placement_mod.make_placement(
            placement, guard_slack=placement_guard_slack)
        self.placement = self._placement.name
        self.placement_guard_slack = int(placement_guard_slack)
        self.redeal = str(redeal)
        self.stats = IngestStats()
        self._lock = threading.RLock()

        # host mirrors: the authority; a snapshot is a function of them
        self._pts = np.zeros((self.total, self.dim), np.float32)
        self._ids = np.full(self.total, ID_SENTINEL, np.int32)
        self._valid = np.zeros(self.total, bool)
        self._slot_of: dict[int, int] = {}
        # ids are single-use forever, so the id -> value map is monotone
        self._used_ids: set[int] = set()
        self._live = np.zeros(self.k, np.int64)   # live points per shard
        self._used = np.zeros(self.k, np.int64)   # high-water mark per shard
        self._values: dict[int, int] = {}
        # the per-slot label mirror (f32: class ids are exact below 2^24)
        # and the monotone id -> label map
        self._labels = (np.zeros(self.total, np.float32)
                        if self.with_labels else None)
        self._label_of: dict[int, float] = {}
        self._next_id = 0

        # write-ahead staging
        self._pending: list[_Op] = []
        self._staged_state: dict[int, bool] = {}  # id -> live after flush
        self._projected_live = 0

        self._summ = adaptive_mod.AdaptiveMaintainer(
            self.k, self.dim, num_projections=summary_projections,
            seed=summary_seed, num_pivots=summary_pivots,
            retighten_every=retighten_every,
            split_radius_factor=split_radius_factor)
        self.split_cooldown = int(split_cooldown)
        self._applies_at_split = -(1 << 30)   # no split yet: first may fire
        self._index = (index_mod.IndexMaintainer(
            self.k, self.cap, self.dim, index_buckets)
            if index_buckets > 0 else None)

        self._history: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        self._track_history = bool(track_history)
        self._snap = self._upload_snapshot_locked(generation=0)
        self._summaries = self._summ.freeze(0)
        self._frozen_index = (self._index.freeze(0)
                              if self._index is not None else None)
        self._record_history()

        # the maintenance plane: the journal exists only while the worker
        # holds a capture (module docstring); the commit clock counts the
        # worker's committed cycles
        self._journal: Optional[list] = None
        self._journal_invalid = False
        self._obs = None                      # attach_obs
        self._maint_commits = 0
        self._last_maint_commit: Optional[dict] = None
        self._worker: Optional[maintenance_mod.MaintenanceWorker] = None
        if self.maintenance == "background":
            self._worker = maintenance_mod.MaintenanceWorker(
                self, probe_sample=maintenance_probe_sample)

    def attach_obs(self, plane) -> None:
        """Attach a :class:`repro_torch.obs.ObsPlane` (the server hands
        the store its own): applies, repacks and maintenance cycles
        record spans into its tracer and ``store.*`` / ``maint.*``
        timings, counters and the compaction trigger's gauges into its
        registry.  Attaching replaces any earlier plane; the worker
        re-reads it every cycle."""
        self._obs = plane

    def _obs_tracer(self):
        return self._obs.tracer if self._obs is not None else NULL_TRACER

    def _obs_registry(self):
        return self._obs.metrics if self._obs is not None else None

    def _note_maint_commit(self, info: dict) -> None:
        """Advance the maintenance-commit clock; the caller holds the
        store lock."""
        self._maint_commits += 1
        self._last_maint_commit = dict(info, seq=self._maint_commits)

    def maint_commit_clock(self) -> tuple:
        """(commit count, last commit's info or None), under one lock, so
        a before/after pair brackets a dispatch consistently."""
        with self._lock:
            return self._maint_commits, self._last_maint_commit

    def close(self) -> None:
        """Stop the background worker (a no-op when inline or closed): a
        cycle in flight commits or discards first.  The store stays
        usable, unmaintained; the worker's counters stay readable."""
        worker, self._worker = self._worker, None
        if worker is not None:
            worker.stop()
            self._worker_final = worker

    # ---- read side -------------------------------------------------------

    def snapshot(self) -> StoreSnapshot:
        """The current generation (immutable)."""
        with self._lock:
            return self._snap

    def routing_snapshot(self):
        """(snapshot, summaries) under one lock acquisition."""
        with self._lock:
            return self._snap, self._summaries

    def serving_snapshot(self):
        """(snapshot, summaries, index) under one lock acquisition; the
        index is None when ``index_buckets=0``."""
        with self._lock:
            return self._snap, self._summaries, self._frozen_index

    def summaries(self) -> summaries_mod.ShardSummaries:
        with self._lock:
            return self._summaries

    @property
    def summary_projections(self) -> int:
        return self._summ.num_projections

    @property
    def summary_seed(self) -> int:
        return self._summ.seed

    @property
    def summary_pivots(self) -> int:
        return self._summ.num_pivots

    @property
    def index_buckets(self) -> int:
        """Buckets per shard of the index, 0 when there is none."""
        return self._index.num_buckets if self._index is not None else 0

    def summary_slack(self) -> np.ndarray:
        """(k,) covering-radius slack of the current summaries
        (``summaries.summary_slack``); O(live*dim) host work."""
        with self._lock:
            return summaries_mod.summary_slack(
                self._summaries, self._pts, self._valid, self.cap)

    def maintenance_stats(self) -> dict:
        """The adaptive knobs and counters; with a background worker
        (running or closed) also its ``worker`` counters."""
        with self._lock:
            out = {"summary_pivots": self._summ.num_pivots,
                   "retighten_every": self._summ.retighten_every,
                   "split_radius_factor": self._summ.split_radius_factor,
                   "retightens": self.stats.retightens,
                   "splits": self.stats.splits,
                   "maintenance": self.maintenance}
            worker = self._worker or getattr(self, "_worker_final", None)
            if worker is not None:
                out["worker"] = worker.stats_dict()
            return out

    @property
    def generation(self) -> int:
        return self.snapshot().generation

    @property
    def live_count(self) -> int:
        """Live points in the applied state (staged ops excluded)."""
        with self._lock:
            return int(self._live.sum())

    @property
    def pending_ops(self) -> int:
        with self._lock:
            return len(self._pending)

    @property
    def live_per_shard(self) -> np.ndarray:
        with self._lock:
            return self._live.copy()

    def live_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """(ids, points) of the applied live set, ascending by id."""
        with self._lock:
            slots = np.flatnonzero(self._valid)
            order = slots[np.argsort(self._ids[slots], kind="stable")]
            return self._ids[order].copy(), self._pts[order].copy()

    def history(self, generation: int) -> tuple[np.ndarray, np.ndarray]:
        """(ids, points) live at ``generation`` (needs track_history)."""
        if not self._track_history:
            raise RuntimeError("store built with track_history=False")
        with self._lock:
            return self._history[generation]

    def values_for(self, ids: np.ndarray) -> np.ndarray:
        """Global ids -> payload values, -1 where absent (the map is
        monotone, so older generations' answers stay well-defined)."""
        with self._lock:
            return np.array([self._values.get(int(i), -1) for i in ids],
                            np.int32)

    def labels_for(self, ids: np.ndarray) -> np.ndarray:
        """Global ids -> label payloads, NaN where absent; monotone like
        :meth:`values_for` (needs ``with_labels``)."""
        if not self.with_labels:
            raise RuntimeError("store built with with_labels=False")
        with self._lock:
            return np.array([self._label_of.get(int(i), np.nan) for i in ids],
                            np.float32)

    def live_labels(self) -> tuple[np.ndarray, np.ndarray]:
        """(ids, labels) of the applied live set, ascending by id, aligned
        with :meth:`live_arrays` (needs ``with_labels``)."""
        if not self.with_labels:
            raise RuntimeError("store built with with_labels=False")
        with self._lock:
            slots = np.flatnonzero(self._valid)
            order = slots[np.argsort(self._ids[slots], kind="stable")]
            return self._ids[order].copy(), self._labels[order].copy()

    # ---- write side (staging) -------------------------------------------

    def insert(self, points, ids=None, values=None, labels=None) -> np.ndarray:
        """Stage insertions; returns the assigned global ids.

        ``ids`` (optional) must never have been used, not even by a
        deleted point; omitted ids come from a monotone counter.
        ``values`` needs ``with_values``; ``labels`` (f32 class ids or
        regression targets, 0.0 when omitted) needs ``with_labels``.
        Atomic: on any validation error nothing is staged."""
        points = np.atleast_2d(np.asarray(points, np.float32))
        n = points.shape[0]
        if points.shape != (n, self.dim):
            raise ValueError(f"points shape {points.shape} != (n, {self.dim})")
        if values is not None and not self.with_values:
            raise ValueError("store built with with_values=False")
        if values is not None:
            values = np.broadcast_to(np.asarray(values, np.int32), (n,))
        if labels is not None and not self.with_labels:
            raise ValueError("store built with with_labels=False")
        if labels is not None:
            labels = np.broadcast_to(np.asarray(labels, np.float32), (n,))
        with self._lock:
            if ids is None:
                ids = np.arange(self._next_id, self._next_id + n,
                                dtype=np.int64)
            else:
                ids = np.broadcast_to(np.asarray(ids, np.int64), (n,))
            if self._projected_live + n > self.total:
                raise StoreFullError(
                    f"store full: capacity {self.total}, projected live "
                    f"{self._projected_live}, insert batch {n}")
            batch = set()
            for pid in ids:
                pid = int(pid)
                if not 0 <= pid < ID_SENTINEL:
                    raise ValueError(f"id {pid} outside [0, 2^31-1)")
                if pid in batch or pid in self._used_ids:
                    raise ValueError(
                        f"id {pid} was already used (ids are single-use)")
                batch.add(pid)
            for t in range(n):
                pid = int(ids[t])
                self._pending.append(_Op(
                    "insert", pid, point=points[t].copy(),
                    value=None if values is None else int(values[t]),
                    label=(0.0 if labels is None else float(labels[t]))
                    if self.with_labels else None))
                self._staged_state[pid] = True
                self._used_ids.add(pid)
                self._next_id = max(self._next_id, pid + 1)
            self._projected_live += n
            self._maybe_autoflush_locked()
            return ids.astype(np.int32)

    def delete(self, ids) -> None:
        """Stage deletions by global id (KeyError if not live or staged).
        Atomic: one unknown id rejects the whole batch."""
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        with self._lock:
            gone = set()
            for pid in ids:
                pid = int(pid)
                if pid in gone or not self._would_be_live(pid):
                    raise KeyError(f"id {pid} is not live")
                gone.add(pid)
            for pid in ids:
                pid = int(pid)
                self._pending.append(_Op("delete", pid))
                self._staged_state[pid] = False
            self._projected_live -= len(ids)
            self._maybe_autoflush_locked()

    def update(self, ids, points, labels=None) -> None:
        """Stage in-place overwrites (same id, same slot); ``labels``
        (needs ``with_labels``) overwrites the label payload too, and
        omitted labels stay.  Atomic: one unknown id rejects the whole
        batch."""
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        points = np.atleast_2d(np.asarray(points, np.float32))
        if points.shape != (len(ids), self.dim):
            raise ValueError(
                f"points shape {points.shape} != ({len(ids)}, {self.dim})")
        if labels is not None and not self.with_labels:
            raise ValueError("store built with with_labels=False")
        if labels is not None:
            labels = np.broadcast_to(np.asarray(labels, np.float32),
                                     (len(ids),))
        with self._lock:
            for pid in ids:
                if not self._would_be_live(int(pid)):
                    raise KeyError(f"id {int(pid)} is not live")
            for t, (pid, pt) in enumerate(zip(ids, points)):
                self._pending.append(_Op(
                    "update", int(pid), point=pt.copy(),
                    label=None if labels is None else float(labels[t])))
            self._maybe_autoflush_locked()

    def _would_be_live(self, pid: int) -> bool:
        if pid in self._staged_state:
            return self._staged_state[pid]
        return pid in self._slot_of

    def _maybe_autoflush_locked(self):
        if len(self._pending) >= self.staging_size:
            self.flush()

    # ---- apply (epoch swap) ---------------------------------------------

    def flush(self) -> int:
        """Apply all staged mutations as one epoch swap; returns the new
        generation (the current one when nothing was staged)."""
        with self._lock:
            if not self._pending:
                return self._snap.generation
            return self._apply_locked(force_compact=False)

    def compact(self) -> int:
        """Flush staged ops and force a repack; always a new generation."""
        with self._lock:
            return self._apply_locked(force_compact=True)

    def _apply_locked(self, *, force_compact: bool) -> int:
        t_apply = time.perf_counter()
        ops, self._pending = self._pending, []
        self._staged_state = {}
        touched: set[int] = set()
        repacked = False

        for op in ops:
            if op.kind == "insert":
                j = self._pick_shard_locked(op.point)
                if j < 0:
                    # every shard at its high-water mark with global space
                    # left (staging checked it): reclaim tombstones, at
                    # most once a flush
                    self._repack_locked()
                    repacked = True
                    self.stats.forced_compactions += 1
                    self.stats.last_compact_reason = (
                        "forced: all shards at high-water")
                    j = self._pick_shard_locked(op.point)
                    if j < 0:
                        raise RuntimeError("repack freed no tail space")
                slot = j * self.cap + int(self._used[j])
                self._used[j] += 1
                self._live[j] += 1
                self._summ.insert(j, op.point)
                if self._index is not None:
                    self._index.insert(j, slot, op.point)
                self._pts[slot] = op.point
                self._ids[slot] = op.id
                self._valid[slot] = True
                self._slot_of[op.id] = slot
                if op.value is not None:
                    self._values[op.id] = op.value
                if self.with_labels:
                    self._labels[slot] = op.label
                    self._label_of[op.id] = float(op.label)
                touched.add(slot)
                self.stats.inserted += 1
                if self._journal is not None:
                    self._journal.append(("insert", op.id, j, op.point,
                                          None, op.label))
            elif op.kind == "delete":
                slot = self._slot_of.pop(op.id)
                self._live[slot // self.cap] -= 1
                self._summ.delete(slot // self.cap, self._pts[slot])
                if self._index is not None:
                    self._index.delete(slot)
                if self._journal is not None:
                    self._journal.append(("delete", op.id,
                                          slot // self.cap, None,
                                          self._pts[slot].copy(), None))
                self._valid[slot] = False
                self._ids[slot] = ID_SENTINEL
                touched.add(slot)
                self.stats.deleted += 1
            else:  # update
                slot = self._slot_of[op.id]
                self._summ.update(slot // self.cap, self._pts[slot],
                                  op.point)
                if self._index is not None:
                    self._index.update(slot, op.point)
                if self._journal is not None:
                    self._journal.append(("update", op.id,
                                          slot // self.cap, op.point,
                                          self._pts[slot].copy(), op.label))
                self._pts[slot] = op.point
                if self.with_labels and op.label is not None:
                    self._labels[slot] = op.label
                    self._label_of[op.id] = float(op.label)
                touched.add(slot)
                self.stats.updated += 1

        if force_compact and not repacked:
            self._repack_locked()
            repacked = True
            self.stats.last_compact_reason = "forced: explicit compact()"
        elif (self.auto_compact and self.maintenance == "inline"
              and not repacked):
            decision = compaction.evaluate(
                self._live, self._used, self.cap,
                tombstone_frac=self.compact_tombstone_frac,
                imbalance_frac=self.compact_imbalance_frac,
                registry=self._obs_registry())
            if decision.compact:
                self._repack_locked()
                repacked = True
                self.stats.last_compact_reason = decision.reason

        # adaptive maintenance, only when no repack rebuilt everything: a
        # radius-triggered split re-deals by proximity, else at most one
        # due shard is re-tightened.  maintenance="background" moves this
        # tail and the auto-compaction above to the worker, poked after
        # the swap
        if self.maintenance == "inline":
            if not repacked:
                j = self._split_due_locked()
                if j is not None:
                    self._repack_locked(redeal="proximity")
                    repacked = True
                    self.stats.splits += 1
                    self._applies_at_split = self.stats.applies
                    self.stats.last_compact_reason = (
                        f"split: shard {j} radius outgrew the centroid gap")
            if not repacked:
                j = self._summ.retighten_due()
                if j is not None:
                    self._summ.retighten(j, self._pts, self._valid,
                                         self.cap)
                    self.stats.retightens += 1

        self._projected_live = int(self._live.sum())
        gen = self._snap.generation + 1
        if repacked:
            self._snap = self._upload_snapshot_locked(generation=gen)
        else:
            self._snap = self._scatter_locked(sorted(touched), gen)
        self.stats.applies += 1
        self._summaries = self._summ.freeze(gen)
        if self._index is not None:
            self._frozen_index = self._index.freeze(gen)
        self._record_history()
        if self._worker is not None:
            self._worker.notify()
        t_done = time.perf_counter()
        self._obs_tracer().record("store.apply", t_apply, t_done,
                                  generation=gen, ops=len(ops),
                                  repacked=repacked)
        if self._obs is not None:
            reg = self._obs.metrics
            reg.histogram("store.apply_s").observe(t_done - t_apply)
            reg.counter("store.applies").inc()
            reg.gauge("store.live").set(self._projected_live)
        return gen

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """A device copy of a host mirror (never a view of it: the next
        flush writes the mirror in place)."""
        return torch.from_numpy(arr).to(self.device, copy=True)

    def _upload_snapshot_locked(self, *, generation: int) -> StoreSnapshot:
        """The mirrors, uploaded whole, as a new snapshot."""
        return StoreSnapshot(
            generation=generation, points=self._to_device(self._pts),
            ids=self._to_device(self._ids),
            valid=self._to_device(self._valid), live=int(self._live.sum()),
            labels=(self._to_device(self._labels) if self.with_labels
                    else None))

    def _scatter_locked(self, slots: list[int], generation: int):
        """The new generation: the current snapshot with the final mirror
        value of each touched slot scattered into copies of its buffers,
        the label buffer in the same scatter."""
        snap = self._snap
        bufs = (snap.points, snap.ids, snap.valid) + (
            (snap.labels,) if self.with_labels else ())
        out = scatter_slots(bufs, slots, self._pts, self._ids, self._valid,
                            self._labels, self.total, self.dim)
        return StoreSnapshot(generation=generation, points=out[0],
                             ids=out[1], valid=out[2],
                             live=self._projected_live,
                             labels=out[3] if self.with_labels else None)

    def _pick_shard_locked(self, point=None) -> int:
        """The placement policy's shard for ``point``, -1 when no shard
        has tail space (the caller then repacks and retries)."""
        if self._placement.uses_centroids:
            centroids, radii, occupied = self._summ.placement_view()
        else:
            centroids = radii = occupied = None
        return self._placement.pick(point, placement_mod.PlacementView(
            live=self._live, used=self._used, cap=self.cap,
            centroids=centroids, radii=radii, occupied=occupied))

    def _split_due_locked(self) -> Optional[int]:
        """The shard the split trigger fires on at this apply, or None
        (``split_cooldown`` applies between splits)."""
        if (self._summ.split_radius_factor <= 0
                or self.stats.applies - self._applies_at_split
                < self.split_cooldown):
            return None
        return self._summ.split_candidate()

    def _repack_locked(self, redeal: Optional[str] = None):
        """Repack under ``redeal`` (default: the store's mode; splits pass
        "proximity"), then rebuild the summaries and the index exactly."""
        t_repack = time.perf_counter()
        # a background capture of the pre-repack layout is now stale and
        # its work done: invalidate it
        if self._journal is not None:
            self._journal_invalid = True
        if (redeal or self.redeal) == "proximity":
            centroids, _, occupied = self._summ.placement_view()
            slack = compaction.redeal_slack(
                self.placement_guard_slack, self.compact_imbalance_frac,
                self.cap, self.k)
            res = placement_mod.repack_proximity(
                self._pts, self._ids, self._valid, self.k, self.cap,
                id_sentinel=ID_SENTINEL, balance_slack=slack,
                seed_centroids=centroids[occupied] if occupied.any()
                else None)
        else:
            res = compaction.repack(self._pts, self._ids, self._valid,
                                    self.k, self.cap,
                                    id_sentinel=ID_SENTINEL)
        if self.with_labels:
            # labels follow their points to their new slots, by id
            self._labels = compaction.remap_payload(
                self._labels, self._ids, self._valid, res.ids, res.valid)
        self._pts, self._ids, self._valid = res.points, res.ids, res.valid
        self._slot_of = res.slot_of
        self._live, self._used = res.live, res.used
        self._summ.rebuild(self._pts, self._valid, self.cap)
        if self._index is not None:
            self._index.rebuild(self._pts, self._valid)
        self.stats.compactions += 1
        t_done = time.perf_counter()
        self._obs_tracer().record("store.repack", t_repack, t_done,
                                  redeal=redeal or self.redeal,
                                  plane="inline")
        if self._obs is not None:
            self._obs.metrics.histogram("store.repack_s").observe(
                t_done - t_repack)
            self._obs.metrics.counter("store.repacks").inc()

    def _record_history(self):
        if self._track_history:
            ids, pts = self.live_arrays()
            self._history[self._snap.generation] = (ids, pts)


def scatter_slots(bufs, slots: list[int], points: np.ndarray,
                  ids: np.ndarray, valid: np.ndarray,
                  labels: Optional[np.ndarray], total: int, dim: int, *,
                  in_place: bool = False):
    """Device buffers ``bufs`` (points, ids, valid[, labels]) with the
    host mirrors' rows ``slots`` written in (:func:`scatter_apply`).  The
    operands are the reference's (``compaction.scatter_operands`` and
    ``payload_operand``) without their padding rows."""
    idx, upd_pts, upd_ids, upd_valid = compaction.scatter_operands(
        slots, points, ids, valid, total, dim, id_sentinel=ID_SENTINEL)
    n = len(slots)
    dev = bufs[0].device
    upd_labels = None
    if len(bufs) == 4:
        upd_labels = torch.from_numpy(compaction.payload_operand(
            slots, labels, n)).to(dev)
    return scatter_apply(
        *bufs[:3], torch.from_numpy(idx[:n].astype(np.int64)).to(dev),
        torch.from_numpy(upd_pts[:n]).to(dev),
        torch.from_numpy(upd_ids[:n]).to(dev),
        torch.from_numpy(upd_valid[:n]).to(dev),
        bufs[3] if len(bufs) == 4 else None, upd_labels, in_place=in_place)


def scatter_apply(points, ids, valid, slots, upd_points, upd_ids, upd_valid,
                  labels=None, upd_labels=None, *, in_place: bool = False):
    """One generation's device update: copies of the three buffers (four
    with ``labels``) with rows ``slots`` (int64, unique) set to the update
    rows.  The inputs are never written, so readers of the older
    generation are undisturbed; every op is on the current stream.
    ``in_place=True`` writes the buffers themselves: only for buffers no
    reader has seen (the maintenance worker's staged generation)."""
    bufs = (points, ids, valid) + (() if labels is None else (labels,))
    upds = (upd_points, upd_ids, upd_valid) + (
        () if labels is None else (upd_labels,))
    out = bufs if in_place else tuple(b.clone() for b in bufs)
    for o, u in zip(out, upds):
        o.index_copy_(0, slots, u)
    return out
