"""Background maintenance worker: the store's plan / prepare / commit loop.

The port's copy of ``repro.store.maintenance``.  Under
``maintenance="inline"`` every flush pays for summary hygiene under the
store lock: an exact re-tightening is O(live*dim) host work, a split or
auto-compaction a full repack and upload, and every reader and writer
waits behind it.  One daemon worker thread a store moves that work off
the flush:

* **Plan (store lock).**  The inline tail's precedence: an armed
  auto-compaction trigger first, then a radius split, then the due shard
  with the largest *sampled* summary slack
  (:func:`repro_torch.store.summaries.summary_slack_sampled`).  Planning
  opens the **journal**: until the commit, the store's apply records
  every op ``(kind, id, shard, new_point, old_point, label)``.
* **Prepare (no lock).**  The exact recompute runs on a k=1 scratch
  maintainer; a repack runs on copied mirrors, rebuilds a scratch
  maintainer and index, and uploads the repacked buffers.  Batches keep
  serving their snapshots and flushes keep publishing meanwhile.
* **Commit (store lock).**  When an inline repack invalidated the
  capture, the staged work is discarded.  Otherwise the journal replays
  onto the staged state: a re-tightening replays its shard's ops into
  the scratch maintainer and transplants it
  (``AdaptiveMaintainer.copy_shard_from``), re-freezing the summaries at
  the *current* generation (same live set, tighter bounds); a repack
  replays every op onto the staged mirrors (placement picks against the
  staged layout), writes the replayed slots into the uploaded buffers,
  installs mirrors, maintainer and index, and publishes the epoch swap
  as a flush does.  The committed state equals what an inline repack at
  commit time would have made.

**The upload on the card.**  Every thread's current stream is the
device's default stream, which the serving kernels run on, so an upload
issued there would queue in stream order with every batch.  The worker
copies on a stream of its own into buffers allocated on the serving
stream (their blocks return to the serving stream's pool when a later
generation drops them, and the serving kernels are their only other
users); the side stream first waits for the serving work already queued,
since a freshly freed block may still be read there.  The worker
synchronises on an event recorded after the copies, off the lock, before
anything is published.  The commit's scatter of replayed slots then
writes the staged buffers in place on the serving stream, so stream
order puts it before every batch that captures the new generation; in
place is right because no reader has seen those buffers yet.

Every published generation is a pure function of the applied ops, so
answers are exact for their generation whatever the worker does.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import traceback
from typing import Optional

import numpy as np
import torch

from repro_torch.obs.trace import NULL_TRACER
from repro_torch.store import adaptive as adaptive_mod
from repro_torch.store import compaction
from repro_torch.store import index as index_mod
from repro_torch.store import placement as placement_mod
from repro_torch.store import summaries as summaries_mod


@dataclasses.dataclass
class MaintenanceStats:
    cycles: int = 0          # plans that found work
    retightens: int = 0      # committed background re-tightenings
    repacks: int = 0         # committed background repacks (incl. splits)
    splits: int = 0          # the split-triggered subset of repacks
    commits: int = 0         # total committed cycles
    discards: int = 0        # staged work dropped (invalidated / no room)
    replayed_ops: int = 0    # journal ops replayed across all commits
    errors: int = 0          # cycles that raised (see .error)


def upload(arrays, device, *, stream=None) -> list:
    """Device copies of host numpy ``arrays``, complete on return.

    On the card the copies run on ``stream`` (a side stream) into
    buffers allocated on the current stream, after the work already
    queued there.  On the CPU: copies.
    """
    dev = torch.device(device)
    if dev.type != "cuda":
        return [torch.from_numpy(a).clone() for a in arrays]
    serving = torch.cuda.current_stream(dev)
    outs = [torch.empty(a.shape, dtype=torch.from_numpy(a[:0]).dtype,
                        device=dev) for a in arrays]
    stream = serving if stream is None else stream
    stream.wait_stream(serving)
    with torch.cuda.stream(stream):
        for out, a in zip(outs, arrays):
            out.copy_(torch.from_numpy(a), non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    done.synchronize()
    return outs


class MaintenanceWorker:
    """One store's background maintenance thread (module docstring).

    The store pokes :meth:`notify` after every apply; the loop also
    wakes every 0.1 s.  Every change to the store's state and to these
    stats happens under the store lock, so ``stats_dict()`` never tears.
    ``current``: the kind of the cycle in flight ("retighten", "repack",
    "split"), None between cycles.
    """

    def __init__(self, store, *, probe_sample: int = 64, seed: int = 0):
        self._store = store
        self.probe_sample = int(probe_sample)
        self._rng = np.random.default_rng(seed)
        self._side = None                 # the upload's stream, on the card
        self.stats = MaintenanceStats()
        self.error: Optional[str] = None
        self.current: Optional[str] = None
        self._event = threading.Event()
        self._stop = threading.Event()
        # set while the worker sleeps with no poke pending (wait_idle)
        self._idle = threading.Event()
        self._idle_lock = threading.Lock()
        self._thread = threading.Thread(
            target=self._run, name="knn-store-maintenance", daemon=True)
        self._thread.start()

    # ---- lifecycle -------------------------------------------------------

    def notify(self) -> None:
        """Wake the worker (safe under the store lock: sets events)."""
        with self._idle_lock:
            self._idle.clear()
            self._event.set()

    def wait_idle(self, timeout: Optional[float] = None) -> bool:
        """Block until the worker sleeps with no work due and no poke
        pending; False on timeout."""
        return self._idle.wait(timeout)

    def stop(self) -> None:
        """Stop and join the worker; a cycle in flight commits or
        discards first."""
        self._stop.set()
        self._event.set()
        self._thread.join()

    def stats_dict(self) -> dict:
        d = dataclasses.asdict(self.stats)
        d["probe_sample"] = self.probe_sample
        d["error"] = self.error
        return d

    # ---- worker loop -----------------------------------------------------

    def _run(self) -> None:
        while not self._stop.is_set():
            with self._idle_lock:
                if not self._event.is_set():
                    self._idle.set()
            self._event.wait(timeout=0.1)
            self._event.clear()
            while not self._stop.is_set():
                try:
                    if not self._cycle():
                        break
                except Exception:       # keep serving; surface via stats
                    with self._store._lock:
                        self._store._journal = None
                        self.stats.errors += 1
                        self.error = traceback.format_exc()
                    break

    def _plan_locked(self):
        """The next unit of work (store lock held), or None: compaction
        debt, then a split, then the due shard with the largest sampled
        slack (an over-estimate, fine for ranking)."""
        st = self._store
        if st.auto_compact:
            decision = compaction.evaluate(
                st._live, st._used, st.cap,
                tombstone_frac=st.compact_tombstone_frac,
                imbalance_frac=st.compact_imbalance_frac,
                registry=st._obs_registry())
            if decision.compact:
                return ("repack", st.redeal, decision.reason)
        j = st._split_due_locked()
        if j is not None:
            return ("split", "proximity",
                    f"split: shard {j} radius outgrew the centroid gap")
        if st._summ.retighten_every > 0:
            due = np.flatnonzero(
                (st._summ._ops_since >= st._summ.retighten_every)
                & (st._summ._n > 0))
            if due.size:
                slack = summaries_mod.summary_slack_sampled(
                    st._summaries, st._pts, st._valid, st.cap,
                    sample=self.probe_sample, rng=self._rng)
                return ("retighten", int(due[np.argmax(slack[due])]))
        return None

    def _scratch(self, k: int) -> adaptive_mod.AdaptiveMaintainer:
        """A fresh maintainer with the store's summary knobs: the off-lock
        workspace whose state transplants into the live one."""
        st = self._store
        return adaptive_mod.AdaptiveMaintainer(
            k, st.dim, num_projections=st._summ.num_projections,
            seed=st._summ.seed, num_pivots=st._summ.num_pivots,
            retighten_every=st._summ.retighten_every,
            split_radius_factor=st._summ.split_radius_factor)

    def _cycle(self) -> bool:
        """One plan / prepare / commit pass; False when no work is due.
        A working cycle is one ``maint.cycle`` trace in the store's obs
        plane, with ``maint.plan``, ``maint.prepare`` and ``maint.commit``
        (or ``maint.discard``) children."""
        st = self._store
        obs = st._obs
        tracer = obs.tracer if obs is not None else NULL_TRACER
        t0 = time.perf_counter()
        with st._lock:
            t_held = time.perf_counter()
            plan = self._plan_locked()
            if plan is None:
                return False
            self._idle.clear()
            self.stats.cycles += 1
            st._journal = []
            st._journal_invalid = False
            if plan[0] == "retighten":
                # a copy of the shard's live rows; f64 off the lock
                sl = slice(plan[1] * st.cap, (plan[1] + 1) * st.cap)
                pj = st._pts[sl][st._valid[sl]]
            else:
                pts = st._pts.copy()
                ids = st._ids.copy()
                valid = st._valid.copy()
                labels = st._labels.copy() if st.with_labels else None
                seed_cents = None
                if (plan[1] or st.redeal) == "proximity":
                    centroids, _, occupied = st._summ.placement_view()
                    if occupied.any():
                        seed_cents = centroids[occupied]
                slack = compaction.redeal_slack(
                    st.placement_guard_slack, st.compact_imbalance_frac,
                    st.cap, st.k)
            held = time.perf_counter() - t_held
        self.current = plan[0]
        cspan = tracer.begin("maint.cycle", t0=t0, kind=plan[0])
        tracer.record("maint.plan", t0, time.perf_counter(), parent=cspan,
                      kind=plan[0], held_s=held)
        try:
            if plan[0] == "retighten":
                self._retighten(plan[1], pj, tracer=tracer, cspan=cspan)
            else:
                self._repack(plan, pts, ids, valid, labels, seed_cents,
                             slack, tracer=tracer, cspan=cspan)
        finally:
            self.current = None
            cspan.end()
            if obs is not None:
                obs.metrics.histogram("maint.cycle_s").observe(
                    time.perf_counter() - t0)
        return True

    def _discard(self, tracer, cspan, t_commit, reason: str) -> None:
        """Drop the staged work (store lock held)."""
        self.stats.discards += 1
        tracer.record("maint.discard", t_commit, time.perf_counter(),
                      parent=cspan, reason=reason)

    # ---- re-tightening ---------------------------------------------------

    def _retighten(self, j: int, pj: np.ndarray, *, tracer=NULL_TRACER,
                   cspan=None) -> None:
        st = self._store
        with tracer.span("maint.prepare", parent=cspan, shard=j,
                         live=len(pj)):
            scratch = self._scratch(1)
            if len(pj):                          # off-lock exact rebuild
                scratch._rebuild_shard(
                    0, torch.from_numpy(pj).to(torch.float64))
        t_commit = time.perf_counter()
        with st._lock:
            t_held = time.perf_counter()
            journal, st._journal = st._journal, None
            if st._journal_invalid:
                self._discard(tracer, cspan, t_commit,
                              "capture invalidated")
                return
            # replay what raced the rebuild: shard j's ops only
            for kind, _pid, shard, new_pt, old_pt, _label in journal:
                if shard != j:
                    continue
                if kind == "insert":
                    scratch.insert(0, new_pt)
                elif kind == "delete":
                    scratch.delete(0, old_pt)
                else:
                    scratch.update(0, old_pt, new_pt)
                self.stats.replayed_ops += 1
            st._summ.copy_shard_from(j, scratch, 0)
            # the same live set with tighter bounds: re-freeze at the
            # current generation, no epoch swap
            st._summaries = st._summ.freeze(st._snap.generation)
            st.stats.retightens += 1
            self.stats.retightens += 1
            self.stats.commits += 1
            st._note_maint_commit({
                "kind": "retighten", "shard": int(j),
                "generation": int(st._snap.generation)})
            held = time.perf_counter() - t_held
        tracer.record("maint.commit", t_commit, time.perf_counter(),
                      parent=cspan, kind="retighten", shard=j,
                      generation=st._snap.generation, held_s=held)

    # ---- repack / split --------------------------------------------------

    def _repack(self, plan, pts, ids, valid, labels, seed_cents,
                slack: int, *, tracer=NULL_TRACER, cspan=None) -> None:
        from repro_torch.store import mutable as mutable_mod
        st = self._store
        kind, redeal, reason = plan
        sentinel = mutable_mod.ID_SENTINEL
        # prepare off the lock: repack the copies, rebuild a scratch
        # maintainer and index, upload the repacked buffers
        with tracer.span("maint.prepare", parent=cspan, kind=kind,
                         redeal=redeal or st.redeal, reason=reason) as pspan:
            if (redeal or st.redeal) == "proximity":
                res = placement_mod.repack_proximity(
                    pts, ids, valid, st.k, st.cap, id_sentinel=sentinel,
                    balance_slack=slack, seed_centroids=seed_cents)
            else:
                res = compaction.repack(pts, ids, valid, st.k, st.cap,
                                        id_sentinel=sentinel)
            # labels follow their points, remapped against the captured
            # layout (the replay below carries whatever raced it)
            new_labels = (compaction.remap_payload(
                labels, ids, valid, res.ids, res.valid)
                if labels is not None else None)
            scratch = self._scratch(st.k)
            scratch.rebuild(res.points, res.valid, st.cap)
            scratch_idx = None
            if st._index is not None:
                scratch_idx = index_mod.IndexMaintainer(
                    st.k, st.cap, st.dim, st._index.num_buckets)
                scratch_idx.rebuild(res.points, res.valid)
            host = [res.points, res.ids, res.valid] + (
                [new_labels] if new_labels is not None else [])
            if self._side is None and st.device.type == "cuda":
                self._side = torch.cuda.Stream(st.device)
            with tracer.span("maint.upload", parent=pspan,
                             bytes=sum(a.nbytes for a in host)):
                bufs = upload(host, st.device, stream=self._side)

        t_commit = time.perf_counter()
        with st._lock:
            t_held = time.perf_counter()
            journal, st._journal = st._journal, None
            if st._journal_invalid:
                self._discard(tracer, cspan, t_commit,
                              "capture invalidated")
                return
            new_pts, new_ids, new_valid = res.points, res.ids, res.valid
            slot_of, live, used = res.slot_of, res.live, res.used
            touched: set[int] = set()
            for kind_op, pid, _shard, new_pt, old_pt, label in journal:
                if kind_op == "insert":
                    if st._placement.uses_centroids:
                        c, r, occ = scratch.placement_view()
                    else:
                        c = r = occ = None
                    j = st._placement.pick(
                        new_pt, placement_mod.PlacementView(
                            live=live, used=used, cap=st.cap,
                            centroids=c, radii=r, occupied=occ))
                    if j < 0:
                        # no tail room in the staged layout for what raced
                        # it: the store already holds these ops
                        self._discard(tracer, cspan, t_commit,
                                      "no tail room for replay")
                        return
                    slot = j * st.cap + int(used[j])
                    used[j] += 1
                    live[j] += 1
                    scratch.insert(j, new_pt)
                    if scratch_idx is not None:
                        scratch_idx.insert(j, slot, new_pt)
                    new_pts[slot] = new_pt
                    new_ids[slot] = pid
                    new_valid[slot] = True
                    if new_labels is not None:
                        new_labels[slot] = label
                    slot_of[pid] = slot
                    touched.add(slot)
                elif kind_op == "delete":
                    slot = slot_of.pop(pid)
                    live[slot // st.cap] -= 1
                    scratch.delete(slot // st.cap, new_pts[slot])
                    if scratch_idx is not None:
                        scratch_idx.delete(slot)
                    new_valid[slot] = False
                    new_ids[slot] = sentinel
                    touched.add(slot)
                else:  # update
                    slot = slot_of[pid]
                    scratch.update(slot // st.cap, new_pts[slot], new_pt)
                    if scratch_idx is not None:
                        scratch_idx.update(slot, new_pt)
                    new_pts[slot] = new_pt
                    if new_labels is not None and label is not None:
                        new_labels[slot] = label
                    touched.add(slot)
                self.stats.replayed_ops += 1
            if touched:
                # the staged buffers: no reader has seen them (in place)
                mutable_mod.scatter_slots(
                    bufs, sorted(touched), new_pts, new_ids, new_valid,
                    new_labels, st.total, st.dim, in_place=True)
            # install and publish, as the apply's repack arm does
            st._pts, st._ids, st._valid = new_pts, new_ids, new_valid
            if new_labels is not None:
                st._labels = new_labels
            st._slot_of, st._live, st._used = slot_of, live, used
            gen = st._snap.generation + 1
            st._snap = mutable_mod.StoreSnapshot(
                generation=gen, points=bufs[0], ids=bufs[1],
                valid=bufs[2], live=int(live.sum()),
                labels=bufs[3] if new_labels is not None else None)
            st._summ = scratch
            st._summaries = scratch.freeze(gen)
            if scratch_idx is not None:
                st._index = scratch_idx
                st._frozen_index = scratch_idx.freeze(gen)
            st.stats.applies += 1
            st.stats.compactions += 1
            st.stats.last_compact_reason = reason
            if kind == "split":
                st.stats.splits += 1
                st._applies_at_split = st.stats.applies
                self.stats.splits += 1
            st._record_history()
            self.stats.repacks += 1
            self.stats.commits += 1
            st._note_maint_commit({
                "kind": str(kind), "redeal": str(redeal or st.redeal),
                "reason": str(reason), "generation": int(gen),
                "replayed": len(journal)})
            held = time.perf_counter() - t_held
        tracer.record("maint.commit", t_commit, time.perf_counter(),
                      parent=cspan, kind=kind, generation=gen,
                      replayed=len(journal), held_s=held)
