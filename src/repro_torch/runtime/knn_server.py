"""Micro-batched distributed l-NN query service.

Port of ``repro.runtime.knn_server``.  Requests, each with its own l,
are coalesced into device batches of one of the configured bucket sizes
(padding rows carry l=0 and select nothing), answered by Algorithm 2
(``sampler="selection"``) or the paper's simple method
(``sampler="gather"``) over k shards held on one device, and resolved
per request in ascending order with the k-machine round/message bill.

    submit(q, l) -> [queue] -> micro-batcher (linger max_wait_ms, pad to
        bucket) -> [snapshot capture] -> [routing / bucket prologue]
        -> core.knn on the device -> QueryResult per request

Two backings.  **Static** (``points=``): a fixed point set, generation
0 forever; its routing summaries and bucket index are built once.
**Mutable** (``store=``, a :class:`repro_torch.store.MutableStore`):
each dispatch captures the store's (snapshot, summaries, index) under
one lock and answers against that generation while newer ones land;
the snapshot's ``valid`` masks dead slots, and every answer reports the
generation it was computed against.  ``insert`` / ``update`` /
``delete`` / ``flush_store`` pass through to the store.

``route="pruned"`` masks the shards whose summaries prove they hold no
winner; answers stay byte-identical to ``route="exact"`` and only the
touched shards pay in the k-machine bill (``QueryResult.shards_touched``).
The decision runs on the host in f64 (``route_compute="host"``) or on the
device (``"device"``), whose per-row mask equals the host one.
``search="approx"`` adds the bucket index: the kept buckets' slots are
the only candidates, under a measured recall (``recall_mode="approx"``).
On the device one launch of the route_index_mask kernel gives the
batch's routing and bucket unions; its operands and the slot decode are
built fresh for each generation.

**Prediction** (``cfg.predict="vote"|"regress"``, ``repro_torch.predict``)
answers a label for the query over a labeled backing (the static
``labels=`` argument, or a ``MutableStore(with_labels=True)``, whose
labels are frozen with each generation).  ``predict_mode="exact"`` folds
Algorithm 2's winner mask into a vote or a mean over the labels gathered
with the top-l slots (one more sum over the shards): the label equals a
single-machine vote over the true l nearest.  ``predict_mode="ensemble"``
skips the selection: each shard votes over its own first ``kl``
candidates, the ``(k, B, C)`` answers come back in one readback and the
host aggregates them; the bill is 1 round and one message a touched
shard, and ``dists``/``ids`` are all sentinels.

The entry point runs on the card: ``device=None`` means ``"cuda"`` and
raises when there is none.  Tests pass ``device="cpu"``, which takes
the kernels' plain versions.  Any ``l_max`` is served: above one
top-l pass (256 slots) the card's top-l takes several passes.  A
batch's random stream is a ``torch.Generator`` seeded from
``(seed, batch_id)``, so two fresh servers give byte-identical answers
and iteration counts.

**The operator layer** (``repro_torch.obs``): each server owns an
:class:`~repro_torch.obs.ObsPlane` (a span tracer under
``cfg.obs_trace``, its metrics registry), which a store-backed server
hands to the store, so applies and maintenance cycles land beside the
queries.  Each dispatch is one ``dispatch`` trace (``snapshot``,
``route``, ``kernel``, ``shadow_audit``, ``resolve``) and each request
one ``request`` trace (``queued``, ``serve``); the spans are stamped
from clocks the dispatch reads anyway, and add no device sync.
``kernel`` is the host wall of the batch's device work, its readback
included; its children are the phases a
:class:`~repro_torch.obs.PhaseClock` marks (``topl``, ``prune``,
``select``, ``gather``, ``merge``, ``readback``, ``predict``), each with
its ``device_s`` by CUDA events where the card gives one: the stream's
time from the phase's first mark to the next, so a phase that syncs (the
host-paced Algorithm 1 loop) holds a longer host wall, the wait for the
work before it.  The clock runs on every batch, traced or not, and feeds
``ServerStats.topl_device_s``, ``select_s`` and ``merge_s``; each
``dispatch`` span carries the ``anchor`` that maps its tree onto a
profiler's clock (``obs.trace``).  The
Theorem-1 contract audit runs on every batch; ``cfg.obs_audit_every``
replays every Nth routed, indexed or ensemble batch on the operands it
captured, with every shard active and every slot a candidate, and
audits byte identity, recall@l or label agreement (the replay's kernel
launches are counted apart, in ``audit.shadow.launches.*``).  Every
answer carries an explain report (``QueryResult.explain()``,
:meth:`KnnServer.explain_last`), assembled lazily from a capture of
host arrays; the ``slo_*`` knobs declare burn-rate objectives, and
``cfg.obs_http_port`` serves the registry (``/metrics``,
``/metrics.json``, ``/obs``).  A store-backed dispatch reads the
store's maintenance-commit clock before and after, for the report.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import convert
from repro_torch import predict as predict_mod
from repro_torch.configs.knn_service import CONFIG, KnnServiceConfig
from repro_torch.core import knn as knn_mod
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.kernels import plan
from repro_torch.kernels import routing as routing_mod
from repro_torch.obs import (NULL_PHASES, BatchCapture, ContractAuditor,
                             ExplainRecord, ObsPlane, PhaseClock,
                             ShadowAuditor, SloEngine)
from repro_torch.obs.export import ObsHttpServer
from repro_torch.parallel.collectives import accounting
from repro_torch.store import index as index_mod
from repro_torch.store import summaries as summaries_mod

_ID_SENTINEL = 2**31 - 1
_SEED_MIX = 0x9E3779B97F4A7C15


class QueryResult(NamedTuple):
    """Answer for one request.

    ``dists``/``ids`` have the request's own length l, ascending by
    distance (+inf / 2**31-1 sentinel slots last when fewer than l points
    exist).  ``values`` maps ids through the optional value table, -1
    where absent.  ``rounds``/``messages`` are the carrying batch's
    k-machine bill (``parallel.collectives.accounting``).
    ``host_syncs`` counts the carrying batch's device-to-host reads: the
    host-paced Algorithm 1 loop's done checks (the device loop makes
    none), the answer readbacks and, under
    device routing, the one readback of the touched shards and kept
    buckets.  ``generation``: the store generation the answer was
    computed against (0 for a static point set).
    ``shards_touched``: k under ``route="exact"``, else the batch's union
    of routed shards.  ``recall_mode``: ``"approx"`` when the answer went
    through the bucket index, else ``"exact"``.  ``label`` /
    ``confidence``: the prediction (None when ``cfg.predict="none"``): the
    majority class id as a float (-1 when no live neighbour voted) and
    its vote share, or the mean label and the share of l found (exact)
    or of the routed shards that answered (ensemble); ``predict_mode``:
    ``"none"``, ``"exact"`` or ``"ensemble"``.  ``explain_ref``: the
    handle :meth:`explain` builds the request's report from.
    """

    dists: np.ndarray
    ids: np.ndarray
    values: Optional[np.ndarray]
    l: int
    iterations: int        # Algorithm 1 iterations of the carrying batch
    rounds: int            # k-machine rounds of the carrying batch
    messages: int          # O(1)-word messages of the carrying batch
    survivors: int         # Lemma 2.3 post-prune candidate count (this row)
    bucket: int            # device batch shape the request rode in
    queued_s: float        # enqueue -> dispatch
    latency_s: float       # enqueue -> result
    host_syncs: int = 0
    generation: int = 0
    shards_touched: int = -1
    recall_mode: str = "exact"
    label: Optional[float] = None
    confidence: Optional[float] = None
    predict_mode: str = "none"
    explain_ref: object = None

    def explain(self) -> Optional[dict]:
        """The request's explain report (``repro_torch.obs.explain``
        SCHEMA): per-shard routing bounds and threshold, per-bucket keep,
        the prediction's working, stage timings and any maintenance
        commit that raced it; built on the first call, then cached.
        None for a result made without a capture."""
        return None if self.explain_ref is None else self.explain_ref.build()


class _Batch(NamedTuple):
    """One device batch, read back to the host."""

    dists: np.ndarray        # (B, l_max)
    ids: np.ndarray          # (B, l_max)
    iterations: int
    survivors: np.ndarray    # (B,)
    host_syncs: int
    touched: int
    candidate_fraction: Optional[float]
    pred: Optional[tuple] = None          # (label (B,), confidence (B,))
    payload: Optional[np.ndarray] = None  # ensemble: (k, B, C) answers
    active: Optional[np.ndarray] = None   # (k,) routed-shard union
    keep_any: Optional[np.ndarray] = None  # (k, b) kept-bucket union
    local_k: Optional[np.ndarray] = None  # ensemble: (B,) local k
    votes: Optional[np.ndarray] = None    # ensemble vote: (B, C) tally
    phases: tuple = ()                    # PhaseClock.phases()


@dataclasses.dataclass
class ServerStats:
    """Serving counters, safe to update and read from any thread;
    ``snapshot()`` is the consistent multi-field view."""

    queries: int = 0
    batches: int = 0
    padded_rows: int = 0
    bucket_counts: dict = dataclasses.field(default_factory=dict)
    # route="pruned" batches: summed touched-shard counts and the batches
    # they came from, the inputs of placement_stats()' prune rate
    touched_shards: int = 0
    routed_batches: int = 0
    # summed over the batches: the distance + top-l step's device time by
    # CUDA events (0.0 on the CPU), and the Algorithm 1 loop's wall: on
    # the card the stream's, from the events at its two ends, since the
    # host loop's first sync waits out the step and its host wall holds
    # that wait; on the CPU the host's; and the gather sampler's merge (the
    # all_gather, the reduction over k*l and the per-request cut), timed
    # as the loop is
    topl_device_s: float = 0.0
    select_s: float = 0.0
    merge_s: float = 0.0
    _lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False)

    def observe(self, bucket: int, n_real: int,
                touched: Optional[int] = None, topl_device_s: float = 0.0,
                select_s: float = 0.0, merge_s: float = 0.0):
        with self._lock:
            self.queries += n_real
            self.batches += 1
            self.padded_rows += bucket - n_real
            self.bucket_counts[bucket] = self.bucket_counts.get(bucket, 0) + 1
            if touched is not None:
                self.touched_shards += touched
                self.routed_batches += 1
            self.topl_device_s += topl_device_s
            self.select_s += select_s
            self.merge_s += merge_s

    def snapshot(self) -> dict:
        with self._lock:
            return {"queries": self.queries, "batches": self.batches,
                    "padded_rows": self.padded_rows,
                    "bucket_counts": dict(self.bucket_counts),
                    "touched_shards": self.touched_shards,
                    "routed_batches": self.routed_batches,
                    "topl_device_s": self.topl_device_s,
                    "select_s": self.select_s,
                    "merge_s": self.merge_s}


@dataclasses.dataclass
class _Pending:
    query: np.ndarray
    l: int
    t_enqueue: float
    future: Future
    # the request's root span, begun in submit() at t_enqueue and ended
    # when the batch resolves (the shared no-op span when tracing is off)
    span: object = None


def _check_config(cfg: KnnServiceConfig) -> None:
    """Reject bad values like the reference; no knob is silently
    ignored."""
    if not cfg.bucket_sizes or list(cfg.bucket_sizes) != sorted(
            set(cfg.bucket_sizes)):
        raise ValueError(f"bucket_sizes must be ascending and unique, "
                         f"got {cfg.bucket_sizes}")
    if cfg.route not in ("exact", "pruned"):
        raise ValueError(f"route must be 'exact' or 'pruned', "
                         f"got {cfg.route!r}")
    if cfg.route_compute not in ("host", "device"):
        raise ValueError(f"route_compute must be 'host' or 'device', "
                         f"got {cfg.route_compute!r}")
    if cfg.search not in ("exact", "approx"):
        raise ValueError(f"search must be 'exact' or 'approx', "
                         f"got {cfg.search!r}")
    if cfg.predict not in ("none", "vote", "regress"):
        raise ValueError(f"predict must be 'none', 'vote' or 'regress', "
                         f"got {cfg.predict!r}")
    if cfg.predict_mode not in ("exact", "ensemble"):
        raise ValueError(f"predict_mode must be 'exact' or 'ensemble', "
                         f"got {cfg.predict_mode!r}")
    if cfg.search == "approx" and cfg.index_buckets < 1:
        raise ValueError(f"search='approx' needs index_buckets >= 1, "
                         f"got {cfg.index_buckets}")
    if cfg.sampler not in ("selection", "gather"):
        raise ValueError(f"unknown sampler {cfg.sampler!r}")
    if cfg.distance_impl != "auto":
        raise ValueError(
            f"distance_impl={cfg.distance_impl!r}: the port picks the "
            f"kernel or its plain version by the device; only 'auto'")
    if cfg.predict != "none" and cfg.sampler != "selection":
        raise ValueError(
            f"predict={cfg.predict!r} needs sampler='selection' "
            f"(the gather baseline has no winner mask to vote over), "
            f"got sampler={cfg.sampler!r}")
    if cfg.predict != "none" and cfg.predict_mode == "ensemble":
        # one collective-free pass: the local-k split needs the touched
        # count before the launch, and the local votes the true local top-l
        if cfg.search != "exact":
            raise ValueError(
                "predict_mode='ensemble' requires search='exact' "
                "(per-shard local votes need the true local top-l)")
        if cfg.route == "pruned" and cfg.route_compute == "device":
            raise ValueError(
                "predict_mode='ensemble' requires route_compute="
                "'host': the local-k split needs the touched-shard "
                "count before the launch")
        if cfg.obs_audit_every > 0 and cfg.predict != "vote":
            raise ValueError(
                "the accuracy shadow audit (obs_audit_every > 0 with "
                "predict_mode='ensemble') needs predict='vote' — "
                "label agreement is defined on class ids")


def _check_u8(cfg: KnnServiceConfig) -> None:
    """What uint8 points cannot serve: their step is one kernel of at most
    ``MAX_L`` slots, and the routing summaries and the bucket index are
    built over f32 points."""
    if cfg.l_max > plan.MAX_L:
        raise ValueError(f"l_max={cfg.l_max} above {plan.MAX_L} with uint8 "
                         f"points: their step has no l2_distance + "
                         f"local_topk passes")
    if cfg.route != "exact" or cfg.search != "exact":
        raise ValueError(f"uint8 points serve route='exact' and "
                         f"search='exact', got route={cfg.route!r}, "
                         f"search={cfg.search!r}")


class KnnServer:
    """Serve l-NN queries against k shards of a static point set or a
    mutable store.

    ``points``: an ``(n, dim)`` numpy array (split by the reference's
    row -> shard rule, ``convert.shards_from_numpy``) or an ``(n, dim)``
    float32 tensor (viewed in place on its device when it is there).
    uint8 points (array or tensor) stay uint8, with no f32 copy: their
    step is the exact uint8 kernel, a query must then hold integers in
    [0, 255], and ``l_max`` above 256, ``route="pruned"`` and
    ``search="approx"`` are refused (the JAX reference serves f32 points
    only).
    ``values``: optional ``(n,)`` int payload, looked up on the host.
    ``labels``: optional ``(n,)`` label payload (class ids or regression
    targets as f32), required when ``cfg.predict`` is set; it lives on
    the device beside the points, split like them.
    ``shards``: k, the counterpart of the reference's mesh axis size (8
    when omitted).  ``cfg.route="pruned"`` builds the routing summaries
    and ``cfg.search="approx"`` the bucket index from the construction
    points, on their device; both are generation 0 forever.

    ``store``: a :class:`repro_torch.store.MutableStore` instead of
    points (module docstring).  Its device must be the server's, its
    summary sketch and index must match ``cfg``, as in the reference, and
    it must be ``with_labels`` when ``cfg.predict`` is set.

    Synchronous use: ``submit(...)`` then ``flush()``, or ``query_batch``.
    Server use: ``with server.serving(): ...`` runs the micro-batcher
    thread, which lingers ``cfg.max_wait_ms`` after the first pending
    request to fill a bucket.
    """

    def __init__(self, points=None, values=None, labels=None, *,
                 store=None, cfg: KnnServiceConfig = CONFIG,
                 shards: Optional[int] = None, device=None, seed: int = 0):
        _check_config(cfg)
        self.cfg = cfg
        self._predict = cfg.predict != "none"
        self._ensemble = self._predict and cfg.predict_mode == "ensemble"
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # the port's numerics are f32 throughout (no TF32 anywhere)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            # the kernel library's build (a checkout's first use) and load
            # here, not inside the first request's wait
            kops.load_library()
        self._store = store
        self._summaries = self._index = None
        self._points = self._ids = self._values = None
        # the label operand on the device (k, m) and its host copy (n,)
        self._labels = self._labels_host = None
        if store is not None:
            self._init_store(store, points, values, labels, shards)
        else:
            self._init_static(points, values, labels,
                              8 if shards is None else shards)
        self.seed = int(seed)
        self.envelopes = [
            kops.service_envelope(b, self.m_local, self.dim, cfg.l_max,
                                  k=self.k, device=self.device,
                                  dtype=self._points_dtype)
            for b in cfg.bucket_sizes]

        # device routing operands and the index's slot decode, built
        # fresh for the generation last served: (summaries, index,
        # packed, decode), replaced whole, so a batch keeps what it read
        self._gen_ops = None
        if store is None:
            self._operands(self._summaries, self._index)

        self._batch_counter = 0
        self._cv = threading.Condition()
        self._pending: list[_Pending] = []
        self._thread: Optional[threading.Thread] = None
        self._running = False
        # idle phase clocks, each with its CUDA events: one serves every
        # batch unless two threads dispatch at once
        self._clocks: list[PhaseClock] = []
        self.stats = ServerStats()
        # the observability plane: the tracer per cfg.obs_trace and this
        # server's registry, handed to the store too
        self.obs = ObsPlane.from_config(cfg)
        self.metrics = reg = self.obs.metrics
        if store is not None:
            store.attach_obs(self.obs)
        self._m = {name: reg.histogram(f"serve.{name}") for name in (
            "queued_s", "snapshot_s", "route_s", "kernel_s", "resolve_s",
            "dispatch_s", "latency_s", "rounds", "messages", "host_syncs",
            "touched_shards", "candidate_fraction")}
        self._errors = reg.counter("serve.dispatch_errors")
        self._contract = ContractAuditor(reg, k=self.k)
        # the shadow replay audits the contract this server serves:
        # byte identity for pruned routing, recall@l for the approx tier,
        # label agreement for the ensemble
        if self._ensemble:
            mode, floor = "accuracy", cfg.accuracy_floor
        elif cfg.search == "approx":
            mode, floor = "recall", cfg.recall_floor
        else:
            mode, floor = "bytes", cfg.recall_floor
        self._shadow = (ShadowAuditor(reg, every=cfg.obs_audit_every,
                                      mode=mode, floor=floor)
                        if cfg.obs_audit_every > 0 else None)
        # the newest explain records; each holds host arrays only
        self._explains: deque = deque(maxlen=256)
        self._slo = SloEngine.from_config(cfg, reg, self.obs.tracer)
        # the exposition endpoint: > 0 that localhost port, -1 ephemeral
        self._http = None
        if cfg.obs_http_port != 0:
            self._http = ObsHttpServer(reg, port=max(cfg.obs_http_port, 0),
                                       snapshot_fn=self.obs_snapshot)

    def _init_static(self, points, values, labels, shards: int) -> None:
        cfg = self.cfg
        if points is None:
            raise ValueError("points or store= required")
        self.k = int(shards)
        if labels is not None:
            labels = np.asarray(labels, np.float32)
        if (not isinstance(points, torch.Tensor)
                and np.asarray(points).dtype == np.uint8):
            points = torch.from_numpy(np.ascontiguousarray(points))
        if isinstance(points, torch.Tensor):
            pts = points.to(device=self.device,
                            dtype=(torch.uint8 if points.dtype == torch.uint8
                                   else torch.float32))
            self._points, self._ids = convert.shards_from_tensor(pts, self.k)
            n = pts.shape[0]
            if values is not None:
                values = np.asarray(values, np.int32)
            if labels is not None:
                self._labels = convert.labels_from_numpy(labels, n, self.k,
                                                         self.device)
        else:
            pts = np.ascontiguousarray(points, np.float32)
            (self._points, self._ids, values,
             self._labels) = convert.shards_from_numpy(
                pts, self.k, values, labels, device=self.device)
            n = self._ids.numel()
        if self._predict and self._labels is None:
            raise ValueError(f"predict={cfg.predict!r} on a static server "
                             f"needs the labels= constructor argument")
        self._labels_host = labels
        self._points = self._points.contiguous()
        self._points_dtype = self._points.dtype
        if self._points_dtype == torch.uint8:
            _check_u8(cfg)
        self._values = values
        self.m_local = n // self.k
        self.dim = int(self._points.shape[-1])
        if cfg.route == "pruned":
            self._summaries = summaries_mod.build_summaries(
                pts, self.k, num_projections=cfg.route_num_projections,
                seed=cfg.route_proj_seed, num_pivots=cfg.summary_pivots)
        if cfg.search == "approx":
            idx = index_mod.IndexMaintainer(self.k, self.m_local, self.dim,
                                            cfg.index_buckets)
            idx.rebuild(pts)
            self._index = idx.freeze(0)

    def _init_store(self, store, points, values, labels, shards) -> None:
        cfg = self.cfg
        if points is not None or values is not None or labels is not None:
            raise ValueError(
                "pass either points/values/labels or store=, not both")
        if self._predict and not store.with_labels:
            raise ValueError(
                f"predict={cfg.predict!r} needs a labeled store: "
                f"construct it with with_labels=True "
                f"(cfg.store_kwargs() does when predict != 'none')")
        if shards is not None and int(shards) != store.k:
            raise ValueError(f"store-backed server uses the store's "
                             f"{store.k} shards, got shards={shards}")
        if store.device != self.device:
            raise ValueError(f"store on {store.device}, server on "
                             f"{self.device}")
        self.k, self.dim, self.m_local = store.k, store.dim, store.cap
        self._points_dtype = torch.float32
        # the sketch and the index are the store's, frozen with each
        # generation: a conflicting config fails loudly
        if cfg.route == "pruned" and (
                store.summary_projections != cfg.route_num_projections
                or store.summary_seed != cfg.route_proj_seed
                or store.summary_pivots != cfg.summary_pivots):
            raise ValueError(
                f"route summary sketch mismatch: store was built with "
                f"summary_projections={store.summary_projections}"
                f"/summary_seed={store.summary_seed}"
                f"/summary_pivots={store.summary_pivots} but cfg asks "
                f"for route_num_projections={cfg.route_num_projections}"
                f"/route_proj_seed={cfg.route_proj_seed}"
                f"/summary_pivots={cfg.summary_pivots}; "
                f"configure the store, or match the config to it")
        if cfg.search == "approx" and store.index_buckets != cfg.index_buckets:
            raise ValueError(
                f"search index mismatch: store was built with "
                f"index_buckets={store.index_buckets} (0 = no index "
                f"maintained) but cfg asks for "
                f"index_buckets={cfg.index_buckets}; construct the "
                f"store from cfg.store_kwargs(), or match the config to it")

    # ---- device work -----------------------------------------------------

    def _generator(self, batch_id: int) -> torch.Generator:
        """The batch's random stream, from ``(seed, batch_id)``."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed((self.seed * _SEED_MIX + batch_id) % (2**63))
        return gen

    def _capture(self):
        """The batch's backing: ``(points (k, m, dim), ids (k, m), valid
        (k, m) or None, generation, live count, summaries, index, labels
        (k, m) or None)``.  A store-backed server captures the store's
        serving triple under one lock here, the epoch-swap point, so the
        labels are the generation's own; the summaries, the index and the
        labels are None where the config does not read them."""
        cfg = self.cfg
        if self._store is None:
            return (self._points, self._ids, None, 0, self.m_local * self.k,
                    self._summaries, self._index,
                    self._labels if self._predict else None)
        snap, summ, idx = self._store.serving_snapshot()
        k, m = self.k, self.m_local
        return (snap.points.view(k, m, self.dim), snap.ids.view(k, m),
                snap.valid.view(k, m), snap.generation, snap.live,
                summ if cfg.route == "pruned" else None,
                idx if cfg.search == "approx" else None,
                snap.labels.view(k, m) if self._predict else None)

    def _operands(self, summ, idx):
        """The device router's operands for (summaries, index) (None
        unless routing is pruned on the device) and the index's slot
        decode ``(colidx, has)``, both (k, m) (None without an index),
        built when the pair differs by identity from the last one built.
        Two threads may both build a new pair; each uses its own."""
        ops = self._gen_ops
        if ops is None or ops[0] is not summ or ops[1] is not idx:
            cfg, dev = self.cfg, self.device
            packed = decode = None
            if cfg.route == "pruned" and cfg.route_compute == "device":
                packed = routing_mod.PackedRouting(
                    routing_mod.pack_summaries(summ),
                    None if idx is None else routing_mod.pack_index(idx),
                    device=dev, slack=cfg.route_slack,
                    oversample=cfg.index_oversample)
            if idx is not None:
                # each slot's flat bucket column shard*b + bucket, and
                # whether it is assigned (index_mod.slot_decode)
                assign = torch.from_numpy(idx.assign).to(dev).view(
                    self.k, self.m_local)
                base = torch.arange(self.k, device=dev)[:, None]
                decode = (assign.clamp(min=0) + base * idx.num_buckets,
                          assign >= 0)
            ops = self._gen_ops = (summ, idx, packed, decode)
        return ops[2], ops[3]

    def _prologue(self, q: np.ndarray, l_arr: np.ndarray, qt, lt,
                  summ=None, idx=None):
        """The batch's masks ahead of Algorithm 2: ``(shard_active (k,)
        bool or None, point_candidates (k, m) bool or None, touched,
        candidate fraction or None, host_syncs, the (k,) bool numpy union
        of routed shards or None, the (k, b) bool numpy union of kept
        buckets or None)``, from ``summ`` and ``idx`` (a static server's
        own when omitted).

        Device routing is one ``route_index`` call (one launch on the card:
        the routing rows and, under ``search="approx"``, the bucket rows
        gated by them, with both batch unions), whose unions are read
        back in one transfer; host routing runs the f64 ``route_shards``
        and ``bucket_keep``.  Both take the union over the batch's rows
        (padding rows, l = 0, route nowhere)."""
        cfg = self.cfg
        if self._store is None:
            summ, idx = self._summaries, self._index
        active = keep_t = keep_any = act = cand = frac = None
        syncs = 0
        packed, decode = self._operands(summ, idx)
        if cfg.route == "pruned" and cfg.route_compute == "device":
            _, _, unions = kops.route_index(qt, lt, packed, with_rows=False)
            host = unions.cpu().numpy()
            active, act = unions[:self.k], host[:self.k]
            if idx is not None:
                keep_t = unions[self.k:]
                keep_any = host[self.k:].reshape(self.k, -1)
            syncs = 1
        else:
            rows = None
            if cfg.route == "pruned":
                rows = summaries_mod.route_shards(
                    summ, q, l_arr, slack=cfg.route_slack)
                act = rows.any(0)
                active = torch.from_numpy(act).to(self.device)
            if idx is not None:
                keep_any = index_mod.bucket_keep(
                    idx, q, l_arr, shard_keep=rows,
                    oversample=cfg.index_oversample).any(0)
                keep_t = torch.from_numpy(keep_any.reshape(-1)).to(
                    self.device)
        if keep_t is not None:
            colidx, has = decode
            cand = keep_t[colidx] & has
            frac = index_mod.candidate_fraction(idx, keep_any)
        touched = self.k if act is None else int(act.sum())
        return active, cand, touched, frac, syncs, act, keep_any

    def _clock(self) -> PhaseClock:
        """An idle phase clock of the pool, reset (a new one when every
        clock is in use); give it back to ``self._clocks``."""
        try:
            return self._clocks.pop().reset()
        except IndexError:
            return PhaseClock(self.device)

    def _run(self, q: np.ndarray, l_arr: np.ndarray, gen,
             backing=None, *, exact: bool = False,
             marks: Optional[dict] = None, phases=None) -> _Batch:
        """One batch on the device against ``backing`` (a
        :meth:`_capture`, taken now when omitted), read back to the
        host; ``d``/``i`` of shape ``(B, l_max)``.  ``exact``: no
        routing prologue, every shard active and every slot a candidate,
        and the exact fold for a predicting server (the shadow audit's
        replay).  ``marks`` receives ``"route"``: the prologue's
        (start, end) clock stamps.  ``phases``: a :class:`PhaseClock`
        that the batch marks (Algorithm 2's phases, ``topl`` and
        ``merge`` for the gather sampler, ``topl`` alone for the
        ensemble; then ``readback`` and, with labels, ``predict``) and
        closes; ``_Batch.phases`` lists them."""
        cfg = self.cfg
        ph = NULL_PHASES if phases is None else phases
        points, ids, valid, _, _, summ, idx, labels = (
            self._capture() if backing is None else backing)
        qt = torch.from_numpy(q).to(self.device)
        lt = torch.from_numpy(l_arr).to(self.device)
        t0 = time.perf_counter()
        if exact:
            active = cand = frac = act = keep_any = None
            touched, syncs = self.k, 0
        else:
            active, cand, touched, frac, syncs, act, keep_any = (
                self._prologue(q, l_arr, qt, lt, summ, idx))
        if marks is not None:
            marks["route"] = (t0, time.perf_counter())
        if self._ensemble and not exact:
            return self._ensemble_run(points, ids, valid, labels, active,
                                      act, qt, l_arr, touched, syncs, phases)
        masks = dict(point_valid=valid, shard_active=active,
                     point_candidates=cand)
        if cfg.sampler == "selection":
            res = knn_mod.knn_query_batched(
                points, ids, qt, cfg.l_max, lt, gen,
                use_sampling=cfg.use_sampling, num_pivots=cfg.num_pivots,
                point_labels=labels, phases=phases, **masks)
            ph.mark("readback")
            sel = res.selection
            d, i = res.dists.cpu().numpy(), res.ids.cpu().numpy()
            # Algorithm 1's per-row counts ride with the survivors
            surv, rows = torch.stack(
                [res.prune.survivors, sel.row_iterations]).cpu().numpy()
            iters = int(rows.max()) if len(rows) else 0
            syncs += sel.host_syncs + 3
            pred = None
            if labels is not None:
                # the fold and one readback of (label, confidence)
                ph.mark("predict")
                label, conf, _ = predict_mod.exact_predict(
                    res, lt, predict=cfg.predict,
                    num_classes=cfg.num_classes)
                lc = torch.stack([label, conf]).cpu().numpy()
                pred, syncs = (lc[0], lc[1]), syncs + 1
            return _Batch(d, i, iters, surv, syncs,
                          touched, frac, pred, active=act,
                          keep_any=keep_any, phases=_closed(phases))
        sd, si = knn_mod.knn_simple(points, ids, qt, cfg.l_max,
                                    phases=phases, **masks)
        # per-request l: ranks >= l[b] become sentinels
        keep = (torch.arange(cfg.l_max, device=self.device)[None, :]
                < lt[:, None])
        d = torch.where(keep, sd, float("inf"))
        i = torch.where(keep, si, _ID_SENTINEL)
        ph.mark("readback")
        d, i = d.cpu().numpy(), i.cpu().numpy()
        return _Batch(d, i, 0, np.zeros(len(q), np.int32), 2 + syncs,
                      touched, frac, active=act, keep_any=keep_any,
                      phases=_closed(phases))

    def _ensemble_run(self, points, ids, valid, labels, active, act, qt,
                      l_arr, touched, syncs, phases=None) -> _Batch:
        """One ensemble batch: the local-k split on the host, each shard's
        masked local top-l and its vote or (sum, count) on the device with
        no sum over the shards, one readback of the ``(k, B, C)`` answers,
        and the host aggregation.  ``dists``/``ids`` are all sentinels: no
        point leaves its shard.  ``phases`` as in :meth:`_run`: ``topl``
        is the local top-l, ``readback`` the vote and its readback."""
        cfg = self.cfg
        ph = NULL_PHASES if phases is None else phases
        kl = predict_mod.local_k_for(l_arr, touched, cfg.local_k, cfg.l_max)
        mask = knn_mod._point_mask(points, valid, active, None)
        ph.mark("topl")
        d, _, labels_top = knn_mod.local_distance_top_l(
            qt, points, ids, cfg.l_max, valid=mask, extra=labels)
        ph.mark("readback")
        klt = torch.from_numpy(kl).to(self.device)
        act = np.ones(self.k, bool) if act is None else act
        if cfg.predict == "vote":
            payload = predict_mod.local_vote(d, labels_top, klt,
                                             cfg.num_classes).cpu().numpy()
            label, conf, votes = predict_mod.aggregate_vote(payload, act)
        else:
            payload = predict_mod.local_mean(d, labels_top,
                                             klt).cpu().numpy()
            label, conf = predict_mod.aggregate_regress(payload, act)
            votes = None
        b = len(l_arr)
        return _Batch(np.full((b, cfg.l_max), np.inf, np.float32),
                      np.full((b, cfg.l_max), _ID_SENTINEL, np.int32), 0,
                      np.zeros(b, np.int32), syncs + 1, touched, None,
                      (label, conf), payload, active=act, local_k=kl,
                      votes=votes, phases=_closed(phases))

    def warmup(self):
        """Run every bucket shape once, at rank ``cfg.l`` so the Algorithm
        1 loop, the routing prologue and the prediction fold or ensemble
        run too: on the card this builds the kernels and loads every CUDA
        module the path uses before the first request.  Works on an empty
        store (every answer sentinels)."""
        clock = self._clock()
        try:
            for b in self.cfg.bucket_sizes:
                self._run(np.zeros((b, self.dim), np.float32),
                          np.full(b, min(self.cfg.l, self.cfg.l_max),
                                  np.int32),
                          self._generator(0), phases=clock.reset())
        finally:
            self._clocks.append(clock)

    # ---- store passthrough -----------------------------------------------

    def _require_store(self, op: str):
        if self._store is None:
            raise ValueError(f"{op}() needs a store-backed server "
                             f"(construct with store=)")
        return self._store

    def insert(self, points, ids=None, values=None, labels=None):
        """Stage insertions on the store; returns the assigned global ids
        (``MutableStore.insert``)."""
        return self._require_store("insert").insert(
            points, ids=ids, values=values, labels=labels)

    def update(self, ids, points, labels=None):
        """Stage in-place overwrites (``MutableStore.update``)."""
        return self._require_store("update").update(ids, points,
                                                    labels=labels)

    def delete(self, ids):
        """Stage deletions by global id (``MutableStore.delete``)."""
        return self._require_store("delete").delete(ids)

    def flush_store(self) -> int:
        """Apply staged mutations as one epoch swap; returns the new
        generation (``MutableStore.flush``)."""
        return self._require_store("flush_store").flush()

    # ---- request path ----------------------------------------------------

    @property
    def with_values(self) -> bool:
        """Whether answers carry the int payload table (the store's
        ``with_values``, or the static ``values=`` argument)."""
        return (self._store.with_values if self._store is not None
                else self._values is not None)

    @property
    def with_labels(self) -> bool:
        """Whether a label payload is attached (the store's
        ``with_labels``, or the static ``labels=`` argument)."""
        return (self._store.with_labels if self._store is not None
                else self._labels is not None)

    def labels_for(self, ids):
        """Map global ids to label payloads, NaN where absent."""
        if self._store is not None:
            return self._store.labels_for(ids)
        if self._labels_host is None:
            raise RuntimeError("server has no label payload")
        ids = np.asarray(ids)
        safe = np.clip(ids, 0, len(self._labels_host) - 1)
        return np.where(ids == _ID_SENTINEL, np.nan,
                        self._labels_host[safe]).astype(np.float32)

    def values_for(self, ids):
        """Map global ids to int payload values, -1 where absent."""
        if self._store is not None:
            return self._store.values_for(ids)
        if self._values is None:
            raise RuntimeError("server has no value payload")
        ids = np.asarray(ids)
        safe = np.clip(ids, 0, len(self._values) - 1)
        return np.where(ids == _ID_SENTINEL, -1, self._values[safe])

    def submit(self, query, l: Optional[int] = None) -> Future:
        """Enqueue one query; the Future resolves to a QueryResult."""
        l = self.cfg.l if l is None else int(l)
        if not 1 <= l <= self.cfg.l_max:
            raise ValueError(f"l={l} outside [1, l_max={self.cfg.l_max}]")
        if (self._points_dtype == torch.uint8
                and np.asarray(query).dtype != np.uint8):
            raw = np.asarray(query, np.float64)
            if not (np.all(raw == np.round(raw)) and np.all(raw >= 0)
                    and np.all(raw <= 255)):
                raise ValueError("a query to uint8 points must hold "
                                 "integers in [0, 255]")
        query = np.asarray(query, np.float32)
        if query.shape != (self.dim,):
            raise ValueError(f"query shape {query.shape} != ({self.dim},)")
        t_enq = time.perf_counter()
        rec = _Pending(query, l, t_enq, Future(),
                       self.obs.tracer.begin("request", t0=t_enq, l=l))
        with self._cv:
            self._pending.append(rec)
            self._cv.notify()
        return rec.future

    def query_batch(self, queries, ls=None) -> list[QueryResult]:
        """Synchronous convenience: submit all, flush, collect."""
        queries = np.asarray(queries, np.float32)
        if ls is None:
            ls = [None] * len(queries)
        futs = [self.submit(q, l) for q, l in zip(queries, ls)]
        self.flush()
        return [f.result() for f in futs]

    def flush(self):
        """Drain the queue now, bucket by bucket (synchronous path)."""
        while True:
            with self._cv:
                if not self._pending:
                    return
                chunk = self._take_chunk_locked()
            self._dispatch(chunk)

    def _take_chunk_locked(self) -> list[_Pending]:
        n = min(len(self._pending), self.cfg.bucket_sizes[-1])
        chunk, self._pending = self._pending[:n], self._pending[n:]
        return chunk

    def _bucket_for(self, n: int) -> int:
        for b in self.cfg.bucket_sizes:
            if b >= n:
                return b
        return self.cfg.bucket_sizes[-1]

    def _dispatch(self, chunk: list[_Pending]):
        cfg = self.cfg
        n = len(chunk)
        bucket = self._bucket_for(n)
        q = np.zeros((bucket, self.dim), np.float32)
        l_arr = np.zeros(bucket, np.int32)      # padding rows keep l=0
        for row, rec in enumerate(chunk):
            q[row] = rec.query
            l_arr[row] = rec.l
        with self._cv:
            batch_id = self._batch_counter
            self._batch_counter += 1
        tracer = self.obs.tracer
        t_dispatch = time.perf_counter()
        # the batch's trace root; a request's "serve" span names it by
        # attribute, so every tree keeps one root
        dspan = tracer.begin("dispatch", t0=t_dispatch, batch=batch_id,
                             bucket=bucket, n_real=n,
                             anchor=tracer.anchor())
        routed = cfg.route == "pruned" or cfg.search == "approx"
        marks = {}
        clock = self._clock()
        try:
            backing = self._capture()
            generation, n_live = backing[3], backing[4]
            maint0 = (self._store.maint_commit_clock()
                      if self._store is not None else (0, None))
            t_snap = time.perf_counter()
            out = self._run(q, l_arr, self._generator(batch_id), backing,
                            marks=marks, phases=clock)
        except Exception as exc:
            # a failed dispatch must never strand its futures (the chunk
            # already left the queue), kill the micro-batcher thread or
            # leave a span open
            self._errors.inc()
            for rec in chunk:
                _resolve(rec.future, error=exc)
                rec.span.end(error=type(exc).__name__)
            dspan.end(error=type(exc).__name__)
            return
        finally:
            self._clocks.append(clock)
        t_done = time.perf_counter()
        t_route0, t_route1 = marks["route"]
        tracer.record("snapshot", t_dispatch, t_snap, parent=dspan,
                      generation=generation, n_live=n_live)
        if routed:
            tracer.record("route", t_route0, t_route1, parent=dspan,
                          compute=cfg.route_compute
                          if cfg.route == "pruned" else "host",
                          touched=out.touched, slack=cfg.route_slack)
        # the host wall of the device work, readback included; the
        # phases below it carry the device time
        kspan = tracer.record("kernel", t_route1 if routed else t_snap,
                              t_done, parent=dspan, sampler=cfg.sampler,
                              route_compute=cfg.route_compute,
                              iterations=out.iterations,
                              host_syncs=out.host_syncs)
        topl_device_s, select_s, merge_s = None, 0.0, 0.0
        for name, p0, p1, device_s, attrs in out.phases:
            if name == "topl":
                topl_device_s = device_s
            elif name == "select":
                select_s = p1 - p0 if device_s is None else device_s
            elif name == "merge":
                merge_s = p1 - p0 if device_s is None else device_s
            if tracer.enabled:
                if device_s is not None:
                    attrs = dict(attrs, device_s=device_s)
                tracer.record(name, p0, p1, parent=kspan, **attrs)

        d, i, iters, surv, syncs = out[:5]
        rounds, messages = accounting(
            sampler=cfg.sampler, iterations=iters, touched=out.touched,
            l_max=cfg.l_max, use_sampling=cfg.use_sampling,
            predict=cfg.predict, predict_mode=cfg.predict_mode)
        self.stats.observe(
            bucket, n,
            touched=out.touched if cfg.route == "pruned" else None,
            topl_device_s=topl_device_s or 0.0, select_s=select_s,
            merge_s=merge_s)
        # the gather bill charges the static buffer width l_max per peer,
        # so its envelope is checked against that width
        audit_l = (cfg.l_max if cfg.sampler == "gather"
                   else max(rec.l for rec in chunk))
        contract_ok = self._contract.check(
            l_max=audit_l, n_live=n_live, rounds=rounds,
            messages=messages, use_sampling=cfg.use_sampling,
            sampler=cfg.sampler, generation=generation)
        if self._store is not None:
            maint1 = self._store.maint_commit_clock()
            head = self._store.generation
        else:
            maint1, head = (0, None), generation
        if self._slo is not None:
            self._slo.measure("contract", 0.0 if contract_ok else 1.0)

        pmode = ("none" if not self._predict
                 else "ensemble" if self._ensemble else "exact")
        pred = out.pred
        # one capture a dispatch, of host arrays the dispatch holds
        # anyway; the reports assemble lazily from it
        capture = BatchCapture(
            batch_id=batch_id, bucket=bucket, n_real=n,
            generation=generation, route=cfg.route,
            route_compute=cfg.route_compute, search=cfg.search,
            slack=cfg.route_slack, oversample=cfg.index_oversample,
            queries=q, ls=l_arr, summaries=backing[5], index=backing[6],
            active=out.active, keep_any=out.keep_any, touched=out.touched,
            candidate_fraction=out.candidate_fraction,
            predict=cfg.predict, predict_mode=pmode,
            labels=None if pred is None else pred[0],
            confidences=None if pred is None else pred[1],
            local_k=out.local_k, shard_answers=out.payload,
            votes=out.votes,
            timings={"snapshot_s": t_snap - t_dispatch,
                     "route_s": t_route1 - t_route0 if routed else None,
                     "kernel_s": t_done - (t_route1 if routed else t_snap),
                     "topl_device_s": topl_device_s},
            maint_before=maint0[0], maint_after=maint1[0],
            maint_last=maint1[1], contract_ok=contract_ok)
        if (self._shadow is not None
                and (cfg.route == "pruned" or cfg.search == "approx"
                     or self._ensemble)
                and self._shadow.due()):
            self._shadow_audit(out, backing, q, l_arr, batch_id, generation,
                               dspan)

        t_res0 = time.perf_counter()
        vspan = tracer.begin("resolve", parent=dspan, t0=t_res0)
        for row, rec in enumerate(chunk):
            # ascending by distance: gather_selected packs by shard rank,
            # and l is small, so sort on the host
            order = np.argsort(d[row, :rec.l], kind="stable")
            dists = d[row, order]
            ids = i[row, order]
            values = self.values_for(ids) if self.with_values else None
            xrec = ExplainRecord(capture, row, l=rec.l, dists=dists,
                                 ids=ids, queued_s=t_dispatch - rec.t_enqueue,
                                 latency_s=t_done - rec.t_enqueue)
            self._explains.append(xrec)
            _resolve(rec.future, result=QueryResult(
                dists=dists, ids=ids, values=values, l=rec.l,
                iterations=iters, rounds=rounds, messages=messages,
                survivors=int(surv[row]), bucket=bucket,
                queued_s=t_dispatch - rec.t_enqueue,
                latency_s=t_done - rec.t_enqueue, host_syncs=syncs,
                generation=generation, shards_touched=out.touched,
                recall_mode="approx" if cfg.search == "approx"
                else "exact",
                label=None if pred is None else float(pred[0][row]),
                confidence=None if pred is None else float(pred[1][row]),
                predict_mode=pmode, explain_ref=xrec))
            tracer.record("queued", rec.t_enqueue, t_dispatch,
                          parent=rec.span)
            tracer.record("serve", t_dispatch, t_done, parent=rec.span,
                          batch=batch_id)
            rec.span.end(bucket=bucket, generation=generation,
                         route=cfg.route, touched=out.touched,
                         rounds=rounds)
            latency = time.perf_counter() - rec.t_enqueue
            self._m["queued_s"].observe(t_dispatch - rec.t_enqueue)
            self._m["latency_s"].observe(latency)
            if self._slo is not None:
                self._slo.measure("latency_p99", latency)
                self._slo.measure("staleness", head - generation)
        vspan.end()
        dspan.end(touched=out.touched, generation=generation)
        t_res1 = time.perf_counter()
        m = self._m
        m["snapshot_s"].observe(t_snap - t_dispatch)
        if routed:
            m["route_s"].observe(t_route1 - t_route0)
        m["kernel_s"].observe(t_done - (t_route1 if routed else t_snap))
        m["resolve_s"].observe(t_res1 - t_res0)
        m["dispatch_s"].observe(t_res1 - t_dispatch)
        m["rounds"].observe(rounds)
        m["messages"].observe(messages)
        m["host_syncs"].observe(syncs)
        m["touched_shards"].observe(out.touched)
        if out.candidate_fraction is not None:
            m["candidate_fraction"].observe(out.candidate_fraction)
        # reports build only after the dispatch, so this late fill shows
        capture.timings["resolve_s"] = t_res1 - t_res0
        if self._slo is not None:
            self._slo.evaluate()

    def _shadow_audit(self, out: _Batch, backing, q, l_arr, batch_id: int,
                      generation: int, dspan) -> None:
        """Replay the batch exactly on the operands it captured (never a
        new capture: under churn that is a newer generation) with the
        same random stream, and audit the served answer against it.  The
        replay's launches are counted apart, in
        ``audit.shadow.launches.<kernel>``."""
        reg = self.obs.metrics
        with self.obs.tracer.span("shadow_audit", parent=dspan,
                                  generation=generation) as aspan:
            with kops.counted_apart() as tally:
                if self._ensemble:
                    ok = self._shadow.check_labels(
                        out.pred[0], l_arr,
                        lambda: self._exact_replay(backing, q, l_arr,
                                                   batch_id).pred[0],
                        generation=generation, batch_id=batch_id,
                        touched=out.touched)
                    measured = ("label_agreement",
                                self._shadow.last_agreement)
                else:
                    ok = self._shadow.check(
                        out.dists, out.ids,
                        lambda: self._exact_replay(backing, q, l_arr,
                                                   batch_id)[:2],
                        generation=generation, batch_id=batch_id,
                        touched=out.touched)
                    measured = ("recall_min", self._shadow.last_min_recall
                                if self._shadow.mode == "recall" else None)
            for name, launches in tally.items():
                reg.counter(f"audit.shadow.launches.{name}").inc(launches)
            if self._slo is not None and measured[1] is not None:
                self._slo.measure(*measured)
            aspan.annotate(diverged=not ok)

    def _exact_replay(self, backing, q, l_arr, batch_id: int) -> _Batch:
        """The exact collective for one dispatched batch: the captured
        operands and the batch's random stream, every shard active and
        every slot a candidate; the exact fold for a predicting server."""
        return self._run(q, l_arr, self._generator(batch_id), backing,
                         exact=True)

    def placement_stats(self) -> dict:
        """Locality and bound fidelity of the layout being served.

        ``prune_rate``: the fraction of shard visits the routing test
        avoided over the ``route="pruned"`` batches, ``1 - touched /
        (batches * k)`` (0.0 before the first).  ``live_per_shard``: the
        store's per-shard live counts (uniform for a static point set).
        ``summary_slack``: per-shard covering-radius decay of the store's
        summaries (``MutableStore.summary_slack``; 0.0 for a static set,
        whose summaries are exact).  ``maintenance``: the adaptive
        knobs and counters."""
        snap = self.stats.snapshot()
        routed = snap["routed_batches"]
        rate = (1.0 - snap["touched_shards"] / (routed * self.k)
                if routed else 0.0)
        st = self._store
        if st is not None:
            hist = [int(v) for v in st.live_per_shard]
            placement, redeal = st.placement, st.redeal
            slack = [float(v) for v in st.summary_slack()]
            maintenance = st.maintenance_stats()
        else:
            hist = [self.m_local] * self.k
            placement = redeal = "static"
            slack = [0.0] * self.k
            maintenance = {"summary_pivots": self.cfg.summary_pivots,
                           "retighten_every": 0,
                           "split_radius_factor": 0.0,
                           "retightens": 0, "splits": 0}
        return {"placement": placement, "redeal": redeal,
                "live_per_shard": hist, "routed_batches": routed,
                "prune_rate": rate, "summary_slack": slack,
                "max_summary_slack": max(slack) if slack else 0.0,
                "maintenance": maintenance}

    def obs_snapshot(self) -> dict:
        """The unified observability view: serving counters, this
        server's metrics, the process-wide kernel launch counts, the
        tracer's ring stats, both auditors' verdicts, the SLO state and
        the routing effectiveness."""
        shadow = (self._shadow.snapshot() if self._shadow is not None
                  else {"every": 0, "checks": 0, "divergences": 0,
                        "details": []})
        return {"server": self.stats.snapshot(),
                "metrics": self.metrics.snapshot(),
                "launches": kops.launch_counts(),
                "trace": self.obs.tracer.stats(),
                "audit": {"contract": self._contract.snapshot(),
                          "shadow": shadow},
                "slo": (self._slo.snapshot() if self._slo is not None
                        else {"objectives": {}, "firing": [],
                              "alerts_fired": 0, "alerts_cleared": 0}),
                "placement": self.placement_stats()}

    def explain_last(self, n: int = 1) -> list[dict]:
        """Built explain reports of the newest ``n`` resolved requests,
        oldest first."""
        if n < 1:
            return []
        return [r.build() for r in list(self._explains)[-n:]]

    def export_trace_jsonl(self, path_or_file) -> int:
        """Dump the tracer's ring as JSONL (0 spans when tracing is off)."""
        return self.obs.tracer.export_jsonl(path_or_file)

    # ---- background micro-batcher ----------------------------------------

    def start(self):
        """Run the micro-batcher thread (linger-then-dispatch loop)."""
        if self._running:
            return
        self._running = True
        self._thread = threading.Thread(target=self._serve_loop,
                                        name="knn-microbatcher", daemon=True)
        self._thread.start()

    def stop(self):
        """Quiesce the micro-batcher and drain the queue: every pending
        request resolves before this returns, each dispatched once, in
        FIFO order; idempotent and safe to race with itself."""
        with self._cv:
            self._running = False
            self._cv.notify_all()
            t, self._thread = self._thread, None
        if t is not None:
            t.join()
        self.flush()

    def close(self) -> None:
        """Quiesce the micro-batcher and release the exposition endpoint
        (idempotent)."""
        self.stop()
        if self._http is not None:
            self._http.close()

    def serving(self):
        return _Serving(self)

    def _serve_loop(self):
        linger = self.cfg.max_wait_ms / 1e3
        full = self.cfg.bucket_sizes[-1]
        while True:
            with self._cv:
                while self._running and not self._pending:
                    self._cv.wait(timeout=0.1)
                if not self._running:
                    return
                deadline = self._pending[0].t_enqueue + linger
                while (self._running and len(self._pending) < full
                       and time.perf_counter() < deadline):
                    self._cv.wait(timeout=max(
                        deadline - time.perf_counter(), 1e-4))
                chunk = self._take_chunk_locked()
            if chunk:
                self._dispatch(chunk)


def _closed(phases) -> tuple:
    """Close a batch's phase clock and list its phases (none without
    one)."""
    if phases is None:
        return ()
    phases.close()
    return tuple(phases.phases())


def _resolve(future: Future, result=None, error=None):
    """Resolve a future, tolerating client-side cancellation."""
    try:
        if error is not None:
            future.set_exception(error)
        else:
            future.set_result(result)
    except InvalidStateError:
        pass      # already cancelled by the client: nothing owed


class _Serving:
    def __init__(self, server: KnnServer):
        self._server = server

    def __enter__(self):
        self._server.start()
        return self._server

    def __exit__(self, *exc):
        self._server.stop()
        return False
