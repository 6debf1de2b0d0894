"""The paper's own artifact: a standalone distributed l-NN service config.

The port's own copy of ``repro.configs.knn_service`` (same fields, same
defaults), so that ``repro_torch`` imports nothing of the JAX package.
Mirrors the paper's experimental setup (Section 3): synthetic points
split over k shards, query broadcast, answer = l nearest.  The port's
micro-batched query service (``repro_torch/runtime/knn_server.py``)
takes every tuning knob from here, and ``store_kwargs()`` builds a
``MutableStore`` from the store's knobs (both maintenance planes).
Every knob is live in the port; ``distance_impl`` takes only
``"auto"`` (the port picks the kernel or its plain version by the
device).
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class KnnServiceConfig:
    name: str = "knn-service"
    n_points: int = 1 << 22          # paper: 2^22 points per process
    dim: int = 64                    # paper uses scalars; dim=1 reproduces it
    l: int = 128                     # neighbors per query
    query_batch: int = 8
    num_classes: int = 16            # for the classification head
    value_range: float = 4294967295.0  # paper: U[0, 2^32 - 1]

    # ---- micro-batched query service (runtime/knn_server.py) ------------
    # Incoming requests are coalesced into one of these device batch shapes
    # (ascending; each a static jit specialization).  A flush picks the
    # smallest bucket >= pending count and pads the rest with l=0 rows.
    bucket_sizes: tuple = (1, 2, 4, 8, 16, 32)
    # Shared static upper bound on per-request l — the (B, l_max) buffer
    # width every bucket compiles against; requests may ask for any l in
    # [1, l_max] (per-row masking inside knn_query_batched).
    l_max: int = 128
    # Micro-batcher linger: how long the background batcher waits for more
    # requests after the first one arrives before dispatching a partial
    # bucket.
    max_wait_ms: float = 2.0
    # Algorithm knobs, passed straight through to Algorithm 2.
    use_sampling: bool = True        # Lemma 2.3 sample-and-prune on/off
    num_pivots: int = 1              # >1 = beyond-paper multi-pivot mode
    # A/B switch: "selection" = Algorithm 2 (O(log l) rounds), "gather" =
    # the paper's simple method (knn_simple; one O(k*l)-value all_gather).
    sampler: str = "selection"
    # Distance computation: "auto" routes through kernels/ops.py (Pallas
    # kernel on TPU, jnp oracle elsewhere); "jnp" forces the pure-jnp path.
    distance_impl: str = "auto"
    # Shard routing (store/summaries.py): "exact" sends every query to all
    # k shards (the paper's collective); "pruned" consults per-shard pivot
    # summaries (centroid + covering radius + random-projection sketch)
    # and masks shards that provably cannot hold an l-NN winner.  Answers
    # are bit-identical either way (tests/test_routing.py); only the
    # k-machine message/round bill and QueryResult.shards_touched change.
    route: str = "exact"
    # Relative float-safety margin of the routing lower-bound test: a
    # shard is kept unless lb > T*(1+slack) + err, where err is the
    # magnitude-absolute f32 rounding bound computed per query
    # (summaries.pipeline_error_bound) — so pipeline rounding can never
    # turn a mathematically sound prune into a dropped winner, even for
    # data far from the origin.
    route_slack: float = 1e-4
    # Random-projection sketch width (directions per summary) and the seed
    # of the shared direction matrix (deterministic: two servers over the
    # same generation must route identically).  Store-backed servers take
    # the sketch from the store (MutableStore summary_projections /
    # summary_seed); a mismatch with these values raises at construction.
    route_num_projections: int = 8
    route_proj_seed: int = 0
    # Where the route="pruned" decision is computed: "host" runs the f64
    # numpy route_shards per dispatch (a serial host pass ahead of the
    # launch); "device" folds the identical decision into the service
    # executable's prologue (kernels/routing.py — f32, bit-identical
    # masks on every tested instance, tests/test_routing.py) so routing
    # rides the batch's own launch and the touched-shard set returns
    # with the answers.  Ignored under route="exact".
    route_compute: str = "host"

    # ---- mutable sharded store (store/mutable.py) -----------------------
    # Slots per shard of the capacity-padded buffers; fixes every compiled
    # shape, so the store can mutate forever without recompilation.
    store_capacity_per_shard: int = 2048
    # Write-ahead staging: pending mutations auto-flush (one scatter + one
    # epoch swap) once this many ops are queued.
    store_staging_size: int = 128
    # Compaction triggers (store/compaction.py): repack when dead slots
    # exceed this fraction of occupied slots...
    store_compact_tombstone_frac: float = 0.35
    # ...or when (max_live - min_live) / capacity exceeds this skew.
    store_compact_imbalance_frac: float = 0.5
    # Placement subsystem (store/placement.py): "balance" sends each
    # applied insert to the emptiest shard; "affinity" sends it to the
    # nearest live summary centroid so clusters stay shard-coherent and
    # route="pruned" can skip shards on store-backed serving too.
    placement: str = "balance"
    # Affinity balance guardrail: only shards within this many live
    # points of the global minimum are eligible, so insert-only streams
    # can never skew live counts beyond guard_slack + 1 — far below the
    # compaction imbalance trigger, which therefore never thrashes.
    placement_guard_slack: int = 32
    # Compaction re-deal mode: "round_robin" deals live points by id;
    # "proximity" re-deals them to Lloyd-centroid-owned shards (balanced
    # to within one, ids stable) so a repack *restores* locality instead
    # of smearing it.
    redeal: str = "round_robin"
    # ---- adaptive summary maintenance (store/adaptive.py) ----------------
    # Pivot balls per shard summary: 1 is the classic single-ball form;
    # >1 lets one shard host several small clusters without voiding its
    # routing bounds (the lower bound becomes the min over pivots, still
    # provably exact).  Store-backed pruned servers must match the store,
    # like the sketch knobs above.
    summary_pivots: int = 1
    # Scheduled exact re-tightening: a shard that absorbs this many ops
    # since its last exact rebuild becomes due; the store re-tightens at
    # most ONE due shard per flush (round-robin, O(live·dim) host work) so
    # covering radii shrink back to the live spread mid-stream instead of
    # inflating until the next compaction.  0 disables.
    retighten_every: int = 0
    # Radius-triggered shard splitting: when a shard's covering radius
    # exceeds this factor times the gap to its nearest occupied neighbor
    # centroid (and has grown since its last exact rebuild), the store
    # schedules its own quota-bounded proximity re-deal instead of
    # waiting for the tombstone/imbalance compaction trigger.  0 disables.
    split_radius_factor: float = 0.0
    # Maintenance execution plane (store/maintenance.py): "inline" runs
    # re-tightening / splits / auto-compaction at the tail of every flush
    # under the store lock (today's exact behavior); "background" moves
    # them to a worker thread that plans by a sampled summary-slack
    # probe, prepares repacked buffers off-lock, and commits via the
    # epoch swap under a short lock window — flushes stop paying for
    # maintenance and in-flight micro-batches keep serving their
    # snapshot.  Answers are bit-identical either way at every
    # generation (tests/test_async_maintenance.py).
    maintenance: str = "inline"
    # ---- in-shard approximate search index (store/index.py) --------------
    # "exact" (default) brute-forces every live slot of every touched
    # shard — answers bit-identical to the paper's collective.  "approx"
    # adds the per-shard bucket index: a query prologue keeps only the
    # covering-ball buckets whose lower bound can still hold a top-l
    # winner and masks the rest of the slots, trading exactness for a
    # measured recall contract (recall_floor, audited by the shadow
    # replay and hard-asserted by bench_serve's "index" section).
    search: str = "exact"
    # Covering-ball buckets per shard (store/index.py); store-backed
    # approx servers must match the store's index_buckets, like the
    # summary knobs.  Ignored under search="exact".
    index_buckets: int = 8
    # Candidate oversampling: the bucket keep rule targets
    # max(l, ceil(index_oversample · l)) cumulative live points before
    # it stops keeping buckets.  Larger = higher recall, more
    # candidates; large enough that the target is never reached keeps
    # every bucket (bit-identical to exact).
    index_oversample: float = 2.0
    # The serving recall contract: the shadow-exact audit flags any
    # approx batch whose measured recall@l drops below this floor.
    recall_floor: float = 0.95

    # ---- label prediction (src/repro/predict/) --------------------------
    # What to predict from the neighbors' label payloads: "none" (default)
    # serves ids/distances only; "vote" majority-votes a class id over
    # num_classes classes; "regress" means the label values.  Requires a
    # labeled backing (MutableStore with_labels=True, or the static
    # labels= constructor arg).
    predict: str = "none"
    # How the prediction is computed: "exact" runs Algorithm 2 and folds
    # the winner mask into the vote inside the fused executable — the
    # label is bit-identical to a single-machine vote/mean over the true
    # l nearest neighbors, for +1 round / +(t-1) messages (the class
    # histogram crossing the network).  "ensemble" skips the selection
    # collectives entirely: each routed shard answers its local-kNN vote
    # in ONE message (arXiv 1812.05005) and the host aggregates — the
    # message bill is exactly touched_shards, and accuracy-vs-exact is a
    # measured contract (accuracy_floor).  Ensemble requires
    # search="exact" and host-computed routing (route_compute="host").
    predict_mode: str = "exact"
    # Ensemble local-k rule: 0 (auto) uses ceil(l / touched_shards) — the
    # budget split arXiv 1812.05005 analyzes, which degenerates to the
    # exact vote on a 1-shard store; >0 pins every shard's local k.
    local_k: int = 0
    # The ensemble accuracy contract: the accuracy-mode shadow audit
    # (obs/audit.py) flags any sampled batch whose ensemble-vs-exact
    # label agreement drops below this floor.
    accuracy_floor: float = 0.9
    # Label-agreement SLO (obs/slo.py): lower bound on the shadow-audited
    # agreement fraction, burn-rate-windowed like the recall floor.
    # 0 = off.
    slo_label_agreement_floor: float = 0.0

    # ---- observability plane (src/repro/obs/) ---------------------------
    # Flight-recorder tracing: when on, the server records spans for the
    # full request lifecycle (enqueue -> queued -> dispatch -> snapshot ->
    # route -> kernel -> resolve) and the maintenance worker's
    # plan/prepare/commit/discard phases into a fixed ring buffer
    # (obs/trace.py); export with KnnServer.export_trace_jsonl().  Off
    # by default: the disabled plane is a shared no-op (NULL_TRACER).
    # The metrics registry is always live regardless of this knob.
    obs_trace: bool = False
    # Ring capacity (finished spans retained; newest win).
    obs_trace_capacity: int = 8192
    # Shadow-exact auditing: every Nth routed (pruned) micro-batch is
    # replayed through the exact collective at the same generation and
    # byte-compared (obs/audit.py).  0 disables.  The Theorem-1
    # round/message contract auditor is always on (it is arithmetic on
    # numbers the server already computes).
    obs_audit_every: int = 0
    # ---- SLO engine (obs/slo.py) — all objectives opt-in ----------------
    # Each knob declares one promise; leaving it at its zero default
    # leaves that objective un-monitored, and with no objective declared
    # the server constructs no engine at all.  Fired/cleared alerts
    # surface as slo.* spans in the trace ring, slo.alerts_* counters in
    # the registry, and obs_snapshot()["slo"].
    # Per-request end-to-end latency promise (seconds; the p99 framing:
    # with the default 1% budget, the burn rate is 1.0 exactly when 1%
    # of windowed requests exceed the bound).  0 = off.
    slo_latency_p99_s: float = 0.0
    # Shadow-audited minimum recall@l promise (lower bound; only
    # meaningful with obs_audit_every > 0 on an approx server).  0 = off.
    slo_recall_floor: float = 0.0
    # Answer-generation staleness promise: how many generations behind
    # the store head an answer may be computed (epoch-swapped serving is
    # normally 0-1 behind).  0 = off.
    slo_staleness_generations: int = 0
    # Promise that the Theorem-1 round/message envelope never trips
    # (any contract-audit violation is a bad event).  False = off.
    slo_contract_violations: bool = False
    # Multi-window burn-rate mechanics: an alert fires when the bad-
    # event fraction over BOTH windows exceeds burn_threshold × budget,
    # and clears when the fast window's burn drops back under threshold.
    slo_fast_window_s: float = 60.0
    slo_slow_window_s: float = 300.0
    slo_burn_threshold: float = 1.0
    slo_budget: float = 0.01
    # ---- metrics exposition endpoint (obs/export.py) --------------------
    # >0: serve Prometheus text (/metrics), OTLP-ish JSON
    # (/metrics.json), and the full obs snapshot (/obs) on this
    # localhost port via a stdlib ThreadingHTTPServer; -1: bind an
    # ephemeral port (tests); 0 (default): no endpoint.
    obs_http_port: int = 0

    def replace(self, **kw) -> "KnnServiceConfig":
        return dataclasses.replace(self, **kw)

    def store_kwargs(self) -> dict:
        """MutableStore construction kwargs this config pins — the single
        source of service tuning extends to the store: capacity, staging,
        compaction triggers, placement policy, re-deal mode, the routing
        sketch (matched to route_num_projections/route_proj_seed so a
        store-backed ``route="pruned"`` server always constructs), and
        the adaptive-maintenance knobs (summary_pivots matched the same
        way)."""
        return dict(
            capacity_per_shard=self.store_capacity_per_shard,
            staging_size=self.store_staging_size,
            compact_tombstone_frac=self.store_compact_tombstone_frac,
            compact_imbalance_frac=self.store_compact_imbalance_frac,
            placement=self.placement,
            placement_guard_slack=self.placement_guard_slack,
            redeal=self.redeal,
            summary_projections=self.route_num_projections,
            summary_seed=self.route_proj_seed,
            summary_pivots=self.summary_pivots,
            retighten_every=self.retighten_every,
            split_radius_factor=self.split_radius_factor,
            maintenance=self.maintenance,
            index_buckets=self.index_buckets if self.search == "approx"
            else 0,
            with_labels=self.predict != "none")


CONFIG = KnnServiceConfig()
