"""The port's obs plane against the JAX package's, on the same inputs.

The pure cases of tests/test_obs.py and tests/test_operator.py, each run
through ``repro_torch.obs`` and ``repro.obs`` alike and held equal:

* **Metrics.**  Histogram quantiles within 5% of a sorted oracle (one
  geometric bucket is ~2.2%) and equal between the packages; sliding
  windows on a synthetic clock; the registry's create-or-get.
* **SLOs.**  Burn-rate units, fire and clear on a synthetic clock, the
  ``_MIN_EVENTS`` gate, the slow window's veto, opt-in construction:
  snapshots and transition events equal between the packages.
* **Exporters.**  Prometheus text of the same registry byte-equal,
  each parser reading the other's text, both refusing the same
  malformations; the OTLP documents equal; the HTTP endpoint's views.
* **Tracing.**  Span trees, the ring's eviction and export, the null
  tracer, ``build_trees``' refusals: the same records (ids aside).
* **Auditors.**  ``ShadowAuditor`` in its bytes, recall and accuracy
  modes: the same verdicts and snapshots.

Every comparison is exact: these modules are stdlib arithmetic.
"""

import io
import json
import math
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.configs.knn_service import CONFIG as JCONFIG
from repro.obs import audit as jaudit
from repro.obs import export as jexport
from repro.obs import metrics as jmetrics
from repro.obs import slo as jslo
from repro.obs import trace as jtrace
from repro.store import compaction as jcompaction
from repro_torch import obs as tobs
from repro_torch.configs import CONFIG
from repro_torch.obs import audit as taudit
from repro_torch.obs import export as texport
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import slo as tslo
from repro_torch.obs import trace as ttrace
from repro_torch.store import compaction as tcompaction

torch.set_num_threads(1)

# (metrics, slo, trace, export, audit, obs package, service config)
PKGS = {"torch": (tmetrics, tslo, ttrace, texport, taudit, tobs, CONFIG),
        "jax": (jmetrics, jslo, jtrace, jexport, jaudit, jobs, JCONFIG)}


def both(fn):
    """``fn`` run on each package's modules: (torch result, jax result)."""
    return fn(*PKGS["torch"]), fn(*PKGS["jax"])


def _strip_ids(recs):
    """Span records without their process-wide ids, parents as indices."""
    pos = {r["span"]: n for n, r in enumerate(recs)}
    return [{k: v for k, v in r.items() if k not in ("trace", "span",
                                                      "parent", "t0", "t1")}
            | {"parent": pos.get(r["parent"])} for r in recs]


# ---- metrics ---------------------------------------------------------------

@pytest.mark.parametrize("dist", ["lognormal", "uniform", "constant"])
def test_histogram_quantiles_vs_sorted_oracle(dist):
    rng = np.random.default_rng(0)
    vals = {"lognormal": rng.lognormal(-3.0, 1.5, 5000),
            "uniform": rng.uniform(1e-4, 2.0, 5000),
            "constant": np.full(300, 0.25)}[dist]
    oracle = np.sort(vals)

    def run(metrics, *_):
        h = metrics.Histogram()
        for v in vals:
            h.observe(float(v))
        return [h.quantile(q) for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0)], \
            h.snapshot(), h.bucket_counts()

    (tq, tsnap, tb), (jq, jsnap, jb) = both(run)
    assert tq == jq and tsnap == jsnap and tb == jb
    for q, got in zip((0.0, 0.1, 0.5, 0.9, 0.99, 1.0), tq):
        rank = min(max(math.ceil(q * len(vals)), 1), len(vals))
        want = oracle[rank - 1]
        assert abs(got - want) <= 0.05 * want, (q, got, want)


def test_histogram_empty_and_registry_create_or_get():
    def run(metrics, *_):
        reg = metrics.MetricsRegistry()
        h = reg.histogram("serve.latency_s")
        empty = h.snapshot()
        assert reg.histogram("serve.latency_s") is h
        with pytest.raises(TypeError):
            reg.counter("serve.latency_s")
        reg.counter("c").inc(3)
        reg.gauge("g").set(2.5)
        reg.window("w").observe(1.0, t=0.0)
        buf = io.StringIO()
        n = reg.export_jsonl(buf)
        return (json.dumps(empty), [name for name, _ in reg.items()],
                reg.value("c"), reg.value("missing", 7), reg.get("nope"), n,
                buf.getvalue())

    t, j = both(run)
    assert t == j
    assert math.isnan(json.loads(t[0])["p50"])


def test_window_aggregates_and_quantile_on_synthetic_clock():
    def run(metrics, *_):
        w = metrics.Window()
        for t in range(10):
            w.observe(float(t), t=float(t))
        agg = w.window(5.0, now=9.0)
        full = w.window(100.0, now=9.0)
        empty = w.window(5.0, now=100.0)
        q = [w.quantile(x, 100.0, now=9.0) for x in (0.5, 1.0)]
        return agg, full["count"], empty["count"], math.isnan(
            empty["min"]), q, w.snapshot()

    t, j = both(run)
    assert t == j
    assert t[0]["count"] == 6 and t[0]["sum"] == 39.0 and t[1] == 10
    assert t[2] == 0 and t[3] and t[4] == [4.0, 9.0]


# ---- SLO burn rates ---------------------------------------------------------

def _engine(metrics, slo, trace, *, tracer=None, budget=0.01, fast=10.0,
            slow=50.0):
    reg = metrics.MetricsRegistry()
    return slo.SloEngine(
        reg, tracer if tracer is not None else trace.NULL_TRACER,
        [slo.SloObjective("latency_p99", "upper", 0.1)],
        fast_window_s=fast, slow_window_s=slow, budget=budget)


def test_burn_rate_units_on_synthetic_stream():
    def run(metrics, slo, trace, *_):
        eng = _engine(metrics, slo, trace, fast=1000.0, slow=1000.0)
        for i in range(100):
            eng.measure("latency_p99", 0.2 if i == 0 else 0.01, now=float(i))
        at_budget = eng.snapshot(now=100.0)
        eng.measure("latency_p99", 0.2, now=101.0)
        return at_budget, eng.snapshot(now=101.0)

    t, j = both(run)
    assert t == j
    obj = t[0]["objectives"]["latency_p99"]
    assert obj["burn_fast"] == pytest.approx(1.0)
    assert t[0]["alerts_fired"] == 0 and not obj["firing"]
    assert t[1]["alerts_fired"] == 1


def test_fire_and_clear_walk_a_synthetic_clock():
    def run(metrics, slo, trace, *_):
        tracer = trace.Tracer(capacity=64)
        eng = _engine(metrics, slo, trace, tracer=tracer)
        for i in range(5):
            eng.measure("latency_p99", 1.0, now=float(i))
        fired = eng.evaluate(now=5.0)
        cleared = eng.evaluate(now=25.0)
        spans = [(s["name"], s["t0"], s["t1"]) for s in tracer.spans()]
        return fired, cleared, eng.snapshot(now=25.0), spans

    t, j = both(run)
    assert t == j
    assert [e["event"] for e in t[0]] == ["fire"]
    assert [e["event"] for e in t[1]] == ["clear"]
    assert t[1][0]["fired_for_s"] == pytest.approx(20.0)
    assert [n for n, *_ in t[3]] == ["slo.fire", "slo.clear", "slo.alert"]
    assert t[3][2][2] - t[3][2][1] == pytest.approx(20.0)


def test_min_events_gate_and_slow_window_veto():
    def run(metrics, slo, trace, *_):
        thin = _engine(metrics, slo, trace)
        for i in range(3):                      # 3 < _MIN_EVENTS
            thin.measure("latency_p99", 1.0, now=float(i))
        veto = _engine(metrics, slo, trace, budget=0.05)
        for i in range(96):
            veto.measure("latency_p99", 0.01, now=i * 0.5)
        for i in range(4):
            veto.measure("latency_p99", 1.0, now=48.0 + i * 0.4)
        return thin.evaluate(now=3.0), veto.snapshot(now=49.9)

    t, j = both(run)
    assert t == j
    assert t[0] == []
    obj = t[1]["objectives"]["latency_p99"]
    assert obj["burn_fast"] > 1.0 >= obj["burn_slow"]
    assert t[1]["alerts_fired"] == 0


def test_slo_from_config_is_opt_in():
    def run(metrics, slo, trace, export, audit, obs, cfg):
        reg = metrics.MetricsRegistry()
        assert slo.SloEngine.from_config(cfg, reg, trace.NULL_TRACER) is None
        eng = slo.SloEngine.from_config(
            cfg.replace(slo_latency_p99_s=0.5, slo_contract_violations=True,
                        slo_recall_floor=0.9, slo_staleness_generations=2,
                        slo_label_agreement_floor=0.8),
            reg, trace.NULL_TRACER)
        eng.measure("recall_min", 0.5, now=1.0)
        eng.measure("unknown", 1.0, now=1.0)
        with pytest.raises(ValueError):
            slo.SloEngine(reg, trace.NULL_TRACER, [])
        with pytest.raises(ValueError):
            slo.SloObjective("x", "sideways", 1.0)
        return eng.snapshot(now=2.0)

    t, j = both(run)
    assert t == j
    assert set(t["objectives"]) == {"latency_p99", "contract", "recall_min",
                                    "staleness", "label_agreement"}


# ---- exporters --------------------------------------------------------------

def _populated(metrics):
    reg = metrics.MetricsRegistry()
    reg.counter("serve.batches").inc(7)
    reg.gauge("store.live_points").set(123.0)
    h = reg.histogram("serve.latency_s")
    for v in (0.001, 0.002, 0.004, 0.01, 0.05, 1.5, 0.0, -1.0):
        h.observe(v)
    reg.histogram("serve.empty")
    reg.window("slo.events.latency_p99").observe(1.0)
    return reg


def test_prometheus_text_byte_equal_and_round_trip():
    t, j = both(lambda metrics, slo, trace, export, *_: export.prometheus_text(
        _populated(metrics)))
    assert t == j
    assert "# TYPE knn_serve_batches_total counter" in t
    assert 'knn_serve_latency_s_bucket{le="+Inf"} 8' in t
    for text in (t, j):           # each parser reads the other's text
        pt, pj = (texport.parse_prometheus_text(text),
                  jexport.parse_prometheus_text(text))
        assert pt == pj
        assert pt["knn_serve_latency_s"]["count"] == 8.0
        assert not any("slo_events" in name for name in pt)


@pytest.mark.parametrize("text", [
    "knn_mystery 1.0\n",
    ('# TYPE knn_h histogram\nknn_h_bucket{le="1.0"} 5\n'
     'knn_h_bucket{le="2.0"} 3\nknn_h_bucket{le="+Inf"} 5\n'
     "knn_h_sum 1.0\nknn_h_count 5\n"),
    ('# TYPE knn_h histogram\nknn_h_bucket{le="1.0"} 5\n'
     'knn_h_bucket{le="+Inf"} 5\nknn_h_sum 1.0\nknn_h_count 9\n'),
    ('# TYPE knn_h histogram\nknn_h_bucket{le="1.0"} 5\n'
     "knn_h_sum 1.0\nknn_h_count 5\n"),
    ('# TYPE knn_h histogram\nknn_h_bucket{foo="1.0"} 5\n'),
    "# TYPE knn_x gauge\nknn_x\n",
])
def test_prometheus_parsers_refuse_the_same_malformations(text):
    for export in (texport, jexport):
        with pytest.raises(ValueError):
            export.parse_prometheus_text(text)


def test_otlp_documents_equal():
    t, j = both(lambda metrics, slo, trace, export, *_: export.otlp_json(
        _populated(metrics)))
    assert t == j
    metrics = t["resourceMetrics"][0]["scopeMetrics"][0]["metrics"]
    pt = {m["name"]: m for m in metrics}["knn_serve_latency_s"][
        "histogram"]["dataPoints"][0]
    assert len(pt["bucketCounts"]) == len(pt["explicitBounds"]) + 1
    assert sum(pt["bucketCounts"]) == pt["count"] == 8


def test_metric_name_mangling():
    for name in ("serve.latency_s", "maint.plan-probe", "a.b.c"):
        assert texport.metric_name(name) == jexport.metric_name(name)
    assert texport.metric_name("maint.plan-probe") == "knn_maint_plan_probe"


def test_http_server_serves_all_three_views():
    reg = _populated(tmetrics)
    with texport.ObsHttpServer(reg, port=0,
                               snapshot_fn=lambda: {"hello": 1}) as http:
        base = f"http://127.0.0.1:{http.port}"
        with urllib.request.urlopen(f"{base}/metrics", timeout=10) as r:
            assert r.headers["Content-Type"].startswith("text/plain")
            body = r.read().decode()
        assert body == jexport.prometheus_text(_populated(jmetrics))
        with urllib.request.urlopen(f"{base}/metrics.json", timeout=10) as r:
            assert json.loads(r.read().decode()) == texport.otlp_json(reg)
        with urllib.request.urlopen(f"{base}/obs", timeout=10) as r:
            assert json.loads(r.read().decode()) == {"hello": 1}
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"{base}/nope", timeout=10)
    http.close()                                  # idempotent
    assert not http._thread.is_alive()


# ---- tracing ----------------------------------------------------------------

def test_tracer_span_tree_ring_and_export():
    def run(metrics, slo, trace, *_):
        tr = trace.Tracer(capacity=64)
        root = tr.begin("request", l=4)
        with tr.span("kernel", parent=root, path="oracle"):
            pass
        tr.record("queued", root.t0, root.t0, parent=root)
        root.end(route="pruned")
        root.end()                                 # idempotent
        recs = tr.spans()
        trees = trace.build_trees(recs)
        ring = trace.Tracer(capacity=4)
        for i in range(10):
            ring.begin(f"s{i}").end()
        buf = io.StringIO()
        n = ring.export_jsonl(buf)
        names = [json.loads(x)["name"] for x in buf.getvalue().splitlines()]
        stats = ring.stats()
        # the port's tracer also reports its anchors' widest gap (none
        # taken here)
        assert stats.pop("anchor_gap_ns", 0) == 0
        ring.clear()
        with pytest.raises(ValueError):
            trace.Tracer(capacity=0)
        return (_strip_ids(recs), len(trees), tr.active_count(), n, names,
                ring.dropped, stats)

    t, j = both(run)
    assert t == j
    assert [r["name"] for r in t[0]] == ["kernel", "queued", "request"]
    assert t[0][0]["parent"] == 2 and t[0][2]["attrs"] == {"l": 4,
                                                          "route": "pruned"}
    assert t[4] == ["s6", "s7", "s8", "s9"] and t[6]["dropped"] == 6


def test_null_tracer_is_inert():
    def run(metrics, slo, trace, *_):
        sp = trace.NULL_TRACER.begin("x", parent=None, l=1)
        with trace.NULL_TRACER.span("y"):
            pass
        return (sp.end() is sp, sp.span_id, trace.NULL_TRACER.spans(),
                trace.NULL_TRACER.export_jsonl(io.StringIO()),
                trace.NULL_TRACER.stats())

    t, j = both(run)
    assert t == j and t[0] and t[4]["enabled"] is False


@pytest.mark.parametrize("records,match", [
    ([(1, None, 0.0, None, 1)], "unfinished"),
    ([(2, 99, 0.0, 1.0, 1)], "orphaned"),
    ([(1, None, 5.0, 1.0, 1)], "ends before"),
    ([(1, None, 0.0, 1.0, 1), (2, 1, 0.0, 2.0, 1)], "outside parent"),
    ([(1, None, 0.0, 1.0, 1), (2, 1, 0.0, 0.5, 7)], "crosses traces"),
    ([(1, None, 0.0, 1.0, 1), (2, 1, 0.2, 0.8, 1), (3, None, 0.0, 1.0, 3)],
     None)])
def test_build_trees_verdicts(records, match):
    recs = [{"trace": tr, "span": sp, "parent": pa, "name": "s", "t0": t0,
             "t1": t1} for sp, pa, t0, t1, tr in records]
    for trace in (ttrace, jtrace):
        if match is None:
            assert set(trace.build_trees(recs)) == {1, 3}
        else:
            with pytest.raises(ValueError, match=match):
                trace.build_trees(recs)


def test_phase_clock_marks_algorithm2_on_cpu_tensors():
    """A clock through one ``knn_query_batched`` on CPU tensors: the
    answer is the one without it; the phases come in order with no device
    time and nest under a kernel span that ``build_trees`` accepts."""
    from repro_torch.core import knn

    g = torch.Generator().manual_seed(0)
    pts = torch.randn(8, 64, 8, generator=g)
    ids = torch.arange(512, dtype=torch.int32).view(8, 64)
    q = torch.randn(4, 8, generator=g)
    l = torch.tensor([1, 4, 16, 0])
    plain = knn.knn_query_batched(pts, ids, q, 16, l,
                                  torch.Generator().manual_seed(5))
    clock = ttrace.PhaseClock(torch.device("cpu"))
    res = knn.knn_query_batched(pts, ids, q, 16, l,
                                torch.Generator().manual_seed(5),
                                phases=clock)
    clock.mark("readback")
    res.dists.cpu()
    clock.close()
    assert torch.equal(res.dists, plain.dists)
    assert torch.equal(res.ids, plain.ids)
    assert res.selection.iterations == plain.selection.iterations
    phases = clock.phases()
    assert [p[0] for p in phases] == ["topl", "prune", "select", "gather",
                                      "readback"]
    assert all(p[3] is None for p in phases)
    assert phases[2][4] == {"host_syncs": res.selection.host_syncs}
    assert all(a[2] == b[1] for a, b in zip(phases, phases[1:]))
    tr = ttrace.Tracer()
    kernel = tr.record("kernel", phases[0][1], phases[-1][2])
    for name, t0, t1, _, attrs in phases:
        tr.record(name, t0, t1, parent=kernel, **attrs)
    assert len(ttrace.build_trees(tr.spans())) == 1
    assert clock.reset().phases() == []


def test_anchor_maps_a_span_onto_the_profiler_clock():
    """On the profiler's own thread, a span around a ``record_function``
    range maps through its anchor to an interval holding the range's
    kineto stamps, give or take 0.5 ms."""
    tr = ttrace.Tracer()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        anchor = tr.anchor()
        with tr.span("probe") as sp:
            with torch.profiler.record_function("obs.anchor_probe"):
                time.sleep(0.002)
    ev = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "obs.anchor_probe"][-1]
    p_ns, u_ns = anchor
    t0 = u_ns + sp.t0 * 1e9 - p_ns
    t1 = u_ns + sp.t1 * 1e9 - p_ns
    assert t0 - 5e5 <= ev.start_ns()
    assert ev.start_ns() + ev.duration_ns() <= t1 + 5e5
    assert 0 < tr.stats()["anchor_gap_ns"] < 5e5


def test_obs_plane_from_config():
    def run(metrics, slo, trace, export, audit, obs, cfg):
        on = obs.ObsPlane.from_config(cfg.replace(obs_trace=True,
                                                  obs_trace_capacity=32))
        off = obs.ObsPlane.from_config(cfg)
        return (on.tracer.enabled, on.tracer.capacity,
                off.tracer is trace.NULL_TRACER, off.snapshot())

    t, j = both(run)
    assert t == j and t[:3] == (True, 32, True)


def test_compaction_evaluate_publishes_registry():
    def run(reg, compaction):
        live = np.array([10, 10, 10, 10])
        d = compaction.evaluate(live, np.array([20, 10, 10, 10]), 32,
                                tombstone_frac=0.1, imbalance_frac=0.5,
                                registry=reg)
        d2 = compaction.evaluate(live, np.array([30, 10, 10, 10]), 32,
                                 tombstone_frac=0.9, imbalance_frac=0.5,
                                 registry=reg)
        return tuple(d), tuple(d2), reg.snapshot()

    t = run(tmetrics.MetricsRegistry(), tcompaction)
    assert t == run(jmetrics.MetricsRegistry(), jcompaction)
    assert t[0][0] and not t[1][0]
    assert t[2]["store.compact_trigger.tombstone"] == 1


# ---- auditors ---------------------------------------------------------------

def test_shadow_auditor_bytes_mode():
    def run(metrics, slo, trace, export, audit, *_):
        reg = metrics.MetricsRegistry()
        s = audit.ShadowAuditor(reg, every=3)
        due = [s.due() for _ in range(7)]
        d = np.arange(4, dtype=np.float32)
        i = np.arange(4, dtype=np.int32)
        ok = s.check(d, i, lambda: (d.copy(), i.copy()))
        bad = s.check(d, i, lambda: (d + 1, i.copy()), batch_id=5)
        with pytest.raises(ValueError):
            audit.ShadowAuditor(reg, every=0)
        with pytest.raises(ValueError, match="mode"):
            audit.ShadowAuditor(reg, every=1, mode="fuzzy")
        return due, ok, bad, s.snapshot()

    t, j = both(run)
    assert t == j
    assert t[0] == [True, False, False, True, False, False, True]
    assert t[1] and not t[2] and t[3]["divergences"] == 1


def test_shadow_auditor_recall_mode():
    sent = 2**31 - 1
    exact_i = np.array([[1, 2, 3, 4], [10, 11, sent, sent],
                        [sent, sent, sent, sent]], np.int32)
    d = np.zeros_like(exact_i, np.float32)
    near, bad = exact_i.copy(), exact_i.copy()
    near[0, 3] = 99
    bad[1, :2] = [98, 99]

    def run(metrics, slo, trace, export, audit, *_):
        s = audit.ShadowAuditor(metrics.MetricsRegistry(), every=1,
                                mode="recall", floor=0.75)
        verdicts = [s.check(d, got, lambda: (d, exact_i.copy()),
                            batch_id=n) for n, got in
                    enumerate((exact_i.copy(), near, bad))]
        return verdicts, s.last_min_recall, s.snapshot()

    t, j = both(run)
    assert t == j
    assert t[0] == [True, True, False] and t[1] == 0.0
    assert t[2]["details"][0]["min_recall"] == 0.0
    assert t[2]["recall"]["count"] == 3


def test_shadow_auditor_accuracy_mode():
    served = np.array([1, 2, 3, 4], np.float32)
    ls = np.array([5, 5, 5, 0], np.int32)

    def run(metrics, slo, trace, export, audit, *_):
        reg = metrics.MetricsRegistry()
        s = audit.ShadowAuditor(reg, every=1, mode="accuracy", floor=0.9)
        same = s.check_labels(served, ls, lambda: served.copy())
        # one of three real rows disagrees (the padding row never counts)
        off = s.check_labels(served, ls, lambda: np.array([1, 9, 3, 7],
                                                          np.float32),
                             batch_id=2)
        with pytest.raises(RuntimeError, match="accuracy"):
            audit.ShadowAuditor(reg, every=1).check_labels(
                served, ls, lambda: served)
        return same, off, s.last_agreement, s.snapshot()

    t, j = both(run)
    assert t == j
    assert t[0] and not t[1] and t[2] == pytest.approx(2 / 3)
    assert t[3]["agreement"]["count"] == 2 and t[3]["divergences"] == 1
