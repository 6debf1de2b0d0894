"""The port's operator layer against the JAX server's, on the CPU.

* **Explain reports.**  The same data, queries and configuration through
  both servers give byte-equal ``deterministic_json`` reports: the
  stable subset (batch, request digests, routing bounds and threshold,
  bucket keep, prediction working) holds no iteration count, so the two
  packages' random streams do not enter.  The points and queries lie on
  an integer grid small enough that every f32 distance is exact, and the
  routing summaries are the stores' incrementally maintained ones (host
  f64, bit-equal between the packages); so the digests of the answers
  and every bound agree bit for bit.  A request repeated at the same
  key and generation gives the same string again.
* **Traces.**  One request's span forest carries the same span names in
  both servers; dispatch trees nest their stages.
* **SLOs, the endpoint, the shadow audit.**  A forced latency breach
  fires and clears in both; the config-bound endpoint serves the
  registry; a corrupted router is caught by the bytes-mode shadow replay
  in both; the ensemble's accuracy audit agrees with the JAX server's.
* **No sync for observability.**  The kernel entry points are called as
  often, and ``host_syncs`` is the same, with tracing, explain and SLOs
  on as off; the shadow replay adds calls but no served host sync, and
  its launches are counted apart.
"""

import io
import json
import time
import urllib.request

import numpy as np
import pytest
import torch

from repro.configs.knn_service import CONFIG as JCONFIG
from repro.obs.explain import deterministic_json as jdeterministic_json
from repro.runtime import KnnServer as JaxServer
from repro.store import MutableStore as JaxStore
from repro_torch.configs import CONFIG
from repro_torch.kernels import _cuda
from repro_torch.kernels import ops as tops
from repro_torch.obs import build_trees
from repro_torch.obs.explain import SCHEMA, deterministic_json, export_jsonl
from repro_torch.obs.export import parse_prometheus_text
from repro_torch.runtime import KnnServer
from repro_torch.runtime import knn_server as tserver
from repro_torch.store import MutableStore

torch.set_num_threads(1)

K = 8
DIM = 8
CAP = 96
L_MAX = 16
NUM_CLASSES = 5


def grid_data(seed=3, n=512):
    """Integer-valued clustered points (one cluster a shard's worth),
    labels by cluster, and integer queries near the centres: every
    squared distance is an integer below 2^24, exact in f32."""
    rng = np.random.default_rng(seed)
    centers = rng.integers(-300, 300, size=(K, DIM))
    owner = np.repeat(np.arange(K), n // K)
    pts = (centers[owner] + rng.integers(-40, 41, size=(n, DIM))).astype(
        np.float32)
    labels = (owner % NUM_CLASSES).astype(np.float32)
    qs = (centers[rng.integers(0, K, 12)]
          + rng.integers(-30, 31, size=(12, DIM))).astype(np.float32)
    return pts, labels, qs


def _kw(**kw):
    return dict(dim=DIM, l=8, l_max=L_MAX, bucket_sizes=(4, 8),
                num_classes=NUM_CLASSES, **kw)


# the servers whose reports are compared: static or store-backed
REPORT_CASES = {
    "static_exact": (False, {}),
    "static_gather": (False, dict(sampler="gather")),
    "store_pruned_approx": (True, dict(route="pruned", search="approx",
                                       index_buckets=4)),
    "store_pruned_device": (True, dict(route="pruned",
                                       route_compute="device",
                                       summary_pivots=2)),
    "store_vote": (True, dict(route="pruned", predict="vote")),
    "store_ensemble": (True, dict(route="pruned", predict="vote",
                                  predict_mode="ensemble")),
    "store_regress": (True, dict(predict="regress")),
}


def _pair(mesh8, case, **extra):
    """(port server, JAX server) over the same grid data."""
    stored, kw = REPORT_CASES[case]
    kw = _kw(**{**kw, **extra})
    pts, labels, qs = grid_data()
    tcfg, jcfg = CONFIG.replace(**kw), JCONFIG.replace(**kw)
    if not stored:
        lab = labels if kw.get("predict", "none") != "none" else None
        return (KnnServer(pts, labels=lab, cfg=tcfg, shards=K,
                          device="cpu"),
                JaxServer(pts, labels=lab, cfg=jcfg, mesh=mesh8,
                          axis_name="x"), qs)
    skw = tcfg.replace(store_capacity_per_shard=CAP).store_kwargs()
    ts = MutableStore(DIM, device="cpu", **skw)
    js = JaxStore(DIM, mesh=mesh8, axis_name="x", **skw)
    gone = np.arange(0, len(pts), 9)
    for st in (ts, js):
        st.insert(pts, labels=labels if st.with_labels else None)
        st.flush()
        st.delete(gone)                        # tombstones, no repack
        st.flush()
    return (KnnServer(store=ts, cfg=tcfg, device="cpu"),
            JaxServer(store=js, cfg=jcfg), qs)


@pytest.mark.parametrize("case", sorted(REPORT_CASES))
def test_explain_json_byte_equal_to_jax(mesh8, case):
    tsrv, jsrv, qs = _pair(mesh8, case)
    ls = [1, 4, 8, 16, 3, 16, 2, 5, 7, 16, 1, 9]
    tres, jres = tsrv.query_batch(qs, ls), jsrv.query_batch(qs, ls)
    for a, b in zip(tres, jres):
        ta, jb = a.explain(), b.explain()
        assert ta["schema"] == jb["schema"] == SCHEMA
        assert set(ta) == set(jb)
        assert deterministic_json(ta) == jdeterministic_json(jb)
        assert ta["maintenance"]["raced_commit"] is False
    if case == "store_pruned_approx":
        rep = tres[0].explain()
        assert rep["index"]["kept_matches_recompute"]
        assert rep["routing"]["kept_shards"]
    if case == "store_ensemble":
        rep = tres[3].explain()["predict"]
        assert len(rep["shard_answers"]) == K and rep["local_k"] >= 1
    # the same requests again: new batches, the same stable reports
    for a, b in zip(tres, tsrv.query_batch(qs, ls)):
        assert a.explain()["batch"]["id"] != b.explain()["batch"]["id"]
        assert deterministic_json(a.explain()) == deterministic_json(
            b.explain())
    tsrv.close()
    jsrv.close()


def test_explain_report_sections_and_recompute(mesh8):
    tsrv, _, qs = _pair(mesh8, "store_pruned_approx")
    rep = tsrv.query_batch(qs[:1], [4])[0].explain()
    assert set(rep) == {"schema", "batch", "request", "routing", "index",
                        "predict", "timings", "maintenance"}
    assert rep["predict"] == {"enabled": False}
    kept = [s["shard"] for s in rep["routing"]["shards"] if s["kept"]]
    assert kept == rep["routing"]["kept_shards"]
    assert rep["batch"]["shards_touched"] == len(
        rep["routing"]["batch_active_shards"])
    for s in rep["routing"]["shards"]:
        assert (s["lower"] <= rep["routing"]["threshold_eff"]) == s["kept"]
    assert rep["index"]["kept_buckets"]
    assert rep["timings"]["latency_s"] > 0.0
    assert rep["maintenance"]["commits_before"] == 0


def test_explain_capture_holds_no_tensor(mesh8):
    """A capture keeps host arrays and frozen host metadata only: the
    ring of 256 pins no device generation."""
    for case in ("store_pruned_device", "store_ensemble", "static_exact"):
        tsrv, _, qs = _pair(mesh8, case)
        res = tsrv.query_batch(qs[:4], [4] * 4)
        cap = res[0].explain_ref.capture
        for name in cap.__slots__:
            v = getattr(cap, name)
            assert not isinstance(v, torch.Tensor), (case, name)
            if isinstance(v, tuple):
                assert not any(isinstance(x, torch.Tensor) for x in v)
        assert isinstance(cap.queries, np.ndarray)


def test_explain_last_ring_and_jsonl_export(mesh8):
    tsrv, _, qs = _pair(mesh8, "static_exact")
    tsrv.query_batch(qs[:3], [4, 4, 4])
    reports = tsrv.explain_last(2)
    assert len(reports) == 2 and all(r["schema"] == SCHEMA for r in reports)
    assert tsrv.explain_last(0) == []
    buf = io.StringIO()
    assert export_jsonl(tsrv.explain_last(3), buf) == 3
    lines = [json.loads(x) for x in buf.getvalue().splitlines()]
    assert [r["request"]["row"] for r in lines] == [0, 1, 2]


# ---- traces -----------------------------------------------------------------

def _forest(srv):
    recs = srv.obs.tracer.spans()
    build_trees(recs)
    by_id = {r["span"]: r for r in recs}
    edges = sorted((by_id[r["parent"]]["name"], r["name"]) for r in recs
                   if r["parent"] is not None)
    return edges, recs


# the port's phases of a batch, children of its "kernel" span
PHASES = ("topl", "prune", "select", "gather", "readback", "predict")


@pytest.mark.parametrize("case", ["store_pruned_approx", "store_ensemble",
                                  "static_exact"])
def test_span_forest_names_match_jax(mesh8, case):
    tsrv, jsrv, qs = _pair(mesh8, case, obs_trace=True, obs_audit_every=1)
    for srv in (tsrv, jsrv):
        srv.query_batch(qs[:3], [4, 4, 4])
        assert srv.obs.tracer.active_count() == 0
    (tedges, trecs), (jedges, _) = _forest(tsrv), _forest(jsrv)
    # the reference's forest is the port's less the phases under kernel
    assert set(jedges) <= set(tedges)
    assert set(tedges) - set(jedges) <= {("kernel", p) for p in PHASES}
    kernel = [r for r in trecs if r["name"] == "kernel"][-1]
    phases = sorted((r for r in trecs if r["parent"] == kernel["span"]),
                    key=lambda r: r["t0"])
    if case == "static_exact":
        # the plain selection path: Algorithm 2's phases, then the readback
        assert [r["name"] for r in phases] == ["topl", "prune", "select",
                                               "gather", "readback"]
        assert phases[2]["attrs"]["host_syncs"] >= 1
    # on the CPU no phase has device time
    assert phases and not any("device_s" in r.get("attrs", {})
                              for r in phases)
    requests = [r for r in trecs if r["name"] == "request"]
    assert len(requests) == 3
    dispatch = [r for r in trecs if r["name"] == "dispatch"][-1]
    assert dispatch["attrs"]["n_real"] == 3
    serves = [r for r in trecs if r["name"] == "serve"]
    assert {r["attrs"]["batch"] for r in serves} == {
        dispatch["attrs"]["batch"]}


# ---- SLOs, the endpoint, the audits -----------------------------------------

def test_server_forced_breach_slo_fires_and_clears(mesh8):
    extra = dict(slo_latency_p99_s=1e-9, slo_fast_window_s=0.3,
                 slo_slow_window_s=0.9)
    tsrv, jsrv, qs = _pair(mesh8, "static_exact", **extra)
    for srv in (tsrv, jsrv):
        srv.query_batch(qs[:8], [4] * 8)       # 8 bad events
        snap = srv.obs_snapshot()["slo"]
        assert snap["alerts_fired"] >= 1 and "latency_p99" in snap["firing"]
        deadline = time.perf_counter() + 15
        while snap["alerts_cleared"] == 0 and time.perf_counter() < deadline:
            time.sleep(0.05)
            snap = srv.obs_snapshot()["slo"]
        assert snap["alerts_cleared"] >= 1 and snap["firing"] == []
        srv.close()


def test_server_http_endpoint_from_config(mesh8):
    tsrv, jsrv, qs = _pair(mesh8, "static_exact", obs_http_port=-1)
    try:
        parsed = {}
        for name, srv in (("torch", tsrv), ("jax", jsrv)):
            srv.query_batch(qs[:2], [4, 4])
            url = f"http://127.0.0.1:{srv._http.port}/metrics"
            with urllib.request.urlopen(url, timeout=10) as r:
                parsed[name] = parse_prometheus_text(r.read().decode())
        assert parsed["torch"]["knn_serve_latency_s"]["count"] == 2
        shared = set(parsed["torch"]) & set(parsed["jax"])
        assert "knn_serve_latency_s" in shared
        for name in shared:
            assert parsed["torch"][name]["type"] == parsed["jax"][name][
                "type"]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{tsrv._http.port}/obs", timeout=10) as r:
            assert json.loads(r.read().decode())["server"]["queries"] == 2
    finally:
        tsrv.close()
        jsrv.close()
    assert not tsrv._http._thread.is_alive()


def test_shadow_auditor_catches_injected_routing_corruption(mesh8,
                                                            monkeypatch):
    """Route every batch to shard 0 alone: the bytes-mode replay, every
    shard active, must flag the answers the corrupted router lost, in
    the port as in the JAX server."""
    from repro.store import summaries as jsumm
    tsrv, jsrv, qs = _pair(mesh8, "store_pruned_approx", search="exact",
                           obs_audit_every=1)

    def corrupt(real):
        def route(summ, q, l_arr, slack):
            out = np.zeros_like(real(summ, q, l_arr, slack=slack))
            out[:, 0] = True
            return out
        return route

    monkeypatch.setattr(tserver.summaries_mod, "route_shards",
                        corrupt(tserver.summaries_mod.route_shards))
    monkeypatch.setattr(jsumm, "route_shards", corrupt(jsumm.route_shards))
    for srv in (tsrv, jsrv):
        for c in range(3):
            srv.query_batch(qs[4 * c:4 * c + 4], [4] * 4)
        shadow = srv.obs_snapshot()["audit"]["shadow"]
        assert shadow["mode"] == "bytes" and shadow["checks"] == 3
        assert shadow["divergences"] >= 1
        assert shadow["details"][0]["batch_id"] >= 0
    monkeypatch.undo()
    clean, _, _ = _pair(mesh8, "store_pruned_approx", search="exact",
                        obs_audit_every=1)
    clean.query_batch(qs[:4], [4] * 4)
    assert clean.obs_snapshot()["audit"]["shadow"]["divergences"] == 0


def test_ensemble_accuracy_audit_matches_jax(mesh8):
    tsrv, jsrv, qs = _pair(mesh8, "store_ensemble", obs_audit_every=1,
                           accuracy_floor=0.9, slo_label_agreement_floor=0.5)
    snaps = []
    for srv in (tsrv, jsrv):
        for c in range(3):
            srv.query_batch(qs[4 * c:4 * c + 4], [5, 9, 16, 1])
        snaps.append(srv.obs_snapshot())
    ts, js = (s["audit"]["shadow"] for s in snaps)
    assert ts["mode"] == js["mode"] == "accuracy"
    for key in ("checks", "divergences", "floor", "agreement"):
        assert ts[key] == js[key], key
    assert ts["checks"] == 3
    assert snaps[0]["slo"]["objectives"]["label_agreement"] == snaps[1][
        "slo"]["objectives"]["label_agreement"]


# ---- observability adds no sync ---------------------------------------------

def _count_entry_points(monkeypatch):
    calls = {}
    for name in ("distance_topk", "l2_distance", "local_topk",
                 "route_index"):
        real = getattr(tops, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*a, **kw)
        monkeypatch.setattr(tops, name, counted)
    return calls


@pytest.mark.parametrize("case", ["store_pruned_device",
                                  "store_pruned_approx", "static_gather"])
def test_obs_on_and_off_equal_calls_and_host_syncs(mesh8, monkeypatch,
                                                   case):
    """Tracing, explain and an SLO on: the kernel entry points are called
    as often and every answer reports the same host_syncs as with all
    off.  The shadow replay adds its own calls, but no served sync."""
    calls = _count_entry_points(monkeypatch)
    on = dict(obs_trace=True, slo_latency_p99_s=10.0)
    runs = {}
    for name, extra in (("off", {}), ("on", on),
                        ("audit", dict(on, obs_audit_every=1))):
        srv, _, qs = _pair(mesh8, case, **extra)
        calls.clear()
        res = srv.query_batch(qs, [4, 16, 1, 8] * 3)
        runs[name] = (dict(calls), [r.host_syncs for r in res],
                      [r.ids.tobytes() for r in res])
    assert runs["on"] == runs["off"]
    assert runs["audit"][1:] == runs["off"][1:]
    replayed = sum(runs["audit"][0].values()) - sum(runs["off"][0].values())
    # only routed or indexed batches are replayed
    assert replayed > 0 if case.startswith("store") else replayed == 0


def test_counted_apart_keeps_the_main_counts():
    counter = _cuda.LaunchCounter("probe")
    counter.add()
    with tops.counted_apart() as tally:
        counter.add()
        counter.add()
        with tops.counted_apart() as inner:
            counter.add()
        counter.add()
    counter.add()
    assert counter.n == 2
    assert tally == {"probe": 3} and inner == {"probe": 1}
