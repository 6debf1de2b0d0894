"""The whole slice on the CPU: the port's KnnServer against the JAX one.

Both servers get the same points (8 x 512, dim 32), queries and
heterogeneous ls, for both samplers.  Answers: sorted distances within
f32 tolerance; ids equal, except where the true l-th and (l+1)-th
distances lie within tolerance, where only the strict interior is
compared.  Bills: equal for the gather sampler; inside the Theorem-1
envelope for the selection sampler (the random streams differ).
"""

import numpy as np
import pytest
import torch

from repro.configs.knn_service import CONFIG as JCONFIG
from repro.runtime import KnnServer as JaxServer
from repro.store import MutableStore as JaxStore
from repro_torch import convert
from repro_torch.configs import CONFIG
from repro_torch.runtime import KnnServer
from repro_torch.runtime import knn_server as tserver
from repro_torch.store import MutableStore

# the cases are small: one intra-op thread a process is faster here than
# a pool, and leaves the cores to the other test processes
torch.set_num_threads(1)

K = 8
DIM = 32
N = K * 512
L_MAX = 16
KW = dict(dim=DIM, l=8, l_max=L_MAX, bucket_sizes=(4, 8))
TOL = dict(rtol=1e-4, atol=1e-3)
INT32_MAX = 2**31 - 1


@pytest.fixture(scope="module")
def pts():
    return np.random.default_rng(5).normal(size=(N, DIM)).astype(np.float32)


def _port(pts, **kw):
    return KnnServer(pts, cfg=CONFIG.replace(**{**KW, **kw}), shards=K,
                     device="cpu")


def _jax(pts, mesh, **kw):
    return JaxServer(pts, cfg=JCONFIG.replace(**{**KW, **kw}), mesh=mesh,
                     axis_name="x")


def _brute(points, q):
    d = ((q[None, :] - points) ** 2).sum(-1)
    order = np.argsort(d, kind="stable")
    return d[order], order


def _same_answer(points, q, a, b):
    """Two servers' answers to one request agree (see module docstring),
    and both equal brute force."""
    l = a.l
    assert b.l == l and len(a.ids) == len(b.ids) == l
    np.testing.assert_allclose(a.dists, b.dists, **TOL)
    bd, bi = _brute(points, q)
    np.testing.assert_allclose(a.dists, bd[:l], **TOL)
    assert np.all(a.ids < N) and np.all(b.ids < N)      # no padding leaks
    tol = TOL["atol"] + TOL["rtol"] * bd[l - 1]
    if bd[l] - bd[l - 1] > tol:
        assert set(a.ids.tolist()) == set(b.ids.tolist()) == set(
            bi[:l].tolist())
    else:
        inner = set(bi[:l][bd[:l] < bd[l - 1] - tol].tolist())
        assert inner <= set(a.ids.tolist()) and inner <= set(b.ids.tolist())


@pytest.mark.parametrize("sampler", ["selection", "gather"])
def test_server_matches_jax(mesh8, rng, pts, sampler):
    qs = rng.normal(size=(11, DIM)).astype(np.float32)
    ls = [1, 3, 16, 7, 12, 16, 2, 9, 5, 16, 1]     # 11 -> buckets 8 + 4
    jsrv, tsrv = _jax(pts, mesh8, sampler=sampler), _port(pts,
                                                          sampler=sampler)
    jres, tres = jsrv.query_batch(qs, ls), tsrv.query_batch(qs, ls)
    for q, a, b in zip(qs, tres, jres):
        _same_answer(pts, q, a, b)
        assert a.bucket == b.bucket
        if sampler == "gather":
            assert (a.rounds, a.messages) == (b.rounds, b.messages)
            assert a.iterations == b.iterations == 0
        else:
            assert a.iterations <= 8 * int(np.ceil(np.log2(K * L_MAX))) + 16
            assert a.survivors >= a.l
    # the port's phase sums are its own: the step's device time (none on
    # the CPU), the Algorithm 1 loop's host wall (none under gather) and
    # the gather merge's (none under selection)
    tsnap = tsrv.stats.snapshot()
    assert tsnap.pop("topl_device_s") == 0.0
    assert (tsnap.pop("select_s") > 0.0) == (sampler == "selection")
    assert (tsnap.pop("merge_s") > 0.0) == (sampler == "gather")
    assert tsnap == {
        k: v for k, v in jsrv.stats.snapshot().items()
        if k != "invalid_touched"}
    audit = tsrv.obs_snapshot()["audit"]["contract"]
    assert audit["checks"] == 2 and audit["violations"] == 0


def test_accounting_matches_jax(mesh8, pts):
    """The bill formula is the reference server's _accounting."""
    from repro_torch.parallel.collectives import accounting
    for sampler in ("selection", "gather"):
        jsrv = _jax(pts, mesh8, sampler=sampler)
        for it in (0, 3, 17):
            assert accounting(sampler=sampler, iterations=it, touched=K,
                              l_max=L_MAX, use_sampling=True) == \
                jsrv._accounting(it, K)


def test_server_padding_no_leak(rng, pts):
    """A query answered alone equals the same query inside a padded batch."""
    srv = _port(pts)
    q = rng.normal(size=(DIM,)).astype(np.float32)
    alone = srv.query_batch(q[None], [16])[0]
    crowd = srv.query_batch(
        np.stack([q, *rng.normal(size=(2, DIM)).astype(np.float32)]),
        [16, 3, 9])[0]
    np.testing.assert_allclose(alone.dists, crowd.dists, rtol=1e-6)
    assert set(alone.ids.tolist()) == set(crowd.ids.tolist())


def test_determinism_across_fresh_instances(rng, pts):
    """Same seed => byte-identical answers and iteration counts."""
    qs = rng.normal(size=(5, DIM)).astype(np.float32)
    ls = [1, 3, 16, 11, 8]
    a, b = _port(pts), _port(pts)
    b.warmup()
    for ra, rb in zip(a.query_batch(qs, ls), b.query_batch(qs, ls)):
        assert ra.dists.tobytes() == rb.dists.tobytes()
        assert np.array_equal(ra.ids, rb.ids)
        assert ra.iterations == rb.iterations
        assert ra.host_syncs == rb.host_syncs == ra.iterations + 4


def test_values_lookup_with_sentinel_slots(mesh8, rng):
    """More neighbors than points: sentinel slots map to -1, as in the
    reference server."""
    small = rng.normal(size=(K * 2, DIM)).astype(np.float32)
    vals = np.arange(K * 2, dtype=np.int32) * 3
    cfg = dict(l_max=32, bucket_sizes=(1,))
    q = rng.normal(size=(1, DIM)).astype(np.float32)
    jr = JaxServer(small, vals, cfg=JCONFIG.replace(**{**KW, **cfg}),
                   mesh=mesh8, axis_name="x").query_batch(q, [32])[0]
    tr = KnnServer(small, vals, cfg=CONFIG.replace(**{**KW, **cfg}),
                   device="cpu").query_batch(q, [32])[0]
    assert np.all(np.isinf(tr.dists[K * 2:]))
    assert np.all(tr.ids[K * 2:] == INT32_MAX)
    assert np.array_equal(tr.values, jr.values)
    assert sorted(tr.values[:K * 2].tolist()) == vals.tolist()


@pytest.mark.parametrize("with_values", [False, True])
def test_with_values_and_close_match_jax(mesh8, rng, pts, with_values):
    """with_values follows the static values= argument on both servers;
    close() stops a serving server and a stopped one, twice each, and a
    closed server still answers synchronously."""
    vals = np.arange(N, dtype=np.int32) if with_values else None
    port = KnnServer(pts, vals, cfg=CONFIG.replace(**KW), shards=K,
                     device="cpu")
    ref = JaxServer(pts, vals, cfg=JCONFIG.replace(**KW), mesh=mesh8,
                    axis_name="x")
    assert port.with_values is ref.with_values is with_values
    q = rng.normal(size=(DIM,)).astype(np.float32)
    for srv in (port, ref):
        srv.start()
        fut = srv.submit(q, 4)
        srv.close()
        srv.close()
        assert fut.done() and len(fut.result(timeout=0).ids) == 4
    stopped = KnnServer(pts, vals, cfg=CONFIG.replace(**KW), shards=K,
                        device="cpu")
    stopped.close()
    stopped.close()
    res = port.query_batch(q[None], [4])[0]
    assert (res.values is not None) is with_values


def test_rejects_bad_requests(pts):
    srv = _port(pts)
    with pytest.raises(ValueError):
        srv.submit(np.zeros(DIM, np.float32), 0)
    with pytest.raises(ValueError):
        srv.submit(np.zeros(DIM, np.float32), L_MAX + 1)
    with pytest.raises(ValueError):
        srv.submit(np.zeros(DIM + 1, np.float32), 4)
    with pytest.raises(ValueError, match="route_compute"):
        _port(pts, route_compute="gpu")
    with pytest.raises(ValueError, match="divide"):
        KnnServer(pts[:-1], cfg=CONFIG.replace(**KW), device="cpu")
    with pytest.raises(ValueError, match="divide"):
        convert.shards_from_numpy(pts[:-3], K)
    srv.flush()


@pytest.mark.parametrize("knob,error,match", [
    (dict(predict="regress", sampler="gather"), ValueError,
     "needs sampler='selection'"),
    (dict(slo_recall_floor=0.9), None, "recall_min"),
    (dict(predict="vote", predict_mode="ensemble", search="approx"),
     ValueError, "requires search='exact'"),
    (dict(predict="vote", predict_mode="ensemble", route="pruned",
          route_compute="device"), ValueError, "route_compute='host'"),
    (dict(obs_trace=True), None, "trace"),
    (dict(obs_audit_every=4), None, "shadow"),
    (dict(obs_http_port=-1), None, "http"),
    (dict(slo_latency_p99_s=0.5), None, "latency_p99"),
    (dict(slo_contract_violations=True), None, "contract")])
def test_out_of_slice_knobs_raise(mesh8, pts, knob, error, match):
    """Prediction's invalid combinations raise the reference's
    ValueErrors, as the JAX server does.  The operator knobs (tracing,
    the shadow audit, the endpoint, the SLOs) were refused until the
    operator layer was ported; now each builds the same plane as the JAX
    server's: both answer alike and report the same tracer state, audit
    period, endpoint presence and declared objectives."""
    if error is not None:
        with pytest.raises(error, match=match):
            _port(pts, **knob)
        with pytest.raises(ValueError, match=match):
            _jax(pts, mesh8, **knob)
        return
    tsrv, jsrv = _port(pts, **knob), _jax(pts, mesh8, **knob)
    try:
        qs = pts[:4] + np.float32(0.01)
        for q, a, b in zip(qs, tsrv.query_batch(qs, [4] * 4),
                           jsrv.query_batch(qs, [4] * 4)):
            _same_answer(pts, q, a, b)
        ts, js = tsrv.obs_snapshot(), jsrv.obs_snapshot()
        assert ts["trace"]["enabled"] == js["trace"]["enabled"]
        assert ts["audit"]["shadow"]["every"] == js["audit"]["shadow"][
            "every"]
        assert set(ts["slo"]["objectives"]) == set(js["slo"]["objectives"])
        assert (tsrv._http is None) == (jsrv._http is None)
        shown = {"trace": ts["trace"]["enabled"],
                 "shadow": ts["audit"]["shadow"]["every"] == 4,
                 "http": tsrv._http is not None and tsrv._http.port > 0}
        assert shown.get(match, match in ts["slo"]["objectives"])
    finally:
        tsrv.close()
        jsrv.close()


@pytest.mark.parametrize("case", ["points_and_store", "later_items"])
def test_out_of_slice_arguments_raise(mesh8, pts, case):
    """points or labels with store= is an error, as in the reference; the
    store's background maintenance, refused until it was ported, runs
    and holds the JAX background store's live set; the label payload (a
    store's with_labels, a static server's labels=) is served, and
    predicting without it is the reference's ValueError."""
    if case == "points_and_store":
        st = MutableStore(DIM, capacity_per_shard=N // K, device="cpu")
        with pytest.raises(ValueError, match="not both"):
            KnnServer(pts, store=st, cfg=CONFIG.replace(**KW), device="cpu")
        with pytest.raises(ValueError, match="not both"):
            KnnServer(labels=np.zeros(N, np.float32), store=st,
                      cfg=CONFIG.replace(**KW), device="cpu")
        with pytest.raises(ValueError, match="labeled store"):
            KnnServer(store=st, cfg=CONFIG.replace(predict="vote", **KW),
                      device="cpu")
        return
    bg = MutableStore(DIM, capacity_per_shard=8, device="cpu",
                      maintenance="background")
    jbg = JaxStore(DIM, capacity_per_shard=8, mesh=mesh8, axis_name="x",
                   maintenance="background")
    for st in (bg, jbg):
        st.insert(pts[:12])
        st.flush()
        st.close()
        assert st.maintenance_stats()["worker"]["errors"] == 0
    for a, b in zip(bg.live_arrays(), jbg.live_arrays()):
        assert np.array_equal(a, b)
    st = MutableStore(DIM, capacity_per_shard=8, device="cpu",
                      with_labels=True)
    st.insert(pts[:4], labels=[1.0, 2.0, 3.0, 4.0])
    st.flush()
    assert st.with_labels and st.labels_for([2, 9]).tolist()[0] == 3.0
    with pytest.raises(ValueError, match="labels= constructor"):
        KnnServer(pts, cfg=CONFIG.replace(predict="vote", **KW),
                  device="cpu")
    labels = np.arange(N, dtype=np.float32) % 4
    srv = KnnServer(pts, labels=labels,
                    cfg=CONFIG.replace(predict="vote", num_classes=4, **KW),
                    device="cpu")
    assert srv.with_labels
    res = srv.query_batch(pts[7][None], [1])[0]
    assert res.ids[0] == 7 and res.label == labels[7]
    assert res.predict_mode == "exact" and res.confidence == 1.0
    np.testing.assert_array_equal(srv.labels_for([7, INT32_MAX]),
                                  [labels[7], np.nan])


def test_device_none_means_the_card(monkeypatch, pts):
    """No card: device=None raises rather than taking the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        KnnServer(pts, cfg=CONFIG.replace(**KW))
    assert tserver.resolve_device("cpu") == torch.device("cpu")


def test_background_batcher_and_stop_drains(rng, pts):
    """Futures submitted while the micro-batcher runs resolve to the
    synchronous answers; stop() drains every pending request once."""
    srv = _port(pts, max_wait_ms=20.0)
    qs = rng.normal(size=(10, DIM)).astype(np.float32)
    want = srv.query_batch(qs, [8] * 10)
    srv.start()
    futs = [srv.submit(q, 8) for q in qs]
    srv.stop()
    assert all(f.done() for f in futs)
    for f, w in zip(futs, want):
        np.testing.assert_allclose(f.result(timeout=0).dists, w.dists,
                                   rtol=1e-6)
    assert srv.stats.queries == 20
    with srv.serving():
        r = srv.submit(qs[0], 8).result(timeout=60)
    np.testing.assert_allclose(r.dists, want[0].dists, rtol=1e-6)


def test_envelopes_report_the_plain_path_on_cpu(pts):
    srv = _port(pts)
    assert [e["bucket_b"] for e in srv.envelopes] == [4, 8]
    assert all(e["path"] == "plain" for e in srv.envelopes)
    assert all(e["select_path"] == "host_loop" for e in srv.envelopes)


def test_device_loop_counts_ride_with_the_answers(monkeypatch, rng, pts):
    """With a stand-in for Algorithm 1's device loop (the host loop's
    thresholds, per-row counts left as a tensor and no sync): the same
    answers as the host loop; the batch's iterations the largest row's,
    read in the survivors' transfer, so a batch makes its 3 readbacks and
    no loop sync; the kernel span carries the count."""
    from repro_torch.core import selection

    def stand_in(v, i, l, gen, *, valid=None, max_iterations,
                 num_pivots=1):
        r = selection.host_loop(v, i, l, gen, valid=valid,
                                max_iterations=max_iterations)
        return r.threshold_v, r.threshold_i, r.converged, r.row_iterations

    qs = rng.normal(size=(6, DIM)).astype(np.float32)
    ls = [1, 3, 16, 11, 8, 16]
    host = _port(pts).query_batch(qs, ls)
    monkeypatch.setattr(selection.kops, "select_path",
                        lambda v: selection.kops.DEVICE_LOOP)
    monkeypatch.setattr(selection.kops, "select_loop", stand_in)
    srv = KnnServer(pts, cfg=CONFIG.replace(obs_trace=True, **KW),
                    device="cpu", seed=0)
    dev = srv.query_batch(qs, ls)
    for a, b in zip(dev, host):
        assert a.dists.tobytes() == b.dists.tobytes()
        assert np.array_equal(a.ids, b.ids)
        assert a.iterations == b.iterations > 0
        assert a.survivors == b.survivors
        assert a.host_syncs == 3 == b.host_syncs - b.iterations - 1
    spans = srv.obs.tracer.spans()
    kern = [r for r in spans if r["name"] == "kernel"]
    assert kern and all(isinstance(r["attrs"]["iterations"], int)
                        for r in kern)
    assert {r["attrs"]["iterations"] for r in kern} == {
        r.iterations for r in dev}
    assert all("iterations" not in r["attrs"] for r in spans
               if r["name"] == "select")
