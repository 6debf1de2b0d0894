"""The port's mutable store and its store-backed server against the JAX
reference, on the CPU.

* **Mirrors.**  One op stream (numpy seeds) drives ``repro.store.
  MutableStore`` (mesh8) and the port's (``device="cpu"``); after every
  flush the host mirrors, slot map, per-shard counts, ``stats``,
  ``generation`` and ``live_arrays()`` are equal exactly, and the
  snapshot tensors equal the JAX snapshot arrays exactly.
* **Answers.**  The port's store-backed server and the JAX one answer the
  same requests at every generation: ids equal as sets (the distances
  are a.s. distinct), distances within ``TOL`` (the tolerance of
  tests/test_torch_server.py), generations equal; and every answer is
  the brute-force l-NN of the live set of the generation it reports.
* The reference's cases (tests/test_store.py), each on the port: staging
  invisible until flush, auto-flush, atomic staging, ``StoreFullError``,
  single-use ids, values follow mutations, both compaction triggers,
  forced and id-stable compaction, epoch swap under load, exactness per
  generation and the empty store; and a snapshot captured before a flush
  is unchanged after it.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from repro.configs.knn_service import CONFIG as JCONFIG
from repro.runtime import KnnServer as JaxServer
from repro.store import MutableStore as JaxStore
from repro_torch.configs import CONFIG
from repro_torch.obs import MetricsRegistry, ObsPlane
from repro_torch.runtime import KnnServer
from repro_torch.store import MutableStore, StoreFullError

# the cases are small: one intra-op thread a process is faster here than
# a pool, and leaves the cores to the other test processes
torch.set_num_threads(1)

K = 8
DIM = 4
CAP = 32                      # slots per shard -> 256 total
NEVER = 10**9                 # staging_size that never auto-flushes
TOL = dict(rtol=1e-4, atol=1e-3)
_SENTINEL = 2**31 - 1


def _mk_store(**kw):
    kw.setdefault("staging_size", NEVER)
    return MutableStore(DIM, capacity_per_shard=CAP, device="cpu", **kw)


def _mk_jstore(mesh, **kw):
    kw.setdefault("staging_size", NEVER)
    return JaxStore(DIM, capacity_per_shard=CAP, mesh=mesh, axis_name="x",
                    **kw)


def _cfg(**kw):
    return dict(dim=DIM, l=8, l_max=16, bucket_sizes=(4,), **kw)


def _mk_server(store, **kw):
    return KnnServer(store=store, cfg=CONFIG.replace(**_cfg(**kw)),
                     device="cpu")


def _mk_jserver(store, **kw):
    return JaxServer(store=store, cfg=JCONFIG.replace(**_cfg(**kw)))


def _brute_ids(ids, pts, q, l):
    """Set of the l nearest live ids (distances are a.s. distinct)."""
    if len(ids) == 0:
        return set()
    d = ((q[None] - pts) ** 2).sum(-1)
    return set(np.asarray(ids)[np.argsort(d, kind="stable")[:l]].tolist())


def _check_result(r, live_ids, live_pts, q, l):
    """r's finite slots == brute-force l-NN of the live set; the rest are
    sentinels (deleted points never surface, not even at +inf)."""
    l_eff = min(l, len(live_ids))
    assert set(r.ids[:l_eff].tolist()) == _brute_ids(live_ids, live_pts, q,
                                                     l_eff)
    assert np.all(np.isfinite(r.dists[:l_eff]))
    assert np.all(np.isinf(r.dists[l_eff:]))
    assert np.all(r.ids[l_eff:] == _SENTINEL)


def _same_state(js, ts):
    """The two stores' applied state is equal exactly."""
    for name in ("_pts", "_ids", "_valid", "_live", "_used"):
        a, b = getattr(js, name), getattr(ts, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert js._slot_of == ts._slot_of
    assert js._values == ts._values
    assert js._next_id == ts._next_id and js._used_ids == ts._used_ids
    assert dataclasses.asdict(js.stats) == dataclasses.asdict(ts.stats)
    assert js.generation == ts.generation
    assert np.array_equal(js.live_per_shard, ts.live_per_shard)
    for a, b in zip(js.live_arrays(), ts.live_arrays()):
        assert np.array_equal(a, b)
    jsnap, tsnap = js.snapshot(), ts.snapshot()
    assert jsnap.generation == tsnap.generation and jsnap.live == tsnap.live
    for name in ("points", "ids", "valid"):
        a = np.asarray(getattr(jsnap, name))
        b = getattr(tsnap, name).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), name


def _same_answers(jsrv, tsrv, store, qs, ls):
    """The two servers' answers agree and equal brute force over the
    live set of the generation they report."""
    lid, lpts = store.live_arrays()
    for q, l, a, b in zip(qs, ls, tsrv.query_batch(qs, ls),
                          jsrv.query_batch(qs, ls)):
        assert a.generation == b.generation == store.generation
        assert set(a.ids.tolist()) == set(b.ids.tolist())
        fin = np.isfinite(b.dists)
        assert np.array_equal(np.isfinite(a.dists), fin)
        np.testing.assert_allclose(a.dists[fin], b.dists[fin], **TOL)
        _check_result(a, lid, lpts, q, l)


def _random_op(st, model, rng, *, values=False):
    """One random insert / delete / update / compact on ``st`` (applied to
    the oracle ``model``); the same rng state gives the same op."""
    action = rng.choice(["insert", "delete", "update", "compact"],
                        p=[0.45, 0.25, 0.15, 0.15])
    if action == "insert" or not model:
        n = int(rng.integers(1, min(40, st.total - len(model)) + 1))
        pts = rng.normal(size=(n, DIM)).astype(np.float32)
        vals = rng.integers(0, 1000, n) if values else None
        ids = st.insert(pts, values=vals)
        model.update(zip(ids.tolist(), pts))
    elif action == "delete":
        n = int(rng.integers(1, max(2, len(model) // 2)))
        victims = rng.choice(sorted(model), size=n, replace=False)
        st.delete(victims)
        for v in victims:
            del model[int(v)]
    elif action == "update":
        n = int(rng.integers(1, max(2, len(model) // 2)))
        chosen = rng.choice(sorted(model), size=n, replace=False)
        pts = rng.normal(size=(n, DIM)).astype(np.float32)
        st.update(chosen, pts)
        model.update(zip((int(c) for c in chosen), pts))
    else:
        st.compact()
    return st.flush()


# ---- parity with the reference store ---------------------------------------


STREAMS = {
    "balance": dict(),
    "affinity_proximity": dict(placement="affinity", redeal="proximity",
                               placement_guard_slack=4, summary_pivots=2,
                               retighten_every=16, split_radius_factor=1.0,
                               index_buckets=4, with_values=True),
    "retighten": dict(placement="affinity", summary_pivots=2,
                      retighten_every=4, index_buckets=4),
}
# the maintenance path each stream must have taken
EXPECT = {"balance": "compactions", "affinity_proximity": "splits",
          "retighten": "retightens"}


@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_store_stream_matches_jax(mesh8, stream):
    """One random interleaving on both stores: equal state after every
    flush, equal summaries (bit for bit between exact rebuilds; the
    port's rebuild agrees to f64 rounding, rtol 1e-12), and equal
    answers from both servers (exact route, and the pruned device route
    on the adaptive store, whose answers must be byte-identical to its
    exact route's)."""
    kw = STREAMS[stream]
    js, ts = _mk_jstore(mesh8, **kw), _mk_store(**kw)
    _same_state(js, ts)
    jrng, trng = np.random.default_rng(3), np.random.default_rng(3)
    jmodel, tmodel = {}, {}
    skw = dict(summary_pivots=kw.get("summary_pivots", 1))
    jsrv, tsrv = _mk_jserver(js, **skw), _mk_server(ts, **skw)
    pruned = (_mk_server(ts, route="pruned", route_compute="device", **skw)
              if stream != "balance" else None)
    approx = (_mk_server(ts, search="approx", index_buckets=4,
                         index_oversample=1e9, **skw)
              if "index_buckets" in kw else None)
    qrng = np.random.default_rng(4)
    for _ in range(14):
        jg = _random_op(js, jmodel, jrng, values=ts.with_values)
        tg = _random_op(ts, tmodel, trng, values=ts.with_values)
        assert jg == tg
        _same_state(js, ts)
        a, b = js.summaries(), ts.summaries()
        for f in ("live", "pivot_count", "pivot_live"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
        for f in ("centroids", "radii", "proj_lo", "proj_hi", "pivots",
                  "pivot_radii"):
            if getattr(a, f) is not None:
                np.testing.assert_allclose(getattr(b, f), getattr(a, f),
                                           rtol=1e-12, atol=1e-12)
        qs = qrng.normal(size=(3, DIM)).astype(np.float32)
        _same_answers(jsrv, tsrv, ts, qs, [8, 3, 16])
        if pruned is not None:
            for x, y in zip(tsrv.query_batch(qs, [8, 3, 16]),
                            pruned.query_batch(qs, [8, 3, 16])):
                assert x.dists.tobytes() == y.dists.tobytes()
                assert np.array_equal(x.ids, y.ids)
        if approx is not None:      # every live bucket kept: exact
            for x, y in zip(tsrv.query_batch(qs, [8, 3, 16]),
                            approx.query_batch(qs, [8, 3, 16])):
                assert y.recall_mode == "approx"
                assert x.dists.tobytes() == y.dists.tobytes()
                assert np.array_equal(x.ids, y.ids)
    assert ts.stats.applies == 14
    assert getattr(ts.stats, EXPECT[stream]) > 0


def test_snapshot_unchanged_by_later_flush():
    """A snapshot captured before a flush keeps its contents; the flush's
    generation lives in other tensors."""
    rng = np.random.default_rng(0)
    st = _mk_store()
    ids = st.insert(rng.normal(size=(40, DIM)).astype(np.float32))
    st.flush()
    old = st.snapshot()
    kept = [t.clone() for t in (old.points, old.ids, old.valid)]
    st.delete(ids[:10])
    st.update(ids[10:20], rng.normal(size=(10, DIM)).astype(np.float32))
    st.insert(rng.normal(size=(5, DIM)).astype(np.float32))
    st.flush()
    new = st.snapshot()
    assert new.generation == old.generation + 1
    for was, t, n in zip(kept, (old.points, old.ids, old.valid),
                         (new.points, new.ids, new.valid)):
        assert torch.equal(was, t)
        assert t.data_ptr() != n.data_ptr()
    assert int(old.valid.sum()) == 40 and int(new.valid.sum()) == 35
    st.compact()                                  # the full-upload path
    assert torch.equal(kept[0], old.points)
    assert st.snapshot().points.data_ptr() != new.points.data_ptr()


# ---- the reference's cases on the port -------------------------------------


def test_staged_ops_invisible_until_flush(rng):
    st = _mk_store()
    srv = _mk_server(st)
    q = rng.normal(size=DIM).astype(np.float32)
    st.insert(rng.normal(size=(20, DIM)).astype(np.float32))
    assert st.pending_ops == 20 and st.live_count == 0
    r = srv.query_batch(q[None], [8])[0]
    assert r.generation == 0
    assert np.all(np.isinf(r.dists)) and np.all(r.ids == _SENTINEL)
    gen = st.flush()
    assert gen == 1 and st.pending_ops == 0 and st.live_count == 20
    r = srv.query_batch(q[None], [8])[0]
    assert r.generation == 1
    ids, pts = st.live_arrays()
    _check_result(r, ids, pts, q, 8)


def test_autoflush_at_staging_size(rng):
    st = _mk_store(staging_size=16)
    st.insert(rng.normal(size=(15, DIM)).astype(np.float32))
    assert st.generation == 0
    st.insert(rng.normal(size=(1, DIM)).astype(np.float32))
    assert st.generation == 1 and st.live_count == 16


def test_staging_validation(rng):
    st = _mk_store()
    ids = st.insert(rng.normal(size=(4, DIM)).astype(np.float32))
    with pytest.raises(ValueError):      # duplicate staged id
        st.insert(np.zeros(DIM, np.float32), ids=[int(ids[0])])
    with pytest.raises(KeyError):
        st.delete([999])
    with pytest.raises(KeyError):
        st.update([999], np.zeros((1, DIM), np.float32))
    st.flush()
    st.delete([int(ids[0])])
    with pytest.raises(KeyError):
        st.delete([int(ids[0])])
    st.flush()
    with pytest.raises(ValueError):      # ids are single-use forever
        st.insert(np.zeros(DIM, np.float32), ids=[int(ids[0])])
    new = st.insert(np.zeros(DIM, np.float32))
    assert int(new[0]) > int(ids.max())
    with pytest.raises(ValueError, match="with_values"):
        st.insert(np.zeros(DIM, np.float32), values=[3])


def test_staging_is_atomic_per_call(rng):
    st = _mk_store()
    ids = st.insert(rng.normal(size=(st.total - 2, DIM)).astype(np.float32))
    st.flush()
    with pytest.raises(StoreFullError):
        st.insert(rng.normal(size=(3, DIM)).astype(np.float32))
    assert st.pending_ops == 0
    with pytest.raises(KeyError):
        st.delete([int(ids[0]), 10**6])
    with pytest.raises(KeyError):
        st.delete([int(ids[1]), int(ids[1])])
    with pytest.raises(KeyError):
        st.update([int(ids[0]), 10**6], np.zeros((2, DIM), np.float32))
    assert st.pending_ops == 0
    st.flush()
    assert st.live_count == st.total - 2


def test_store_full_raises_at_staging(rng):
    st = _mk_store()
    st.insert(rng.normal(size=(st.total, DIM)).astype(np.float32))
    with pytest.raises(StoreFullError):
        st.insert(np.zeros(DIM, np.float32))
    st.flush()
    st.delete([0])
    st.insert(np.zeros(DIM, np.float32))
    st.flush()
    assert st.live_count == st.total


def test_update_moves_point(rng):
    st = _mk_store()
    ids = st.insert(rng.normal(size=(32, DIM)).astype(np.float32) + 10.0)
    st.flush()
    srv = _mk_server(st)
    q = rng.normal(size=DIM).astype(np.float32)
    target = int(ids[7])
    srv.update([target], q[None])        # through the server's passthrough
    assert srv.flush_store() == 2
    r = srv.query_batch(q[None], [1])[0]
    assert r.ids[0] == target and r.dists[0] < 1e-6


def test_values_follow_mutations(mesh8, rng):
    """Values ride the store through the server, as on the reference."""
    pts = rng.normal(size=(10, DIM)).astype(np.float32)
    out = []
    for st, mk in ((_mk_store(with_values=True), _mk_server),
                   (_mk_jstore(mesh8, with_values=True), _mk_jserver)):
        srv = mk(st)
        assert srv.with_values
        ids = srv.insert(pts, values=np.arange(100, 110))
        srv.flush_store()
        r = srv.query_batch(pts[3][None], [2])[0]
        assert r.values[0] == 103            # nearest is the point itself
        srv.delete([int(ids[3])])
        srv.flush_store()
        r2 = srv.query_batch(pts[3][None], [2])[0]
        assert 103 not in r2.values.tolist()
        out.append((sorted(r.values.tolist()), sorted(r2.values.tolist()),
                    srv.values_for(np.array([ids[3], 999]))))
    assert out[0][:2] == out[1][:2]
    assert np.array_equal(out[0][2], out[1][2])


def test_store_gather_sampler_agrees(rng):
    st = _mk_store()
    ids = st.insert(rng.normal(size=(120, DIM)).astype(np.float32))
    st.flush()
    st.delete(ids[::3])
    st.flush()
    sel = _mk_server(st)
    gat = _mk_server(st, sampler="gather")
    qs = rng.normal(size=(4, DIM)).astype(np.float32)
    for a, b in zip(sel.query_batch(qs, [8] * 4),
                    gat.query_batch(qs, [8] * 4)):
        np.testing.assert_allclose(a.dists, b.dists, rtol=1e-5)
        assert a.ids.tolist() == b.ids.tolist()


def test_tombstone_compaction_trigger(rng):
    st = _mk_store(compact_tombstone_frac=0.3, compact_imbalance_frac=10.0)
    reg = MetricsRegistry()
    st.attach_obs(ObsPlane(registry=reg))
    ids = st.insert(rng.normal(size=(200, DIM)).astype(np.float32))
    st.flush()
    assert st.stats.compactions == 0
    st.delete(rng.choice(ids, size=120, replace=False))
    st.flush()                           # density 0.6 > 0.3
    assert st.stats.compactions == 1
    assert "tombstone_density" in st.stats.last_compact_reason
    live = st.live_per_shard
    assert live.max() - live.min() <= 1
    srv = _mk_server(st)
    q = rng.normal(size=DIM).astype(np.float32)
    lid, lpts = st.live_arrays()
    _check_result(srv.query_batch(q[None], [8])[0], lid, lpts, q, 8)
    snap = reg.snapshot()
    assert snap["store.applies"] == 2 and snap["store.repacks"] == 1
    assert snap["store.live"] == 80
    assert snap["store.apply_s"]["count"] == 2
    assert snap["store.repack_s"]["count"] == 1
    assert snap["store.compact_trigger.tombstone"] == 1


def test_imbalance_compaction_trigger(rng):
    st = _mk_store(compact_tombstone_frac=10.0, compact_imbalance_frac=0.25)
    ids = st.insert(rng.normal(size=(st.total, DIM)).astype(np.float32))
    st.flush()
    st.delete(ids[::K])                  # empties one shard
    st.flush()
    assert st.stats.compactions == 1
    assert "imbalance" in st.stats.last_compact_reason
    live = st.live_per_shard
    assert live.max() - live.min() <= 1


def test_forced_compaction_reclaims_tombstones(rng):
    st = _mk_store(auto_compact=False)
    ids = st.insert(rng.normal(size=(st.total, DIM)).astype(np.float32))
    st.flush()
    st.delete(ids[: st.total // 2])
    st.flush()                           # tombstones everywhere, no tail
    st.insert(rng.normal(size=(st.total // 4, DIM)).astype(np.float32))
    st.flush()
    assert st.stats.forced_compactions == 1
    assert st.live_count == st.total // 2 + st.total // 4
    ids2, pts2 = st.live_arrays()
    srv = _mk_server(st)
    q = rng.normal(size=DIM).astype(np.float32)
    _check_result(srv.query_batch(q[None], [8])[0], ids2, pts2, q, 8)


def test_compaction_is_id_stable(rng):
    st = _mk_store()
    pts = rng.normal(size=(100, DIM)).astype(np.float32)
    ids = st.insert(pts)
    st.flush()
    ids_b, pts_b = st.live_arrays()
    before = {int(i): p for i, p in zip(ids_b, pts_b)}
    st.compact()
    ids_a, pts_a = st.live_arrays()
    assert sorted(ids_a.tolist()) == sorted(ids.tolist())
    for i, p in zip(ids_a.tolist(), pts_a):
        np.testing.assert_array_equal(p, before[i])


def test_epoch_swap_under_load_drops_nothing(rng):
    """Concurrent submit load across continuous epoch swaps: every future
    resolves, and each answer is exactly the brute-force l-NN of the live
    set of the generation it reports."""
    st = _mk_store(track_history=True)
    st.insert(rng.normal(size=(64, DIM)).astype(np.float32))
    st.flush()
    srv = _mk_server(st)
    srv.warmup()
    stop = threading.Event()

    def mutate():
        r = np.random.default_rng(5)
        while not stop.is_set():
            ids = st.insert(r.normal(size=(8, DIM)).astype(np.float32))
            st.flush()
            st.delete(ids)
            st.flush()

    t = threading.Thread(target=mutate, daemon=True)
    queries = [rng.normal(size=DIM).astype(np.float32) for _ in range(24)]
    with srv.serving():
        t.start()
        futs = [srv.submit(q, 8) for q in queries[:12]]
        results = [f.result(timeout=120) for f in futs]
        st.insert(rng.normal(size=(4, DIM)).astype(np.float32))
        forced_gen = st.flush()
        futs = [srv.submit(q, 8) for q in queries[12:]]
        results += [f.result(timeout=120) for f in futs]
        stop.set()
        t.join(timeout=120)
    assert not t.is_alive()
    gens = [r.generation for r in results]
    assert min(gens) >= 1 and max(gens) <= st.generation
    assert min(gens[12:]) >= forced_gen > max(gens[:12])
    for q, r in zip(queries, results):
        ids_g, pts_g = st.history(r.generation)
        _check_result(r, ids_g, pts_g, q, 8)


def test_epoch_swap_exactness_per_generation(rng):
    st = _mk_store(track_history=True)
    srv = _mk_server(st)
    q = rng.normal(size=DIM).astype(np.float32)
    for _ in range(6):
        ids = st.insert(rng.normal(size=(16, DIM)).astype(np.float32))
        st.flush()
        st.delete(ids[:10])
        st.flush()
        r = srv.query_batch(q[None], [8])[0]
        assert r.generation == st.generation
        ids_g, pts_g = st.history(r.generation)
        _check_result(r, ids_g, pts_g, q, 8)


@pytest.mark.parametrize("kw", [
    dict(), dict(sampler="gather"),
    dict(route="pruned", route_compute="device", search="approx")])
def test_empty_store_serves_sentinels(rng, kw):
    """An empty store and a store drained to empty answer all sentinels,
    warm-up included, on every path."""
    skw = {"index_buckets": 8} if kw.get("search") == "approx" else {}
    st = _mk_store(**skw)
    srv = _mk_server(st, **kw)
    srv.warmup()
    r = srv.query_batch(rng.normal(size=(1, DIM)).astype(np.float32),
                        [8])[0]
    assert np.all(np.isinf(r.dists)) and np.all(r.ids == _SENTINEL)
    ids = st.insert(rng.normal(size=(30, DIM)).astype(np.float32))
    st.flush()
    st.delete(ids)
    st.flush()
    r = srv.query_batch(rng.normal(size=(1, DIM)).astype(np.float32),
                        [8])[0]
    assert np.all(np.isinf(r.dists)) and np.all(r.ids == _SENTINEL)
    assert r.generation == 2


def test_server_store_conflicts_rejected():
    st = _mk_store()
    with pytest.raises(ValueError, match="not both"):
        KnnServer(np.zeros((8, DIM), np.float32), store=st,
                  cfg=CONFIG.replace(**_cfg()), device="cpu")
    with pytest.raises(ValueError, match="shards"):
        KnnServer(store=st, cfg=CONFIG.replace(**_cfg()), shards=4,
                  device="cpu")
    with pytest.raises(ValueError, match="sketch mismatch"):
        _mk_server(st, route="pruned", summary_pivots=2)
    with pytest.raises(ValueError, match="index mismatch"):
        _mk_server(st, search="approx")
    with pytest.raises(ValueError, match="store-backed"):
        KnnServer(np.zeros((8, DIM), np.float32),
                  cfg=CONFIG.replace(**_cfg()), device="cpu").flush_store()
    KnnServer(store=st, cfg=CONFIG.replace(**_cfg()), shards=K, device="cpu")


def test_out_of_slice_store_knobs_raise(mesh8, monkeypatch):
    # background maintenance, refused until it was ported, holds the JAX
    # background store's state once both workers are stopped
    bg, jbg = _mk_store(maintenance="background"), _mk_jstore(
        mesh8, maintenance="background")
    pts = np.random.default_rng(4).normal(size=(20, DIM)).astype(np.float32)
    for st in (bg, jbg):
        st.insert(pts)
        st.flush()
        st.close()
    _same_state(jbg, bg)
    assert bg.maint_commit_clock() == jbg.maint_commit_clock()
    # the label payload is ported: labeled ops are taken, and refused
    # without with_labels, as in the reference
    st = _mk_store(with_labels=True)
    st.update(st.insert(np.ones((2, DIM), np.float32), labels=[1.0, 2.0])[:1],
              np.zeros((1, DIM), np.float32), labels=[5.0])
    st.flush()
    assert st.live_labels()[1].tolist() == [5.0, 2.0]
    with pytest.raises(ValueError, match="with_labels=False"):
        _mk_store().insert(np.ones((1, DIM), np.float32), labels=[1.0])
    with pytest.raises(ValueError):
        _mk_store(maintenance="sometimes")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MutableStore(DIM, capacity_per_shard=CAP)


def test_placement_stats_store_form_matches_jax(mesh8, rng):
    kw = dict(placement="affinity", summary_pivots=2, retighten_every=8)
    js, ts = _mk_jstore(mesh8, **kw), _mk_store(**kw)
    pts = rng.normal(size=(150, DIM)).astype(np.float32)
    for st in (js, ts):
        ids = st.insert(pts)
        st.flush()
        st.delete(ids[::4])
        st.flush()
    a = _mk_jserver(js, route="pruned", summary_pivots=2).placement_stats()
    b = _mk_server(ts, route="pruned", summary_pivots=2).placement_stats()
    assert set(a) == set(b)
    for key in ("placement", "redeal", "live_per_shard", "routed_batches",
                "prune_rate"):
        assert a[key] == b[key], key
    np.testing.assert_allclose(b["summary_slack"], a["summary_slack"],
                               rtol=1e-9, atol=1e-9)
    assert {k: a["maintenance"][k] for k in b["maintenance"]} == \
        b["maintenance"]
