"""Background maintenance on the port against the JAX reference, on the
CPU.

* **Deterministic parity.**  The port's and the reference's stores, both
  ``maintenance="background"`` and closed at once (an empty store plans
  nothing), take one seeded op stream; after each flush each worker's
  ``_cycle()`` runs by hand until it finds no work.  Mirrors, slot maps,
  live and used counts, ``stats``, the worker's counters and every
  ``maint_commit_clock()`` are then equal exactly.
* **The concurrency harness** (the port of tests/test_async_maintenance.py):
  mutator threads race the micro-batcher and the worker, and every
  answer equals, byte for byte, an exact server over a quiet store that
  holds the live set of the answer's generation (``history()``), under
  host and device routing; no ``serving_snapshot()`` tears; background
  converges to inline's live set; inline has no worker; the worker
  stops cleanly; the approx tier under the race keeps its recall floor.
* **A re-tightening at an unchanged generation.**  The commit re-freezes
  the summaries at the same generation; the device router must build
  its operands from the new object: its rows equal host
  ``route_shards`` of the new summaries right after the commit.
"""

import dataclasses
import threading
import time
import traceback

import numpy as np
import pytest
import torch

from repro.store import MutableStore as JaxStore
from repro_torch.configs import CONFIG
from repro_torch.kernels import ops as tops
from repro_torch.obs import ObsPlane, build_trees
from repro_torch.runtime import KnnServer
from repro_torch.store import MutableStore, route_shards, summary_invariants

torch.set_num_threads(1)

K = 8
DIM = 8
CAP = 192
L_MAX = 16
MUT_STEPS = 12
QUERY_WAVES = 10
WAVE_SIZE = 4
ORACLE_GEN_CAP = 8       # replay at most this many generations
SENTINEL = 2**31 - 1


def _kw(**overrides):
    kw = dict(capacity_per_shard=CAP, placement="affinity",
              redeal="proximity", summary_pivots=2, retighten_every=3,
              split_radius_factor=1.2, maintenance="background",
              track_history=True, staging_size=64)
    kw.update(overrides)
    return kw


def _mk_store(**overrides):
    return MutableStore(DIM, device="cpu", **_kw(**overrides))


def _centers(seed):
    return np.random.default_rng(seed).normal(scale=20.0, size=(2 * K, DIM))


def _draw(rng, centers, n, c=None):
    c = int(rng.integers(0, len(centers))) if c is None else c
    return (centers[c] + rng.normal(size=(n, DIM))).astype(np.float32)


# ---- deterministic parity with the JAX store --------------------------------

def _drain(store) -> int:
    """Run the closed worker's cycles by hand until none is due."""
    n = 0
    while store._worker_final._cycle():
        n += 1
    return n


def _same_state(js, ts, *, labels=False):
    for name in ("_pts", "_ids", "_valid", "_live", "_used") + (
            ("_labels",) if labels else ()):
        a, b = getattr(js, name), getattr(ts, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert js._slot_of == ts._slot_of
    assert dataclasses.asdict(js.stats) == dataclasses.asdict(ts.stats)
    assert js.generation == ts.generation
    jw = dict(js.maintenance_stats()["worker"], error=None)
    tw = dict(ts.maintenance_stats()["worker"], error=None)
    assert jw == tw
    assert js.maint_commit_clock() == ts.maint_commit_clock()
    jsnap, tsnap = js.snapshot(), ts.snapshot()
    for name in ("points", "ids", "valid") + (("labels",) if labels else ()):
        assert np.array_equal(np.asarray(getattr(jsnap, name)),
                              getattr(tsnap, name).numpy()), name


@pytest.mark.parametrize("case", ["proximity", "round_robin", "labels"])
def test_background_cycles_bit_equal_to_jax(mesh8, case):
    over = {"proximity": {},
            "round_robin": dict(placement="balance", redeal="round_robin",
                                summary_pivots=1, split_radius_factor=0.0,
                                index_buckets=4),
            "labels": dict(with_labels=True, index_buckets=4)}[case]
    kw = _kw(staging_size=10**9, **over)
    ts = MutableStore(DIM, device="cpu", **kw)
    js = JaxStore(DIM, mesh=mesh8, axis_name="x", **kw)
    for st in (ts, js):
        st.close()
        assert _drain(st) == 0                 # an empty store plans nothing
    labels = case == "labels"
    centers = _centers(31)
    rng = np.random.default_rng(32)
    kinds = set()
    for step in range(10):
        pts = _draw(rng, centers, 24)
        lab = rng.integers(0, 5, 24).astype(np.float32) if labels else None
        live = ts.live_arrays()[0]
        for st in (ts, js):
            st.insert(pts, labels=lab)
        if len(live) > 40:
            perm = rng.permutation(live)
            moved = perm[12:18]
            new = _draw(rng, centers, len(moved))
            for st in (ts, js):
                st.delete(perm[:12])
                st.update(moved, new)
        for st in (ts, js):
            st.flush()
        cycles = _drain(ts)
        assert _drain(js) == cycles
        _same_state(js, ts, labels=labels)
        clock = ts.maint_commit_clock()[1]
        if clock is not None:
            kinds.add(clock["kind"])
    ws = ts.maintenance_stats()["worker"]
    assert ws["errors"] == 0 and ws["commits"] > 0
    assert "retighten" in kinds and kinds & {"repack", "split"}


# ---- the concurrency harness ------------------------------------------------

def _mutator(store, centers, seed, errors):
    """Seeded insert / delete / update churn, flushed in small waves so
    the worker races real epoch swaps."""
    rng = np.random.default_rng(seed)
    try:
        for _ in range(MUT_STEPS):
            store.insert(_draw(rng, centers, 12))
            store.flush()
            live = store.live_arrays()[0]
            if len(live) > 80:
                perm = rng.permutation(live)
                store.delete(perm[:8])
                moved = perm[8:12]
                store.update(moved, _draw(rng, centers, len(moved)))
                store.flush()
            time.sleep(0.003)
    except Exception:
        errors.append(traceback.format_exc())


def _torn_detector(store, stop_evt, violations):
    while not stop_evt.is_set():
        snap, summ, idx = store.serving_snapshot()
        gens = {snap.generation, summ.generation}
        if idx is not None:
            gens.add(idx.generation)
        if len(gens) != 1:
            violations.append(sorted(gens))
        time.sleep(0.0005)   # dense, without burning a core


def _sampled(gens, cap):
    if len(gens) <= cap:
        return gens
    idx = np.linspace(0, len(gens) - 1, cap).round().astype(int)
    return [gens[i] for i in sorted(set(idx.tolist()))]


def _race(store, cfg, seed):
    """Serve waves of requests while a mutator churns and the worker
    maintains; returns [(query, l, QueryResult)] and the server."""
    centers = _centers(seed)
    srv = KnnServer(store=store, cfg=cfg, device="cpu")
    rng = np.random.default_rng(10 + seed)
    store.insert(_draw(rng, centers, 40, 0))
    store.insert(_draw(rng, centers, 40, 1))
    store.flush()
    srv.warmup()
    stop_evt = threading.Event()
    torn, errors = [], []
    detector = threading.Thread(target=_torn_detector,
                                args=(store, stop_evt, torn), daemon=True)
    mutator = threading.Thread(target=_mutator,
                               args=(store, centers, 100 + seed, errors),
                               daemon=True)
    qrng = np.random.default_rng(200 + seed)
    pending = []
    with srv.serving():
        detector.start()
        mutator.start()
        for _ in range(QUERY_WAVES):
            for _ in range(WAVE_SIZE):
                q = _draw(qrng, centers, 1)[0]
                l = int(qrng.integers(1, L_MAX))
                pending.append((q, l, srv.submit(q, l)))
            time.sleep(0.004)
        mutator.join()
        results = [(q, l, f.result(timeout=120)) for q, l, f in pending]
    stop_evt.set()
    detector.join()
    store.close()
    assert not errors, errors[0]
    assert not torn, f"torn serving_snapshot reads: {torn[:5]}"
    ws = store.maintenance_stats()["worker"]
    assert ws["errors"] == 0 and ws["error"] is None
    assert ws["commits"] > 0
    return results, srv


def _oracle_answers(store, cfg, results):
    """{generation: [(expected, got)]}: an exact server over a quiet store
    replaying ``history(g)`` answers each sampled generation's queries."""
    by_gen = {}
    for q, l, r in results:
        by_gen.setdefault(r.generation, []).append((q, l, r))
    gens = _sampled(sorted(by_gen), ORACLE_GEN_CAP)
    assert gens, "no queries resolved"
    out = {}
    for g in gens:
        ids, pts_g = store.history(g)
        oracle = MutableStore(DIM, capacity_per_shard=CAP, device="cpu")
        if len(ids):
            oracle.insert(pts_g, ids=ids)
        oracle.flush()
        osrv = KnnServer(store=oracle, cfg=cfg, device="cpu")
        qs = np.stack([q for q, _, _ in by_gen[g]])
        ls = [l for _, l, _ in by_gen[g]]
        out[g] = list(zip(osrv.query_batch(qs, ls),
                          [r for _, _, r in by_gen[g]]))
    return out


@pytest.mark.parametrize("route_compute", ["host", "device"])
def test_racing_answers_match_quiet_oracle(route_compute):
    seed = 0 if route_compute == "host" else 1
    cfg = CONFIG.replace(dim=DIM, l=8, l_max=L_MAX, bucket_sizes=(1, 2, 4),
                         route="pruned", route_compute=route_compute,
                         summary_pivots=2, use_sampling=False,
                         max_wait_ms=2.0)
    store = _mk_store()
    results, _ = _race(store, cfg, seed)
    ws = store.maintenance_stats()["worker"]
    assert ws["retightens"] + ws["splits"] + ws["repacks"] > 0
    oracle_cfg = cfg.replace(route="exact", route_compute="host",
                             summary_pivots=1)
    for g, pairs in _oracle_answers(store, oracle_cfg, results).items():
        for expect, got in pairs:
            assert got.dists.tobytes() == expect.dists.tobytes(), g
            assert np.array_equal(got.ids, expect.ids), g


def test_background_converges_to_inline_live_set():
    centers = _centers(7)
    rng = np.random.default_rng(7)
    bg, inline = _mk_store(), _mk_store(maintenance="inline")
    for step in range(10):
        batch = _draw(rng, centers, 14)
        assert np.array_equal(bg.insert(batch), inline.insert(batch))
        bg.flush()
        inline.flush()
        live = inline.live_arrays()[0]
        if len(live) > 60 and step % 2:
            victims = np.sort(live)[::5][:6]
            bg.delete(victims)
            inline.delete(victims)
            bg.flush()
            inline.flush()
    assert bg._worker.wait_idle(timeout=60)     # the worker drained
    bg.close()
    ids_a, pts_a = bg.live_arrays()
    ids_b, pts_b = inline.live_arrays()
    assert np.array_equal(ids_a, ids_b)
    assert pts_a.tobytes() == pts_b.tobytes()
    inv = summary_invariants(bg.summaries(), bg._pts, bg._valid, bg.cap)
    assert inv["live_mismatch"] == 0
    assert inv["radius_violation"] <= 1e-9
    assert inv["projection_violation"] <= 1e-9
    ws = bg.maintenance_stats()["worker"]
    assert ws["errors"] == 0 and ws["commits"] > 0


def test_inline_mode_has_no_worker():
    store = MutableStore(DIM, capacity_per_shard=32, device="cpu",
                         retighten_every=1)
    assert store.maintenance == "inline"
    assert "worker" not in store.maintenance_stats()
    before = threading.active_count()
    store.insert(np.random.default_rng(0).normal(size=(40, DIM))
                 .astype(np.float32))
    store.flush()
    assert store.stats.retightens > 0
    store.close()
    assert threading.active_count() == before
    assert store.maint_commit_clock() == (0, None)
    with pytest.raises(ValueError, match="maintenance"):
        MutableStore(DIM, capacity_per_shard=8, device="cpu",
                     maintenance="sometimes")


def test_background_worker_stops_cleanly():
    store = _mk_store()
    rng = np.random.default_rng(3)
    store.insert(rng.normal(scale=10.0, size=(64, DIM)).astype(np.float32))
    store.flush()
    assert "knn-store-maintenance" in [t.name for t in threading.enumerate()]
    store.close()
    store.close()
    assert "knn-store-maintenance" not in [t.name
                                           for t in threading.enumerate()]
    store.insert(rng.normal(size=(8, DIM)).astype(np.float32))
    gen = store.flush()
    snap, summ = store.routing_snapshot()
    assert summ.generation == snap.generation == gen


def test_racing_approx_respects_recall_floor():
    cfg = CONFIG.replace(dim=DIM, l=8, l_max=L_MAX, bucket_sizes=(1, 2, 4),
                         route="pruned", summary_pivots=2, search="approx",
                         index_buckets=4, recall_floor=0.95,
                         obs_audit_every=3, use_sampling=False,
                         max_wait_ms=2.0)
    store = _mk_store(index_buckets=4)
    results, srv = _race(store, cfg, 2)
    assert all(r.recall_mode == "approx" for _, _, r in results)
    oracle_cfg = cfg.replace(search="exact", route="exact", summary_pivots=1,
                             obs_audit_every=0)
    recalls = []
    for pairs in _oracle_answers(store, oracle_cfg, results).values():
        for expect, got in pairs:
            truth = set(expect.ids[expect.ids != SENTINEL].tolist())
            if truth:
                recalls.append(len(truth & set(got.ids.tolist()))
                               / len(truth))
    assert recalls and min(recalls) >= cfg.recall_floor, min(recalls)
    shadow = srv.obs_snapshot()["audit"]["shadow"]
    assert shadow["mode"] == "recall" and shadow["checks"] >= 1
    assert shadow["divergences"] == 0


# ---- the worker's trace, and a re-tightening at an unchanged generation -----

def test_worker_cycles_trace_into_the_attached_plane():
    """Each working cycle is one maint.cycle tree with plan, prepare and
    commit (or discard) children; the repack's prepare holds the upload;
    the commit span reports how long the lock was held."""
    plane = ObsPlane(trace=True)
    store = _mk_store(staging_size=10**9)
    store.attach_obs(plane)
    store.close()
    centers = _centers(5)
    rng = np.random.default_rng(6)
    for _ in range(6):
        ids = store.insert(_draw(rng, centers, 30))
        store.flush()
        store.delete(ids[:20])
        store.flush()
        _drain(store)
    recs = plane.tracer.spans()
    build_trees(recs)
    kids = {}
    for r in recs:
        if r["parent"] is not None:
            kids.setdefault(r["parent"], []).append(r)
    cycles = [r for r in recs if r["name"] == "maint.cycle"]
    assert cycles
    kinds = set()
    for c in cycles:
        names = sorted(k["name"] for k in kids[c["span"]])
        assert names in (["maint.commit", "maint.plan", "maint.prepare"],
                         ["maint.discard", "maint.plan", "maint.prepare"])
        kinds.add(c["attrs"]["kind"])
        commit = [k for k in kids[c["span"]] if k["name"] == "maint.commit"]
        assert commit[0]["attrs"]["held_s"] >= 0.0
    assert "repack" in kinds or "split" in kinds
    uploads = [r for r in recs if r["name"] == "maint.upload"]
    assert uploads and all(r["attrs"]["bytes"] > 0 for r in uploads)
    assert plane.metrics.snapshot()["maint.cycle_s"]["count"] == len(cycles)
    assert {"store.apply", "store.repack"} & {r["name"] for r in recs}


def test_retighten_at_unchanged_generation_reroutes_on_device():
    store = _mk_store(staging_size=10**9, split_radius_factor=0.0,
                      retighten_every=4)
    store.auto_compact = False
    cfg = CONFIG.replace(dim=DIM, l=8, l_max=L_MAX, bucket_sizes=(4,),
                         route="pruned", route_compute="device",
                         summary_pivots=2)
    srv = KnnServer(store=store, cfg=cfg, device="cpu")
    exact = KnnServer(store=store, cfg=cfg.replace(route="exact"),
                      device="cpu")
    store.close()
    centers = _centers(8)
    rng = np.random.default_rng(9)
    ls = np.array([1, 4, 8, 16])
    commits = 0
    for _ in range(8):
        ids = store.insert(_draw(rng, centers, 40))
        store.flush()
        store.delete(ids[::3])
        store.update(ids[1::3][:5], _draw(rng, centers, 5))
        store.flush()
        q = _draw(rng, centers, 4)
        srv.query_batch(q, ls.tolist())          # the old operands cached
        gen, before = store.generation, store.summaries()
        while store._worker_final._cycle():
            commits += 1
            assert store.maint_commit_clock()[1]["kind"] == "retighten"
        summ = store.summaries()
        assert store.generation == gen and summ.generation == gen
        if summ is before:
            continue
        got = srv.query_batch(q, ls.tolist())
        assert srv._gen_ops[0] is summ           # rebuilt for the new object
        packed, _ = srv._operands(summ, None)
        rows, _, _ = tops.route_index(
            torch.from_numpy(q), torch.from_numpy(ls.astype(np.int32)),
            packed)
        want = route_shards(summ, q, ls, slack=cfg.route_slack)
        assert np.array_equal(rows.numpy() != 0, want)
        assert got[0].shards_touched == int(want.any(0).sum())
        for a, b in zip(got, exact.query_batch(q, ls.tolist())):
            assert a.generation == b.generation == gen
            assert a.dists.tobytes() == b.dists.tobytes()
            assert np.array_equal(a.ids, b.ids)
    assert commits > 0
    assert store.maintenance_stats()["worker"]["retightens"] == commits
