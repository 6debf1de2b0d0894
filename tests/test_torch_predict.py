"""The port's label prediction against the JAX package's, on the CPU.

At the reference harness's size (tests/test_predict.py: k = 8 shards,
dim 8, n = 128, 4 classes, l_max 16), the same seeded numpy inputs go
through ``repro`` and ``repro_torch``:

* ``labeled_mixture`` / ``bayes_labels`` bit-equal;
* ``local_top_l(extra=)`` (pad path, top-l path, +inf slots) and the
  fused ``local_distance_top_l(extra=)`` under a mask: values, ids and
  labels equal on every finite slot, masked slots carrying the sentinel
  id and label 0;
* the ensemble's device and host functions equal to the reference's;
* the JAX ``KnnServer`` and the port's ``KnnServer(device="cpu")`` over
  the reference's oracle matrix (six route/search modes) and seeds
  {0, 3}: labels and confidences byte-equal, distances within f32
  tolerance and ids equal, touched shards equal, and each side's bill
  equal to the other side's formula at its own iteration count (the two
  random streams differ, so the Algorithm 1 iteration counts may); the
  regress mode and the ensemble's per-shard payloads and labels too;
* the reference harness's own cases on the port: the 1-shard ensemble
  is the exact vote byte for byte, the ensemble bill is ``messages ==
  touched``, tied votes are deterministic across fresh servers, and a
  tombstoned nearest neighbour never votes, in both modes;
* the labeled store: one op stream (labeled inserts, updates with and
  without labels, deletes, ``compact()``, proximity re-deals) drives the
  JAX store and the port's, whose label mirror, id -> label map, live
  labels and snapshot labels are bit-equal to the JAX store's after
  every flush; ``convert.store_from_mirrors(labels=)`` carries it over;
* racing ingest keeps the ensemble bill, and the accuracy-mode shadow
  audit (``obs_audit_every``) holds the floor there, as in the
  reference.
"""

import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import predict as jpredict
from repro.configs.knn_service import KnnServiceConfig as JConfig
from repro.core import knn as jknn
from repro.data import synthetic as jsynth
from repro.runtime import KnnServer as JaxServer
from repro.store import MutableStore as JaxStore
from repro_torch import convert
from repro_torch import predict as tpredict
from repro_torch.configs import KnnServiceConfig
from repro_torch.core import knn as tknn
from repro_torch.data import synthetic as tsynth
from repro_torch.parallel.collectives import accounting
from repro_torch.runtime import KnnServer
from repro_torch.store import MutableStore

# the cases are small: one intra-op thread a process is faster here than
# a pool, and leaves the cores to the other test processes
torch.set_num_threads(1)

K = 8
DIM = 8
N = 128
NUM_CLASSES = 4
L_MAX = 16
TOL = dict(rtol=1e-4, atol=1e-3)
INT32_MAX = 2**31 - 1

KW = dict(dim=DIM, bucket_sizes=(4,), l_max=L_MAX, num_classes=NUM_CLASSES,
          predict="vote", max_wait_ms=0.1)
BASE = KnnServiceConfig(**KW)
JBASE = JConfig(**KW)

MATRIX = [
    dict(route="exact", route_compute="host", search="exact"),
    dict(route="pruned", route_compute="host", search="exact"),
    dict(route="pruned", route_compute="device", search="exact"),
    dict(route="exact", route_compute="host", search="approx",
         index_buckets=4, index_oversample=1e9),
    dict(route="pruned", route_compute="host", search="approx",
         index_buckets=4, index_oversample=1e9),
    dict(route="pruned", route_compute="device", search="approx",
         index_buckets=4, index_oversample=1e9),
]


def _instance(seed=0, n=N):
    """tests/test_predict.py's instance: separation 6, four queries at
    class centres plus N(0, 1)."""
    pts, labels, centers = tsynth.labeled_mixture(n, DIM, NUM_CLASSES,
                                                  separation=6.0, seed=seed)
    rng = np.random.default_rng(seed + 1)
    qs = (centers[rng.integers(0, NUM_CLASSES, 4)]
          + rng.normal(size=(4, DIM))).astype(np.float32)
    return pts, labels.astype(np.float32), qs


def _oracle_vote(pts, labels, q, l):
    d = ((q.astype(np.float64) - pts.astype(np.float64)) ** 2).sum(-1)
    top = np.argsort(d, kind="stable")[:l]
    hist = np.bincount(labels[top].astype(int), minlength=NUM_CLASSES)
    return float(hist.argmax()), hist


def _port(pts, labels, shards=K, **kw):
    return KnnServer(pts, labels=labels, cfg=BASE.replace(**kw),
                     shards=shards, device="cpu")


def _jax(pts, labels, mesh=None, **kw):
    return JaxServer(pts, labels=labels, cfg=JBASE.replace(**kw), mesh=mesh)


def _capture_payload(srv):
    """Wrap ``srv``'s ensemble pass so each batch's (k, B, C) answers are
    kept, as the reference's explain vote table keeps them."""
    seen = []
    run = srv._ensemble_run

    def keep(*a, **kw):
        out = run(*a, **kw)
        seen.append(out.payload)
        return out
    srv._ensemble_run = keep
    return seen


def _labels_of(res):
    return np.array([r.label for r in res], np.float32)


def _confs_of(res):
    return np.array([r.confidence for r in res], np.float32)


def _same_answers(pts, qs, a, b):
    """Two servers' l-NN answers agree: distances within TOL, ids equal
    (no near-tie at rank l in these instances)."""
    for q, ra, rb in zip(qs, a, b):
        np.testing.assert_allclose(ra.dists, rb.dists, **TOL)
        d = ((q.astype(np.float64) - pts.astype(np.float64)) ** 2).sum(-1)
        bd = np.sort(d)
        l = ra.l
        assert bd[l] - bd[l - 1] > TOL["atol"] + TOL["rtol"] * bd[l - 1]
        assert np.array_equal(np.sort(ra.ids), np.sort(rb.ids))


def _same_bill(tsrv, jsrv, res_t, res_j):
    """Touched shards equal; each bill equal to the other side's formula
    at its own iteration count."""
    cfg = tsrv.cfg
    for rt, rj in zip(res_t, res_j):
        assert rt.shards_touched == rj.shards_touched
        assert (rt.rounds, rt.messages) == jsrv._accounting(
            rt.iterations, rt.shards_touched)
        assert (rj.rounds, rj.messages) == accounting(
            sampler=cfg.sampler, iterations=rj.iterations,
            touched=rj.shards_touched, l_max=cfg.l_max,
            use_sampling=cfg.use_sampling, predict=cfg.predict,
            predict_mode=cfg.predict_mode)


# ---- data and the label payload through the top-l step -----------------

@pytest.mark.parametrize("n,dim,c,sep,seed", [(128, 8, 4, 6.0, 0),
                                              (1000, 64, 16, 8.0, 3),
                                              (77, 3, 2, 0.0, 9)])
def test_labeled_mixture_bit_equal(n, dim, c, sep, seed):
    want = jsynth.labeled_mixture(n, dim, c, separation=sep, seed=seed)
    got = tsynth.labeled_mixture(n, dim, c, separation=sep, seed=seed)
    for w, g in zip(want, got):
        assert w.dtype == g.dtype and w.tobytes() == g.tobytes()
    q = np.random.default_rng(seed).normal(size=(40, dim)) * 3
    assert np.array_equal(jsynth.bayes_labels(q, want[2]),
                          tsynth.bayes_labels(q, got[2]))


@pytest.mark.parametrize("m,l", [(40, 16), (16, 16), (9, 16)])
@pytest.mark.parametrize("masked", [False, True])
def test_local_top_l_extra_matches_jax(rng, m, l, masked):
    """The label payload follows the top-l permutation, pad slots carry 0
    (m <= l), +inf slots their own label on the unfused path."""
    d = rng.random((K, 3, m)).astype(np.float32)
    if masked:
        d[:, :, ::3] = np.inf
    ids = rng.permutation(10 * m)[:m].astype(np.int32)
    lab = rng.integers(0, NUM_CLASSES, m).astype(np.float32)
    for s in range(K):
        jv, ji, jl = jknn.local_top_l(jnp.asarray(d[s]), jnp.asarray(ids), l,
                                      extra=jnp.asarray(lab))
        tv, ti, tl = tknn.local_top_l(torch.from_numpy(d[s]),
                                      torch.from_numpy(ids), l,
                                      extra=torch.from_numpy(lab))
        fin = np.isfinite(np.asarray(jv))
        assert np.array_equal(np.asarray(jv), tv.numpy())
        assert np.array_equal(np.asarray(ji)[fin], ti.numpy()[fin])
        assert np.array_equal(np.asarray(jl)[fin], tl.numpy()[fin])
        if m <= l:       # the pad slots, past column m
            assert (tl.numpy()[:, m:] == 0).all()
            assert (ti.numpy()[:, m:] == INT32_MAX).all()


@pytest.mark.parametrize("m,l", [(96, 16), (12, 16)])
def test_fused_local_top_l_extra_under_a_mask(rng, m, l):
    """local_distance_top_l(extra=) against the reference's unfused path
    (masked distances, then local_top_l(extra=)): equal on finite slots;
    a masked slot carries the sentinel id and label 0."""
    pts = rng.normal(size=(K, m, DIM)).astype(np.float32)
    q = rng.normal(size=(5, DIM)).astype(np.float32)
    valid = rng.random((K, m)) > 0.4
    valid[2] = False
    ids = np.arange(K * m, dtype=np.int32).reshape(K, m)
    lab = rng.integers(0, NUM_CLASSES, (K, m)).astype(np.float32)
    tv, ti, tl = tknn.local_distance_top_l(
        torch.from_numpy(q), torch.from_numpy(pts), torch.from_numpy(ids), l,
        valid=torch.from_numpy(valid), extra=torch.from_numpy(lab))
    for s in range(K):
        d = jknn.squared_l2_distances(jnp.asarray(q), jnp.asarray(pts[s]))
        d = jnp.where(jnp.asarray(valid[s])[None], d, jnp.inf)
        jv, ji, jl = jknn.local_top_l(d, jnp.asarray(ids[s]), l,
                                      extra=jnp.asarray(lab[s]))
        fin = np.isfinite(np.asarray(jv))
        np.testing.assert_allclose(tv[s].numpy(), np.asarray(jv), **TOL)
        if m > l:      # the fused path: masked slots are sentinels
            assert np.array_equal(np.asarray(ji)[fin], ti[s].numpy()[fin])
            assert np.array_equal(np.asarray(jl)[fin], tl[s].numpy()[fin])
            assert (ti[s].numpy()[~fin] == INT32_MAX).all()
            assert (tl[s].numpy()[~fin] == 0).all()
        else:          # the pad path keeps slot order on both sides
            assert np.array_equal(np.asarray(ji), ti[s].numpy())
            assert np.array_equal(np.asarray(jl), tl[s].numpy())


# ---- the ensemble's functions ---------------------------------------------

def test_local_vote_and_mean_match_jax(rng):
    d = rng.random((K, 6, L_MAX)).astype(np.float32)
    d[:, :, -5:] = np.inf
    d[:, 1, :4] = 0.25                      # ties break to the lower slot
    d[3] = d[3][:, ::-1].copy()             # unsorted slots (pad path)
    lab = rng.integers(-1, NUM_CLASSES + 1, (K, 6, L_MAX)).astype(np.float32)
    kl = np.array([0, 1, 3, 16, 7, 11], np.int32)
    tv = tpredict.local_vote(torch.from_numpy(d), torch.from_numpy(lab),
                             torch.from_numpy(kl), NUM_CLASSES).numpy()
    tm = tpredict.local_mean(torch.from_numpy(d), torch.from_numpy(lab),
                             torch.from_numpy(kl)).numpy()
    for s in range(K):
        jv = jpredict.local_vote(jnp.asarray(d[s]), jnp.asarray(lab[s]),
                                 jnp.asarray(kl), NUM_CLASSES)
        jm = jpredict.local_mean(jnp.asarray(d[s]), jnp.asarray(lab[s]),
                                 jnp.asarray(kl))
        assert np.asarray(jv).tobytes() == tv[s].astype(np.int32).tobytes()
        assert np.asarray(jm).tobytes() == tm[s].tobytes()


@pytest.mark.parametrize("touched,local_k", [(1, 0), (3, 0), (8, 0), (8, 5),
                                             (0, 0), (2, 40)])
def test_local_k_and_aggregates_match_jax(rng, touched, local_k):
    l = np.array([0, 1, 5, 16, 9, 3, 0, 16], np.int32)
    assert np.array_equal(jpredict.local_k_for(l, touched, local_k, L_MAX),
                          tpredict.local_k_for(l, touched, local_k, L_MAX))
    hists = rng.integers(0, 3, (K, 8, NUM_CLASSES)).astype(np.int32)
    hists[:, 0] = 0                              # every shard abstains
    hists[2, 1] = [2, 2, 0, 1]                   # a tie inside a shard
    active = rng.random(K) > 0.3
    for w, g in zip(jpredict.aggregate_vote(hists, active),
                    tpredict.aggregate_vote(hists, active)):
        assert np.asarray(w).tobytes() == np.asarray(g).tobytes()
    sumcnt = np.stack([rng.random((K, 8)) * 9,
                       rng.integers(0, 4, (K, 8))], -1).astype(np.float32)
    for w, g in zip(jpredict.aggregate_regress(sumcnt, active),
                    tpredict.aggregate_regress(sumcnt, active)):
        assert w.tobytes() == g.tobytes()


# ---- the servers over the reference's oracle matrix -----------------------

@pytest.mark.parametrize("knobs", MATRIX, ids=lambda k: "-".join(
    str(v) for v in list(k.values())[:3]))
@pytest.mark.parametrize("seed", [0, 3])
def test_exact_predict_matches_jax_on_every_mode(seed, knobs):
    pts, labels, qs = _instance(seed)
    ls = [1, 5, L_MAX, 3]
    jsrv, tsrv = _jax(pts, labels, **knobs), _port(pts, labels, **knobs)
    res_j, res_t = jsrv.query_batch(qs, ls=ls), tsrv.query_batch(qs, ls=ls)
    assert _labels_of(res_t).tobytes() == _labels_of(res_j).tobytes()
    assert _confs_of(res_t).tobytes() == _confs_of(res_j).tobytes()
    for q, l, r in zip(qs, ls, res_t):
        assert r.predict_mode == "exact"
        assert r.label == _oracle_vote(pts, labels, q, l)[0]
    _same_answers(pts, qs, res_t, res_j)
    _same_bill(tsrv, jsrv, res_t, res_j)
    jsrv.close()
    tsrv.close()


@pytest.mark.parametrize("mode", ["exact", "ensemble"])
def test_regress_matches_jax(mode):
    pts, labels, qs = _instance(7)
    # non-integer targets: the sums are no longer exact in any order
    targets = (labels + np.random.default_rng(7).random(N)).astype(
        np.float32)
    kw = dict(predict="regress", predict_mode=mode)
    jsrv, tsrv = _jax(pts, targets, **kw), _port(pts, targets, **kw)
    ls = [5, 1, L_MAX, 9]
    res_j, res_t = jsrv.query_batch(qs, ls=ls), tsrv.query_batch(qs, ls=ls)
    np.testing.assert_allclose(_labels_of(res_t), _labels_of(res_j),
                               rtol=1e-6)
    assert _confs_of(res_t).tobytes() == _confs_of(res_j).tobytes()
    for q, l, r in zip(qs, ls, res_t):
        assert r.predict_mode == mode
        if mode == "exact":
            d = ((q.astype(np.float64) - pts.astype(np.float64)) ** 2).sum(-1)
            top = np.argsort(d, kind="stable")[:l]
            assert r.label == pytest.approx(targets[top].mean(), rel=1e-6)
            assert r.confidence == 1.0
    _same_bill(tsrv, jsrv, res_t, res_j)


@pytest.mark.parametrize("knobs", [dict(route="exact"),
                                   dict(route="pruned",
                                        route_compute="host")],
                         ids=["exact", "pruned"])
@pytest.mark.parametrize("seed", [0, 3])
def test_ensemble_payload_and_labels_match_jax(seed, knobs):
    """The per-shard answers (k, B, C), the labels and the bill equal the
    reference's; dists/ids are all sentinels."""
    pts, labels, qs = _instance(seed)
    ls = [1, 5, L_MAX, 3]
    kw = dict(predict_mode="ensemble", **knobs)
    jsrv, tsrv = _jax(pts, labels, **kw), _port(pts, labels, **kw)
    seen = _capture_payload(tsrv)
    res_j, res_t = jsrv.query_batch(qs, ls=ls), tsrv.query_batch(qs, ls=ls)
    for row, rj in enumerate(res_j):
        want = np.array(rj.explain()["predict"]["shard_answers"])  # (k, C)
        assert np.array_equal(seen[0][:, row], want)
    assert _labels_of(res_t).tobytes() == _labels_of(res_j).tobytes()
    assert _confs_of(res_t).tobytes() == _confs_of(res_j).tobytes()
    for rt, rj in zip(res_t, res_j):
        assert (rt.rounds, rt.messages, rt.shards_touched) == (
            rj.rounds, rj.messages, rj.shards_touched)
        assert rt.messages == rt.shards_touched and rt.rounds == 1
        assert (rt.ids == INT32_MAX).all() and np.isinf(rt.dists).all()
    assert tsrv.obs_snapshot()["audit"]["contract"]["violations"] == 0


# ---- the reference harness's own cases, on the port -----------------------

def test_one_shard_ensemble_is_bitwise_exact_vote():
    pts, labels, qs = _instance(2, n=64)
    exact = _port(pts, labels, shards=1)
    ens = _port(pts, labels, shards=1, predict_mode="ensemble")
    ls = [1, 4, 9, L_MAX]
    le = _labels_of(exact.query_batch(qs, ls=ls))
    assert le.tobytes() == _labels_of(ens.query_batch(qs, ls=ls)).tobytes()


def test_ensemble_message_bill_is_touched_shards():
    pts, labels, qs = _instance(4)
    srv = _port(pts, labels, predict_mode="ensemble")
    for r in srv.query_batch(qs, ls=[3, 8, 1, L_MAX]):
        assert r.predict_mode == "ensemble"
        assert r.rounds == 1
        assert r.messages == r.shards_touched == K
        assert (r.ids == INT32_MAX).all()
        assert np.isinf(r.dists).all()


def _tie_instance():
    """A query whose l = 4 neighbourhood votes 2:2 between classes 1 and
    3 (far label-0 filler beyond l)."""
    pts = np.zeros((16, DIM), np.float32)
    pts[0, 0], pts[1, 0] = 1.0, -1.0
    pts[2, 1], pts[3, 1] = 1.0, -1.0
    pts[4:] = 100.0 + np.arange(12)[:, None]
    labels = np.zeros(16, np.float32)
    labels[[0, 2]] = 3.0
    labels[[1, 3]] = 1.0
    return pts, labels, np.zeros(DIM, np.float32)


@pytest.mark.parametrize("mode", ["exact", "ensemble"])
def test_tied_votes_are_deterministic_across_fresh_servers(mode):
    pts, labels, q = _tie_instance()
    got = []
    for _ in range(2):
        srv = _port(pts, labels, predict_mode=mode)
        r = srv.query_batch([q], ls=[4])[0]
        assert r.generation == 0
        got.append(np.float32(r.label))
    assert got[0].tobytes() == got[1].tobytes()
    # exact: the 2:2 tie goes to the lowest class; ensemble: the six far
    # label-0 shards outvote the two near tied ones
    assert got[0] == (1.0 if mode == "exact" else 0.0)


def _store(cfg, **kw):
    return MutableStore(DIM, shards=K, device="cpu",
                        **{**cfg.store_kwargs(), **kw})


@pytest.mark.parametrize("mode", ["exact", "ensemble"])
def test_tombstoned_nearest_neighbor_never_votes(mode):
    cfg = BASE.replace(predict_mode=mode, store_capacity_per_shard=16)
    store = _store(cfg)
    rng = np.random.default_rng(5)
    q = np.zeros(DIM, np.float32)
    far = rng.normal(size=(31, DIM)).astype(np.float32) + 20.0
    store.insert(far, labels=np.full(31, 2.0))
    nearest = store.insert(q + 0.01, labels=[3.0])   # lone class-3 voter
    store.flush()
    srv = KnnServer(store=store, cfg=cfg, device="cpu")
    seen = _capture_payload(srv) if mode == "ensemble" else None

    def class3_votes(r):
        if mode == "exact":
            return int(r.label == 3.0)
        return int(seen[-1][:, 0, 3].sum())

    before = srv.query_batch([q], ls=[1])[0]
    assert class3_votes(before) == 1
    srv.delete(nearest)
    srv.flush_store()
    after = srv.query_batch([q], ls=[1])[0]
    assert class3_votes(after) == 0, "tombstoned neighbor's label voted"
    assert after.label == 2.0


# ---- the labeled store against the JAX store ------------------------------

def _check_labels(js, ts):
    assert ts._labels.tobytes() == js._labels.tobytes()
    assert ts._label_of == js._label_of
    for w, g in zip(js.live_labels(), ts.live_labels()):
        assert w.tobytes() == g.tobytes()
    jsnap, tsnap = js.snapshot(), ts.snapshot()
    assert tsnap.labels.numpy().tobytes() == np.asarray(
        jsnap.labels).tobytes()
    assert np.array_equal(tsnap.ids.numpy(), np.asarray(jsnap.ids))


@pytest.mark.parametrize("kw", [
    dict(), dict(redeal="proximity", placement="affinity"),
    dict(redeal="proximity", placement="affinity", summary_pivots=2,
         split_radius_factor=1.0, split_cooldown=1)],
    ids=["round_robin", "proximity", "splits"])
def test_labels_survive_compaction_and_redeal_bit_equal(mesh8, kw):
    cfg = BASE.replace(store_capacity_per_shard=64)
    skw = {**cfg.store_kwargs(), "staging_size": 10**9, **kw}
    js = JaxStore(DIM, mesh=mesh8, axis_name="x", **skw)
    ts = MutableStore(DIM, shards=K, device="cpu", **skw)
    pts, labels, _ = _instance(9, n=256)
    rng = np.random.default_rng(9)
    more = rng.normal(size=(32, DIM)).astype(np.float32) * 4
    more_labels = rng.integers(0, NUM_CLASSES, 32).astype(np.float32)
    for st in (js, ts):
        ids = st.insert(pts, labels=labels)
        st.flush()
    _check_labels(js, ts)
    steps = [
        lambda st: st.delete(ids[::3]),
        lambda st: st.update(ids[1:40:3], pts[1:40:3] + 0.5,
                             labels=np.arange(13, dtype=np.float32)),
        lambda st: st.update(ids[2:20:3], pts[2:20:3] - 0.5),
        lambda st: st.insert(pts[:64] + 0.25),                # label 0.0
        lambda st: st.compact(),
        lambda st: st.insert(more, labels=more_labels),
    ]
    for step in steps:
        for st in (js, ts):
            step(st)
            st.flush()
        _check_labels(js, ts)
        assert ts.stats.compactions == js.stats.compactions
    keep = np.ones(len(ids), bool)
    keep[::3] = False
    upd = np.zeros(len(ids), bool)
    upd[1:40:3] = True
    want = labels.copy()
    want[upd] = np.arange(13, dtype=np.float32)
    np.testing.assert_array_equal(ts.labels_for(ids[keep]), want[keep])
    # the server votes the surviving labels, not stale slots
    srv = KnnServer(store=ts, cfg=cfg, device="cpu")
    r = srv.query_batch([pts[1]], ls=[1])[0]
    assert r.label == float(ts.labels_for([r.ids[0]])[0])
    assert srv.with_labels
    np.testing.assert_array_equal(srv.labels_for(r.ids), ts.labels_for(
        r.ids))
    # carried over from the JAX store's mirrors
    cs = convert.store_from_mirrors(
        js._pts, js._ids, js._valid, cap=64, shards=K, used=js._used,
        next_id=js._next_id, used_ids=js._used_ids, labels=js._labels,
        device="cpu", **{k: v for k, v in skw.items()
                         if k != "capacity_per_shard"})
    assert cs.with_labels
    for w, g in zip(js.live_labels(), cs.live_labels()):
        assert w.tobytes() == g.tobytes()
    assert cs.snapshot().labels.numpy().tobytes() == np.asarray(
        js.snapshot().labels).tobytes()
    cr = KnnServer(store=cs, cfg=cfg, device="cpu").query_batch(
        [pts[1]], ls=[5])[0]
    assert cr.label == KnnServer(store=ts, cfg=cfg, device="cpu").query_batch(
        [pts[1]], ls=[5])[0].label


@pytest.mark.parametrize("mode", ["exact", "ensemble"])
def test_store_predict_matches_jax_per_generation(mesh8, mode):
    """One labeled op stream into both stores; at every generation both
    servers' labels and confidences are byte-equal."""
    cfg = BASE.replace(store_capacity_per_shard=32, predict_mode=mode,
                       route="pruned", route_compute="host")
    skw = {**cfg.store_kwargs(), "staging_size": 10**9}
    js = JaxStore(DIM, mesh=mesh8, axis_name="x", **skw)
    ts = MutableStore(DIM, shards=K, device="cpu", **skw)
    jsrv = JaxServer(store=js, cfg=JBASE.replace(
        store_capacity_per_shard=32, predict_mode=mode, route="pruned",
        route_compute="host"))
    tsrv = KnnServer(store=ts, cfg=cfg, device="cpu")
    pts, labels, qs = _instance(5, n=160)
    ls = [1, 7, L_MAX, 4]
    steps = [
        lambda st: st.insert(pts[:96], labels=labels[:96]),
        lambda st: (st.insert(pts[96:], labels=labels[96:]),
                    st.delete(np.arange(0, 40, 2))),
        lambda st: (st.delete(np.arange(41, 92, 5)),
                    st.update(np.arange(1, 30, 4), pts[1:30:4] + 0.1,
                              labels=np.full(8, 3.0))),
    ]
    for step in steps:
        for st in (js, ts):
            step(st)
            st.flush()
        _check_labels(js, ts)
        res_j, res_t = jsrv.query_batch(qs, ls=ls), tsrv.query_batch(qs,
                                                                     ls=ls)
        assert _labels_of(res_t).tobytes() == _labels_of(res_j).tobytes()
        assert _confs_of(res_t).tobytes() == _confs_of(res_j).tobytes()
        for rt, rj in zip(res_t, res_j):
            assert rt.generation == rj.generation == ts.generation
            assert rt.shards_touched == rj.shards_touched
    jsrv.close()


def test_racing_ingest_keeps_the_ensemble_bill():
    """Ensemble answers under concurrent labeled inserts: every bill is 1
    round and one message a touched shard, every label a class, and the
    accuracy shadow audit (obs_audit_every=1, the reference's case; it
    was refused until the audit was ported) replays every batch through
    the exact fold at the batch's own generation and never dips below
    the floor."""
    cfg = BASE.replace(predict_mode="ensemble", route="pruned",
                       route_compute="host", store_capacity_per_shard=256,
                       obs_audit_every=1, accuracy_floor=0.9)
    store = _store(cfg)
    pts, labels, centers = tsynth.labeled_mixture(512, DIM, NUM_CLASSES,
                                                  separation=8.0, seed=11)
    labels = labels.astype(np.float32)
    store.insert(pts[:256], labels=labels[:256])
    store.flush()
    srv = KnnServer(store=store, cfg=cfg, device="cpu")
    stop = threading.Event()

    def ingest():
        i = 256
        while not stop.is_set() and i < 512:
            srv.insert(pts[i:i + 8], labels=labels[i:i + 8])
            srv.flush_store()
            i += 8

    t = threading.Thread(target=ingest)
    t.start()
    gens = set()
    try:
        rng = np.random.default_rng(12)
        for _ in range(12):
            qs = (centers[rng.integers(0, NUM_CLASSES, 4)]
                  + 0.5 * rng.normal(size=(4, DIM))).astype(np.float32)
            for r in srv.query_batch(qs, ls=[5, 5, 5, 5]):
                assert r.rounds == 1
                assert r.messages == r.shards_touched >= 1
                assert r.label in range(NUM_CLASSES)
                gens.add(r.generation)
    finally:
        stop.set()
        t.join()
    assert srv.obs_snapshot()["audit"]["contract"]["violations"] == 0
    shadow = srv.obs_snapshot()["audit"]["shadow"]
    assert shadow["mode"] == "accuracy" and shadow["checks"] == 12
    assert shadow["divergences"] == 0, shadow["details"]
