"""The store's host machinery in the port against the JAX reference, on
the CPU, from numpy seeds.

* Compaction (``evaluate``, ``redeal_slack``, ``repack``,
  ``scatter_operands``, ``payload_operand``, ``remap_payload``), the
  proximity re-deal (``lloyd_centroids``, ``repack_proximity``) and both
  placement policies are bit-equal to the reference's.
* The incremental ops are bit-equal: ``SummaryMaintainer`` and
  ``AdaptiveMaintainer`` insert / delete / update (their whole state,
  ``placement_view``, ``retighten_due`` and ``split_candidate``) and
  ``IndexMaintainer`` insert / delete / update.  After an exact rebuild
  (``retighten``, ``rebuild``) the port's torch-f64 build agrees to f64
  rounding: ``REBUILD_TOL`` (rtol 1e-12), counts and assignments equal.
* The covering probes (``summary_invariants``, ``summary_slack``,
  ``summary_slack_sampled``) and ``drifting_clusters`` are bit-equal.
* ``convert.store_from_mirrors`` continues a JAX store mid-stream: the
  same later ops give equal live sets and equal answers.
"""

import numpy as np
import pytest

from repro.configs.knn_service import CONFIG as JCONFIG
from repro.data import drifting_clusters as jdrift
from repro.runtime import KnnServer as JaxServer
from repro.store import MutableStore as JaxStore
from repro.store import adaptive as jadaptive
from repro.store import compaction as jcomp
from repro.store import index as jindex
from repro.store import placement as jplace
from repro.store import summaries as jsumm
from repro_torch import convert
from repro_torch.configs import CONFIG
from repro_torch.data import drifting_clusters as tdrift
from repro_torch.runtime import KnnServer
from repro_torch.store import adaptive as tadaptive
from repro_torch.store import compaction as tcomp
from repro_torch.store import index as tindex
from repro_torch.store import placement as tplace
from repro_torch.store import summaries as tsumm

K = 8
DIM = 6
CAP = 40
SENT = 2**31 - 1
REBUILD_TOL = dict(rtol=1e-12, atol=1e-12)


def _mirrors(seed, *, live_frac=0.6):
    """Store-like mirrors: (points, ids, valid), ids unique, some dead."""
    rng = np.random.default_rng(seed)
    n = K * CAP
    pts = (rng.normal(size=(n, DIM)) * 3).astype(np.float32)
    valid = rng.random(n) < live_frac
    ids = np.full(n, SENT, np.int32)
    ids[valid] = rng.permutation(10 * n)[:int(valid.sum())]
    return pts, ids, valid


def _same(a, b):
    """Equal NamedTuples / arrays / dicts, exactly."""
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == np.asarray(b).dtype and np.array_equal(a, b)
    else:
        assert a == b


# ---- compaction ------------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_evaluate_and_redeal_slack_match_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        live = rng.integers(0, CAP, K)
        used = np.minimum(live + rng.integers(0, CAP, K), CAP)
        for tomb, imb in ((0.35, 0.5), (0.1, 0.1), (10.0, 10.0)):
            _same(tcomp.evaluate(live, used, CAP, tombstone_frac=tomb,
                                 imbalance_frac=imb),
                  jcomp.evaluate(live, used, CAP, tombstone_frac=tomb,
                                 imbalance_frac=imb))
        gs, frac = int(rng.integers(0, 64)), float(rng.random())
        assert tcomp.redeal_slack(gs, frac, CAP, K) == jcomp.redeal_slack(
            gs, frac, CAP, K)


@pytest.mark.parametrize("seed", range(4))
def test_repack_and_operands_match_jax(seed):
    pts, ids, valid = _mirrors(seed)
    _same(tcomp.repack(pts, ids, valid, K, CAP, id_sentinel=SENT),
          jcomp.repack(pts, ids, valid, K, CAP, id_sentinel=SENT))
    slots = sorted(np.random.default_rng(seed).choice(K * CAP, 13, False))
    _same(tcomp.scatter_operands(slots, pts, ids, valid, K * CAP, DIM,
                                 id_sentinel=SENT),
          jcomp.scatter_operands(slots, pts, ids, valid, K * CAP, DIM,
                                 id_sentinel=SENT))
    pay = np.random.default_rng(seed).random(K * CAP).astype(np.float32)
    _same(tcomp.payload_operand(slots, pay, 16),
          jcomp.payload_operand(slots, pay, 16))
    res = jcomp.repack(pts, ids, valid, K, CAP, id_sentinel=SENT)
    _same(tcomp.remap_payload(pay, ids, valid, res.ids, res.valid),
          jcomp.remap_payload(pay, ids, valid, res.ids, res.valid))


@pytest.mark.parametrize("slack", [0, 3, 32])
@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_proximity_redeal_matches_jax(seed, seeded, slack):
    pts, ids, valid = _mirrors(seed)
    cents = (np.random.default_rng(seed + 9).normal(size=(5, DIM)) * 3
             if seeded else None)
    live = np.asarray(pts[valid], np.float64)
    _same(tplace.lloyd_centroids(live, K, seed_centroids=cents),
          jplace.lloyd_centroids(live, K, seed_centroids=cents))
    _same(tplace.repack_proximity(pts, ids, valid, K, CAP, id_sentinel=SENT,
                                  seed_centroids=cents, balance_slack=slack),
          jplace.repack_proximity(pts, ids, valid, K, CAP, id_sentinel=SENT,
                                  seed_centroids=cents, balance_slack=slack))


@pytest.mark.parametrize("name", ["balance", "affinity"])
def test_placement_policies_match_jax(name):
    """Random views, with empty and full shards and unoccupied rows."""
    rng = np.random.default_rng(11)
    tp = tplace.make_placement(name, guard_slack=3)
    jp = jplace.make_placement(name, guard_slack=3)
    assert (tp.name, tp.uses_centroids) == (jp.name, jp.uses_centroids)
    for _ in range(300):
        live = rng.integers(0, CAP, K)
        used = np.minimum(live + rng.integers(0, 4, K), CAP)
        if rng.random() < 0.1:
            used[:] = CAP
        occupied = live > 0
        cents = np.where(occupied[:, None], rng.normal(size=(K, DIM)) * 4,
                         0.0)
        radii = np.where(occupied, rng.random(K) * 3, 0.0)
        point = (rng.normal(size=DIM) * 5).astype(np.float32)
        view = dict(live=live, used=used, cap=CAP, centroids=cents,
                    radii=radii, occupied=occupied)
        assert tp.pick(point, tplace.PlacementView(**view)) == jp.pick(
            point, jplace.PlacementView(**view))
    with pytest.raises(ValueError):
        tplace.make_placement("nearest")
    with pytest.raises(ValueError):
        tplace.AffinityPlacement(guard_slack=-1)
    custom = tplace.BalancePlacement()
    assert tplace.make_placement(custom) is custom


# ---- incremental summaries and index ---------------------------------------

def _op_stream(seed, n_ops=300):
    """(kind, shard, point, old point) ops from a seed, each shard's
    deletes and updates taken from its own live points."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(K, DIM)) * 6
    live = {j: [] for j in range(K)}
    ops = []
    for _ in range(n_ops):
        j = int(rng.integers(0, K))
        kind = rng.choice(["insert", "delete", "update"], p=[0.6, 0.2, 0.2])
        if kind == "insert" or not live[j]:
            p = (centres[j] + rng.normal(size=DIM)).astype(np.float32)
            live[j].append(p)
            ops.append(("insert", j, p, None))
        elif kind == "delete":
            old = live[j].pop(int(rng.integers(0, len(live[j]))))
            ops.append(("delete", j, None, old))
        else:
            t = int(rng.integers(0, len(live[j])))
            p = (centres[j] + 2 * rng.normal(size=DIM)).astype(np.float32)
            ops.append(("update", j, p, live[j][t]))
            live[j][t] = p
    return ops


def _apply(m, op):
    kind, j, p, old = op
    if kind == "insert":
        m.insert(j, p)
    elif kind == "delete":
        m.delete(j, old)
    else:
        m.update(j, old, p)


_ADAPTIVE_STATE = ("_sum", "_n", "_radius", "_lo", "_hi", "_piv", "_piv_r",
                   "_piv_n", "_piv_live", "_ops_since", "_radius_at_rebuild")


@pytest.mark.parametrize("pivots", [1, 3])
@pytest.mark.parametrize("seed", range(3))
def test_incremental_summaries_match_jax(seed, pivots):
    """Op for op, the whole maintainer state, its freeze, placement view,
    re-tightening schedule and split choice are bit-equal; a re-tightened
    shard agrees to f64 rounding."""
    mk = dict(num_projections=4, seed=seed, num_pivots=pivots,
              retighten_every=7, split_radius_factor=0.8)
    a = jadaptive.AdaptiveMaintainer(K, DIM, **mk)
    b = tadaptive.AdaptiveMaintainer(K, DIM, **mk)
    sa = jsumm.SummaryMaintainer(K, DIM, num_projections=4, seed=seed)
    sb = tsumm.SummaryMaintainer(K, DIM, num_projections=4, seed=seed)
    for step, op in enumerate(_op_stream(seed)):
        for m in (a, b, sa, sb):
            _apply(m, op)
        for f in _ADAPTIVE_STATE:
            assert np.array_equal(getattr(a, f), getattr(b, f)), (step, f)
        for f in ("_sum", "_n", "_radius", "_lo", "_hi"):
            assert np.array_equal(getattr(sa, f), getattr(sb, f)), (step, f)
        if step % 25 == 0:
            _same(b.freeze(step), a.freeze(step))
            _same(sb.freeze(step), sa.freeze(step))
            _same(b.placement_view(), a.placement_view())
            assert b.split_candidate() == a.split_candidate()
            ja, jb = a.retighten_due(), b.retighten_due()
            assert ja == jb and a._rr == b._rr
    # an exact re-tightening of each shard from mirrors of its live points
    pts = np.zeros((K * CAP, DIM), np.float32)
    valid = np.zeros(K * CAP, bool)
    rng = np.random.default_rng(seed + 50)
    for j in range(K):
        n = int(rng.integers(0, CAP))
        pts[j * CAP:j * CAP + n] = rng.normal(size=(n, DIM)) + j
        valid[j * CAP:j * CAP + n] = True
    for j in range(K):
        a.retighten(j, pts, valid, CAP)
        b.retighten(j, pts, valid, CAP)
    for f in ("_n", "_piv_n", "_piv_live", "_ops_since"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    for f in ("_sum", "_radius", "_lo", "_hi", "_piv", "_piv_r",
              "_radius_at_rebuild"):
        np.testing.assert_allclose(getattr(b, f), getattr(a, f),
                                   **REBUILD_TOL)
    assert b.split_candidate() == a.split_candidate()


@pytest.mark.parametrize("seed", range(3))
def test_covering_probes_match_jax(seed):
    pts, _, valid = _mirrors(seed)
    m = jadaptive.AdaptiveMaintainer(K, DIM, num_pivots=2)
    for op in _op_stream(seed, 120):
        _apply(m, op)
    s = m.freeze(3)
    _same(tsumm.summary_invariants(s, pts, valid, CAP),
          jsumm.summary_invariants(s, pts, valid, CAP))
    _same(tsumm.summary_slack(s, pts, valid, CAP),
          jsumm.summary_slack(s, pts, valid, CAP))
    _same(tsumm.summary_slack_sampled(s, pts, valid, CAP, sample=5,
                                      rng=np.random.default_rng(seed)),
          jsumm.summary_slack_sampled(s, pts, valid, CAP, sample=5,
                                      rng=np.random.default_rng(seed)))


@pytest.mark.parametrize("buckets", [1, 4])
@pytest.mark.parametrize("seed", range(3))
def test_incremental_index_matches_jax(seed, buckets):
    """Insert / delete / update op for op bit-equal; then the exact
    rebuild agrees to f64 rounding with equal assignments."""
    a = jindex.IndexMaintainer(K, CAP, DIM, buckets)
    b = tindex.IndexMaintainer(K, CAP, DIM, buckets)
    rng = np.random.default_rng(seed)
    pts = np.zeros((K * CAP, DIM), np.float32)
    valid = np.zeros(K * CAP, bool)
    used = np.zeros(K, int)
    for step in range(250):
        kind = rng.choice(["insert", "delete", "update"], p=[0.6, 0.2, 0.2])
        j = int(rng.integers(0, K))
        mine = np.flatnonzero(valid[j * CAP:(j + 1) * CAP]) + j * CAP
        if (kind == "insert" or not mine.size) and used[j] < CAP:
            slot = j * CAP + used[j]
            used[j] += 1
            p = (rng.normal(size=DIM) * 2 + j).astype(np.float32)
            pts[slot], valid[slot] = p, True
            for m in (a, b):
                m.insert(j, slot, p)
        elif kind == "delete" and mine.size:
            slot = int(rng.choice(mine))
            valid[slot] = False
            for m in (a, b):
                m.delete(slot)
        elif mine.size:
            slot = int(rng.choice(mine))
            pts[slot] = (rng.normal(size=DIM) * 3 + j).astype(np.float32)
            for m in (a, b):
                m.update(slot, pts[slot])
        _same(b.freeze(step), a.freeze(step))
    a.rebuild(pts, valid)
    b.rebuild(pts, valid)
    fa, fb = a.freeze(0), b.freeze(0)
    for f in ("assign", "live", "count"):
        assert np.array_equal(getattr(fa, f), getattr(fb, f)), f
    np.testing.assert_allclose(fb.centers, fa.centers, **REBUILD_TOL)
    np.testing.assert_allclose(fb.radii, fa.radii, **REBUILD_TOL)


def test_drifting_clusters_match_jax():
    kw = dict(steps=4, drift=8.0, scale=12.0, seed=17)
    for (pa, ca), (pb, cb) in zip(jdrift(K, 5, DIM, **kw),
                                  tdrift(K, 5, DIM, **kw)):
        _same(pb, pa)
        _same(cb, ca)


# ---- continuing a reference store ------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(), dict(placement="affinity", redeal="proximity", summary_pivots=2,
                 index_buckets=4)])
def test_store_from_mirrors_continues_jax_store(mesh8, kw):
    """A JAX store's state carried into the port mid-stream: the used ids
    carry over (a deleted id cannot come back), the same later ops leave
    the same live set, and both servers answer alike
    (ids as sets, distances within rtol 1e-4 / atol 1e-3) at every
    generation."""
    rng = np.random.default_rng(21)
    js = JaxStore(DIM, capacity_per_shard=CAP, mesh=mesh8, axis_name="x",
                  staging_size=10**9, with_values=True, **kw)
    ids = js.insert(rng.normal(size=(150, DIM)).astype(np.float32),
                    values=np.arange(150) * 2)
    js.flush()
    js.delete(ids[::3])
    js.update(ids[1:20:3], rng.normal(size=(7, DIM)).astype(np.float32))
    js.flush()
    ts = convert.store_from_mirrors(
        js._pts, js._ids, js._valid, cap=CAP, shards=K, values=js._values,
        generation=js.generation, device="cpu", used=js._used,
        next_id=js._next_id, used_ids=js._used_ids, staging_size=10**9,
        **kw)
    assert ts.generation == js.generation
    assert ts._used_ids == js._used_ids and ts._next_id == js._next_id
    for st in (js, ts):     # a deleted id stays used across the carry
        with pytest.raises(ValueError, match="single-use"):
            st.insert(np.zeros((1, DIM), np.float32), ids=[int(ids[0])],
                      values=[0])
    for a, b in zip(ts.live_arrays(), js.live_arrays()):
        assert np.array_equal(a, b)
    assert np.array_equal(ts.live_per_shard, js.live_per_shard)
    assert np.array_equal(ts._used, js._used)
    base = dict(dim=DIM, l=8, l_max=16, bucket_sizes=(4,),
                summary_pivots=kw.get("summary_pivots", 1))
    tsrv = KnnServer(store=ts, cfg=CONFIG.replace(**base), device="cpu")
    jsrv = JaxServer(store=js, cfg=JCONFIG.replace(**base))
    for step in range(4):
        if step:
            pts = rng.normal(size=(20, DIM)).astype(np.float32)
            live = js.live_arrays()[0]
            gone = rng.choice(live, 10, replace=False)
            for st in (js, ts):
                st.insert(pts, values=np.arange(20))
                st.delete(gone)
                st.flush()
            for a, b in zip(ts.live_arrays(), js.live_arrays()):
                assert np.array_equal(a, b)
        qs = rng.normal(size=(3, DIM)).astype(np.float32)
        for a, b in zip(tsrv.query_batch(qs, [8, 2, 16]),
                        jsrv.query_batch(qs, [8, 2, 16])):
            assert a.generation == b.generation
            assert set(a.ids.tolist()) == set(b.ids.tolist())
            np.testing.assert_allclose(a.dists, b.dists, rtol=1e-4,
                                       atol=1e-3)
            assert np.array_equal(a.values, b.values)
