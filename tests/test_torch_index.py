"""The approx bucket index in the port against the JAX reference, on CPU.

* The build (``IndexMaintainer.rebuild``) equals the reference's:
  centers and radii within 1e-9 relative, assignments, live counts and
  bucket counts equal.
* The host rule (``bucket_keep``, ``candidate_mask``,
  ``candidate_fraction``) equals the reference's on the same inputs.
* ``ops.index_mask`` (the plain version on the CPU) equals the
  reference's ``kops.index_mask`` (Pallas in interpret mode) bit for bit
  on the routing test instances.  The reference calls this tier
  approximate, so the rule held here is: an entry that differs must be
  one whose bucket's lower bound lies within f32 rounding of the row's
  threshold; the test names any such entry.
* Serving: with ``index_oversample=1e9`` every live bucket is kept and
  answers are byte-identical to exact on each route mode
  (tests/test_index.py:145); on tests/test_index.py:169's clustered
  instance recall@l is >= 0.95 and the mean candidate fraction < 0.75;
  and the port's approx answers match the JAX approx server's.
"""

import numpy as np
import pytest
import torch

from repro.configs.knn_service import CONFIG as JCONFIG
from repro.kernels import ops as jops
from repro.kernels import routing as jrouting
from repro.runtime import KnnServer as JaxServer
from repro.store import build_summaries as jbuild
from repro.store import route_shards as jroute
from repro.store.index import IndexMaintainer as JIndex
from repro.store.index import bucket_keep as jkeep
from repro.store.index import candidate_fraction as jfrac
from repro.store.index import candidate_mask as jcand
from repro_torch.configs import CONFIG
from repro_torch.kernels import ops as tops
from repro_torch.kernels import routing as trouting
from repro_torch.runtime import KnnServer
from repro_torch.store import index as tindex

from test_torch_routing import FAMILIES, L_SET, _instance

# the cases are small: one intra-op thread a process is faster here than
# a pool, and leaves the cores to the other test processes
torch.set_num_threads(1)

K = 8
DIM = 8
M = 64
N = K * M
L_MAX = 16
_SENT = 2**31 - 1
F32_EPS = float(np.finfo(np.float32).eps)


def _pair(pts, valid, b):
    j = JIndex(K, len(pts) // K, DIM, b)
    j.rebuild(pts, np.ones(len(pts), bool) if valid is None else valid)
    t = tindex.IndexMaintainer(K, len(pts) // K, DIM, b)
    t.rebuild(pts, valid)
    return j.freeze(0), t.freeze(0)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("buckets", [1, 4, 8])
@pytest.mark.parametrize("family", FAMILIES)
def test_index_build_matches_jax(family, buckets, masked):
    pts, _ = _instance(family, 3)
    valid = None
    if masked:
        valid = np.random.default_rng(4).random(N) > 0.4
        valid[5 * M:6 * M] = False
    a, b = _pair(pts, valid, buckets)
    for f in ("assign", "live", "count"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    np.testing.assert_allclose(b.centers, a.centers, rtol=1e-9, atol=0)
    np.testing.assert_allclose(b.radii, a.radii, rtol=1e-9, atol=0)
    assert b.num_buckets == buckets


@pytest.mark.parametrize("oversample", [1.0, 2.0, 1e9])
@pytest.mark.parametrize("family", FAMILIES)
def test_host_rule_matches_jax(family, oversample):
    pts, q = _instance(family, 9)
    a, b = _pair(pts, None, 4)
    ls = np.array([0, 1, 8, 256])
    summ = jbuild(pts, K)
    for rows in (None, jroute(summ, q, ls)):
        want = jkeep(a, q, ls, rows, oversample=oversample)
        got = tindex.bucket_keep(b, q, ls, rows, oversample=oversample)
        assert np.array_equal(got, want)
        assert not got[0].any()                    # l = 0 keeps nothing
        keep_any = got.any(0)
        assert np.array_equal(tindex.candidate_mask(b, keep_any, M),
                              jcand(a, keep_any, M))
        assert tindex.candidate_fraction(b, keep_any) == jfrac(a, keep_any)


@pytest.mark.parametrize("l", L_SET)
@pytest.mark.parametrize("family", FAMILIES)
def test_index_mask_matches_jax(family, l):
    for seed in (0, 7):
        pts, q = _instance(family, seed)
        la = np.full(len(q), l, np.int64)
        la[0] = 0
        a, b = _pair(pts, None, 4)
        rows = jroute(jbuild(pts, K), q, la).astype(np.int32)
        want = np.asarray(jops.index_mask(q, la, rows,
                                          jrouting.pack_index(a)))
        qt, lt = torch.from_numpy(q), torch.from_numpy(la)
        rt = torch.from_numpy(rows)
        packed = trouting.pack_index(b)
        got = tops.index_mask(qt, lt, rt, packed).numpy()
        assert not got[0].any()
        g, lb, T = trouting.index_parts(
            qt, lt, rt, trouting.on_device(packed, "cpu"))
        for r, c in zip(*np.nonzero(got != want)):
            bound, thr = float(lb[r, c]), float(T[r, 0])
            assert bool(g[r, c]) and abs(bound - thr) <= 4 * F32_EPS * abs(
                thr), (f"row {r} bucket {c} ({family}, seed {seed}): "
                       f"lb {bound} vs T {thr}")


# ---- serving ---------------------------------------------------------------

def _cfg(**kw):
    return CONFIG.replace(**{**dict(dim=DIM, l=4, l_max=L_MAX,
                                    bucket_sizes=(4,)), **kw})


def _clustered(rng, per_shard=24, scale=50.0):
    """tests/test_index.py's ``_clustered``."""
    centers = rng.normal(size=(K, DIM)) * scale
    pts = (centers[:, None, :]
           + rng.normal(size=(K, per_shard, DIM))).reshape(-1, DIM)
    return pts.astype(np.float32), centers


MODES = [("exact", "host"), ("pruned", "host"), ("pruned", "device")]


@pytest.mark.parametrize("route,compute", MODES)
def test_huge_oversample_bit_identical_to_exact(route, compute):
    rng = np.random.default_rng(0)
    pts, centers = _clustered(rng)
    kw = dict(route=route, route_compute=compute)
    se = KnnServer(pts, cfg=_cfg(**kw), device="cpu")
    sa = KnnServer(pts, cfg=_cfg(search="approx", index_buckets=4,
                                 index_oversample=1e9, **kw), device="cpu")
    qs = (centers[[0, 3, 5]] + rng.normal(size=(3, DIM))).astype(np.float32)
    for a, b in zip(se.query_batch(qs, [4, 2, 4]),
                    sa.query_batch(qs, [4, 2, 4])):
        assert a.dists.tobytes() == b.dists.tobytes()
        assert a.ids.tobytes() == b.ids.tobytes()
        assert a.recall_mode == "exact" and b.recall_mode == "approx"
    # every live bucket of the routed shards is a candidate (a pruned
    # shard's buckets count as dropped)
    cf = sa.obs_snapshot()["metrics"]["serve.candidate_fraction"]
    assert cf["count"] == 1
    assert (cf["max"] == 1.0) == (route == "exact")


@pytest.mark.parametrize("route,compute", MODES)
def test_approx_recall_floor_and_candidate_reduction(route, compute):
    rng = np.random.default_rng(0)
    pts, centers = _clustered(rng)
    kw = dict(route=route, route_compute=compute)
    se = KnnServer(pts, cfg=_cfg(**kw), device="cpu")
    sa = KnnServer(pts, cfg=_cfg(search="approx", index_buckets=4, **kw),
                   device="cpu")
    sa.warmup()
    recalls = []
    for wave in range(4):
        qs = (centers[[wave, wave + 2, wave + 4]]
              + rng.normal(size=(3, DIM))).astype(np.float32)
        for a, b in zip(se.query_batch(qs, [4] * 3),
                        sa.query_batch(qs, [4] * 3)):
            truth = set(a.ids[a.ids != _SENT].tolist())
            recalls.append(len(truth & set(b.ids.tolist()))
                           / max(len(truth), 1))
    assert min(recalls) >= 0.95, recalls
    cf = sa.obs_snapshot()["metrics"]["serve.candidate_fraction"]
    assert cf["count"] >= 4 and cf["mean"] < 0.75


@pytest.fixture(scope="module")
def jax_approx(mesh8):
    """The JAX approx server (pruned, host routing) on test_index.py's
    clustered instance, its answers and candidate fractions."""
    rng = np.random.default_rng(1)
    pts, centers = _clustered(rng)
    qs = (centers[[1, 4, 6, 6]] + rng.normal(size=(4, DIM))).astype(
        np.float32)
    ls = [4, 16, 1, 9]
    cfg = JCONFIG.replace(dim=DIM, l=4, l_max=L_MAX, bucket_sizes=(4,),
                          route="pruned", search="approx", index_buckets=4)
    srv = JaxServer(pts, cfg=cfg, mesh=mesh8, axis_name="x")
    res = srv.query_batch(qs, ls)
    frac = srv.obs_snapshot()["metrics"]["serve.candidate_fraction"]["mean"]
    return pts, qs, ls, res, frac


@pytest.mark.parametrize("compute", ["host", "device"])
def test_approx_server_matches_jax(jax_approx, compute):
    pts, qs, ls, want, want_frac = jax_approx
    srv = KnnServer(pts, cfg=_cfg(route="pruned", route_compute=compute,
                                  search="approx", index_buckets=4),
                    device="cpu")
    got = srv.query_batch(qs, ls)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.dists, b.dists, rtol=1e-4, atol=1e-3)
        assert a.recall_mode == b.recall_mode == "approx"
        assert a.shards_touched == b.shards_touched
    frac = srv.obs_snapshot()["metrics"]["serve.candidate_fraction"]["mean"]
    assert frac == pytest.approx(want_frac)


def test_search_knob_validation():
    with pytest.raises(ValueError, match="search"):
        KnnServer(np.zeros((8, DIM), np.float32), cfg=_cfg(search="fuzzy"),
                  device="cpu")
    with pytest.raises(ValueError, match="index_buckets"):
        KnnServer(np.zeros((8, DIM), np.float32),
                  cfg=_cfg(search="approx", index_buckets=0), device="cpu")


def test_bucket_rows_per_store_generation_equal_host():
    """Each generation's index (and summaries), packed anew per
    generation by the server: the plain route_index bucket rows equal
    host ``bucket_keep`` gated by host ``route_shards``, except an entry
    whose bucket's lower bound lies within f32 rounding of the row's
    threshold (named by the test); the packed operands are the reference
    packing of this generation's; and the server's slot decode of the
    batch union is host ``candidate_mask``."""
    from test_torch_routing import store_generations
    la = np.array([0, 1, 8, 40])
    lt = torch.from_numpy(la.astype(np.int32))
    srv = None
    for st, q in store_generations(2, 13, buckets=4):
        _, summ, idx = st.serving_snapshot()
        if srv is None:
            srv = KnnServer(store=st, cfg=_cfg(
                route="pruned", route_compute="device", search="approx",
                index_buckets=4, summary_pivots=2), device="cpu")
        packed = srv._operands(summ, idx)[0]
        want_buf = trouting.PackedRouting(trouting.pack_summaries(summ),
                                          trouting.pack_index(idx),
                                          device="cpu").buf
        assert torch.equal(packed.buf, want_buf)
        qt = torch.from_numpy(q)
        rows, keep, unions = tops.route_index(qt, lt, packed)
        host_rows = jroute(summ, q, la)
        assert np.array_equal(rows.numpy() != 0, host_rows)
        want = tindex.bucket_keep(idx, q, la, host_rows).reshape(len(q), -1)
        g, lb, T = trouting.index_parts(qt, lt, rows, packed.index_ops())
        for r, c in zip(*np.nonzero((keep.numpy() != 0) != want)):
            bound, thr = float(lb[r, c]), float(T[r, 0])
            assert bool(g[r, c]) and abs(bound - thr) <= 4 * F32_EPS * abs(
                thr), f"gen {st.generation} row {r} bucket {c}"
        keep_any = unions[K:].numpy().reshape(K, -1)
        _, cand, _, frac, _, _, _ = srv._prologue(
            q, la.astype(np.int32), qt, lt, summ, idx)
        assert np.array_equal(cand.reshape(-1).numpy(),
                              tindex.candidate_mask(idx, keep_any, M))
        assert frac == tindex.candidate_fraction(idx, keep_any)
