"""Algorithms 1 and 2 in the port against the JAX reference on the CPU.

The JAX functions run under shard_map on the 8-device CPU mesh (the
``mesh8`` fixture); the port runs the same data split 8 ways as a leading
shard dimension.  Winners must match: the same threshold id, the
threshold value within f32 tolerance and the same selected mask.  The
random streams differ (jax.random vs torch.Generator), so iteration
counts are held to the cap and survivors to >= l, not to equality.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import repro.core as jcore
from repro.parallel.compat import shard_map
from repro_torch.core import knn as tknn
from repro_torch.core import sampling as tsampling
from repro_torch.core import selection as tsel
from repro_torch.parallel import collectives

# the cases are small: one intra-op thread a process is faster here than
# a pool, and leaves the cores to the other test processes
torch.set_num_threads(1)

K = 8
DIM = 8
N = K * 256
INT32_MAX = 2**31 - 1


@pytest.fixture(scope="module")
def pts():
    return np.random.default_rng(3).normal(size=(N, DIM)).astype(np.float32)


def _by_shard(x):
    """(B, K*m) columns split over K shards -> (K, B, m) tensor."""
    B = x.shape[0]
    return torch.from_numpy(
        np.ascontiguousarray(x.reshape(B, K, -1).transpose(1, 0, 2)))


def _gen(seed=0):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _jax_select(mesh, vals, ids, l, valid=None, num_pivots=1):
    res_spec = jcore.SelectionResult(P(None), P(None), P(), P(None))

    def fn(v, i, ll, key, *va):
        vv = va[0] if va else None
        res = jcore.select_l_smallest(v, i, ll, key, axis_name="x",
                                      valid=vv, num_pivots=num_pivots)
        return res, jcore.selected_mask(v, i, res, valid=vv)

    in_specs = [P(None, "x"), P(None, "x"), P(None), P(None)]
    args = [vals, ids, l, jax.random.PRNGKey(0)]
    if valid is not None:
        in_specs.append(P(None, "x"))
        args.append(valid)
    f = jax.jit(shard_map(fn, mesh=mesh, in_specs=tuple(in_specs),
                          out_specs=(res_spec, P(None, "x"))))
    return f(*args)


@pytest.mark.parametrize("num_pivots", [1, 4])
@pytest.mark.parametrize("with_valid", [False, True])
def test_select_l_smallest_matches_jax(mesh8, rng, num_pivots, with_valid):
    B, m = 4, 64
    vals = rng.random((B, K * m)).astype(np.float32)
    vals[:, ::37] = np.inf                     # sentinel slots
    ids = np.broadcast_to(np.arange(K * m, dtype=np.int32),
                          (B, K * m)).copy()
    l = np.array([1, 17, 200, K * m], np.int32)
    valid = rng.random((B, K * m)) > 0.3 if with_valid else None
    jres, jmask = _jax_select(mesh8, vals, ids, l, valid, num_pivots)

    tres = tsel.select_l_smallest(
        _by_shard(vals), _by_shard(ids), torch.from_numpy(l), _gen(),
        valid=None if valid is None else _by_shard(valid),
        num_pivots=num_pivots)
    tmask = tsel.selected_mask(_by_shard(vals), _by_shard(ids), tres,
                               valid=None if valid is None
                               else _by_shard(valid))
    np.testing.assert_array_equal(tres.threshold_i.numpy(),
                                  np.asarray(jres.threshold_i))
    np.testing.assert_allclose(tres.threshold_v.numpy(),
                               np.asarray(jres.threshold_v), rtol=1e-6)
    got_mask = tmask.permute(1, 0, 2).reshape(B, K * m).numpy()
    np.testing.assert_array_equal(got_mask, np.asarray(jmask))
    assert bool(tres.converged.all())
    assert tres.iterations <= tsel.iteration_cap(K * m)
    assert tres.host_syncs == tres.iterations + 1


def test_select_cap_reports_unconverged(rng):
    """A cap of 1 iteration cannot find rank 200 of 512: the row reports
    converged=False and the loop stops at the cap."""
    vals = rng.random((1, K * 64)).astype(np.float32)
    ids = np.arange(K * 64, dtype=np.int32)[None]
    res = tsel.select_l_smallest(_by_shard(vals), _by_shard(ids), 200,
                                 _gen(), max_iterations=1)
    assert res.iterations == 1 and not bool(res.converged.all())


def test_sample_prune_keeps_true_top_l(mesh8, rng, pts):
    """Lemma 2.3 with the Las Vegas check: >= l survivors globally and the
    true l nearest all survive, in the port as in the reference."""
    L = 32
    q = rng.normal(size=(6, DIM)).astype(np.float32)
    d, gid = tknn.local_distance_top_l(
        torch.from_numpy(q), torch.from_numpy(pts.reshape(K, -1, DIM)),
        torch.arange(N, dtype=torch.int32).reshape(K, -1), L)
    ls = torch.tensor([1, 5, 32, 17, 8, 32], dtype=torch.int32)
    prune = tsampling.sample_prune(d, _gen(1), ls)
    assert (prune.survivors >= ls).all()
    assert torch.equal(prune.survivors,
                       collectives.psum(prune.valid.sum(-1,
                                                        dtype=torch.int32)))
    full = ((q[:, None, :] - pts[None]) ** 2).sum(-1)
    for b in range(len(q)):
        true = set(np.argsort(full[b], kind="stable")[:int(ls[b])].tolist())
        kept = set(gid[:, b][prune.valid[:, b]].tolist())
        assert true <= kept

    def fn(dd, key):
        return jcore.sample_prune(dd, key, L, axis_name="x").survivors

    f = jax.jit(shard_map(fn, mesh=mesh8, in_specs=(P("x"), P(None)),
                          out_specs=P(None)))
    # shard j of P("x") holds rows [j*B, (j+1)*B): the port's (K, B, L)
    jsurv = np.asarray(f(d.numpy().reshape(K * 6, L), jax.random.PRNGKey(0)))
    assert (jsurv >= L).all()


def _jax_batched(mesh, pts, q, l_max, ls):
    pids = np.arange(N, dtype=np.int32)

    def fn(p, i, qq, la, key):
        res = jcore.knn_query_batched(p, i, qq, l_max, la, key,
                                      axis_name="x")
        sd, si = jcore.knn_simple(p, i, qq, l_max, axis_name="x")
        return res.dists, res.ids, sd, si

    f = jax.jit(shard_map(
        fn, mesh=mesh,
        in_specs=(P("x"), P("x"), P(None), P(None), P(None)),
        out_specs=(P(None),) * 4))
    return [np.asarray(x) for x in f(pts, pids, q, ls,
                                     jax.random.PRNGKey(0))]


def test_knn_query_batched_and_simple_match_jax(mesh8, rng, pts):
    """Mixed l including 0 (bucket padding): the same winners as the
    reference, sentinels past each row's l, and knn_simple equal to the
    reference's simple method."""
    l_max = 32
    ls = np.array([1, 5, 32, 0, 17], np.int32)
    q = rng.normal(size=(5, DIM)).astype(np.float32)
    jd, ji, jsd, jsi = _jax_batched(mesh8, pts, q, l_max, ls)

    tp = torch.from_numpy(pts.reshape(K, -1, DIM))
    tids = torch.arange(N, dtype=torch.int32).reshape(K, -1)
    res = tknn.knn_query_batched(tp, tids, torch.from_numpy(q), l_max,
                                 torch.from_numpy(ls), _gen())
    d, i = res.dists.numpy(), res.ids.numpy()
    for b, l in enumerate(ls):
        np.testing.assert_allclose(np.sort(d[b, :l]), np.sort(jd[b, :l]),
                                   rtol=1e-4, atol=1e-3)
        assert set(i[b, :l].tolist()) == set(ji[b, :l].tolist())
        assert np.all(np.isinf(d[b, l:]))
        assert np.all(i[b, l:] == INT32_MAX)
    assert res.selection.iterations <= tsel.iteration_cap(K * l_max)
    assert (res.prune.survivors.numpy() >= ls).all()

    sd, si = tknn.knn_simple(tp, tids, torch.from_numpy(q), l_max)
    np.testing.assert_allclose(sd.numpy(), jsd, rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(si.numpy(), jsi)


@pytest.mark.parametrize("use_sampling,num_pivots", [(False, 1), (True, 4)])
def test_knn_query_variants_match_simple(rng, pts, use_sampling,
                                         num_pivots):
    """The no-sampling (Theorem 2.2) and multi-pivot paths answer the
    same as the simple method."""
    tp = torch.from_numpy(pts.reshape(K, -1, DIM))
    tids = torch.arange(N, dtype=torch.int32).reshape(K, -1)
    q = torch.from_numpy(rng.normal(size=(3, DIM)).astype(np.float32))
    res = tknn.knn_query(tp, tids, q, 16, _gen(), use_sampling=use_sampling,
                         num_pivots=num_pivots)
    sd, si = tknn.knn_simple(tp, tids, q, 16)
    order = torch.argsort(res.dists, dim=-1, stable=True)
    torch.testing.assert_close(res.dists.gather(1, order), sd)
    for b in range(3):
        assert set(res.ids[b].tolist()) == set(si[b].tolist())


def test_local_top_l_pad_path_matches_jax(rng):
    """m <= l: the shard is padded with +inf fake points, not sorted."""
    d = rng.random((3, 10)).astype(np.float32)
    ids = np.arange(100, 110, dtype=np.int32)
    jv, ji = jcore.local_top_l(d, ids, 16)
    tv, ti = tknn.local_top_l(torch.from_numpy(d), torch.from_numpy(ids), 16)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    jv, ji = jcore.local_top_l(d, ids, 4)
    tv, ti = tknn.local_top_l(torch.from_numpy(d), torch.from_numpy(ids), 4)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_classify_and_regress_over_selected(rng):
    """The vote and the mean fold exactly the selected neighbors."""
    mask = torch.from_numpy(rng.random((K, 3, 16)) > 0.6)
    labels = torch.from_numpy(rng.integers(0, 5, (K, 3, 16)).astype(np.int32))
    pred, hist = tknn.knn_classify(mask, labels, 5)
    for b in range(3):
        want = np.bincount(labels[:, b][mask[:, b]].numpy(), minlength=5)
        np.testing.assert_array_equal(hist[b].numpy(), want)
        assert int(pred[b]) == int(np.argmax(want))
    vals = labels.to(torch.float32)
    mean = tknn.knn_regress(mask, vals)
    for b in range(3):
        sel = vals[:, b][mask[:, b]]
        assert float(mean[b]) == pytest.approx(float(sel.mean()))


def test_collectives_over_the_shard_dimension():
    x = torch.arange(24, dtype=torch.int32).reshape(K, 3)
    assert collectives.psum(x).dtype == torch.int32
    assert torch.equal(collectives.psum(x), x.sum(0).to(torch.int32))
    assert torch.equal(collectives.all_gather(x), x)
    assert collectives.axis_index(x).reshape(-1).tolist() == list(range(K))
    assert collectives.axis_size(x) == K
    assert collectives.accounting(sampler="gather", iterations=0, touched=K,
                                  l_max=32, use_sampling=True) == (1, 7 * 32)
    assert collectives.accounting(sampler="selection", iterations=5,
                                  touched=K, l_max=32,
                                  use_sampling=True) == (14, 7 * 14)


# ---- the gather baseline: the fused step, then the merge --------------------

def _no_l2(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("knn_simple built the (k, B, m) matrix")
    monkeypatch.setattr(tknn.kops, "l2_distance", refuse)


@pytest.mark.parametrize("l", [1, 16, 255])
def test_knn_simple_builds_no_distance_matrix(monkeypatch, rng, pts, l):
    """Every shard holds more than l points: the step is the fused one,
    so knn_simple answers with l2_distance refusing every call; the
    answer equals the one computed through the matrix."""
    tp = torch.from_numpy(pts.reshape(K, -1, DIM))
    tids = torch.arange(N, dtype=torch.int32).reshape(K, -1)
    q = torch.from_numpy(rng.normal(size=(5, DIM)).astype(np.float32))
    full = ((q[:, None, :] - tp.reshape(N, DIM)[None]) ** 2).sum(-1)
    want = torch.sort(full, dim=1, stable=True)
    _no_l2(monkeypatch)
    valid = torch.ones(K, N // K, dtype=torch.bool)
    for kw in ({}, {"point_valid": valid},
               {"shard_active": torch.ones(K, dtype=torch.bool)}):
        sd, si = tknn.knn_simple(tp, tids, q, l, **kw)
        assert sd.shape == si.shape == (5, l)
        torch.testing.assert_close(sd, want.values[:, :l])
        assert torch.equal(si.long(), want.indices[:, :l])
    # a shard of no more than l points is padded through the matrix
    with pytest.raises(AssertionError, match="matrix"):
        tknn.knn_simple(tp[:, :8], tids[:, :8], q, 8)


def _masked_instance(rng, pts, mode):
    """Live prefixes of unequal length in each shard (a store's tails),
    and, in mode "routed", shards 2 and 5 routed away."""
    m = N // K
    used = rng.integers(m // 3, m + 1, K)
    used[0] = m
    valid = torch.arange(m)[None, :] < torch.from_numpy(used)[:, None]
    active = torch.ones(K, dtype=torch.bool)
    if mode == "routed":
        active[[2, 5]] = False
    chunks = [(j * m, torch.from_numpy(pts[j * m:j * m + used[j]]))
              for j in range(K) if active[j]]
    return valid, active, chunks


@pytest.mark.parametrize("mode", ["live", "routed"])
def test_knn_simple_matches_exact_and_selection(rng, pts, mode):
    """knn_simple equals the exact top-l (perfbench's f64 reference, ties
    to the smaller id) and the selection sampler's answer, under the
    store's live mask, pruned-routing flags and per-request l; the
    distances bit-equal to the selection's (one step makes both)."""
    from perfbench.reference import exact_topl

    l_max = 24
    ls = torch.tensor([1, 24, 7, 0, 13, 24], dtype=torch.int32)
    valid, active, chunks = _masked_instance(rng, pts, mode)
    tp = torch.from_numpy(pts.reshape(K, -1, DIM))
    tids = torch.arange(N, dtype=torch.int32).reshape(K, -1)
    q = torch.from_numpy(rng.normal(size=(len(ls), DIM)).astype(np.float32))
    masks = dict(point_valid=valid, shard_active=active)
    sd, si = tknn.knn_simple(tp, tids, q, l_max, **masks)
    res = tknn.knn_query_batched(tp, tids, q, l_max, ls, _gen(), **masks)
    ref = exact_topl.scan(q, l_max, chunks)
    assert torch.equal(si.long(), ref["top_i"])
    torch.testing.assert_close(sd.double(), ref["top_d"], rtol=1e-5,
                               atol=1e-4)
    live = torch.cat([torch.arange(r0, r0 + len(p)) for r0, p in chunks])
    assert set(si.flatten().tolist()) <= set(live.tolist())
    for b, l in enumerate(ls.tolist()):
        order = torch.argsort(res.dists[b], stable=True)
        assert torch.equal(res.dists[b][order][:l], sd[b, :l])
        assert set(res.ids[b, :l].tolist()) == set(si[b, :l].tolist())
        assert bool(torch.isinf(res.dists[b, l:]).all())
