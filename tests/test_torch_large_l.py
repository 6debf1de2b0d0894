"""l above one top-l pass (256 slots) in the port, on the CPU.

* The pass loop (``local_topk.passes``) over the plain one-pass-with-
  floor (``local_topk_floor_plain``) equals the plain top-l exactly, at
  l in {257, 300, 600}, on random rows, rows rounded to one decimal
  (ties), signed zeros, all-+inf rows and rows shorter than l; the floor
  pass equals a numpy filter-and-sort of the (value, id) keys.
* ``ops.local_topk`` and ``ops.distance_topk`` at l in {257, 600} agree
  with the JAX package's (its jnp oracle above 256), with the tolerance
  of tests/test_torch_kernels.py; ids are compared as sets where
  distances tie within it.
* The port's KnnServer at ``l_max = 300`` answers as the JAX one on the
  data of tests/test_torch_server.py, both samplers; selection bills stay
  inside the Theorem-1 envelope.
* ``ops.service_envelope`` names the card's distance + top-l path by l,
  without launching anything.

Small on purpose (m <= 4096, B <= 8): the JAX package's wall-clock tests
run beside these in other workers.
"""

import numpy as np
import pytest
import torch

from repro.configs.knn_service import CONFIG as JCONFIG
from repro.kernels import ops as jops
from repro.runtime import KnnServer as JaxServer
from repro_torch.configs import CONFIG
from repro_torch.kernels import local_topk as ltk
from repro_torch.kernels import ops as tops
from repro_torch.runtime import KnnServer

# the cases are small: one intra-op thread a process is faster here than
# a pool, and leaves the cores to the other test processes
torch.set_num_threads(1)

INT32_MAX = 2**31 - 1
TOL = dict(rtol=1e-4, atol=1e-3)          # tests/test_torch_kernels.py _tol
ROWS = ("random", "ties", "zeros", "inf", "short")


def _rows(rng, mode, rows=5, m=1000):
    """(rows, m) f32 numpy rows of one family; "short" rows have m < l."""
    if mode == "short":
        m = 200
    x = rng.normal(size=(rows, m)).astype(np.float32)
    if mode == "ties":
        x = np.round(x, 1)
    elif mode == "zeros":
        x = np.round(x * 2) / 8
        neg = rng.random((rows, m)) < 0.5
        x = np.where((x == 0) & neg, np.float32(-0.0), x).astype(np.float32)
    elif mode == "inf":
        x[: rows // 2] = np.inf                  # all-+inf rows
        x[rows // 2, 40:] = np.inf               # fewer finite values than l
        x[rows // 2 + 1, ::3] = np.inf
    return x


def _floor_pass(x):
    return lambda lp, floor: ltk.local_topk_floor_plain(x, lp, floor)


@pytest.mark.parametrize("l", [257, 300, 600])
@pytest.mark.parametrize("mode", ROWS)
def test_pass_loop_equals_one_top_l(rng, mode, l):
    x = torch.from_numpy(_rows(rng, mode))
    if mode == "zeros":
        assert bool(torch.signbit(x[x == 0]).any())
    rows, m = x.shape
    v, i = ltk.passes(_floor_pass(x), rows, m, l, x.device)
    rv, ri = ltk.local_topk_plain(x, l)
    assert torch.equal(v, rv) and torch.equal(i, ri)
    assert v.shape == (rows, l) and i.dtype == torch.int32


def _keys_above(x, fv, fi, l):
    """numpy: each row's l smallest (value, column) keys above the floor
    key (fv[r], fi[r]), sentinels after; -0.0 equals +0.0."""
    rows, m = x.shape
    out_v = np.full((rows, l), np.inf, np.float32)
    out_i = np.full((rows, l), INT32_MAX, np.int32)
    for r in range(rows):
        cols = np.arange(m)
        above = (x[r] > fv[r]) | ((x[r] == fv[r]) & (cols > fi[r]))
        order = np.lexsort((cols[above], x[r][above]))[:l]
        out_v[r, :len(order)] = x[r][above][order]
        out_i[r, :len(order)] = cols[above][order]
    return out_v, out_i


@pytest.mark.parametrize("mode", ROWS)
def test_floor_pass_matches_numpy(rng, mode):
    x = _rows(rng, mode)
    rows, m = x.shape
    # floors on values of the rows (equal values on both sides of the
    # floor's id), at +inf and below every value
    pick = rng.integers(0, m, rows)
    fv = x[np.arange(rows), pick].copy()
    fi = rng.integers(0, m, rows).astype(np.int32)
    fv[0], fi[0] = -np.inf, -1
    for lp in (1, 100, 256):
        got_v, got_i = ltk.local_topk_floor_plain(
            torch.from_numpy(x), lp, (torch.from_numpy(fv),
                                      torch.from_numpy(fi)))
        want_v, want_i = _keys_above(x, fv, fi, lp)
        np.testing.assert_array_equal(got_v.numpy(), want_v)
        np.testing.assert_array_equal(got_i.numpy(), want_i)


def _sets_agree(ti, ji, full):
    """Ids equal as sets on rows whose l-th and (l+1)-th distances are
    apart by more than the tolerance; else the strict interior."""
    l = ti.shape[-1]
    srt = np.sort(full, -1)
    for r in range(ti.shape[0]):
        got, want = set(ti[r].tolist()), set(np.asarray(ji)[r].tolist())
        if srt.shape[-1] <= l:
            assert got == want
            continue
        tol = TOL["atol"] + TOL["rtol"] * abs(srt[r, l])
        if srt[r, l] - srt[r, l - 1] > tol:
            assert got == want, r
        else:
            inner = set(np.nonzero(full[r] < srt[r, l - 1] - tol)[0].tolist())
            assert inner <= got and inner <= want, r


@pytest.mark.parametrize("l", [257, 600])
def test_local_topk_matches_jax_above_one_pass(rng, l):
    x = rng.normal(size=(4, 4096)).astype(np.float32)
    jv, ji = jops.local_topk(x, l)
    tv, ti = tops.local_topk(torch.from_numpy(x), l)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("l", [257, 600])
def test_distance_topk_matches_jax_above_one_pass(rng, l, masked):
    q = rng.normal(size=(8, 32)).astype(np.float32)
    p = rng.normal(size=(2048, 32)).astype(np.float32)
    valid = rng.random(2048) > 0.4 if masked else None
    jv, ji = jops.distance_topk(q, p, l, valid=valid)
    tv, ti = tops.distance_topk(
        torch.from_numpy(q), torch.from_numpy(p), l,
        valid=None if valid is None else torch.from_numpy(valid))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    fin = np.isfinite(tv.numpy())
    assert np.array_equal(fin, np.isfinite(np.asarray(jv)))
    assert (ti.numpy()[~fin] == INT32_MAX).all()
    full = ((q[:, None, :] - p[None]) ** 2).sum(-1)
    if masked:
        full = np.where(valid[None], full, np.inf)
        assert valid[ti.numpy()[fin]].all()        # no masked point wins
    _sets_agree(ti.numpy(), ji, full)


# ---- the server at l_max = 300 ---------------------------------------------

K, DIM, L_MAX = 8, 32, 300
KW = dict(dim=DIM, l=8, l_max=L_MAX, bucket_sizes=(4,))


@pytest.fixture(scope="module")
def pts():
    return np.random.default_rng(5).normal(size=(K * 512, DIM)).astype(
        np.float32)


@pytest.mark.parametrize("sampler", ["selection", "gather"])
def test_server_l_max_300_matches_jax(mesh8, rng, pts, sampler):
    qs = rng.normal(size=(4, DIM)).astype(np.float32)
    ls = [300, 1, 257, 150]
    tsrv = KnnServer(pts, cfg=CONFIG.replace(**KW, sampler=sampler),
                     shards=K, device="cpu")
    jsrv = JaxServer(pts, cfg=JCONFIG.replace(**KW, sampler=sampler),
                     mesh=mesh8, axis_name="x")
    tres, jres = tsrv.query_batch(qs, ls), jsrv.query_batch(qs, ls)
    full = ((qs[:, None, :] - pts[None]) ** 2).sum(-1)
    for r, (a, b) in enumerate(zip(tres, jres)):
        assert a.l == b.l == ls[r] and len(a.ids) == a.l
        np.testing.assert_allclose(a.dists, b.dists, **TOL)
        np.testing.assert_allclose(a.dists, np.sort(full[r])[:a.l], **TOL)
        _sets_agree(a.ids[None], b.ids[None], full[r:r + 1])
        if sampler == "gather":
            assert (a.rounds, a.messages) == (b.rounds, b.messages)
        else:
            assert a.iterations <= 8 * int(np.ceil(np.log2(K * L_MAX))) + 16
            assert a.survivors >= a.l
    audit = tsrv.obs_snapshot()["audit"]["contract"]
    assert audit["checks"] == 1 and audit["violations"] == 0


def test_envelope_names_the_top_l_path_without_launching(monkeypatch):
    """On a card device object: distance_topk up to 256, l2_distance and
    local_topk's passes above; nothing launches (the SM count, the one
    card property read, is given)."""
    monkeypatch.setattr(ltk, "sm_count", lambda index: 132)
    before = tops.launch_counts()
    card = torch.device("cuda")
    small = tops.service_envelope(32, 524288, 64, 256, k=8, device=card)
    large = tops.service_envelope(32, 524288, 64, 1024, k=8, device=card)
    assert tops.launch_counts() == before
    assert (small["path"], small["dtk_path"]) == ("cuda", "distance_topk")
    assert small["dtk_chunk"] and small["ltk_passes"] is None
    assert (large["dtk_path"], large["ltk_passes"]) == ("l2+local_topk", 4)
    assert large["dtk_chunk"] is None and large["unsupported"] is None
    assert tops.service_envelope(32, 100, 64, 1024, k=8,
                                 device=card)["ltk_passes"] == 1
    cpu = tops.service_envelope(32, 524288, 64, 1024, k=8, device="cpu")
    assert cpu["path"] == "plain" and cpu["dtk_path"] is None
