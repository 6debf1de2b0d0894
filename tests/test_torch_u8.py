"""uint8 point sets on the CPU: the uint8 step's plain version and the
whole KnnServer over uint8 points against an f64 brute force, the plan of
the uint8 kernel, and what the server refuses.

The step's distances are exact integers (at most d * 255^2), exact in f32
up to d = 258, so every answer equals the brute force's exactly: the
same ids, ties to the smaller id, and the same distances.  The JAX
package serves f32 points only; the port keeps uint8 points as uint8
(a documented divergence, pinned here against the JAX server).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.configs.knn_service import CONFIG as JCONFIG
from repro.runtime import KnnServer as JaxServer
from repro_torch.configs import CONFIG
from repro_torch.core import knn as knn_mod
from repro_torch.kernels import distance_topk as dtk
from repro_torch.kernels import ops, plan
from repro_torch.runtime import KnnServer

torch.set_num_threads(1)

K = 8
INT32_MAX = 2**31 - 1
BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)


def _points(kind: str, n: int, d: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    high = 3 if kind == "ties" else 256
    return rng.integers(0, high, (n, d), dtype=np.uint8)


def _brute(points: np.ndarray, q: np.ndarray, l: int):
    """The l nearest by (squared distance, id), exact in f64."""
    d = ((points.astype(np.float64) - q.astype(np.float64)) ** 2).sum(1)
    order = np.lexsort((np.arange(len(points)), d))[:l]
    return d[order], order


def _cfg(d: int, l_max: int = 10, **kw):
    return dataclasses.replace(CONFIG, dim=d, l=min(10, l_max), l_max=l_max,
                               bucket_sizes=BUCKETS, **kw)


@pytest.mark.parametrize("kind", ["seeded", "ties"])
@pytest.mark.parametrize("d", [96, 128])
@pytest.mark.parametrize("l", [1, 10, 256])
def test_plain_step_equals_brute_force(kind, d, l):
    """The uint8 step's plain version: ids and distances equal an f64
    brute force per shard, ties to the smaller id; f32 values exact."""
    k, m = 3, 600
    pts = _points(kind, k * m, d, seed=1)
    qs = _points(kind, 5, d, seed=2)
    v, i = dtk.distance_topk_u8_plain(torch.from_numpy(qs),
                                      torch.from_numpy(pts).reshape(k, m, d),
                                      l)
    assert v.dtype == torch.float32 and i.dtype == torch.int32
    for s in range(k):
        shard = pts[s * m:(s + 1) * m]
        for b, q in enumerate(qs):
            bd, bi = _brute(shard, q, l)
            assert np.array_equal(i[s, b].numpy(), bi)
            assert np.array_equal(v[s, b].numpy().astype(np.float64), bd)
    if kind == "ties" and l > 1:
        same = v[..., 1:] == v[..., :-1]
        assert bool(same.any())
        assert not bool((same & (i[..., 1:] < i[..., :-1])).any())


def test_plain_step_mask_and_short_shards():
    """A masked point never wins; a shard of fewer points than l pads with
    (+inf, 2**31-1), as the f32 step does."""
    q = torch.from_numpy(_points("seeded", 4, 16, seed=3))
    p = torch.from_numpy(_points("seeded", 2 * 50, 16, seed=4)).reshape(
        2, 50, 16)
    valid = torch.ones(2, 50, dtype=torch.bool)
    valid[0, ::2] = False
    v, i = ops.distance_topk(q, p, 64, valid=valid)
    assert bool((i[0, :, :25] % 2 == 1).all())
    assert bool(torch.isinf(v[0, :, 25:]).all())
    assert bool((i[0, :, 25:] == INT32_MAX).all())
    assert bool((i[1, :, 50:] == INT32_MAX).all())
    assert bool(torch.isfinite(v[1, :, :50]).all())


@pytest.mark.parametrize("kind", ["seeded", "ties"])
def test_server_on_uint8_points_equals_brute_force(kind):
    """Every bucket size 1-128 and per-request l: the served ids and
    distances equal the f64 brute force exactly; the points stay uint8."""
    d, n = 128, K * 400
    pts = _points(kind, n, d, seed=5)
    srv = KnnServer(pts, cfg=_cfg(d, l_max=16), device="cpu", seed=7)
    assert srv._points.dtype == torch.uint8
    assert srv._points.shape == (K, n // K, d)
    assert all(e["points_dtype"] == "uint8" for e in srv.envelopes)
    rng = np.random.default_rng(6)
    qs = _points(kind, 128 + 64 + 3, d, seed=8)
    ls = rng.integers(1, 17, len(qs))
    seen = set()
    start = 0
    for b in BUCKETS:
        rows = slice(start, start + b)
        start = (start + b) % (len(qs) - 128)
        res = srv.query_batch(qs[rows], ls[rows])
        for q, l, r in zip(qs[rows], ls[rows], res):
            bd, bi = _brute(pts, q, int(l))
            assert np.array_equal(r.ids, bi)
            assert np.array_equal(r.dists.astype(np.float64), bd)
            seen.add(len(r.ids))
    assert len(seen) > 4
    srv.close()


def test_server_holds_tensor_points_as_uint8():
    """A uint8 tensor is viewed, not copied: no f32 copy of the points."""
    pts = torch.from_numpy(_points("seeded", K * 64, 32, seed=9))
    srv = KnnServer(pts, cfg=_cfg(32), device="cpu")
    assert srv._points.dtype == torch.uint8
    assert srv._points.data_ptr() == pts.data_ptr()
    srv.close()


@pytest.mark.parametrize("query", [
    np.full(32, 0.5, np.float32), np.full(32, 256.0, np.float32),
    np.full(32, -1.0, np.float32), np.full(32, np.nan, np.float32),
    np.full(32, np.inf, np.float32)])
def test_submit_refuses_a_query_that_is_not_uint8(query):
    srv = KnnServer(_points("seeded", K * 16, 32), cfg=_cfg(32),
                    device="cpu")
    with pytest.raises(ValueError, match=r"integers in \[0, 255\]"):
        srv.submit(query, 4)
    # integers in range pass, in any numeric type
    srv.query_batch(np.full((1, 32), 255.0), [4])
    srv.query_batch(np.zeros((1, 32), np.int64), [4])
    srv.close()


@pytest.mark.parametrize("knob,match", [
    (dict(l_max=257), "above 256"),
    (dict(route="pruned"), "route='exact'"),
    (dict(search="approx"), "search='exact'")])
def test_uint8_points_refuse_what_their_step_lacks(knob, match):
    cfg = _cfg(32, l_max=knob.pop("l_max", 10), **knob)
    with pytest.raises(ValueError, match=match):
        KnnServer(_points("seeded", K * 64, 32), cfg=cfg, device="cpu")
    # the same config serves f32 points
    KnnServer(_points("seeded", K * 64, 32).astype(np.float32), cfg=cfg,
              device="cpu").close()


def test_local_step_takes_uint8_even_when_a_shard_is_short():
    """local_distance_top_l sends uint8 points to the uint8 step whatever m
    and l (the f32 path's l2_distance has no uint8 version)."""
    pts = torch.from_numpy(_points("seeded", 3 * 5, 16)).reshape(3, 5, 16)
    ids = torch.arange(15, dtype=torch.int32).reshape(3, 5)
    q = torch.from_numpy(_points("seeded", 2, 16, seed=1)).float()
    v, gid = knn_mod.local_distance_top_l(q, pts, ids, 8)
    assert v.shape == (3, 2, 8)
    assert bool((gid[:, :, 5:] == INT32_MAX).all())
    for s in range(3):
        bd, bi = _brute(pts[s].numpy(), q[0].numpy(), 5)
        assert np.array_equal(gid[s, 0, :5].numpy(), bi + 5 * s)


@pytest.mark.parametrize("B,tile", [(1, 64), (32, 64), (33, 64), (64, 64),
                                    (65, 128), (128, 128)])
def test_u8_plan_tiles_every_bucket(B, tile):
    """The plan's uint8 launch: a tile of 64 rows up to 64 (a bucket of
    32 or fewer padded), else 128; three ring slabs; candidate keys from
    the block's budget; chunks of whole 128-point tiles that fill the
    card; one step path whatever B."""
    m, sms = 62_500_000, 132
    tp = plan.topk_u8(B, 128, 10, m, sms)
    assert (tp.tile, tp.groups, tp.unsupported) == (tile, 3, None)
    assert tp.cand == (128 if tile == 128 else 109)
    assert tp.smem <= plan.WIDE_SMEM[tile]
    assert tp.chunk % plan.WIDE_POINT_TILE == 0
    assert tp.nchunks * tp.chunk >= m > (tp.nchunks - 1) * tp.chunk
    assert tp.blocks == tp.nchunks * -(-B // tile)
    assert tp.blocks >= plan.WIDE_BLOCKS_PER_SM[tile] * sms
    assert tp.width == 10
    sp = plan.step(B, 128, 10, plan.U8_ELEM, m, sms)
    assert sp.path == plan.DISTANCE_TOPK_U8 and sp.topk == tp
    assert sp.l2 is None and sp.passes is None


@pytest.mark.parametrize("d,l,match", [(259, 10, "d=258"),
                                       (128, 257, "outside")])
def test_u8_plan_refuses_inexact_or_long_rows(d, l, match):
    why = plan.topk_u8(128, d, l, 1 << 20, 132).unsupported
    assert why and match in why
    assert plan.topk_u8(128, 258, 256, 1 << 20, 132).unsupported is None


def test_envelope_reports_the_u8_step(monkeypatch):
    """``service_envelope`` names the points' dtype and the uint8 plan's
    tile on the card; the f32 envelope is as before."""
    monkeypatch.setattr(ops._ltk, "sm_count", lambda index: 132)
    card = torch.device("cuda")
    env = ops.service_envelope(128, 62_500_000, 128, 10, k=8, device=card,
                               dtype=torch.uint8)
    assert env["points_dtype"] == "uint8"
    assert env["dtk_path"] == plan.DISTANCE_TOPK_U8
    assert env["dtk_tile"] == 128 and env["l2_tile"] is None
    assert env["dtk_chunk"] == plan.topk_u8(128, 128, 10, 62_500_000,
                                            132).chunk
    small = ops.service_envelope(8, 62_500_000, 128, 10, k=8, device=card,
                                 dtype=torch.uint8)
    assert small["dtk_tile"] == 64
    f32 = ops.service_envelope(128, 1 << 20, 96, 100, k=8, device=card)
    assert f32["points_dtype"] == "float32"
    assert f32["dtk_path"] == plan.DISTANCE_TOPK and f32["l2_tile"] == 128


def test_reference_serves_uint8_points_as_f32(mesh8):
    """The documented divergence: the JAX server casts uint8 points to
    f32; the port keeps them uint8 and gives the same exact answers."""
    d = 32
    pts = _points("seeded", K * 128, d, seed=12)
    qs = _points("seeded", 8, d, seed=13)
    kw = dict(dim=d, l=8, l_max=16, bucket_sizes=(8,))
    jsrv = JaxServer(pts, cfg=JCONFIG.replace(**kw), mesh=mesh8,
                     axis_name="x")
    tsrv = KnnServer(pts, cfg=CONFIG.replace(**kw), shards=K, device="cpu")
    assert np.dtype(jsrv._points.dtype) == np.float32
    assert tsrv._points.dtype == torch.uint8
    ls = [1, 3, 8, 16, 5, 2, 9, 16]
    for a, b, q, l in zip(jsrv.query_batch(qs, ls), tsrv.query_batch(qs, ls),
                          qs, ls):
        bd, bi = _brute(pts, q, l)
        assert np.array_equal(np.asarray(a.ids), bi)
        assert np.array_equal(np.asarray(b.ids), bi)
        assert np.array_equal(b.dists.astype(np.float64), bd)
    tsrv.close()
