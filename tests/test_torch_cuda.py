"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU with nvcc: it is marked ``cuda`` and
skips, with its reason, where ``torch.cuda.is_available()`` is false.
Whether a card exists is decided inside the ``card`` fixture, never at
import.  Run on a card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import time

import numpy as np
import pytest
import torch

from repro_torch.configs import CONFIG
from repro_torch.kernels import distance_topk as dtk
from repro_torch.kernels import l2_distance as l2
from repro_torch.kernels import local_topk as ltk
from repro_torch.kernels import ops
from repro_torch.kernels import plan
from repro_torch.kernels import routing as rt
from repro_torch.runtime import KnnServer
from repro_torch.store import IndexMaintainer, build_summaries

pytestmark = pytest.mark.cuda

F32 = dict(rtol=1e-4, atol=1e-3)
INT32_MAX = 2**31 - 1


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); none on this machine")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(card, *shape, seed=0):
    g = torch.Generator(device=card)
    g.manual_seed(seed)
    return torch.randn(shape, generator=g, device=card)


@pytest.mark.parametrize("shape", [(32, 8, 4096, 64), (13, 1, 777, 300),
                                   (4, 3, 96, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_l2_distance_kernel(card, shape, dtype):
    B, k, m, d = shape
    q = _randn(card, B, d).to(dtype)
    p = _randn(card, k, m, d, seed=1).to(dtype)
    before = l2.COUNT.n
    out = l2.l2_distance_cuda(q, p)
    torch.cuda.synchronize()
    assert l2.COUNT.n == before + 1
    torch.testing.assert_close(out, l2.l2_distance_plain(q, p), **F32)


@pytest.mark.parametrize("shape,l", [((32, 8, 8192, 64), 128),
                                     ((13, 1, 777, 300), 1),
                                     ((13, 2, 777, 300), 256),
                                     ((4, 2, 96, 64), 128)])
def test_distance_topk_kernel(card, shape, l):
    B, k, m, d = shape
    q, p = _randn(card, B, d), _randn(card, k, m, d, seed=2)
    before = (dtk.COUNT.n, ltk.COUNT.n)
    v, i = dtk.distance_topk_cuda(q, p, l)
    torch.cuda.synchronize()
    # one launch, plus local_topk's merge launches when the points were
    # chunked: one, and one more where the merge split its rows again
    tp = plan.topk(B, d, l, 4, m, ltk.sm_count(0))
    slots = ltk.blocks_per_sm(l, 0, True) * ltk.sm_count(0)
    merges = (0 if tp.nchunks == 1 else
              len(ltk.merge_plans(k * B, tp.nchunks * tp.width, l, slots)))
    assert (dtk.COUNT.n, ltk.COUNT.n) == (before[0] + 1, before[1] + merges)
    rv, ri = dtk.distance_topk_plain(q, p, l)
    torch.testing.assert_close(v, rv, **F32)
    fin = torch.isfinite(rv)
    assert bool((i[~fin] == INT32_MAX).all())
    full = l2.l2_distance_plain(q, p)
    true = full.gather(-1, torch.where(fin, i, 0).long())
    torch.testing.assert_close(torch.where(fin, true, 0.0),
                               torch.where(fin, v, 0.0), **F32)


def test_distance_topk_kernel_masked(card):
    k, m = 4, 2048
    q, p = _randn(card, 5, 32), _randn(card, k, m, 32, seed=3)
    valid = torch.rand((k, m), device=card) > 0.4
    v, i = dtk.distance_topk_cuda(q, p, 16, valid=valid)
    rv, ri = dtk.distance_topk_plain(q, p, 16, valid=valid)
    torch.testing.assert_close(v, rv, **F32)
    dead = (~valid).unsqueeze(1).expand(k, 5, m).gather(2, i.long())
    assert not bool(dead.any())
    v, i = dtk.distance_topk_cuda(q, p, 8,
                                  valid=torch.zeros_like(valid))
    assert bool(torch.isinf(v).all()) and bool((i == INT32_MAX).all())


def _mask(card, k, m, mode, seed=0):
    """A (k, m) valid mask: random, whole shards off, all off, or only
    shard 3 on (the routed phase's 1 of k)."""
    g = torch.Generator(device=card)
    g.manual_seed(seed)
    if mode == "random":
        return torch.rand((k, m), generator=g, device=card) > 0.4
    v = torch.ones((k, m), dtype=torch.bool, device=card)
    if mode == "shards":
        v[::2] = False
    elif mode == "none":
        v[:] = False
    elif mode == "one":
        v[:] = False
        v[3 % k] = True
    return v


@pytest.mark.parametrize("mode", ["random", "shards", "none"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_l2_distance_kernel_masked(card, mode, dtype):
    k, m, d = 4, 777, 64
    q = _randn(card, 13, d).to(dtype)
    p = _randn(card, k, m, d, seed=6).to(dtype)
    valid = _mask(card, k, m, mode)
    before = l2.COUNT.n
    out = l2.l2_distance_cuda(q, p, valid=valid)
    torch.cuda.synchronize()
    assert l2.COUNT.n == before + 1
    want = torch.where(valid.unsqueeze(1), l2.l2_distance_plain(q, p),
                       torch.full((k, 13, m), float("inf"), device=card))
    assert torch.equal(torch.isinf(out), torch.isinf(want))
    torch.testing.assert_close(out, want, **F32)
    # through the dispatcher: the same kernel, no torch.where after it
    assert torch.equal(ops.l2_distance(q, p, valid=valid), out)


def _masked_plain(q, p, valid):
    want = l2.l2_distance_plain(q, p)
    if valid is None:
        return want
    return torch.where(valid.unsqueeze(1), want,
                       torch.full_like(want, float("inf")))


@pytest.mark.parametrize("mode", [None, "random", "shards", "none"])
@pytest.mark.parametrize("km", [(1, 777), (3, 4096), (8, 777)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 96, 300, 1024])
@pytest.mark.parametrize("B", [33, 64, 100, 128])
def test_l2_distance_wide_kernel(card, B, d, dtype, km, mode):
    """The whole-bucket loop (B > 32) is bit-equal to the 32-row loop run
    on 32-row slices of the same queries, and within F32 of the plain
    version; masked points +inf.  Every call counts one l2_distance
    launch; only the B > 32 call counts one of the whole-bucket loop."""
    k, m = km
    q = _randn(card, B, d, seed=B + d).to(dtype)
    p = _randn(card, k, m, d, seed=k * m + d).to(dtype)
    valid = None if mode is None else _mask(card, k, m, mode, seed=B)
    before = (l2.COUNT.n, l2.COUNT_WIDE.n)
    out = l2.l2_distance_cuda(q, p, valid=valid)
    torch.cuda.synchronize()
    assert (l2.COUNT.n, l2.COUNT_WIDE.n) == (before[0] + 1, before[1] + 1)
    parts = [l2.l2_distance_cuda(q[i:i + plan.QUERY_TILE], p, valid=valid)
             for i in range(0, B, plan.QUERY_TILE)]
    torch.cuda.synchronize()
    assert (l2.COUNT.n, l2.COUNT_WIDE.n) == (before[0] + 1 + len(parts),
                                             before[1] + 1)
    assert torch.equal(out, torch.cat(parts, dim=1))
    want = _masked_plain(q, p, valid)
    assert torch.equal(torch.isinf(out), torch.isinf(want))
    torch.testing.assert_close(out, want, **F32)


@pytest.mark.parametrize("B,d,mode", [(200, 96, None), (300, 64, "random"),
                                      (129, 300, "shards")])
def test_l2_distance_wide_kernel_several_row_tiles(card, B, d, mode):
    """Above 128 rows the bucket is tiles of 128 (a point tile's row
    tiles walked together): still bit-equal to the 32-row slices."""
    k, m = 3, 777
    q, p = _randn(card, B, d, seed=B), _randn(card, k, m, d, seed=d)
    valid = None if mode is None else _mask(card, k, m, mode, seed=B)
    out = l2.l2_distance_cuda(q, p, valid=valid)
    parts = [l2.l2_distance_cuda(q[i:i + plan.QUERY_TILE], p, valid=valid)
             for i in range(0, B, plan.QUERY_TILE)]
    assert torch.equal(out, torch.cat(parts, dim=1))
    torch.testing.assert_close(out, _masked_plain(q, p, valid), **F32)


def _topk_close(v, i, rv, ri, full):
    """Kernel vs plain top-l: values within F32, +inf slots carry the
    sentinel, every id's true distance matches its value, and the id sets
    agree on rows whose l-th and (l+1)-th distances are apart."""
    torch.testing.assert_close(v, rv, **F32)
    fin = torch.isfinite(rv)
    assert torch.equal(fin, torch.isfinite(v))
    assert bool((i[~fin] == INT32_MAX).all())
    true = full.gather(-1, torch.where(fin, i, 0).long())
    torch.testing.assert_close(torch.where(fin, true, 0.0),
                               torch.where(fin, v, 0.0), **F32)
    l = v.shape[-1]
    srt = full.sort(-1).values
    if srt.shape[-1] > l:
        gap = (srt[..., l] - srt[..., l - 1]) > 1e-3 + 1e-4 * srt[..., l]
        rows = gap & fin.all(-1)
        assert torch.equal(i.sort(-1).values[rows], ri.sort(-1).values[rows])


def test_distance_topk_kernel_one_shard_valid(card):
    k, m, d, l = 8, 4096, 64, 128
    q, p = _randn(card, 32, d), _randn(card, k, m, d, seed=7)
    valid = _mask(card, k, m, "one")
    v, i = dtk.distance_topk_cuda(q, p, l, valid=valid)
    rv, ri = dtk.distance_topk_plain(q, p, l, valid=valid)
    full = torch.where(valid.unsqueeze(1), l2.l2_distance_plain(q, p),
                       torch.full((k, 32, m), float("inf"), device=card))
    _topk_close(v, i, rv, ri, full)
    assert bool(torch.isinf(v[torch.arange(k, device=card) != 3]).all())
    assert torch.equal(torch.isfinite(v[3]), torch.ones_like(v[3], dtype=bool))


@pytest.mark.parametrize("m", [777, 96])
@pytest.mark.parametrize("B", [1, 5, 32, 33])
@pytest.mark.parametrize("masked", [False, True])
def test_distance_kernels_ragged(card, m, B, masked):
    """m that is no multiple of the tile or the ring, B around the query
    tile, with and without a mask: both kernels against the plain."""
    k, d, l = 3, 64, 16
    q, p = _randn(card, B, d, seed=B), _randn(card, k, m, d, seed=m)
    valid = _mask(card, k, m, "random", seed=B) if masked else None
    full = l2.l2_distance_plain(q, p)
    if masked:
        full = torch.where(valid.unsqueeze(1), full,
                           torch.full_like(full, float("inf")))
    out = l2.l2_distance_cuda(q, p, valid=valid)
    assert torch.equal(torch.isinf(out), torch.isinf(full))
    torch.testing.assert_close(out, full, **F32)
    v, i = dtk.distance_topk_cuda(q, p, l, valid=valid)
    rv, ri = dtk.distance_topk_plain(q, p, l, valid=valid)
    _topk_close(v, i, rv, ri, full)


def _dtk_by_slices(q, p, l, valid):
    """distance_topk's 32-row kernel on the 32-row slices of the queries,
    joined along the rows."""
    parts = [dtk.distance_topk_cuda(q[i:i + plan.QUERY_TILE], p, l,
                                    valid=valid)
             for i in range(0, q.shape[0], plan.QUERY_TILE)]
    return (torch.cat([v for v, _ in parts], dim=1),
            torch.cat([i for _, i in parts], dim=1))


@pytest.mark.parametrize("km", [(1, 777), (3, 4096), (8, 20000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l", [1, 10, 100, 256])
@pytest.mark.parametrize("d", [64, 96, 100, 128])
@pytest.mark.parametrize("B", [33, 64, 100, 128, 200])
def test_distance_topk_wide_kernel(card, B, d, l, dtype, km):
    """The whole-bucket path (B > 32) gives values and ids equal to the
    32-row kernel run on 32-row slices of the same queries, unmasked,
    under a random mask, with one shard alive and with none; values
    within F32 of the plain version, masked points never served.  Every
    call counts one distance_topk launch; only the B > 32 call counts one
    of the whole-bucket path."""
    k, m = km
    elem = 4 if dtype == torch.float32 else 2
    assert plan.topk(B, d, l, elem, m, ltk.sm_count(0)).wide
    q = _randn(card, B, d, seed=B + d + l).to(dtype)
    p = _randn(card, k, m, d, seed=k * m + d).to(dtype)
    for mode in (None, "random", "one", "none"):
        valid = None if mode is None else _mask(card, k, m, mode, seed=B + l)
        before = (dtk.COUNT.n, dtk.COUNT_WIDE.n)
        v, i = dtk.distance_topk_cuda(q, p, l, valid=valid)
        torch.cuda.synchronize()
        assert (dtk.COUNT.n, dtk.COUNT_WIDE.n) == (before[0] + 1,
                                                   before[1] + 1)
        sv, si = _dtk_by_slices(q, p, l, valid)
        assert dtk.COUNT_WIDE.n == before[1] + 1
        assert torch.equal(v, sv) and torch.equal(i, si), mode
        rv, _ = dtk.distance_topk_plain(q, p, l, valid=valid)
        torch.testing.assert_close(v, rv, **F32)
        fin = torch.isfinite(v)
        assert bool((i[~fin] == INT32_MAX).all())
        if valid is not None:
            live = valid.unsqueeze(1).expand(k, B, m).gather(
                2, torch.where(fin, i, 0).long())
            assert bool(live[fin].all())


@pytest.mark.parametrize("B,d,l", [(128, 96, 100), (64, 64, 10),
                                   (200, 100, 256)])
def test_distance_topk_wide_kernel_ties(card, B, d, l):
    """Points duplicated within a shard and across shards: equal distances
    order by id, as the 32-row kernel orders them."""
    k, m = 4, 6000
    base = _randn(card, 97, d, seed=d)
    p = base[torch.arange(m, device=card) % 97].expand(k, m, d).contiguous()
    q = _randn(card, B, d, seed=B)
    v, i = dtk.distance_topk_cuda(q, p, l)
    sv, si = _dtk_by_slices(q, p, l, None)
    assert torch.equal(v, sv) and torch.equal(i, si)
    same = v[..., 1:] == v[..., :-1]
    assert bool((i[..., 1:][same] > i[..., :-1][same]).all())
    assert torch.equal(v[0], v[3]) and torch.equal(i[0], i[3])


def test_distance_topk_wide_kernel_one_chunk(card):
    """A bucket whose points fit one chunk: the partial is the answer, the
    l smallest ascending, (+inf, 2**31-1) past the shard's points."""
    B, k, m, d, l = 128, 2, 90, 96, 100
    assert plan.topk(B, d, l, 4, m, ltk.sm_count(0)).nchunks == 1
    q, p = _randn(card, B, d, seed=1), _randn(card, k, m, d, seed=2)
    v, i = dtk.distance_topk_cuda(q, p, l)
    sv, si = _dtk_by_slices(q, p, l, None)
    assert torch.equal(v, sv) and torch.equal(i, si)
    assert bool(torch.isinf(v[..., m:]).all())
    assert bool((i[..., m:] == INT32_MAX).all())
    assert torch.equal(i[..., :m].sort(-1).values,
                       torch.arange(m, device=card, dtype=torch.int32)
                       .expand(k, B, m))


@pytest.mark.parametrize("shape,l,launches", [
    ((256, 65536), 128, 2),     # split rows: the first pass + its merge
    ((7, 100003), 64, 2),       # ragged rows, none 16-byte aligned
    ((32, 1024), 128, 1), ((5, 1000), 256, 1), ((3, 100), 128, 1)])
def test_local_topk_kernel(card, shape, l, launches):
    x = _randn(card, *shape, seed=4)
    before = ltk.COUNT.n
    v, i = ltk.local_topk_cuda(x, l)
    torch.cuda.synchronize()
    assert ltk.COUNT.n == before + launches
    rv, ri = ltk.local_topk_plain(x, l)
    assert torch.equal(v, rv) and torch.equal(i, ri)


@pytest.mark.parametrize("shape", [(8, 4099), (3, 40001)])
def test_local_topk_kernel_bf16_ragged(card, shape):
    x = _randn(card, *shape, seed=8).to(torch.bfloat16)
    v, i = ltk.local_topk_cuda(x, 64)
    rv, ri = ltk.local_topk_plain(x, 64)
    assert torch.equal(v, rv) and torch.equal(i, ri)


def test_local_topk_kernel_ties(card):
    x = torch.round(_randn(card, 4, 512, seed=5) * 10) / 10
    v, i = ltk.local_topk_cuda(x, 32)
    rv, ri = ltk.local_topk_plain(x, 32)
    assert torch.equal(i, ri)


@pytest.mark.parametrize("m", [1001, 50003])
def test_local_topk_kernel_signed_zeros(card, m):
    """Negative values and -0.0 / +0.0 ties: the two zeros are equal, so
    they go in index order; held against the plain version on the CPU,
    whose stable sort compares values (a radix sort would not)."""
    x = torch.round(_randn(card, 6, m, seed=9) * 2) / 8
    signs = torch.rand((6, m), generator=torch.Generator(device=card)
                       .manual_seed(9), device=card) < 0.5
    x = torch.where((x == 0) & signs, torch.full_like(x, -0.0), x)
    assert bool(torch.signbit(x[x == 0]).any())
    v, i = ltk.local_topk_cuda(x, 256)
    rv, ri = ltk.local_topk_plain(x.cpu(), 256)
    assert torch.equal(v.cpu(), rv) and torch.equal(i.cpu(), ri)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(16, 50003), (9, 1000)])
def test_local_topk_kernel_inf_rows(card, dtype, shape):
    """Rows of +inf (a masked shard's distances), rows with fewer finite
    values than l, and +inf between finite values: +inf slots keep their
    columns in order, as the plain version's stable sort gives them."""
    rows, m = shape
    x = _randn(card, rows, m, seed=12)
    x[: rows // 2] = float("inf")
    x[rows // 2, 40:] = float("inf")
    x[rows // 2 + 1, ::3] = float("inf")
    x = x.to(dtype)
    v, i = ltk.local_topk_cuda(x, 128)
    rv, ri = ltk.local_topk_plain(x, 128)
    assert torch.equal(v, rv) and torch.equal(i, ri)


def _ltk_launches(x, l):
    """local_topk launches of local_topk_cuda(x, l) on this card: per
    pass, the first launch and, for split rows, its merge's."""
    rows, m = x.shape
    n = 0
    for p0 in range(0, min(l, m), 256):
        lp = min(256, l - p0)
        _, nparts, _ = ltk.plan(rows, m, ltk.card_slots(x, lp, False, p0 > 0))
        slots = ltk.blocks_per_sm(lp, 0, True) * ltk.sm_count(0)
        n += 1 + (len(ltk.merge_plans(rows, nparts * lp, lp, slots))
                  if nparts > 1 else 0)
    return n


def _rows(card, rows, m, mode, seed):
    """Rows for the multi-pass tests: random, ties (one decimal), all
    equal, signed zeros, or +inf rows (whole, mostly and in a stride)."""
    x = _randn(card, rows, m, seed=seed)
    if mode == "ties":
        x = torch.round(x * 10) / 10
    elif mode == "equal":
        x = torch.full_like(x, 1.5)
    elif mode == "zeros":
        x = torch.round(x * 2) / 8
        neg = torch.rand((rows, m), generator=torch.Generator(device=card)
                         .manual_seed(seed), device=card) < 0.5
        x = torch.where((x == 0) & neg, torch.full_like(x, -0.0), x)
    elif mode == "inf":
        x[: rows // 2] = float("inf")
        x[rows // 2, 40:] = float("inf")
        x[rows // 2 + 1, ::3] = float("inf")
    return x


@pytest.mark.parametrize("l", [257, 1000])
@pytest.mark.parametrize("shape,mode", [
    ((256, 65536), "random"), ((7, 100003), "random"), ((8, 4096), "ties"),
    ((5, 20000), "equal"), ((6, 50003), "zeros"), ((16, 50003), "inf"),
    ((3, 600), "random")])
def test_local_topk_multipass_kernel(card, shape, mode, l):
    """l above one pass: the passes (a floored launch and its merge each)
    equal the plain top-l bit for bit; signed zeros against the CPU's
    stable sort, which compares values."""
    x = _rows(card, *shape, mode, seed=20)
    before = ltk.COUNT.n
    v, i = ltk.local_topk_cuda(x, l)
    torch.cuda.synchronize()
    assert ltk.COUNT.n == before + _ltk_launches(x, l)
    if mode == "zeros":
        x, v, i = x.cpu(), v.cpu(), i.cpu()
    rv, ri = ltk.local_topk_plain(x, l)
    assert torch.equal(v, rv) and torch.equal(i, ri)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,mode", [((256, 65536), "ties"),
                                        ((9, 1000), "inf"),
                                        ((5, 20000), "equal")])
def test_local_topk_floor_pass_kernel(card, shape, mode, dtype):
    """One floored pass (its launch and merge) against
    local_topk_floor_plain, with floors on values of the rows (equal
    values on both sides of the floor's id) and below every value."""
    x = _rows(card, *shape, mode, seed=21).to(dtype)
    rows, m = shape
    g = torch.Generator(device=card).manual_seed(21)
    pick = torch.randint(0, m, (rows,), generator=g, device=card)
    fv = x.float().gather(1, pick[:, None])[:, 0].contiguous()
    fi = torch.randint(0, m, (rows,), generator=g, device=card,
                       dtype=torch.int32)
    fv[0], fi[0] = -float("inf"), -1
    for lp in (1, 100, 256):
        pv, pi = ltk.launch(x, None, lp, floor=(fv, fi))
        v, i = ltk.merge_partials(pv, pi, lp)
        rv, ri = ltk.local_topk_floor_plain(x, lp, (fv, fi))
        assert torch.equal(v, rv) and torch.equal(i, ri), lp


@pytest.mark.parametrize("masked", [False, True])
def test_distance_topk_above_one_pass(card, masked):
    """ops.distance_topk at l = 300: l2_distance then local_topk's
    passes, no distance_topk launch, equal to the plain version."""
    k, m, d, l = 4, 4096, 64, 300
    q, p = _randn(card, 13, d), _randn(card, k, m, d, seed=22)
    valid = _mask(card, k, m, "random", seed=3) if masked else None
    before = ops.launch_counts()
    v, i = ops.distance_topk(q, p, l, valid=valid)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["distance_topk"] == before["distance_topk"]
    assert after["l2_distance"] == before["l2_distance"] + 1
    assert after["local_topk"] >= before["local_topk"] + 2
    rv, ri = dtk.distance_topk_plain(q, p, l, valid=valid)
    full = l2.l2_distance_plain(q, p)
    if masked:
        full = torch.where(valid.unsqueeze(1), full,
                           torch.full_like(full, float("inf")))
    _topk_close(v, i, rv, ri, full)


def _sentinel_partials(card, rows, chunks, w, seed):
    """distance_topk-like partials: unique ids, many (+inf, INT32_MAX)."""
    g = torch.Generator(device=card)
    g.manual_seed(seed)
    v = torch.round(torch.randn((rows, chunks, w), generator=g,
                                device=card) * 10) / 10
    i = torch.argsort(torch.rand((rows, chunks * w), generator=g,
                                 device=card), dim=1).to(torch.int32)
    i = i.reshape(rows, chunks, w)
    dead = torch.rand((rows, chunks, w), generator=g, device=card) < 0.6
    return (torch.where(dead, float("inf"), v),
            torch.where(dead, INT32_MAX, i).to(torch.int32))


@pytest.mark.parametrize("rows,chunks,w,l", [(64, 40, 256, 128),
                                             (16, 128, 256, 128),
                                             (5, 7, 64, 256), (3, 2, 32, 1)])
def test_merge_partials_kernel(card, rows, chunks, w, l):
    pv, pi = _sentinel_partials(card, rows, chunks, w, seed=rows)
    slots = ltk.blocks_per_sm(l, 0, True) * ltk.sm_count(0)
    before = ltk.COUNT.n
    v, i = ltk.merge_partials(pv, pi, l)
    torch.cuda.synchronize()
    assert ltk.COUNT.n == before + len(ltk.merge_plans(rows, chunks * w, l,
                                                           slots))
    rv, ri = ltk.merge_partials_plain(pv, pi, l)
    assert torch.equal(v, rv) and torch.equal(i, ri)


def test_merge_partials_kernel_sentinel_rows(card):
    """Rows of (+inf, INT32_MAX) only (a routed-away shard's partials) and
    rows of +inf under real ids, beside ordinary rows."""
    pv, pi = _sentinel_partials(card, 12, 64, 256, seed=3)
    pv[:4], pi[:4] = float("inf"), INT32_MAX
    pv[4:6] = float("inf")
    v, i = ltk.merge_partials(pv, pi, 128)
    rv, ri = ltk.merge_partials_plain(pv, pi, 128)
    assert torch.equal(v, rv) and torch.equal(i, ri)


@pytest.mark.parametrize("masked", [False, True])
def test_merge_of_distance_topk_partials(card, monkeypatch, masked):
    """The merge pass on a real distance_topk launch's partials (under
    the routed 1-of-8 mask too) equals the plain merge, bit for bit."""
    k, m, d, l = 8, 32768, 64, 128
    q, p = _randn(card, 32, d), _randn(card, k, m, d, seed=11)
    valid = _mask(card, k, m, "one") if masked else None
    seen = []
    merge = ltk.merge_partials

    def keep(pv, pi, l):
        seen.append((pv.clone(), pi.clone()))
        return merge(pv, pi, l)

    monkeypatch.setattr(ltk, "merge_partials", keep)
    v, i = dtk.distance_topk_cuda(q, p, l, valid=valid)
    (pv, pi), = seen
    rv, ri = ltk.merge_partials_plain(pv, pi, l)
    assert torch.equal(v.reshape(-1, l), rv)
    assert torch.equal(i.reshape(-1, l), ri)


def test_wrappers_raise_instead_of_falling_back(card):
    q, p = _randn(card, 4, 16), _randn(card, 1000, 16)
    with pytest.raises(ValueError, match="l=300"):
        dtk.distance_topk_cuda(q, p, 300)
    # the dispatcher serves l = 300 with kernels (l2_distance, then
    # local_topk's passes), equal to the plain version
    v, i = ops.distance_topk(q, p, 300)
    rv, ri = dtk.distance_topk_plain(q, p, 300)
    _topk_close(v, i, rv, ri, l2.l2_distance_plain(q, p))
    with pytest.raises(TypeError):
        ops.l2_distance(q.double(), p.double())
    with pytest.raises(ValueError, match="contiguous"):
        ops.local_topk(_randn(card, 64, 8).t(), 4)


def test_server_on_the_card_matches_the_cpu(card):
    pts = np.random.default_rng(0).normal(size=(8 * 2048, 32)).astype(
        np.float32)
    cfg = CONFIG.replace(dim=32, l_max=64, bucket_sizes=(4, 8))
    qs = np.random.default_rng(1).normal(size=(6, 32)).astype(np.float32)
    ls = [1, 64, 7, 30, 2, 64]
    for sampler in ("selection", "gather"):
        gpu = KnnServer(pts, cfg=cfg.replace(sampler=sampler), device=card)
        cpu = KnnServer(pts, cfg=cfg.replace(sampler=sampler), device="cpu")
        for a, b in zip(gpu.query_batch(qs, ls), cpu.query_batch(qs, ls)):
            np.testing.assert_allclose(a.dists, b.dists, **F32)
    # l_max above one top-l pass is served on the card too
    big = cfg.replace(l_max=300)
    ls = [1, 300, 257, 30, 2, 299]
    for sampler in ("selection", "gather"):
        gpu = KnnServer(pts, cfg=big.replace(sampler=sampler), device=card)
        cpu = KnnServer(pts, cfg=big.replace(sampler=sampler), device="cpu")
        for a, b in zip(gpu.query_batch(qs, ls), cpu.query_batch(qs, ls)):
            np.testing.assert_allclose(a.dists, b.dists, **F32)


def _routing_instance(B, pivots, seed=0, k=8, per=256, dim=64):
    """Clustered points with shard 2 emptied, queries near the centers,
    l mixing 0 with 1..300; numpy, from a seed."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=8.0, size=(k, dim))
    pts = (centers[:, None, :] + rng.normal(size=(k, per, dim))).reshape(
        -1, dim).astype(np.float32)
    valid = np.ones(k * per, bool)
    valid[2 * per:3 * per] = False
    q = (centers[rng.integers(0, k, B)]
         + rng.normal(size=(B, dim))).astype(np.float32)
    ls = rng.integers(0, 300, B).astype(np.int32)
    ls[0] = 0
    summ = build_summaries(pts, k, valid=valid, num_pivots=pivots)
    return pts, valid, q, ls, summ


@pytest.mark.parametrize("pivots", [1, 2, 4])
@pytest.mark.parametrize("B", [1, 5, 32, 70])
def test_route_mask_kernel_bit_equal(card, pivots, B):
    """The fused kernel's route mode: rows equal route_mask_plain's on
    the card and on the CPU, in one launch (B = 70: warps take rows in
    turn); unions are the rows' any(0)."""
    pts, valid, q, ls, summ = _routing_instance(B, pivots, seed=B)
    packed = rt.PackedRouting(rt.pack_summaries(summ), device=card)
    qt = torch.from_numpy(q).to(card)
    lt = torch.from_numpy(ls).to(card)
    before = rt.COUNT.n
    out, keep, unions = rt.route_index_cuda(qt, lt, packed)
    torch.cuda.synchronize()
    assert rt.COUNT.n == before + 1 and keep is None
    assert torch.equal(out, rt.route_mask_plain(qt, lt, packed.route_ops()))
    cpu = rt.route_mask_plain(torch.from_numpy(q), torch.from_numpy(ls),
                              rt.on_device(rt.pack_summaries(summ), "cpu"))
    assert torch.equal(out.cpu(), cpu)
    assert torch.equal(unions, out.any(0))
    assert not bool(out[0].any()) and not bool(out[:, 2].any())


@pytest.mark.parametrize("B", [1, 5, 32])
def test_index_mask_kernel_bit_equal(card, B):
    """The fused kernel's index mode, on caller-given rows."""
    pts, valid, q, ls, summ = _routing_instance(B, 1, seed=10 + B)
    idx = IndexMaintainer(8, 256, 64, 8)
    idx.rebuild(pts, valid)
    iops = rt.pack_index(idx.freeze(0))
    qt = torch.from_numpy(q).to(card)
    lt = torch.from_numpy(ls).to(card)
    rows = rt.route_mask_plain(qt, lt,
                               rt.on_device(rt.pack_summaries(summ), card))
    rows[:, 5] = 0                                 # the gate drops shard 5
    packed = rt.PackedRouting(index=iops, device=card, k=8)
    before = rt.COUNT.n
    none, out, unions = rt.route_index_cuda(qt, lt, packed, rows)
    torch.cuda.synchronize()
    assert rt.COUNT.n == before + 1 and none is None
    assert torch.equal(out, rt.index_mask_plain(qt, lt, rows,
                                                packed.index_ops()))
    assert torch.equal(unions, torch.cat([rows.any(0), out.any(0)]))
    assert not bool(out[0].any()) and not bool(out[:, 40:48].any())


@pytest.mark.parametrize("pivots", [1, 4])
@pytest.mark.parametrize("B", [1, 5, 32, 33])
def test_route_index_kernel_unions(card, pivots, B):
    """Route + index in one launch: both row sets bit-equal to the plain
    versions (the buckets gated by the rows the launch computed), and the
    unions, shards then buckets, their any(0)."""
    pts, valid, q, ls, summ = _routing_instance(B, pivots, seed=30 + B)
    idx = IndexMaintainer(8, 256, 64, 8)
    idx.rebuild(pts, valid)
    packed = rt.PackedRouting(rt.pack_summaries(summ),
                              rt.pack_index(idx.freeze(0)), device=card)
    qt = torch.from_numpy(q).to(card)
    lt = torch.from_numpy(ls).to(card)
    before = rt.COUNT.n
    rows, keep, unions = ops.route_index(qt, lt, packed)
    torch.cuda.synchronize()
    assert rt.COUNT.n == before + 1
    want_rows, want_keep, want_unions = rt.route_index_plain(qt, lt, packed)
    assert torch.equal(rows, want_rows) and torch.equal(keep, want_keep)
    assert torch.equal(unions, want_unions)
    assert torch.equal(unions, torch.cat([rows.any(0), keep.any(0)]))
    # the server's launch: the unions alone, no rows written
    none, none2, alone = ops.route_index(qt, lt, packed, with_rows=False)
    assert none is None and none2 is None and torch.equal(alone, unions)
    assert rt.COUNT.n == before + 2


def test_routed_server_on_the_card_matches_the_cpu(card):
    rng = np.random.default_rng(2)
    centers = rng.normal(scale=8.0, size=(8, 32))
    pts = (centers[:, None, :] + rng.normal(size=(8, 1024, 32))).reshape(
        -1, 32).astype(np.float32)
    qs = (centers[[0, 3, 5, 5, 1, 7]]
          + rng.normal(size=(6, 32))).astype(np.float32)
    ls = [1, 64, 7, 30, 2, 64]
    base = CONFIG.replace(dim=32, l_max=64, bucket_sizes=(4, 8),
                          route="pruned", route_compute="device")
    before = ops.launch_counts()
    for cfg in (base, base.replace(search="approx"),
                base.replace(sampler="gather")):
        gpu = KnnServer(pts, cfg=cfg, device=card).query_batch(qs, ls)
        cpu = KnnServer(pts, cfg=cfg, device="cpu").query_batch(qs, ls)
        for a, b in zip(gpu, cpu):
            np.testing.assert_allclose(a.dists, b.dists, **F32)
            assert a.shards_touched == b.shards_touched < 8
    after = ops.launch_counts()
    # one batch (bucket 8) per server: one routing launch in each, the
    # approx one's computing the bucket rows too
    assert after["route_index_mask"] - before["route_index_mask"] == 3


def _store_mask(card, k, m, mode, l, seed=0):
    """A (k, m) valid mask as a mutable store leaves it: unequal live
    prefixes and dead tails ("tail"), tombstones scattered in the used
    prefix ("scattered"), or one shard at 0 < live < l and one empty
    ("few")."""
    g = torch.Generator(device=card)
    g.manual_seed(seed)
    used = torch.randint(m // 4, m + 1, (k, 1), generator=g, device=card)
    v = torch.arange(m, device=card)[None, :] < used
    if mode == "scattered":
        v &= torch.rand((k, m), generator=g, device=card) > 0.3
    elif mode == "few":
        v[2] = False
        v[2, torch.randperm(m, generator=g, device=card)[:l // 3]] = True
        v[5] = False
    return v


@pytest.mark.parametrize("mode", ["tail", "scattered", "few"])
def test_masked_kernels_under_store_masks(card, monkeypatch, mode):
    """distance_topk, l2_distance and the merge of distance_topk's
    partials under a store's masks equal their plain versions: values
    within F32, +inf slots with the sentinel id, no dead point surfacing,
    the merge bit for bit."""
    k, m, d, l = 8, 32768, 64, 128
    q, p = _randn(card, 32, d, seed=21), _randn(card, k, m, d, seed=22)
    valid = _store_mask(card, k, m, mode, l)
    full = torch.where(valid.unsqueeze(1), l2.l2_distance_plain(q, p),
                       torch.full((k, 32, m), float("inf"), device=card))
    out = l2.l2_distance_cuda(q, p, valid=valid)
    assert torch.equal(torch.isinf(out), torch.isinf(full))
    torch.testing.assert_close(out, full, **F32)
    seen = []
    merge = ltk.merge_partials

    def keep(pv, pi, l):
        seen.append((pv.clone(), pi.clone()))
        return merge(pv, pi, l)

    monkeypatch.setattr(ltk, "merge_partials", keep)
    v, i = dtk.distance_topk_cuda(q, p, l, valid=valid)
    rv, ri = dtk.distance_topk_plain(q, p, l, valid=valid)
    _topk_close(v, i, rv, ri, full)
    fin = torch.isfinite(v)
    dead = (~valid).unsqueeze(1).expand(k, 32, m)
    assert not bool((dead.gather(2, torch.where(fin, i, 0).long())
                     & fin).any())
    if mode == "few":
        assert int(fin[2].sum(-1).max()) == l // 3 and not bool(fin[5].any())
    (pv, pi), = seen
    mv, mi = ltk.merge_partials_plain(pv, pi, l)
    assert torch.equal(v.reshape(-1, l), mv) and torch.equal(
        i.reshape(-1, l), mi)


def test_store_server_on_the_card(card):
    """A small store on the card under churn: every server's answers
    equal brute force over the live set of the generation they report,
    the pruned answers byte-identical to the exact route's, and the
    snapshot captured before a flush unchanged by it."""
    from repro_torch.data import drifting_clusters
    from repro_torch.store import MutableStore
    dim, cap = 32, 2048
    cfg = CONFIG.replace(dim=dim, l_max=64, bucket_sizes=(4, 8),
                         summary_pivots=2, placement="affinity",
                         redeal="proximity", retighten_every=256,
                         store_capacity_per_shard=cap,
                         store_staging_size=10**9)
    st = MutableStore(dim, device=card,
                      **cfg.replace(search="approx").store_kwargs())
    servers = {name: KnnServer(store=st, cfg=cfg.replace(**kw), device=card)
               for name, kw in (
                   ("exact", {}), ("gather", dict(sampler="gather")),
                   ("pruned", dict(route="pruned",
                                   route_compute="device")),
                   ("approx", dict(route="pruned", route_compute="device",
                                   search="approx",
                                   index_oversample=1e9)))}
    servers["exact"].warmup()                     # on the empty store
    rng = np.random.default_rng(3)
    ls = [1, 64, 7, 30, 2, 64]
    for pts, centers in drifting_clusters(8, 300, dim, steps=4, seed=3):
        ids = st.insert(pts)
        st.flush()
        before = st.snapshot()
        held = before.points.clone()
        st.delete(rng.choice(ids, 500, replace=False))
        st.flush()
        assert torch.equal(held, before.points)
        lid, lpts = st.live_arrays()
        lp = torch.as_tensor(lpts, device=card).double()
        qs = (centers[rng.integers(0, 8, 6)]
              + rng.normal(size=(6, dim))).astype(np.float32)
        answers = {n: s.query_batch(qs, ls) for n, s in servers.items()}
        for j, (q, l) in enumerate(zip(qs, ls)):
            q64 = torch.as_tensor(q, device=card).double()
            d = ((lp - q64) ** 2).sum(-1)              # f64 brute force
            bv, bi = (t.cpu().numpy() for t in torch.topk(d, l + 1,
                                                          largest=False))
            # F32 plus the f32 rounding of the expanded distance the
            # kernels compute, 32 * 2^-23 * (|q|^2 + max |p|^2); ids as
            # sets, or the strict interior where the l-th and (l+1)-th
            # distances lie within that of each other
            mag = float((q64 * q64).sum() + (lp * lp).sum(-1).max())
            tol = 1e-3 + 1e-4 * bv[l - 1] + 32 * 2.0 ** -23 * mag
            want = set(lid[bi[:l] if bv[l] - bv[l - 1] > tol
                           else bi[:l][bv[:l] < bv[l - 1] - tol]].tolist())
            for name, res in answers.items():
                assert res[j].generation == st.generation
                np.testing.assert_allclose(res[j].dists, bv[:l], rtol=0,
                                           atol=tol)
                got = set(res[j].ids.tolist())
                assert want <= got if bv[l] - bv[l - 1] <= tol else (
                    want == got), name
            assert answers["pruned"][j].dists.tobytes() == \
                answers["exact"][j].dists.tobytes()


@pytest.mark.parametrize("l", [128, 300])
@pytest.mark.parametrize("mode", ["tail", "scattered", "few"])
def test_label_gather_under_store_masks(card, mode, l):
    """The label payload behind the card's top-l (distance_topk at l =
    128, l2_distance + local_topk's passes at l = 300) under a store's
    masks: each finite slot carries the label of the point its id names,
    each +inf slot label 0 and the sentinel id, and the labels equal the
    plain version's wherever the ids do."""
    from repro_torch.core import knn as tknn
    k, m, d = 8, 8192, 64
    q, p = _randn(card, 32, d, seed=31), _randn(card, k, m, d, seed=32)
    valid = _store_mask(card, k, m, mode, l)
    ids = torch.arange(k * m, dtype=torch.int32, device=card).view(k, m)
    g = torch.Generator(device=card)
    g.manual_seed(33)
    labels = torch.randint(0, 16, (k, m), generator=g, device=card).float()
    before = dict(ops.launch_counts())
    v, i, lab = tknn.local_distance_top_l(q, p, ids, l, valid=valid,
                                          extra=labels)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    fused = "distance_topk" if l <= 256 else "l2_distance"
    assert after[fused] > before[fused]
    rv, ri, rlab = (t.to(card) for t in tknn.local_distance_top_l(
        q.cpu(), p.cpu(), ids.cpu(), l, valid=valid.cpu(),
        extra=labels.cpu()))
    full = torch.where(valid.unsqueeze(1), l2.l2_distance_plain(q, p),
                       torch.full((k, 32, m), float("inf"), device=card))
    # the ids are global (shard * m + slot); _topk_close reads slots
    base = (torch.arange(k, device=card) * m).view(k, 1, 1).int()
    _topk_close(v, torch.where(torch.isfinite(v), i - base, i), rv,
                torch.where(torch.isfinite(rv), ri - base, ri), full)
    for vv, ii, ll in ((v, i, lab), (rv, ri, rlab)):
        fin = torch.isfinite(vv)
        want = labels.view(-1)[torch.where(fin, ii, 0).long()]
        assert torch.equal(torch.where(fin, ll, 0.0), torch.where(
            fin, want, 0.0))
        assert bool((ll[~fin] == 0).all()) and bool(
            (ii[~fin] == INT32_MAX).all())
    same = i == ri
    assert torch.equal(lab[same], rlab[same])


def _boundary_clear(d, r):
    """Whether ascending f64 distances ``d`` have their r-th and
    (r+1)-th apart by more than f32 rounding could close."""
    return len(d) <= r or d[r] - d[r - 1] > 1e-5 * d[r] + 1e-6


def test_predict_on_the_card_matches_the_cpu(card):
    """Exact vote (exact and device-pruned routes), exact regress and the
    ensemble (vote and regress, exact and host-pruned routes), static and
    over a labeled store under churn: the card's labels and confidences
    equal the CPU's byte for byte on every row whose deciding rank (l for
    the exact fold, kl in every shard for the ensemble) is clear of a
    near-tie; the bill of the ensemble is one message a touched shard."""
    from repro_torch.data import labeled_mixture
    from repro_torch.store import MutableStore
    n, dim, c, l_max = 8 * 1024, 16, 8, 64
    pts, labels, centers = labeled_mixture(n, dim, c, separation=6.0,
                                           seed=0)
    labels = labels.astype(np.float32)
    rng = np.random.default_rng(1)
    qs = (centers[rng.integers(0, c, 8)]
          + rng.normal(size=(8, dim))).astype(np.float32)
    ls = [1, 64, 7, 30, 2, 64, 13, 40]
    cfg = CONFIG.replace(dim=dim, l_max=l_max, bucket_sizes=(4, 8),
                         num_classes=c, predict="vote",
                         store_capacity_per_shard=1024,
                         store_staging_size=10**9)
    runs = (dict(), dict(route="pruned", route_compute="device"),
            dict(predict="regress"),
            dict(predict_mode="ensemble"),
            dict(predict_mode="ensemble", route="pruned",
                 route_compute="host"),
            dict(predict_mode="ensemble", predict="regress"))

    def live_f64(st):
        lid, lpts = st.live_arrays()
        return lid, lpts.astype(np.float64), st._slot_of

    compared = 0
    for backing in ("static", "store"):
        stores = {}
        if backing == "store":
            for dev in (card, "cpu"):
                st = MutableStore(dim, device=dev, **cfg.store_kwargs())
                ids = st.insert(pts[:6000], labels=labels[:6000])
                st.flush()
                st.delete(ids[::7])
                st.update(ids[1:500:7], pts[1:500:7] + 0.3,
                          labels=np.zeros(72, np.float32))
                st.insert(pts[6000:7000], labels=labels[6000:7000])
                st.flush()
                stores[dev if dev == "cpu" else "card"] = st
            lid, lp, slot_of = live_f64(stores["cpu"])
            shard_of = np.array([slot_of[int(i)] // 1024 for i in lid])
        else:
            lid, lp = np.arange(n), pts.astype(np.float64)
            shard_of = lid // 1024
        for kw in runs:
            k_cfg = cfg.replace(**kw)
            if backing == "static":
                gpu = KnnServer(pts, labels=labels, cfg=k_cfg, device=card)
                cpu = KnnServer(pts, labels=labels, cfg=k_cfg, device="cpu")
            else:
                gpu = KnnServer(store=stores["card"], cfg=k_cfg,
                                device=card)
                cpu = KnnServer(store=stores["cpu"], cfg=k_cfg,
                                device="cpu")
            for q, l, a, b in zip(qs, ls, gpu.query_batch(qs, ls),
                                  cpu.query_batch(qs, ls)):
                assert a.predict_mode == b.predict_mode != "none"
                d = ((lp - q.astype(np.float64)) ** 2).sum(-1)
                if a.predict_mode == "exact":
                    clear = _boundary_clear(np.sort(d), l)
                else:
                    assert a.messages == a.shards_touched == b.shards_touched
                    kl = -(-l // a.shards_touched)
                    clear = all(_boundary_clear(np.sort(d[shard_of == j]), kl)
                                for j in range(8))
                if clear:
                    compared += 1
                    assert np.float32(a.label).tobytes() == np.float32(
                        b.label).tobytes(), (backing, kw, l)
                    assert np.float32(a.confidence).tobytes() == np.float32(
                        b.confidence).tobytes(), (backing, kw, l)
    assert compared >= 0.75 * 2 * len(runs) * len(qs)


# ---- background maintenance and the operator layer on the card ---------------

def _brute_check(card, res, hid, hpts, q, l):
    """One answer against an f64 brute force over the live set ``(hid,
    hpts)`` of its generation, with the tolerance of
    test_store_server_on_the_card."""
    lp = torch.as_tensor(hpts, device=card).double()
    q64 = torch.as_tensor(q, device=card).double()
    d = ((lp - q64) ** 2).sum(-1)
    n = min(l, len(hid))
    bv, bi = (t.cpu().numpy() for t in torch.topk(
        d, min(l + 1, len(hid)), largest=False))
    mag = float((q64 * q64).sum() + (lp * lp).sum(-1).max())
    tol = 1e-3 + 1e-4 * bv[n - 1] + 32 * 2.0 ** -23 * mag
    np.testing.assert_allclose(res.dists[:n], bv[:n], rtol=0, atol=tol)
    assert np.all(res.ids[n:] == INT32_MAX)
    got = set(res.ids[:n].tolist())
    if len(bv) == n or bv[n] - bv[n - 1] > tol:
        assert got == set(hid[bi[:n]].tolist())
    else:
        assert set(hid[bi[:n][bv[:n] < bv[n - 1] - tol]].tolist()) <= got


def _background_store(card, dim, cap, **kw):
    from repro_torch.store import MutableStore
    return MutableStore(dim, capacity_per_shard=cap, device=card,
                        placement="affinity", redeal="proximity",
                        summary_pivots=2, retighten_every=64,
                        split_radius_factor=1.2, maintenance="background",
                        track_history=True, staging_size=10**9, **kw)


def test_background_store_races_a_batcher_on_the_card(card):
    """A writer thread churns a small background store while the
    micro-batcher serves pruned device routing and the worker maintains:
    every answer equals brute force over its own generation, and the
    worker committed work without an error."""
    import threading
    from repro_torch.data import drifting_clusters
    dim, cap = 32, 1024
    st = _background_store(card, dim, cap)
    cfg = CONFIG.replace(dim=dim, l_max=32, bucket_sizes=(1, 4, 8),
                         route="pruned", route_compute="device",
                         summary_pivots=2, max_wait_ms=2.0)
    srv = KnnServer(store=st, cfg=cfg, device=card)
    stream = drifting_clusters(8, 200, dim, steps=64, drift=2.0, seed=5)
    pts, centers = next(stream)
    st.insert(pts)
    st.flush()
    srv.warmup()
    errors = []

    def writer():
        rng = np.random.default_rng(6)
        try:
            for _ in range(8):
                pts, _ = next(stream)
                ids = st.insert(pts)
                st.flush()
                st.delete(rng.choice(ids, 900, replace=False))
                st.flush()
        except Exception as exc:
            errors.append(exc)

    rng = np.random.default_rng(7)
    t = threading.Thread(target=writer, daemon=True)
    pending = []
    with srv.serving():
        t.start()
        while t.is_alive() or len(pending) < 32:
            q = (centers[rng.integers(0, 8)] + rng.normal(size=dim)).astype(
                np.float32)
            l = int(rng.integers(1, 33))
            pending.append((q, l, srv.submit(q, l)))
            if len(pending) % 8 == 0:
                time.sleep(0.01)
        t.join()
        results = [(q, l, f.result(timeout=120)) for q, l, f in pending]
    time.sleep(0.2)
    st.close()
    assert not errors, errors
    ws = st.maintenance_stats()["worker"]
    assert ws["errors"] == 0 and ws["commits"] > 0, ws
    for q, l, r in results:
        hid, hpts = st.history(r.generation)
        _brute_check(card, r, hid, hpts, q, l)
    assert srv.obs_snapshot()["audit"]["contract"]["violations"] == 0


@pytest.mark.parametrize("pinned", [False, True])
def test_side_stream_upload_read_before_and_after_commit(card, pinned):
    """The repack's upload runs on the worker's own stream while a batch
    reads the old generation; after the commit the snapshot's buffers
    equal the host mirrors, and a query before and one after the commit
    each equal brute force at their generation.  The upload alone copies
    pageable and page-locked host arrays alike."""
    import threading
    from repro_torch.store import maintenance
    dim, cap = 16, 2048
    st = _background_store(card, dim, cap, compact_tombstone_frac=0.2)
    st.close()
    cfg = CONFIG.replace(dim=dim, l_max=16, bucket_sizes=(4,))
    srv = KnnServer(store=st, cfg=cfg, device=card)
    rng = np.random.default_rng(8)
    ids = st.insert(rng.normal(scale=4.0, size=(6000, dim)).astype(
        np.float32))
    st.flush()
    st.delete(rng.choice(ids, 3000, replace=False))     # arms the trigger
    st.flush()
    q = rng.normal(scale=4.0, size=(4, dim)).astype(np.float32)
    ls = [1, 5, 16, 9]
    gen0 = st.generation
    before = srv.query_batch(q, ls)
    during = []
    t = threading.Thread(target=lambda: during.append(
        [srv.query_batch(q, ls) for _ in range(3)]))
    t.start()
    assert st._worker_final._cycle()                    # plan, upload, commit
    t.join()
    after = srv.query_batch(q, ls)
    assert st.generation == gen0 + 1
    assert st.maint_commit_clock()[1]["kind"] == "repack"
    snap = st.snapshot()
    torch.cuda.synchronize()
    assert torch.equal(snap.points.cpu(), torch.from_numpy(st._pts))
    assert torch.equal(snap.ids.cpu(), torch.from_numpy(st._ids))
    assert torch.equal(snap.valid.cpu(), torch.from_numpy(st._valid))
    for res in [before, after] + during[0]:
        for r, qq, l in zip(res, q, ls):
            hid, hpts = st.history(r.generation)
            _brute_check(card, r, hid, hpts, qq, l)
    assert {r.generation for r in before} == {gen0}
    assert {r.generation for r in after} == {gen0 + 1}
    host = [rng.normal(size=(1000, dim)).astype(np.float32),
            np.arange(1000, dtype=np.int32), np.ones(1000, bool)]
    if pinned:
        host = [torch.from_numpy(a).pin_memory().numpy() for a in host]
    side = torch.cuda.Stream(card)
    for a, b in zip(host, maintenance.upload(host, card, stream=side)):
        assert b.device.type == "cuda" and torch.equal(
            b.cpu(), torch.from_numpy(a))


def test_explain_capture_holds_no_cuda_tensor(card):
    """Explain captures of device-routed, indexed and ensemble batches on
    the card hold host arrays only, and build their reports."""
    from repro_torch.store import MutableStore
    dim, cap = 16, 512
    rng = np.random.default_rng(9)
    pts = rng.normal(scale=3.0, size=(2000, dim)).astype(np.float32)
    labels = rng.integers(0, 4, 2000).astype(np.float32)
    q = rng.normal(scale=3.0, size=(4, dim)).astype(np.float32)
    for kw in (dict(route="pruned", route_compute="device", search="approx",
                    index_buckets=4),
               dict(route="pruned", predict="vote", predict_mode="ensemble",
                    num_classes=4)):
        cfg = CONFIG.replace(dim=dim, l_max=16, bucket_sizes=(4,),
                             store_capacity_per_shard=cap, **kw)
        st = MutableStore(dim, device=card, **cfg.store_kwargs())
        st.insert(pts, labels=labels if st.with_labels else None)
        st.flush()
        srv = KnnServer(store=st, cfg=cfg, device=card)
        res = srv.query_batch(q, [4, 8, 16, 1])
        cap_ = res[0].explain_ref.capture
        for name in cap_.__slots__:
            v = getattr(cap_, name)
            assert not isinstance(v, torch.Tensor), name
        rep = res[1].explain()
        assert rep["batch"]["generation"] == st.generation
        assert rep["routing"]["kept_shards"]


def test_obs_adds_no_launch_or_sync_on_the_card(card):
    """Tracing, explain and an SLO on: the same kernel launches and host
    syncs as with all off; the shadow replay's launches are counted
    apart, in the server's audit.shadow.launches.* counters.  The phase
    clock, on in every arm, reads the step's device time by events: more
    than 0 and no more than the batch's host wall."""
    from repro_torch.store import MutableStore
    dim, cap = 32, 1024
    rng = np.random.default_rng(10)
    pts = rng.normal(scale=3.0, size=(4000, dim)).astype(np.float32)
    q = rng.normal(scale=3.0, size=(8, dim)).astype(np.float32)
    ls = [1, 8, 32, 4, 16, 2, 32, 7]
    base = CONFIG.replace(dim=dim, l_max=32, bucket_sizes=(8,),
                          route="pruned", route_compute="device",
                          search="approx", index_buckets=4,
                          store_capacity_per_shard=cap)
    st = MutableStore(dim, device=card, **base.store_kwargs())
    st.insert(pts)
    st.flush()
    runs = {}
    for name, kw in (("off", {}),
                     ("on", dict(obs_trace=True, slo_latency_p99_s=1.0)),
                     ("audit", dict(obs_trace=True, obs_audit_every=1))):
        srv = KnnServer(store=st, cfg=base.replace(**kw), device=card)
        srv.warmup()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = srv.query_batch(q, ls)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        runs[name] = (ops.launch_counts(), [r.host_syncs for r in res],
                      [r.ids.tobytes() for r in res])
        snap = srv.stats.snapshot()
        assert snap["batches"] == 1
        assert 0.0 < snap["topl_device_s"] <= wall, (snap, wall)
        assert res[0].explain()["timings"]["topl_device_s"] == snap[
            "topl_device_s"]
        if srv.obs.tracer.enabled:
            topl = [r for r in srv.obs.tracer.spans() if r["name"] == "topl"]
            assert topl[-1]["attrs"]["device_s"] == snap["topl_device_s"]
        shadow = srv.obs_snapshot()["metrics"]
        apart = {k: v for k, v in shadow.items()
                 if k.startswith("audit.shadow.launches.")}
        assert bool(apart) == (name == "audit"), apart
    assert runs["on"] == runs["off"] == runs["audit"]
    assert runs["off"][0]["route_index_mask"] == 1


def test_knn_simple_builds_no_distance_matrix_on_the_card(card):
    """The gather baseline at a bucket of 128 over 8 x 2^20 points of
    width 96, l = 100: the (k, B, m) matrix would take 4.3 GB; the step
    is the fused distance_topk, so the peak grows by under 0.5 GB, no
    l2_distance launches, and the distances are bit-equal to the
    selection sampler's (one step makes both)."""
    from repro_torch.core import knn

    B, k, m, d, l = 128, 8, 1 << 20, 96, 100
    p = _randn(card, k, m, d, seed=29)
    q = _randn(card, B, d, seed=30)
    ids = torch.arange(k * m, dtype=torch.int32, device=card).view(k, m)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(card)
    torch.cuda.reset_peak_memory_stats(card)
    before = ops.COUNTERS["l2_distance"].n
    sd, si = knn.knn_simple(p, ids, q, l)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated(card) - base < 0.5e9
    assert ops.COUNTERS["l2_distance"].n == before
    g = torch.Generator(device=card)
    g.manual_seed(0)
    res = knn.knn_query_batched(p, ids, q, l, l, g)
    order = torch.argsort(res.dists, dim=1, stable=True)
    assert torch.equal(res.dists.gather(1, order), sd)
    assert torch.equal(torch.sort(res.ids, 1).values,
                       torch.sort(si, 1).values)
    assert bool((sd[:, 1:] >= sd[:, :-1]).all())


# ---- the LM path: the vocabulary top-k and the datastore's width --------

@pytest.mark.parametrize("B,V,l,mode", [
    (8, 151936, 50, "f32"),            # 64 rows of 18,992 (qwen2-0.5b)
    (8, 151941, 50, "f32"),            # 3 -inf pads in the last shard
    (3, 8 * 60 + 5, 60, "f32"),        # the top-l reaches the pads
    (8, 151936, 50, "bf16_ties")])     # bf16 logits full of ties
def test_local_topk_kernel_vocab_rows(card, B, V, l, mode):
    """The sampler's local step: negated logits over k = 8 vocabulary
    shards, -inf padded logits (+inf once negated) at the tail of a
    vocabulary k does not divide, against the plain version bit for
    bit."""
    from repro_torch.core.topk import shard_vocab
    logits = _randn(card, B, V, seed=30) * 3
    if mode == "bf16_ties":
        logits = (torch.round(logits * 2) / 2).to(torch.bfloat16)
    rows = (-shard_vocab(logits, 8)).contiguous().reshape(8 * B, -1)
    assert bool(torch.isinf(rows).any()) == (V % 8 != 0)
    before = ltk.COUNT.n
    v, i = ltk.local_topk_cuda(rows, l)
    torch.cuda.synchronize()
    assert ltk.COUNT.n > before
    rv, ri = ltk.local_topk_plain(rows, l)
    assert torch.equal(v, rv) and torch.equal(i, ri)


@pytest.mark.parametrize("l", [8, 192, 256])
def test_distance_kernels_at_lm_width(card, l):
    """l2_distance and distance_topk at d = 896 (qwen2-0.5b's hidden
    size), on keys at the embedding's scale.  The fused kernel takes l up
    to 192 at this width (its shared memory); above, ops.distance_topk is
    l2_distance then local_topk."""
    q = _randn(card, 8, 896) * 0.02
    p = _randn(card, 8, 16384, 896, seed=31) * 0.02
    full = l2.l2_distance_plain(q, p)
    torch.testing.assert_close(l2.l2_distance_cuda(q, p), full, **F32)
    sp = plan.step(8, 896, l, 4, 16384, ltk.sm_count(0))
    assert (sp.path == plan.DISTANCE_TOPK) == (l <= 192)
    before = (dtk.COUNT.n, l2.COUNT.n)
    v, i = ops.distance_topk(q, p, l)
    torch.cuda.synchronize()
    assert (dtk.COUNT.n - before[0], l2.COUNT.n - before[1]) == (
        (1, 0) if l <= 192 else (0, 1))
    rv, ri = dtk.distance_topk_plain(q, p, l)
    _topk_close(v, i, rv, ri, full)


def test_lm_server_on_the_card(card):
    """qwen2-0.5b at full width and 2 layers: Server.generate over 8
    vocabulary shards launches local_topk, every step's top-k equals a
    stable descending sort of the row, both samplers draw the same
    tokens, and decode agrees with the teacher-forced forward."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.models import build_model
    from repro_torch.runtime import ServeConfig, Server
    cfg = dataclasses.replace(configs.get("qwen2-0.5b"), n_layers=2)
    api = build_model(cfg)
    params = api.init_params(0, device=card)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, (4, 16))
    logged, gens = [], {}

    def observe(logits, res):
        srt = torch.sort(logits, dim=-1, descending=True, stable=True)
        assert torch.equal(res.indices.long(), srt.indices[:, :20])
        assert torch.equal(res.values, srt.values[:, :20])
        logged.append(logits.clone())

    for sampler in ("selection", "gather"):
        before = ltk.COUNT.n
        srv = Server(api, params, ServeConfig(max_seq=32, top_k=20,
                                              sampler=sampler),
                     shards=8, observe=observe)
        gens[sampler], stats = srv.generate({"tokens": prompt}, 6, key=3)
        assert ltk.COUNT.n > before
    np.testing.assert_array_equal(gens["selection"], gens["gather"])
    ext = np.concatenate([prompt, gens["selection"][:, :-1]], 1)
    with torch.no_grad():
        full, _ = api.forward(params, {"tokens": ext})
    for s in range(5):
        err = (logged[s] - full[:, prompt.shape[1] + s]).abs().max()
        assert float(err) < 5e-3


def test_train_step_on_the_card_matches_the_cpu(card):
    """One train step of qwen2-0.5b's reduced config (grad_accum 2,
    remat) from the same seeded weights on the card and on the CPU: loss
    within 1e-5; 99% of the parameters' elements within 1e-5 x max |p|
    and every tensor's displacement within 1% (relative L2), as
    tests/test_torch_train.py holds the port to the reference; no kernel
    of ``repro_torch.kernels`` launched."""
    from repro_torch import configs
    from repro_torch.data import MarkovTokens
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW
    from repro_torch.runtime import (TrainConfig, init_opt_state,
                                     make_train_step)
    cfg = configs.get("qwen2-0.5b").reduced()
    api = build_model(cfg)
    t, l = MarkovTokens(cfg.vocab, seed=3, branch=2,
                        n_contexts=13).batch(0, 8, 32)
    tcfg = TrainConfig(grad_accum=2, peak_lr=3e-3, warmup_steps=5,
                       total_steps=20)
    out = {}
    before = ops.launch_counts()
    for dev in ("cpu", card):
        model = api.init_params(0, device="cpu", train=True).to(dev)
        opt = AdamW(weight_decay=0.01)
        state = init_opt_state(api, tcfg, opt, model)
        model, state, m = make_train_step(api, tcfg, opt)(
            model, state, {"tokens": t, "labels": l})
        out[str(dev)] = (float(m["loss"]), {n: p.detach().cpu() for n, p
                                            in model.named_parameters()})
    assert ops.launch_counts() == before
    (lc, pc), (lg, pg) = out["cpu"], out[str(card)]
    assert abs(lc - lg) <= 1e-5
    start = {n: p.detach() for n, p in api.init_params(
        0, device="cpu").named_parameters()}
    pmax = max(float(p.abs().max()) for p in pc.values())
    far = sum(int(((pc[n] - pg[n]).abs() > 1e-5 * pmax).sum()) for n in pc)
    assert far <= 0.01 * sum(p.numel() for p in pc.values()), far
    for n in pc:
        moved, moved_ref = pg[n] - start[n], pc[n] - start[n]
        assert float((moved - moved_ref).norm()) <= 1e-2 * float(
            moved_ref.norm()), n


FAMILIES = ["granite-moe-3b-a800m", "phi3.5-moe-42b-a6.6b",
            "jamba-1.5-large-398b", "pixtral-12b", "seamless-m4t-large-v2",
            "xlstm-125m"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_on_the_card_matches_the_cpu(card, arch):
    """Each family's reduced config from the same seeded weights on the
    card and on the CPU: forward logits within 1e-4; greedy generation
    over 8 vocabulary shards token for token, local_topk launched on the
    card; one train step's loss within 1e-5."""
    from repro_torch import configs
    from repro_torch.launch.serve import stub_inputs
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW
    from repro_torch.runtime import (ServeConfig, Server, TrainConfig,
                                     init_opt_state, make_train_step)
    cfg = configs.get(arch).reduced()
    api = build_model(cfg)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (4, 16)),
             "labels": rng.integers(0, cfg.vocab, (4, 16)),
             **stub_inputs(cfg, rng, 4)}
    models = {"cpu": api.init_params(0, device="cpu")}
    models["cuda"] = api.init_params(0, device="cpu").to(card)
    out = {}
    for dev, model in models.items():
        with torch.no_grad():
            logits, _ = api.forward(model, batch)
        before = ltk.COUNT.n
        prefix = cfg.num_prefix_embeds if cfg.family == "vlm" else 0
        srv = Server(api, model, ServeConfig(max_seq=prefix + 32, top_k=1),
                     shards=8)
        gen, _ = srv.generate(batch, 6, key=1)
        assert (ltk.COUNT.n > before) == (dev == "cuda")
        trained = api.init_params(0, device="cpu", train=True).to(
            model.embed.table.device)
        tcfg = TrainConfig(peak_lr=3e-3, warmup_steps=2, total_steps=10)
        opt = AdamW()
        _, _, m = make_train_step(api, tcfg, opt)(
            trained, init_opt_state(api, tcfg, opt, trained), batch)
        out[dev] = (logits.cpu(), gen, float(m["loss"]))
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=0,
                               atol=1e-4)
    np.testing.assert_array_equal(out["cuda"][1], out["cpu"][1])
    assert abs(out["cuda"][2] - out["cpu"][2]) <= 1e-5


# ---- Algorithm 1: the device loop against the host loop and a sort ------

def _select_oracle(v, i, l, valid):
    """The rank-l key of every row by a sort in f64, ties to the smaller
    id: ``(thr_v, thr_i)``; ``(-inf, -2**31)`` at l <= 0 and ``(+inf,
    2**31-1)`` at l >= the row's valid total."""
    k, B, m = v.shape
    vv = v.double().permute(1, 0, 2).reshape(B, k * m)
    ii = i.permute(1, 0, 2).reshape(B, k * m).long()
    ok = (torch.ones_like(vv, dtype=torch.bool) if valid is None
          else valid.permute(1, 0, 2).reshape(B, k * m))
    # (hidden last, value, id): three stable sorts, the last key first
    order = torch.argsort(ii, dim=1, stable=True)
    order = order.gather(1, torch.argsort(vv.gather(1, order), dim=1,
                                          stable=True))
    order = order.gather(1, torch.argsort((~ok).gather(1, order).int(),
                                          dim=1, stable=True))
    total = ok.sum(1)
    lt = torch.minimum(torch.as_tensor(l, device=v.device).expand(B).long(),
                       total)
    pick = order.gather(1, (lt - 1).clamp(min=0)[:, None])[:, 0]
    tv = vv.gather(1, pick[:, None])[:, 0]
    ti = ii.gather(1, pick[:, None])[:, 0]
    allsel, zero = lt >= total, lt <= 0
    tv = torch.where(allsel, float("inf"),
                     torch.where(zero, float("-inf"), tv))
    ti = torch.where(allsel, INT32_MAX, torch.where(zero, -2**31, ti))
    return tv.to(v.dtype), ti.to(torch.int32)


def _select_case(card, B, m, kind, seed, k=8):
    """``(v, ids, l, valid)`` of one selection: per-shard ascending runs
    of m distances as the step writes them (+inf slots with the sentinel
    id at the tail of some shards), unique ids, l mixing 0, 1, m and
    beyond the valid total (as many as B has rows); ``kind``: ``prune``
    (sample_prune's mask, two rows all invalid, one where B < 6), ``ties`` (distances on a grid of 8, the prune's
    mask) or ``plain`` (no mask)."""
    from repro_torch.core import sampling
    g = torch.Generator(device=card)
    g.manual_seed(seed)
    v = torch.rand((k, B, m), generator=g, device=card)
    if kind == "ties":
        v = torch.round(v * 8) / 8
    v = torch.sort(v, dim=-1).values
    ids = torch.randperm(k * B * m, generator=g, device=card).to(
        torch.int32).view(k, B, m)
    tail = torch.rand((k, B, 1), generator=g, device=card) < 0.3
    slot = torch.arange(m, device=card) >= m - m // 5
    v = torch.where(tail & slot, float("inf"), v)
    ids = torch.where(tail & slot, INT32_MAX, ids)
    l = torch.randint(0, m + 1, (B,), generator=g, device=card,
                      dtype=torch.int32)
    l[:4] = torch.tensor([0, 1, m, k * m + 5], dtype=torch.int32)[:B]
    if kind == "plain":
        return v, ids, l, None
    valid = sampling.sample_prune(v, g, l.clamp(max=m)).valid.clone()
    valid[:, 5 % B] = False
    valid[:, B - 1] = False
    return v, ids, l, valid


def _check_select(card, v, ids, l, valid, pivots, seed=1):
    """The device loop against the host loop and an f64 sort on one case:
    thresholds and converged flags torch.equal, one launch, no sync, the
    rows done at once at 0 iterations and the rest at 1 or more; returns
    the device loop's result."""
    from repro_torch.core import selection
    from repro_torch.kernels import select_loop as sl
    assert ops.select_path(v) == ops.DEVICE_LOOP
    k, _, m = v.shape
    g = torch.Generator(device=card)
    g.manual_seed(seed)
    before = sl.COUNT.n
    dev = selection.select_l_smallest(v, ids, l, g, valid=valid,
                                      num_pivots=pivots)
    assert sl.COUNT.n - before == 1 and dev.host_syncs == 0
    cap = selection.iteration_cap(k * m)
    host = selection.host_loop(v, ids, l, g, valid=valid,
                               max_iterations=cap, num_pivots=pivots)
    assert sl.COUNT.n - before == 1
    ov, oi = _select_oracle(v, ids, l, valid)
    for got in (dev, host):
        assert torch.equal(got.threshold_v, ov)
        assert torch.equal(got.threshold_i, oi)
        assert bool(got.converged.all())
    total = k * m if valid is None else valid.sum((0, 2))
    done_at_once = (l.clamp(max=k * m) <= 0) | (l >= total)
    assert bool((dev.row_iterations[done_at_once] == 0).all())
    assert bool((dev.row_iterations[~done_at_once] > 0).all())
    assert dev.iterations == int(dev.row_iterations.max()) <= cap
    return dev


@pytest.mark.parametrize("B,m", [(128, 100), (128, 1024), (64, 100)])
@pytest.mark.parametrize("kind", ["prune", "ties", "plain"])
@pytest.mark.parametrize("pivots", [1, 8])
def test_select_device_loop_equals_host_loop(card, B, m, kind, pivots):
    """Algorithm 1 at k = 8, one pivot or every shard's (num_pivots > 1):
    the device loop's thresholds and converged flags torch.equal to the
    host loop's and to an f64 sort's, in one launch; every row converged
    within the cap, and the batch's iterations inside the Theorem-1
    envelope."""
    from repro_torch.obs import ContractAuditor
    from repro_torch.obs.metrics import MetricsRegistry
    v, ids, l, valid = _select_case(card, B, m, kind, seed=B + m)
    assert plan.select(8 * m, 4, pivots).smem_keys
    dev = _check_select(card, v, ids, l, valid, pivots)
    auditor = ContractAuditor(MetricsRegistry(), k=8)
    assert 2 * dev.iterations <= auditor.rounds_bound(
        m, 8 * m, use_sampling=valid is not None, sampler="selection")


@pytest.mark.parametrize("B,m,kind", [(4, 8192, "prune"), (4, 8192, "ties"),
                                      (2, 16384, "plain")])
@pytest.mark.parametrize("pivots", [1, 8])
def test_select_device_loop_keys_in_global_memory(card, B, m, kind, pivots):
    """Rows too long for their keys to sit in shared memory (65,536 and
    131,072 keys: the LM sampler's vocabulary scale) read them where they
    lie, with several words of in-range bits a thread: thresholds as the
    host loop's and the sort's."""
    v, ids, l, valid = _select_case(card, B, m, kind, seed=m + pivots)
    assert not plan.select(8 * m, 4, pivots).smem_keys
    _check_select(card, v, ids, l, valid, pivots)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_select_device_loop_half_keys(card, dtype):
    """bf16 and f16 keys take the device loop too, thresholds as the host
    loop's and the sort's."""
    v, ids, l, valid = _select_case(card, 128, 100, "ties", seed=7)
    _check_select(card, v.to(dtype), ids, l, valid, 1, seed=2)


def test_select_device_loop_stops_at_the_cap(card):
    """``max_iterations=1``: converged rows hold the exact threshold, the
    rest the initial one; one iteration each, none for rows done at
    once."""
    from repro_torch.core import selection
    v, ids, l, valid = _select_case(card, 128, 1024, "prune", seed=3)
    g = torch.Generator(device=card)
    g.manual_seed(4)
    res = selection.select_l_smallest(v, ids, l, g, valid=valid,
                                      max_iterations=1)
    ov, oi = _select_oracle(v, ids, l, valid)
    c = res.converged
    assert not bool(c.all())
    assert torch.equal(res.threshold_v[c], ov[c])
    assert torch.equal(res.threshold_i[c], oi[c])
    assert bool((res.threshold_v[~c] == float("-inf")).all())
    assert bool((res.threshold_i[~c] == -2**31).all())
    assert bool((res.row_iterations <= 1).all())
    assert res.iterations == 1


@pytest.mark.parametrize("shape", ["deep1b", "knnlm", "open"])
def test_knn_query_batched_paths_equal(card, monkeypatch, shape):
    """Algorithm 2 at scaled-down cell shapes (deep1b: B 128, l 100, d 96;
    knnlm: l 1,024, d 64; the open cell: a bucket of 64 with 41 rows at l
    = 10 and 23 padding rows): the (B, l) distances and ids torch.equal
    between the device loop and the host loop, one device-loop launch a
    batch."""
    from repro_torch.core import knn, selection
    from repro_torch.kernels import select_loop as sl
    B, m, d, l_max = {"deep1b": (128, 4096, 96, 100),
                      "knnlm": (128, 4096, 64, 1024),
                      "open": (64, 4096, 96, 100)}[shape]
    p = _randn(card, 8, m, d, seed=40)
    q = _randn(card, B, d, seed=41)
    pid = torch.arange(8 * m, dtype=torch.int32, device=card).view(8, m)
    ls = torch.full((B,), l_max, dtype=torch.int32, device=card)
    if shape == "open":
        ls[:41], ls[41:] = 10, 0
    out = {}
    for path in (ops.DEVICE_LOOP, ops.HOST_LOOP):
        monkeypatch.setattr(selection.kops, "select_path",
                            lambda v, path=path: path)
        g = torch.Generator(device=card)
        g.manual_seed(5)
        before = sl.COUNT.n
        res = knn.knn_query_batched(p, pid, q, l_max, ls, g)
        assert sl.COUNT.n - before == int(path == ops.DEVICE_LOOP)
        out[path] = res
    a, b = out[ops.DEVICE_LOOP], out[ops.HOST_LOOP]
    assert torch.equal(a.dists, b.dists) and torch.equal(a.ids, b.ids)
    assert torch.equal(a.mask, b.mask)


def _u8(card, *shape, seed=0, high=256):
    g = torch.Generator(device=card)
    g.manual_seed(seed)
    return torch.randint(0, high, shape, generator=g, device=card,
                         dtype=torch.uint8)


@pytest.mark.parametrize("d", [96, 128])
@pytest.mark.parametrize("l", [1, 10, 100, 256])
@pytest.mark.parametrize("B", [1, 32, 33, 64, 128])
def test_distance_topk_u8_kernel(card, B, l, d):
    """The uint8 step equals its plain version bit for bit (exact integer
    distances, ties to the smaller id) at every tile the plan takes, one
    distance_topk_u8 launch a call and no f32 kernel's."""
    k, m = 8, 20000
    q, p = _u8(card, B, d), _u8(card, k, m, d, seed=1)
    before = (dtk.COUNT.n, dtk.COUNT_U8.n, dtk.COUNT_WIDE.n)
    v, i = ops.distance_topk(q, p, l)
    torch.cuda.synchronize()
    assert (dtk.COUNT.n, dtk.COUNT_U8.n, dtk.COUNT_WIDE.n) == (
        before[0] + 1, before[1] + 1, before[2])
    rv, ri = dtk.distance_topk_u8_plain(q, p, l)
    assert torch.equal(v, rv) and torch.equal(i, ri)
    assert plan.topk_u8(B, d, l, m, ltk.sm_count(0)).tile == (
        64 if B <= 64 else 128)


@pytest.mark.parametrize("case", ["ties", "masked", "none", "d100", "d16",
                                  "small_m", "d258", "rows200"])
def test_distance_topk_u8_kernel_edges(card, case):
    """Ties (values in {0, 1, 2}: many equal distances, ids ascending),
    masks, rows no multiple of 16 bytes, l > m, the widest exact d and a
    bucket of two row tiles, each equal to the plain version."""
    B, k, m, d, l, high = 128, 8, 4099, 128, 10, 256
    valid = None
    if case == "ties":
        high, l = 3, 100
    elif case == "masked":
        valid = _randn(card, k, m, seed=3) > 0.3
    elif case == "none":
        valid = torch.zeros((k, m), dtype=torch.bool, device=card)
    elif case == "d100":
        B, d = 64, 100
    elif case == "d16":
        B, d = 33, 16
    elif case == "small_m":
        B, k, m, l = 5, 2, 96, 256
    elif case == "d258":
        d = 258
    elif case == "rows200":
        B = 200
    q, p = _u8(card, B, d, high=high), _u8(card, k, m, d, seed=1, high=high)
    v, i = ops.distance_topk(q, p, l, valid=valid)
    rv, ri = dtk.distance_topk_u8_plain(q, p, l, valid=valid)
    assert torch.equal(v, rv) and torch.equal(i, ri)
    if case == "ties":
        same = v[..., 1:] == v[..., :-1]
        assert bool(same.any())
        assert not bool((same & (i[..., 1:] < i[..., :-1])).any())
    if case == "none":
        assert bool((i == INT32_MAX).all())


def test_distance_topk_u8_refuses_what_it_cannot_hold_exactly(card):
    q, p = _u8(card, 4, 259), _u8(card, 2, 1000, 259)
    with pytest.raises(ValueError, match="258"):
        ops.distance_topk(q, p, 10)
    with pytest.raises(TypeError, match="uint8 queries"):
        dtk.distance_topk_cuda(q.float(), p, 10)


def test_distance_topk_u8_shard_above_2gb(card):
    """A shard of more than 2^31 bytes: points planted past the 2 GiB
    mark are found, and the answer equals the plain version's top-l over
    the shard taken in chunks."""
    B, m, d, l = 8, (1 << 31) // 128 + 50000, 128, 10
    q = _u8(card, B, d)
    p = _u8(card, 1, m, d, seed=5)
    p[0, m - B:] = q                  # each query's own point, distance 0
    v, i = ops.distance_topk(q, p, l)
    assert bool((v[0, :, 0] == 0).all())
    assert torch.equal(i[0, :, 0].long(),
                       torch.arange(m - B, m, device=card))
    vs, ids = [], []
    step = 1 << 22
    for r0 in range(0, m, step):
        cv, ci = dtk.distance_topk_u8_plain(q, p[:, r0:r0 + step], l)
        vs.append(cv)
        ids.append(ci.long() + r0)
    cv, ci = torch.cat(vs, -1), torch.cat(ids, -1)
    o = torch.argsort(ci, dim=-1, stable=True)
    cv, ci = cv.gather(-1, o), ci.gather(-1, o)
    o = torch.argsort(cv, dim=-1, stable=True)[..., :l]
    assert torch.equal(v, cv.gather(-1, o))
    assert torch.equal(i.long(), ci.gather(-1, o))


def test_u8_server_on_the_card_matches_the_cpu(card):
    """A KnnServer over uint8 points keeps them as uint8 on the card and
    answers as the CPU server does, id for id; one distance_topk_u8
    launch a batch."""
    import dataclasses

    rng = np.random.default_rng(11)
    pts = rng.integers(0, 256, (8 * 5000, 128), dtype=np.uint8)
    qs = rng.integers(0, 256, (128, 128), dtype=np.uint8)
    ls = rng.integers(1, 11, 128)
    cfg = dataclasses.replace(CONFIG, dim=128, l=10, l_max=10,
                              bucket_sizes=(1, 4, 32, 128))
    out = {}
    for dev in ("cpu", card):
        srv = KnnServer(pts, cfg=cfg, device=dev, seed=3)
        assert srv._points.dtype == torch.uint8
        n0 = dtk.COUNT_U8.n
        out[str(dev)] = srv.query_batch(qs, ls)
        if dev == card:
            assert dtk.COUNT_U8.n == n0 + 1
            env = srv.envelopes[-1]
            assert env["points_dtype"] == "uint8"
            assert env["dtk_path"] == plan.DISTANCE_TOPK_U8
            assert env["dtk_tile"] == 128
        srv.close()
    for a, b in zip(out["cpu"], out[str(card)]):
        assert np.array_equal(a.ids, b.ids)
        assert np.array_equal(a.dists, b.dists)
