"""The port's kernel layer on the CPU against the JAX reference.

``repro_torch.kernels.ref`` and the plain versions of the three ported
kernels (reached through ``repro_torch.kernels.ops`` with CPU tensors)
against ``repro.kernels.ops`` (Pallas in interpret mode, as
tests/conftest.py sets it) and ``repro.kernels.ref``, on the shapes of
tests/test_kernels.py.  Same inputs, made with numpy from a seed.
Tolerances are those of tests/test_kernels.py: f32 rtol 1e-4 / atol
1e-3, bf16 rtol 2e-2 / atol 1.0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import distance_topk as tdtk
from repro_torch.kernels import l2_distance as tl2
from repro_torch.kernels import ops as tops
from repro_torch.kernels import plan
from repro_torch.kernels import ref as tref
from repro_torch.kernels import select_loop as tsl
from repro_torch.kernels.local_topk import local_topk_plain

# the cases are small: one intra-op thread a process is faster here than
# a pool, and leaves the cores to the other test processes
torch.set_num_threads(1)

SHAPES = [  # (B, d, m)
    (8, 128, 256),
    (16, 256, 512),
    (1, 512, 1024),
    (13, 300, 777),     # padding path
    (4, 64, 96),        # padding path
]
INT32_MAX = 2**31 - 1


def _tol(bf16):
    return dict(rtol=2e-2, atol=1.0) if bf16 else dict(rtol=1e-4, atol=1e-3)


def _inputs(rng, B, d, m, bf16=False):
    """numpy f32 inputs (bf16-representable when ``bf16``), plus the JAX
    and torch views of them in the working dtype."""
    q = rng.normal(size=(B, d)).astype(np.float32)
    p = rng.normal(size=(m, d)).astype(np.float32)
    if bf16:
        q = np.array(jnp.asarray(q, jnp.bfloat16).astype(jnp.float32))
        p = np.array(jnp.asarray(p, jnp.bfloat16).astype(jnp.float32))
        jq, jp = jnp.asarray(q, jnp.bfloat16), jnp.asarray(p, jnp.bfloat16)
        tq = torch.from_numpy(q).to(torch.bfloat16)
        tp = torch.from_numpy(p).to(torch.bfloat16)
    else:
        jq, jp = q, p
        tq, tp = torch.from_numpy(q), torch.from_numpy(p)
    return jq, jp, tq, tp


def _rows_as_sets(a):
    return [set(r.tolist()) for r in np.asarray(a)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bf16", [False, True])
def test_l2_distance_matches_jax(rng, shape, bf16):
    B, d, m = shape
    jq, jp, tq, tp = _inputs(rng, B, d, m, bf16)
    want = np.asarray(jops.l2_distance(jq, jp))
    np.testing.assert_allclose(tops.l2_distance(tq, tp).numpy(), want,
                               **_tol(bf16))
    np.testing.assert_allclose(tref.l2_distance_ref(tq, tp).numpy(),
                               np.asarray(jref.l2_distance_ref(jq, jp)),
                               **_tol(bf16))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("l", [1, 16, 100])
def test_distance_topk_matches_jax(rng, shape, l):
    B, d, m = shape
    l = min(l, m)
    jq, jp, tq, tp = _inputs(rng, B, d, m)
    jv, ji = jops.distance_topk(jq, jp, l)
    tv, ti = tops.distance_topk(tq, tp, l)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **_tol(False))
    assert _rows_as_sets(ti) == _rows_as_sets(ji)
    rv, ri = tref.distance_topk_ref(tq, tp, l)
    np.testing.assert_allclose(rv.numpy(), np.asarray(jv), **_tol(False))
    assert _rows_as_sets(ri) == _rows_as_sets(ji)


@pytest.mark.parametrize("shape", SHAPES)
def test_distance_topk_bf16_values(rng, shape):
    """bf16 inputs are upcast at load; values within the bf16 tolerance
    (id sets are only well defined without bf16 ties)."""
    B, d, m = shape
    jq, jp, tq, tp = _inputs(rng, B, d, m, bf16=True)
    jv, _ = jref.distance_topk_ref(jq, jp, 16)
    tv, _ = tops.distance_topk(tq, tp, 16)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **_tol(True))


@pytest.mark.parametrize("shape", [(8, 512), (5, 1000), (16, 4096)])
@pytest.mark.parametrize("l", [1, 7, 128])
def test_local_topk_matches_jax(rng, shape, l):
    x = rng.normal(size=shape).astype(np.float32)
    jv, ji = jops.local_topk(x, l)
    tv, ti = tops.local_topk(torch.from_numpy(x), l)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    rv, ri = tref.local_topk_ref(torch.from_numpy(x), l)
    np.testing.assert_array_equal(ri.numpy(), np.asarray(ji))


@pytest.mark.parametrize("l", [255, 256])
def test_topk_seam(rng, l):
    """The card's kernels take l <= 256: both sides of the seam agree."""
    B, d, m = 4, 32, 512
    jq, jp, tq, tp = _inputs(rng, B, d, m)
    jv, ji = jops.distance_topk(jq, jp, l)
    tv, ti = tops.distance_topk(tq, tp, l)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **_tol(False))
    assert _rows_as_sets(ti) == _rows_as_sets(ji)
    x = rng.normal(size=(3, 700)).astype(np.float32)
    jv, ji = jops.local_topk(x, l)
    tv, ti = tops.local_topk(torch.from_numpy(x), l)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_duplicate_values_stable(rng):
    """Tie-break parity with lax.top_k: equal values, smaller index first."""
    x = np.round(rng.normal(size=(4, 512)), 1).astype(np.float32)
    jv, ji = jops.local_topk(x, 32)
    tv, ti = tops.local_topk(torch.from_numpy(x), 32)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_distance_topk_exact_ties(rng):
    """Integer coordinates make every distance exact, so ties are exact
    in both frameworks: the ids must then match one for one."""
    q = rng.integers(-2, 3, size=(6, 4)).astype(np.float32)
    p = rng.integers(-2, 3, size=(300, 4)).astype(np.float32)
    jv, ji = jops.distance_topk(q, p, 40)
    tv, ti = tops.distance_topk(torch.from_numpy(q), torch.from_numpy(p), 40)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_local_topk_pads_when_l_exceeds_m(rng):
    """l > m: the missing slots are (+inf, INT32_MAX), as the reference
    dispatcher's padded kernel returns them."""
    x = rng.normal(size=(3, 100)).astype(np.float32)
    jv, ji = jops.local_topk(x, 128)
    tv, ti = tops.local_topk(torch.from_numpy(x), 128)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("shape", [(8, 128, 256), (13, 300, 777)])
@pytest.mark.parametrize("l", [1, 16])
def test_masked_distance_topk_matches_jax(rng, shape, l):
    B, d, m = shape
    jq, jp, tq, tp = _inputs(rng, B, d, m)
    valid = rng.random(m) > 0.4
    jv, ji = jops.distance_topk(jq, jp, l, valid=valid)
    tv, ti = tops.distance_topk(tq, tp, l, valid=torch.from_numpy(valid))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **_tol(False))
    assert _rows_as_sets(ti) == _rows_as_sets(ji)
    dead = set(np.flatnonzero(~valid).tolist())
    assert not any(r & dead for r in _rows_as_sets(ti))
    rv, ri = tref.masked_distance_topk_ref(tq, tp, torch.from_numpy(valid),
                                           l)
    np.testing.assert_array_equal(ri.numpy(), ti.numpy())


def test_masked_distance_topk_all_invalid(rng):
    """Fully masked shard: all +inf distances, all sentinel ids."""
    _, _, tq, tp = _inputs(rng, 4, 64, 256)
    v, i = tops.distance_topk(tq, tp, 8, valid=torch.zeros(256,
                                                           dtype=torch.bool))
    assert torch.isinf(v).all()
    assert (i == INT32_MAX).all()


def test_masked_l2_distance_matches_jax(rng):
    jq, jp, tq, tp = _inputs(rng, 8, 128, 256)
    valid = rng.random(256) > 0.5
    want = np.asarray(jops.l2_distance(jq, jp, valid=valid))
    got = tops.l2_distance(tq, tp, valid=torch.from_numpy(valid)).numpy()
    np.testing.assert_allclose(got, want, **_tol(False))
    assert np.all(np.isinf(got[:, ~valid]))
    np.testing.assert_allclose(
        tref.masked_l2_distance_ref(tq, tp, torch.from_numpy(valid)).numpy(),
        want, **_tol(False))


def test_shard_dimension_is_one_launch_of_k_problems(rng):
    """(k, m, d) points give the per-shard answers of (m, d) calls."""
    _, _, tq, tp = _inputs(rng, 5, 16, 8 * 64)
    p3 = tp.reshape(8, 64, 16)
    d3 = tops.l2_distance(tq, p3)
    v3, i3 = tops.distance_topk(tq, p3, 10)
    for s in range(8):
        torch.testing.assert_close(d3[s], tops.l2_distance(tq, p3[s]))
        v, i = tops.distance_topk(tq, p3[s], 10)
        torch.testing.assert_close(v3[s], v)
        assert torch.equal(i3[s], i)


def test_dispatch_is_by_device_only():
    """CPU tensors take the plain version and launch nothing; a device
    with no kernel raises instead of falling back."""
    x = torch.arange(16, dtype=torch.float32).flip(0).reshape(2, 8)
    before = tops.launch_counts()
    v, i = tops.local_topk(x, 3)
    assert tops.launch_counts() == before
    rv, ri = local_topk_plain(x, 3)
    assert torch.equal(v, rv) and torch.equal(i, ri)
    with pytest.raises(ValueError, match="no kernel"):
        tops.local_topk(torch.zeros(2, 8, device="meta"), 3)
    env = tops.service_envelope(32, 1024, 64, 128, k=8, device="cpu")
    assert env["path"] == "plain" and env["dtk_chunk"] is None


@pytest.mark.parametrize("B,tile,tiles", [
    (1, 32, 1), (8, 32, 1), (32, 32, 1),       # today's 32-row tile
    (33, 64, 1), (64, 64, 1),                  # one tile of 64
    (65, 128, 1), (100, 128, 1), (128, 128, 1),
    (129, 128, 2), (300, 128, 3), (512, 128, 4)])
def test_l2_distance_row_tile_follows_rows(B, tile, tiles):
    """l2_distance's row tile is a function of the bucket's rows alone."""
    got = {plan.l2(B, d, elem, 132).tile
           for d in (16, 96, 1024, 2048) for elem in (4, 2)}
    assert got == {tile} and -(-B // tile) == tiles


class _FakeLibrary:
    """The kernel library's l2_distance and distance_topk entry points,
    recorded."""

    def __init__(self):
        self.calls = []

    def knn_l2_distance(self, *args):
        self.calls.append(("loop32", args))
        return 0

    def knn_l2_distance_wide(self, *args):
        self.calls.append(("wide", args))
        return 0

    def knn_distance_topk(self, *args):
        self.calls.append(("topk32", args))
        return 0

    def knn_distance_topk_wide(self, *args):
        self.calls.append(("topk_wide", args))
        return 0

    def knn_select_loop(self, *args):
        self.calls.append(("select", args))
        return 0


@pytest.fixture
def fake_card(monkeypatch):
    """The wrapper on CPU tensors as if they were on the card: the
    library recorded, nothing launched."""
    lib = _FakeLibrary()
    monkeypatch.setattr(tl2._build, "library", lambda: lib)
    monkeypatch.setattr(tl2._cuda, "check_cuda", lambda *a: None)
    monkeypatch.setattr(tl2._cuda, "stream_of", lambda t: 0)
    monkeypatch.setattr(tl2._ltk, "sm_count", lambda index: 132)
    return lib


@pytest.mark.parametrize("B,entry,tile", [
    (8, "loop32", None), (32, "loop32", None), (33, "wide", 64),
    (64, "wide", 64), (128, "wide", 128), (300, "wide", 128)])
def test_l2_distance_launches_the_loop_of_its_rows(fake_card, B, entry,
                                                   tile):
    """B <= 32 calls the 32-row loop with its persistent blocks, B > 32
    the whole-bucket loop with its row tile; every call counts one
    l2_distance launch, the whole-bucket loop's one l2_distance_wide."""
    q, p = torch.zeros(B, 16), torch.zeros(2, 8, 16)
    before = (tl2.COUNT.n, tl2.COUNT_WIDE.n)
    assert tl2.l2_distance_cuda(q, p).shape == (2, B, 8)
    [(name, args)] = fake_card.calls
    assert name == entry and args[4:9] == (B, 2, 8, 16, 0)
    assert args[9] == (plan.L2_BLOCKS_PER_SM * 132 if tile is None
                       else tile)
    assert (tl2.COUNT.n - before[0], tl2.COUNT_WIDE.n - before[1]) == (
        1, int(entry == "wide"))


@pytest.mark.parametrize("B,accepted", [(128, True), (64, True),
                                        (8, False), (32, False)])
def test_l2_distance_shared_memory_check_by_path(fake_card, B, accepted):
    """At d = 2,048 the 32-row loop's resident query tile does not fit in
    shared memory (refused, as before); the whole-bucket loop's does not
    grow with d (accepted)."""
    d = 2048
    lp = plan.l2(B, d, 4, 132)
    assert (lp.smem <= plan.SMEM_MAX) == accepted == (not lp.unsupported)
    q, p = torch.zeros(B, d), torch.zeros(1, 4, d)
    if accepted:
        tl2.l2_distance_cuda(q, p)
        assert [c[0] for c in fake_card.calls] == ["wide"]
    else:
        with pytest.raises(ValueError, match="shared memory"):
            tl2.l2_distance_cuda(q, p)
        assert fake_card.calls == []


def test_envelope_names_the_l2_distance_tile(monkeypatch):
    """``service_envelope`` reports the row tile each bucket takes, the
    32-row loop's blocks only where it is taken; a width the 32-row loop
    cannot hold is unsupported only for the buckets that take it."""
    monkeypatch.setattr(tops._ltk, "sm_count", lambda index: 132)
    card = torch.device("cuda")
    got = {b: tops.service_envelope(b, 1 << 20, 1024, 1024, k=8,
                                    device=card)
           for b in (8, 32, 64, 128)}
    assert {b: e["l2_tile"] for b, e in got.items()} == {
        8: 32, 32: 32, 64: 64, 128: 128}
    assert got[8]["l2_blocks"] == plan.L2_BLOCKS_PER_SM * 132
    assert got[64]["l2_blocks"] is None and got[128]["l2_blocks"] is None
    assert all(e["unsupported"] is None for e in got.values())
    wide = tops.service_envelope(128, 1 << 20, 2048, 1024, k=8, device=card)
    narrow = tops.service_envelope(8, 1 << 20, 2048, 1024, k=8, device=card)
    assert wide["unsupported"] is None and wide["l2_tile"] == 128
    assert narrow["unsupported"] and narrow["l2_tile"] is None
    cpu = tops.service_envelope(128, 1 << 20, 1024, 1024, k=8, device="cpu")
    assert cpu["l2_tile"] is None


@pytest.mark.parametrize("B,d,l,elem,tile", [
    (1, 96, 100, 4, 32), (8, 896, 8, 4, 32), (32, 96, 256, 4, 32),
    (33, 96, 100, 4, 64), (64, 96, 1, 4, 64), (64, 128, 100, 2, 64),
    (65, 96, 100, 4, 128), (128, 96, 100, 4, 128), (128, 96, 256, 2, 128),
    (200, 100, 10, 4, 128), (128, 128, 100, 4, 128),
    (128, 512, 64, 4, 32), (64, 300, 100, 4, 32), (128, 896, 8, 4, 32)])
def test_distance_topk_row_tile_follows_shape(B, d, l, elem, tile):
    """distance_topk's row tile is a function of (B, d, l, dtype) alone:
    the 32-row kernel up to 32 rows and where the whole-bucket block does
    not fit at the width, else 64 up to 64 rows and 128 above."""
    tp = plan.topk(B, d, l, elem, 1 << 20, 132)
    assert tp.tile == tile
    fits = plan._wide_layout(64 if B <= 64 else 128, d, elem) is not None
    assert (tile > 32) == (B > 32 and fits) == tp.wide
    if tile > 32:
        assert tp.smem <= plan.WIDE_SMEM[tile]


@pytest.mark.parametrize("d,elem,groups", [(64, 4, 2), (96, 4, 2),
                                           (96, 2, 2), (128, 4, 3),
                                           (256, 4, 3)])
def test_distance_topk_wide_layout(d, elem, groups):
    """The 128-row block holds two whole point tiles where they leave at
    least 64 candidate keys a row (one barrier a tile), else three slabs;
    its shared memory does not depend on l."""
    one, most = (plan.topk(128, d, l, elem, 1 << 20, 132) for l in (1, 256))
    assert one.groups == most.groups == groups
    assert plan.WIDE_MIN_CAND[groups] <= one.cand <= plan.WIDE_MAX_CAND
    assert one.cand == most.cand and one.smem == most.smem


@pytest.mark.parametrize("B,entry,tile", [
    (8, "topk32", 32), (32, "topk32", 32), (33, "topk_wide", 64),
    (64, "topk_wide", 64), (128, "topk_wide", 128), (300, "topk_wide", 128)])
def test_distance_topk_launches_the_path_of_its_rows(fake_card, B, entry,
                                                     tile):
    """B <= 32 calls the 32-row kernel, B > 32 the whole-bucket entry with
    its row tile, ring groups and candidate keys; chunks follow the path.
    Every call counts one distance_topk launch, the whole-bucket path's
    one distance_topk_wide."""
    k, m, d, l = 2, 3000, 96, 10
    q, p = torch.zeros(B, d), torch.zeros(k, m, d)
    before = (tdtk.COUNT.n, tdtk.COUNT_WIDE.n)
    v, i = tdtk.distance_topk_cuda(q, p, l)
    assert v.shape == i.shape == (k, B, l)
    [(name, args)] = fake_card.calls
    tp = plan.topk(B, d, l, 4, m, 132)
    assert name == entry and args[6:13] == (B, k, m, d, l, tp.chunk, 0)
    if entry == "topk_wide":
        assert args[13:16] == (tile, tp.groups, tp.cand)
        assert tp.chunk % plan.WIDE_POINT_TILE == 0
    # two chunks: the whole-bucket partials hold l slots, the 32-row
    # kernel's its slots unmerged
    assert (tp.nchunks, tp.width) == (2, l if tp.wide else 128)
    assert (tdtk.COUNT.n - before[0], tdtk.COUNT_WIDE.n - before[1]) == (
        1, int(entry == "topk_wide"))


def test_distance_topk_chunking_follows_the_path():
    """One 128-row block an SM, two 64-row and two 32-row blocks: chunks
    x query tiles fill the card's SMs that many times over."""
    m = 15_625_000
    for B, tile, blocks in [(128, 128, 132), (64, 64, 264), (32, 32, 264),
                            (128, 32, 264), (256, 128, 132)]:
        tp = plan.topk(B, 96, 100, 4, m, 132, tile=tile)
        assert -(-m // tp.chunk) * -(-B // tile) == tp.blocks == blocks
    one = plan.topk(8, 96, 10, 4, 1000, 132)      # one chunk: the answer
    assert (one.nchunks, one.width) == (1, 10)


@pytest.mark.parametrize("B,d,l,accepted", [
    (128, 96, 256, True), (8, 96, 256, True), (128, 600, 256, False),
    (8, 600, 256, False), (128, 600, 8, True)])
def test_distance_topk_shared_memory_check_by_path(fake_card, B, d, l,
                                                   accepted):
    """The shared-memory check applies to the path launched: the
    whole-bucket block at B > 32 where it fits, else the 32-row kernel's
    query tile and slots, refused where they do not fit."""
    tp = plan.topk(B, d, l, 4, 100, 132)
    tile = tp.tile
    want = (plan._topk32_smem(d, l, 4) if tile == 32 else
            plan._wide_fixed_smem(tile, d, 4, tp.groups) + 8 * tile * tp.cand)
    assert tp.smem == want
    assert (want <= plan.SMEM_MAX) == accepted == (not tp.unsupported)
    q, p = torch.zeros(B, d), torch.zeros(1, 100, d)
    if accepted:
        tdtk.distance_topk_cuda(q, p, l)
        assert [c[0] for c in fake_card.calls] == [
            "topk32" if tile == 32 else "topk_wide"]
    else:
        with pytest.raises(ValueError, match="shared memory"):
            tdtk.distance_topk_cuda(q, p, l)
        assert fake_card.calls == []


def test_envelope_names_the_distance_topk_tile(monkeypatch):
    """``service_envelope`` reports the row tile distance_topk takes for
    each bucket and its blocks under that tile; a width whose whole-bucket
    block does not fit keeps the 32-row kernel; the CPU reports none."""
    monkeypatch.setattr(tops._ltk, "sm_count", lambda index: 132)
    card, m = torch.device("cuda"), 1 << 20
    got = {b: tops.service_envelope(b, m, 96, 100, k=8, device=card)
           for b in (8, 32, 64, 128)}
    assert {b: e["dtk_tile"] for b, e in got.items()} == {
        8: 32, 32: 32, 64: 64, 128: 128}
    for b, e in got.items():
        assert e["dtk_chunk"] == plan.topk(b, 96, 100, 4, m, 132).chunk
        assert e["dtk_blocks"] == (-(-m // e["dtk_chunk"])
                                   * -(-b // e["dtk_tile"]))
    assert got[128]["dtk_blocks"] <= 132 < got[8]["dtk_blocks"] <= 264
    wide_d = tops.service_envelope(128, m, 512, 64, k=8, device=card)
    assert wide_d["dtk_tile"] == 32 and wide_d["unsupported"] is None
    big_l = tops.service_envelope(128, m, 96, 1024, k=8, device=card)
    assert big_l["dtk_path"] == "l2+local_topk" and big_l["dtk_tile"] is None
    cpu = tops.service_envelope(128, m, 96, 100, k=8, device="cpu")
    assert cpu["dtk_tile"] is None


def test_envelope_names_the_select_path(monkeypatch):
    """``service_envelope``'s ``select_path``: the device loop on the
    card, at every l and bucket; the host loop on the CPU."""
    monkeypatch.setattr(tops._ltk, "sm_count", lambda index: 132)
    card, m = torch.device("cuda"), 1 << 20
    got = {tops.service_envelope(b, m, 96, l, k=8,
                                 device=card)["select_path"]
           for l in (10, 100, 1024, 4096) for b in (1, 32, 128)}
    assert got == {tops.DEVICE_LOOP}
    cpu = tops.service_envelope(128, m, 96, 100, k=8, device="cpu")
    assert cpu["select_path"] == tops.HOST_LOOP


@pytest.mark.parametrize("B,m,dtype,pivots,per_row,want", [
    (128, 100, torch.float32, 1, False, (128, 7, 1, 1, 0)),
    (5, 1024, torch.bfloat16, 1, True, (1024, 8, 1, 1, 1)),
    (5, 100, torch.float16, 4, True, (128, 7, 8, 1, 2)),
    (2, 8192, torch.float32, 1, False, (1024, 64, 1, 0, 0)),
    (0, 100, torch.float32, 1, False, (128, 7, 1, 1, 0))])
def test_select_loop_launch_args(fake_card, B, m, dtype, pivots, per_row,
                                 want):
    """The device loop's one launch: the grid's rows, k and m, the cap,
    the plan's threads and keys a thread, the pivots (k where num_pivots
    > 1), whether the keys sit in shared memory (a row of 65,536 keys
    does not), the key code; an int l travels as a scalar, a (B,) l as
    int32 rows on the device; an empty batch launches nothing."""
    v = torch.zeros(8, B, m, dtype=dtype)
    ids = torch.zeros(8, B, m, dtype=torch.int32)
    l = torch.arange(B, dtype=torch.int64) if per_row else 100
    before = tsl.COUNT.n
    out = tsl.select_loop_cuda(v, ids, l, torch.Generator(),
                               valid=torch.ones(8, 1, m, dtype=torch.bool),
                               max_iterations=70, num_pivots=pivots)
    assert [(t.shape, t.dtype) for t in out] == [
        ((B,), dtype), ((B,), torch.int32), ((B,), torch.bool),
        ((B,), torch.int32)]
    if B == 0:
        assert fake_card.calls == [] and tsl.COUNT.n == before
        return
    [(name, args)] = fake_card.calls
    assert name == "select" and tsl.COUNT.n == before + 1
    assert args[10:14] == (B, 8, m, 70) and args[14:19] == want
    assert args[2] is not None and (args[3] is None) != per_row
    assert args[4] == (0 if per_row else 100)


def test_select_loop_refuses_what_no_block_holds(fake_card):
    """A row whose in-range bits pass a block's shared memory, f64 keys
    or int64 ids raise; nothing is launched."""
    with pytest.raises(ValueError, match="shared memory"):
        tsl.select_loop_cuda(torch.zeros(1, 1, 1835009),
                             torch.zeros(1, 1, 1835009, dtype=torch.int32),
                             10, torch.Generator(), max_iterations=8)
    with pytest.raises(TypeError, match="float16"):
        tsl.select_loop_cuda(torch.zeros(8, 2, 100, dtype=torch.float64),
                             torch.zeros(8, 2, 100, dtype=torch.int32), 10,
                             torch.Generator(), max_iterations=8)
    with pytest.raises(ValueError, match="int32"):
        tsl.select_loop_cuda(torch.zeros(8, 2, 100),
                             torch.zeros(8, 2, 100, dtype=torch.int64), 10,
                             torch.Generator(), max_iterations=8)
    assert fake_card.calls == []


def test_select_takes_the_path_of_the_device(fake_card, monkeypatch):
    """``select_l_smallest``: keys on the card take the device loop, one
    launch, with no sync and per-row counts, num_pivots > 1 too (k
    pivots); CPU keys take the unchanged host loop, which launches
    nothing and counts its done checks, the batch's iterations its
    largest row's."""
    from repro_torch.core import selection
    v = torch.rand(8, 4, 100)
    ids = torch.arange(3200, dtype=torch.int32).view(8, 4, 100)
    before = tsl.COUNT.n
    cpu = selection.select_l_smallest(v, ids, 10, torch.Generator())
    host = selection.host_loop(v, ids, 10, torch.Generator(),
                               max_iterations=selection.iteration_cap(800))
    assert tsl.COUNT.n == before and fake_card.calls == []
    assert tops.select_path(v) == tops.HOST_LOOP
    for a, b in zip(cpu, host):
        assert a == b if isinstance(a, int) else torch.equal(a, b)
    assert cpu.host_syncs == cpu.iterations + 1
    assert cpu.iterations == int(cpu.row_iterations.max()) > 0
    monkeypatch.setattr(tops, "_path", lambda entry, t: "cuda")
    assert tops.select_path(v) == tops.DEVICE_LOOP
    res = selection.select_l_smallest(v, ids, 10, torch.Generator())
    multi = selection.select_l_smallest(v, ids, 10, torch.Generator(),
                                        num_pivots=4)
    assert [c[0] for c in fake_card.calls] == ["select", "select"]
    assert tsl.COUNT.n == before + 2
    assert fake_card.calls[0][1][13] == selection.iteration_cap(800)
    assert [c[1][16] for c in fake_card.calls] == [1, 8]
    for r in (res, multi):
        assert r.host_syncs == 0 and r.row_iterations.shape == (4,)
