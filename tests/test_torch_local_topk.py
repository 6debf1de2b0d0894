"""The local_topk kernel's host side on the CPU: the plain merge with
carried ids against the JAX package, and the launch plan that cuts rows
into whole-wave items.

``merge_partials_plain`` is held against ``_merge_tile`` of
``repro.kernels.distance_topk`` folded over the chunks, on seeded numpy
partials with +inf sentinel slots, ``2**31-1`` ids and equal values under
different ids (finite slots carry unique ids, as distance_topk's do).
The tolerance is exact: values and ids are equal.  ``plan`` is checked
for its invariants, and a model of the kernel's item and slot layout
(each row segment's top-l written at its slot, the rest sentinels) run
through the merge must give the plain top-l.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.distance_topk import _merge_tile
from repro_torch.kernels import local_topk as ltk

# the cases are small: one intra-op thread a process is faster here than
# a pool, and leaves the cores to the other test processes
torch.set_num_threads(1)

INT32_MAX = 2**31 - 1


def _partials(rng, rows, chunks, w, inf_share=0.4):
    """(rows, chunks, w) partials: rounded values (many equal), unique
    ids for finite slots, (+inf, INT32_MAX) sentinels elsewhere."""
    v = np.round(rng.normal(size=(rows, chunks, w)), 1).astype(np.float32)
    ids = np.stack([rng.permutation(10 * chunks * w)[:chunks * w]
                    for _ in range(rows)]).reshape(rows, chunks, w)
    dead = rng.random((rows, chunks, w)) < inf_share
    v[dead] = np.inf
    ids = np.where(dead, INT32_MAX, ids).astype(np.int32)
    return v, ids


def _jax_fold(v, ids, l):
    rows = v.shape[0]
    top_v = jnp.full((rows, l), jnp.inf, jnp.float32)
    top_i = jnp.full((rows, l), INT32_MAX, jnp.int32)
    for c in range(v.shape[1]):
        top_v, top_i = _merge_tile(jnp.asarray(v[:, c]), jnp.asarray(ids[:, c]),
                                   top_v, top_i, l)
    return np.asarray(top_v), np.asarray(top_i)


@pytest.mark.parametrize("rows,chunks,w", [(4, 5, 16), (3, 8, 32),
                                           (2, 3, 16), (5, 1, 64)])
@pytest.mark.parametrize("l", [1, 8, 16, 100])
def test_merge_partials_plain_matches_jax(rng, rows, chunks, w, l):
    v, ids = _partials(rng, rows, chunks, w)
    want_v, want_i = _jax_fold(v, ids, l)
    got_v, got_i = ltk.merge_partials_plain(torch.from_numpy(v),
                                            torch.from_numpy(ids), l)
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    # the CPU tensors' dispatch takes the plain version, launching nothing
    before = ltk.COUNT.n
    mv, mi = ltk.merge_partials(torch.from_numpy(v), torch.from_numpy(ids), l)
    assert ltk.COUNT.n == before
    assert torch.equal(mv, got_v) and torch.equal(mi, got_i)


def test_merge_partials_plain_all_sentinels(rng):
    v, ids = _partials(rng, 3, 4, 16, inf_share=1.0)
    got_v, got_i = ltk.merge_partials_plain(torch.from_numpy(v),
                                            torch.from_numpy(ids), 8)
    assert torch.isinf(got_v).all() and (got_i == INT32_MAX).all()
    want_v, want_i = _jax_fold(v, ids, 8)
    np.testing.assert_array_equal(got_i.numpy(), want_i)


CASES = [  # rows, m, slots
    (256, 524288, 1056), (256, 524288, 528), (256, 67584, 1056),
    (256, 65536, 792), (7, 100003, 132), (1, 16384, 1056),
    (3, 20000, 8), (256, 768, 1056), (32, 1024, 1056), (2000, 30000, 1056),
    (5, 1000, 1056)]


@pytest.mark.parametrize("rows,m,slots", CASES)
def test_plan_is_whole_waves_of_equal_items(rows, m, slots):
    per, nparts, grid = ltk.plan(rows, m, slots)
    total = rows * m
    assert 1 <= grid <= slots
    if per == m:                              # rows are the items
        assert nparts == 1 and grid == min(rows, slots)
        assert rows >= slots or m < ltk.SPLIT_MIN
        return
    assert per % 8 == 0 and per >= ltk.MIN_SHARE
    assert (grid - 1) * per < total <= grid * per       # one item a block
    if total >= slots * ltk.MIN_SHARE + 8 * slots:
        assert grid == slots                            # a full wave
    spans = [(r * m + m - 1) // per - (r * m) // per + 1 for r in range(rows)]
    assert nparts == max(spans)


@pytest.mark.parametrize("rows,m,slots", CASES)
def test_merge_launches_end_at_one_partial(rows, m, slots):
    n = len(ltk.merge_plans(rows, m, 128, slots))
    assert 1 <= n <= 3
    if ltk.plan(rows, m, slots)[1] == 1:
        assert n == 1


@pytest.mark.parametrize("width", [0, 100, 65536])
def test_merge_of_no_rows_is_one_empty_launch(width):
    assert ltk.merge_plans(0, width, 128, 1056) == [(width, 1, 0)]


def _kernel_layout(x, l, slots):
    """What one launch writes, by plan: the top-l of every row segment of
    every item at slot item - (row * m) // per, sentinels elsewhere."""
    rows, m = x.shape
    per, nparts, _ = ltk.plan(rows, m, slots)
    pv = torch.full((rows, nparts, l), float("inf"))
    pi = torch.full((rows, nparts, l), INT32_MAX, dtype=torch.int32)
    flat = x.reshape(-1)
    for item in range(-(-rows * m // per)):
        s, e = item * per, min(item * per + per, rows * m)
        while s < e:
            r, c0 = divmod(s, m)
            c1 = min(m, c0 + e - s)
            v, i = ltk.local_topk_plain(flat[r * m + c0:r * m + c1][None], l)
            i = torch.where(i < INT32_MAX, i + c0, i)
            pv[r, item - (r * m) // per], pi[r, item - (r * m) // per] = v, i
            s += c1 - c0
    return pv, pi


@pytest.mark.parametrize("rows,m,slots,l", [(3, 20000, 8, 16),
                                            (2, 33333, 4, 128),
                                            (5, 17000, 16, 1),
                                            (4, 1000, 8, 256)])
def test_item_layout_merges_to_the_top_l(rng, rows, m, slots, l):
    x = torch.from_numpy(np.round(rng.normal(size=(rows, m)), 2)
                         .astype(np.float32))
    pv, pi = _kernel_layout(x, l, slots)
    v, i = ltk.merge_partials_plain(pv, pi, l)
    rv, ri = ltk.local_topk_plain(x, l)
    assert torch.equal(v, rv) and torch.equal(i, ri)
