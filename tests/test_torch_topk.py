"""The port's distributed top-k sampler against the JAX reference.

``repro.core.topk`` runs under shard_map over the 8-device CPU mesh
(``mesh8``), the vocabulary split over the mesh axis; the port holds the
same split as ``(8, B, V/8)`` (``core.topk.shard_vocab``).  Values and
ids must be equal, in order.  Ties go to the smaller vocabulary id.
Signed zeros: ``lax.top_k`` orders +0.0 above -0.0, the port (like the
card's local_topk, which folds -0.0 to +0.0) takes them as one value,
ties to the smaller id; that case is held to a numpy stable-sort oracle.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import repro.core as jcore
from repro.parallel.compat import shard_map
from repro_torch.core import topk as ttopk

torch.set_num_threads(1)

K = 8


def _jax_topk(mesh, logits, k, method, key=0, num_pivots=1):
    def fn(lg, kk):
        r = jcore.distributed_topk(lg, k, kk, axis_name="x", method=method,
                                   num_pivots=num_pivots)
        return r.values, r.indices, r.iterations

    f = jax.jit(shard_map(
        fn, mesh=mesh, in_specs=(P(None, "x"), P(None)),
        out_specs=(P(None), P(None), P())))
    v, i, it = f(logits, jax.random.PRNGKey(key))
    return np.asarray(v), np.asarray(i), int(it)


def _port_topk(logits, k, method, seed=0, num_pivots=1, shards=K):
    t = ttopk.shard_vocab(torch.from_numpy(logits), shards)
    r = ttopk.distributed_topk(t, k, ttopk.generator(seed, "cpu"),
                               method=method, num_pivots=num_pivots)
    return r.values.numpy(), r.indices.numpy(), r


def _oracle(logits, k):
    """Stable descending order: equal values (and both zeros) in id
    order."""
    idx = np.argsort(-logits.astype(np.float64), axis=-1, kind="stable")
    idx = idx[:, :k]
    return np.take_along_axis(logits, idx, -1), idx.astype(np.int32)


@pytest.mark.parametrize("method", ["selection", "gather"])
@pytest.mark.parametrize("k", [1, 13, 64])
def test_topk_equals_reference(mesh8, rng, method, k):
    V = K * 512
    logits = rng.normal(size=(3, V)).astype(np.float32)
    jv, ji, _ = _jax_topk(mesh8, logits, k, method)
    tv, ti, res = _port_topk(logits, k, method)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(ti, ji)
    ov, oi = _oracle(logits, k)
    np.testing.assert_array_equal(tv, ov)
    np.testing.assert_array_equal(ti, oi)
    if method == "gather":
        assert res.iterations == 0
    else:
        # Theorem-1 envelope of the selection over k * k candidates
        assert 0 < res.iterations <= 8 * int(np.ceil(np.log2(K * k + 1))) + 16
        assert res.host_syncs == res.iterations + 1


@pytest.mark.parametrize("method", ["selection", "gather"])
def test_topk_ties(mesh8, rng, method):
    """Logits on a coarse grid: most values are tied, across shards and
    within one; every method puts equal values in id order."""
    V = K * 256
    logits = np.round(rng.normal(size=(4, V)) * 2).astype(np.float32) / 2
    jv, ji, _ = _jax_topk(mesh8, logits, 40, method)
    tv, ti, _ = _port_topk(logits, 40, method)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(ti, ji)
    ov, oi = _oracle(logits, 40)
    np.testing.assert_array_equal(ti, oi)
    np.testing.assert_array_equal(tv, ov)


@pytest.mark.parametrize("method", ["selection", "gather"])
def test_topk_signed_zeros(rng, method):
    """Rows whose top values are +0.0 and -0.0 mixed: one value, ties to
    the smaller id."""
    V = K * 64
    logits = -np.abs(rng.normal(size=(3, V))).astype(np.float32)
    z = rng.random((3, V)) < 0.2
    logits[z] = np.where(rng.random(z.sum()) < 0.5, 0.0, -0.0)
    tv, ti, _ = _port_topk(logits, 30, method)
    ov, oi = _oracle(logits, 30)
    np.testing.assert_array_equal(ti, oi)
    np.testing.assert_array_equal(tv, ov)


@pytest.mark.parametrize("method", ["selection", "gather"])
@pytest.mark.parametrize("V,shards", [(1001, 8), (256 * 8 + 3, 8),
                                      (37, 4)])
def test_topk_padded_vocab(mesh8, rng, method, V, shards):
    """A vocabulary k does not divide: -inf padding never wins, also when
    the top-k reaches into the last (partly padded) shard."""
    logits = rng.normal(size=(5, V)).astype(np.float32)
    logits[:, -3:] += 10.0          # winners in the padded shard
    k = min(50, V)
    tv, ti, _ = _port_topk(logits, k, method, shards=shards)
    ov, oi = _oracle(logits, k)
    np.testing.assert_array_equal(tv, ov)
    np.testing.assert_array_equal(ti, oi)
    assert (ti < V).all()
    if shards == K:
        # the reference, padded the way serve_step pads it
        pad = (-V) % K
        padded = np.concatenate(
            [logits, np.full((5, pad), -np.inf, np.float32)], 1)
        jv, ji, _ = _jax_topk(mesh8, padded, k, method)
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(ti, ji)


def test_topk_methods_agree_with_pivots(rng):
    V = K * 256
    logits = rng.normal(size=(2, V)).astype(np.float32)
    v1, i1, r1 = _port_topk(logits, 32, "selection", num_pivots=2)
    v2, i2, _ = _port_topk(logits, 32, "gather")
    np.testing.assert_array_equal(v1, v2)
    np.testing.assert_array_equal(i1, i2)
    assert r1.iterations > 0


def test_greedy_sample(mesh8, rng):
    V = K * 64
    logits = rng.normal(size=(5, V)).astype(np.float32)
    logits[1, [7, 300]] = 9.0       # a tie across shards: the smaller id
    logits[2, [70, 71]] = 9.0       # a tie inside one shard

    def fn(lg):
        return jcore.greedy_sample(lg, axis_name="x")

    f = jax.jit(shard_map(fn, mesh=mesh8, in_specs=P(None, "x"),
                          out_specs=P(None)))
    want = np.asarray(f(logits))
    got = ttopk.greedy_sample(
        ttopk.shard_vocab(torch.from_numpy(logits), K)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.argmax(logits, -1))


@pytest.mark.parametrize("method", ["selection", "gather"])
def test_topk_sample_within_topk(rng, method):
    V = K * 128
    logits = rng.normal(size=(8, V)).astype(np.float32)
    t = ttopk.shard_vocab(torch.from_numpy(logits), K)
    for s in range(5):
        toks = ttopk.topk_sample(t, 8, 1.0, s, method=method).numpy()
        for b in range(8):
            top8 = set(np.argsort(-logits[b])[:8].tolist())
            assert int(toks[b]) in top8


def test_topk_sample_methods_agree_and_replay(rng):
    """One seed: selection and gather draw the same tokens (the
    categorical has its own generator), and a seed replays."""
    V = K * 256
    logits = rng.normal(size=(6, V)).astype(np.float32)
    t = ttopk.shard_vocab(torch.from_numpy(logits), K)
    draws = set()
    for s in range(8):
        a = ttopk.topk_sample(t, 16, 0.7, s, method="selection")
        b = ttopk.topk_sample(t, 16, 0.7, s, method="gather")
        c = ttopk.topk_sample(t, 16, 0.7, s, method="selection",
                              num_pivots=3)
        np.testing.assert_array_equal(a.numpy(), b.numpy())
        np.testing.assert_array_equal(a.numpy(), c.numpy())
        draws.add(tuple(a.tolist()))
    assert len(draws) > 1            # the seed moves the draw


def test_categorical_follows_the_softmax():
    """The Gumbel-max draw's frequencies follow softmax(logits)."""
    logits = torch.tensor([[0.0, 1.0, 2.0, -1.0]]).expand(20000, 4)
    g = ttopk.generator(ttopk.fold_in(3, 1), "cpu")
    draws = ttopk.categorical(g, logits).numpy()
    freq = np.bincount(draws, minlength=4) / draws.size
    want = torch.softmax(logits[0], 0).numpy()
    np.testing.assert_allclose(freq, want, atol=0.015)


def test_fold_in_is_a_function_of_both_arguments():
    seeds = {ttopk.fold_in(s, d) for s in range(20) for d in range(20)}
    assert len(seeds) == 400
    assert all(0 <= x < 2**63 for x in seeds)
    assert ttopk.fold_in(5, 1) == ttopk.fold_in(5, 1)
