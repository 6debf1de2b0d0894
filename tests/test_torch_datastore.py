"""The port's kNN-LM datastore against the JAX reference.

``repro.core.datastore`` runs under shard_map over the 8-device CPU mesh
(``mesh8``), keys and values split over the mesh axis and the LM logits
over the vocabulary; the port holds the same splits as leading shard
dimensions.  Retrieval is exact, so the winners' tokens, weights and
distances must agree (distances and weights within f32 tolerance), and
the mixed log-distribution within rtol 1e-5, atol 1e-6, duplicate tokens
among the winners included (their weights add).
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import repro.core as jcore
from repro.parallel.compat import shard_map
from repro_torch.core import datastore as tds
from repro_torch.core import topk as ttopk

torch.set_num_threads(1)

K = 8


def _jax_retrieve(mesh, keys, values, h, lm_logits, l, lam, temp):
    def fn(kk, vv, hh, lml, key):
        store = jcore.datastore.build_local(kk, vv, axis_name="x")
        ret = jcore.datastore.retrieve(store, hh, l, key, axis_name="x",
                                       temperature=temp)
        out = jcore.datastore.interp_logits(lml, ret, lam, axis_name="x")
        return ret.tokens, ret.weights, ret.dists, out

    f = jax.jit(shard_map(
        fn, mesh=mesh,
        in_specs=(P("x"), P("x"), P(None), P(None, "x"), P(None)),
        out_specs=(P(None), P(None), P(None), P(None, "x"))))
    return [np.asarray(x) for x in f(keys, values, h, lm_logits,
                                     jax.random.PRNGKey(0))]


def _port_retrieve(keys, values, h, lm_logits, l, lam, temp, seed=0):
    k = K
    store = tds.build_local(
        torch.from_numpy(keys).reshape(k, -1, keys.shape[1]),
        torch.from_numpy(values).reshape(k, -1))
    ret = tds.retrieve(store, torch.from_numpy(h), l,
                       ttopk.generator(seed, "cpu"), temperature=temp)
    mixed = tds.interp_logits(
        ttopk.shard_vocab(torch.from_numpy(lm_logits), k), ret, lam)
    B = h.shape[0]
    return ret, mixed.transpose(0, 1).reshape(B, -1).numpy()


def _oracle(keys, values, h, lm_logits, l, lam, temp, V):
    dfull = ((h[:, None, :].astype(np.float64) - keys[None]) ** 2).sum(-1)
    out = []
    for b in range(h.shape[0]):
        nn = np.argsort(dfull[b], kind="stable")[:l]
        wt = np.exp(-(dfull[b][nn] - dfull[b][nn].min()) / temp)
        wt /= wt.sum()
        pk = np.zeros(V)
        np.add.at(pk, values[nn], wt)
        pl = np.exp(lm_logits[b].astype(np.float64) - lm_logits[b].max())
        pl /= pl.sum()
        out.append(np.log(np.maximum((1 - lam) * pl + lam * pk, 1e-30)))
    return np.stack(out)


@pytest.mark.parametrize("n_tokens", [K * 128, 5])
def test_retrieve_and_interp_equal_reference(mesh8, rng, n_tokens):
    """``n_tokens=5``: the winners' values repeat, and interp_logits must
    add their weights."""
    N, dm, V, B, l = K * 512, 16, K * 128, 3, 12
    keys = rng.normal(size=(N, dm)).astype(np.float32)
    values = rng.integers(0, n_tokens, size=(N,)).astype(np.int32)
    h = rng.normal(size=(B, dm)).astype(np.float32)
    lm_logits = rng.normal(size=(B, V)).astype(np.float32)
    lam, temp = 0.3, 10.0
    jt, jw, jd, jmixed = _jax_retrieve(mesh8, keys, values, h, lm_logits,
                                       l, lam, temp)
    ret, mixed = _port_retrieve(keys, values, h, lm_logits, l, lam, temp)
    np.testing.assert_array_equal(ret.tokens.numpy(), jt)
    np.testing.assert_allclose(ret.dists.numpy(), jd, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(ret.weights.numpy(), jw, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(mixed, jmixed, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        mixed, _oracle(keys, values, h, lm_logits, l, lam, temp, V),
        rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.exp(mixed).sum(-1), 1.0, rtol=1e-5)
    if n_tokens == 5:
        assert any(len(set(r)) < l for r in ret.tokens.tolist())
    assert 0 < ret.iterations


def test_interp_drops_out_of_range_tokens_and_adds_duplicates(rng):
    """Unfilled slots (id 2**31-1, weight 0) and tokens beyond the
    vocabulary drop; a token twice gets both weights."""
    B, V, shards = 2, 40, 4
    lm = torch.from_numpy(rng.normal(size=(B, V)).astype(np.float32))
    toks = torch.tensor([[3, 3, 39, 2**31 - 1], [10, 45, 0, 10]],
                        dtype=torch.int32)
    w = torch.tensor([[0.25, 0.25, 0.5, 0.0], [0.5, 0.2, 0.1, 0.2]])
    ret = tds.RetrievalResult(tokens=toks, weights=w,
                              dists=torch.zeros_like(w), iterations=0)
    lam = 0.5
    mixed = tds.interp_logits(ttopk.shard_vocab(lm, shards), ret, lam)
    got = np.exp(mixed.transpose(0, 1).reshape(B, -1).numpy())
    p_lm = torch.softmax(lm.double(), -1).numpy()
    pk = np.zeros((B, V))
    pk[0, 3], pk[0, 39] = 0.5, 0.5
    pk[1, 10], pk[1, 0] = 0.7, 0.1
    np.testing.assert_allclose(got, (1 - lam) * p_lm + lam * pk, rtol=1e-5,
                               atol=1e-7)


def test_retrieved_distribution_prefers_near_tokens(rng):
    """A query on a cluster of same-token keys puts most kNN mass on that
    token (the reference's sanity case)."""
    N, dm, V, l = K * 256, 8, 64, 16
    keys = rng.normal(size=(N, dm)).astype(np.float32) * 5
    values = rng.integers(0, V, size=(N,)).astype(np.int32)
    q = rng.normal(size=(1, dm)).astype(np.float32) * 5
    keys[:l] = q + rng.normal(size=(l, dm)).astype(np.float32) * 0.01
    values[:l] = 7
    store = tds.build_local(torch.from_numpy(keys).reshape(K, -1, dm),
                            torch.from_numpy(values).reshape(K, -1))
    ret = tds.retrieve(store, torch.from_numpy(q), l,
                       ttopk.generator(1, "cpu"), temperature=1.0)
    w, t = ret.weights[0].numpy(), ret.tokens[0].numpy()
    assert float(w[t == 7].sum()) > 0.95


def test_build_local_ids():
    keys = torch.zeros(4, 6, 3)
    st = tds.build_local(keys, torch.arange(24).reshape(4, 6))
    np.testing.assert_array_equal(st.ids.numpy(),
                                  np.arange(24).reshape(4, 6))
    assert st.values.dtype == torch.int32
