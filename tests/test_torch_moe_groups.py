"""The port's MoE dispatch in batch-shard groups against the JAX
package's under its ``mesh42``.

Under a (4, 2) data x model mesh both packages cut the N tokens into G
= ``batch_shards()`` = 4 groups (halved until G divides N, 1 below 64
tokens a group) and route, count capacity and place tokens within each
group.  The port runs under ``sharding.set_mesh(AbstractMesh((4, 2),
...))``, where ``batch_shards()`` reads the shape and ``constrain`` is a
no-op, so the grouped math runs on plain CPU tensors; the JAX package
runs ``moe_ffn`` jitted under ``mesh42``.  The weights are the reduced
granite-moe-3b and jamba MoE layers of the reference's init, carried
across by ``convert.params_from_jax``; x ``(8, 32, 64)`` from a numpy
seed gives G = 4 groups of 64 tokens.

Tolerances: the output and the aux loss within 1e-5 relative (the
output's max |y|); the kept / dropped ``(token, k)`` sets exactly, under
the margin ``tests/test_torch_moe.py`` asserts between every row's k-th
and (k+1)-th probability.  Below 64 tokens a group the grouped dispatch
is the one-group dispatch, and the port's result equals its result
without a mesh bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import build_model as jbuild
from repro.models import moe as jmoe
from repro.parallel.compat import set_mesh as jset_mesh
import repro_torch.configs as tconfigs
from repro_torch import convert
from repro_torch.models import build_model
from repro_torch.models import moe as tmoe
from repro_torch.models import sharding as shd

torch.set_num_threads(1)

ARCHS = ["granite-moe-3b-a800m", "jamba-1.5-large-398b"]
MESH = shd.AbstractMesh((4, 2), ("data", "model"))
REL = 1e-5
MARGIN = 1e-6
_LAYERS = {}


def _layer(arch):
    """``(port MoE module, its weights as numpy, E, top_k)`` of the first
    MoE layer of the reduced ``arch``, from the reference's init."""
    if arch not in _LAYERS:
        cfg = jconfigs.get(arch).reduced()
        tcfg = tconfigs.get(arch).reduced()
        params = jbuild(cfg).init_params(jax.random.PRNGKey(0))
        model = build_model(tcfg).init_params(0, device="cpu")
        model.load_state_dict(convert.params_from_jax(
            jax.tree.map(np.asarray, params), tcfg))
        blk = next(b for b in model.blocks if b.ffn_kind == "moe")
        w = {n: p.detach().numpy() for n, p in blk.moe.named_parameters()}
        _LAYERS[arch] = (blk.moe, w, tcfg.n_experts, tcfg.moe_top_k)
    return _LAYERS[arch]


def _reference(w, x, E, k, cf, mesh42):
    """The JAX package's ``moe_ffn`` under ``mesh42`` and its grouped
    routing (``src/repro/models/moe.py:81-110``): ``(y, aux, probs (G,
    Ng, E), keep (G, Ng, k), pos)``."""
    with jset_mesh(mesh42):
        y, aux = jax.jit(lambda w, x: jmoe.moe_ffn(
            w, x, n_experts=E, top_k=k, capacity_factor=cf))(
                w, jnp.asarray(x))
        G = jmoe.sharding.batch_shards()
    B, S, D = x.shape
    N = B * S
    while N % G:
        G //= 2
    if N // G < 64:
        G = 1
    Ng = N // G
    xt = jnp.asarray(x.reshape(G, Ng, D))
    probs = jax.nn.softmax((xt @ w["router"]).astype(jnp.float32), -1)
    _, idx = jax.lax.top_k(probs, k)
    C = jmoe.capacity(Ng, E, k, cf)
    flat = jax.nn.one_hot(idx, E, dtype=jnp.int32).reshape(G, Ng * k, E)
    pos = jnp.cumsum(flat, axis=1) - flat
    pos = jnp.sum(pos * flat, axis=-1).reshape(G, Ng, k)
    return (np.asarray(y), float(aux), np.asarray(probs),
            np.asarray(pos < C), np.asarray(pos))


def _port_routing(m, x, E, k, cf):
    """The port's groups, route and placement under ``MESH``."""
    B, S, D = x.shape
    with shd.set_mesh(MESH), torch.no_grad():
        G = tmoe.groups(B * S)
        Ng = B * S // G
        probs = torch.softmax(torch.from_numpy(x).reshape(G, Ng, D)
                              @ m.router, -1)
        _, idx = tmoe.route(probs, k)
        pos, keep = tmoe.assign(idx, E, tmoe.capacity(Ng, E, k, cf))
    return G, probs.numpy(), keep.numpy(), pos.numpy()


@pytest.mark.parametrize("cf", [1.25, 0.5])
@pytest.mark.parametrize("arch", ARCHS)
def test_grouped_dispatch_equals_reference_on_mesh42(arch, cf, mesh42):
    m, w, E, k = _layer(arch)
    x = np.random.default_rng(7).normal(size=(8, 32, 64)).astype(np.float32)
    want, waux, jprobs, jkeep, jpos = _reference(w, x, E, k, cf, mesh42)
    with shd.set_mesh(MESH), torch.no_grad():
        got, aux = tmoe.moe_ffn(m, torch.from_numpy(x), n_experts=E,
                                top_k=k, capacity_factor=cf)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, atol=REL * scale, rtol=0)
    assert abs(float(aux) - waux) <= REL * abs(waux)

    G, probs, keep, pos = _port_routing(m, x, E, k, cf)
    assert G == 4 and jkeep.shape == keep.shape == (4, 64, k)
    assert np.abs(probs - jprobs).max() < MARGIN
    srt = -np.sort(-jprobs, -1)
    assert (srt[..., k - 1] - srt[..., k]).min() > MARGIN
    np.testing.assert_array_equal(keep, jkeep)
    np.testing.assert_array_equal(pos[keep], jpos[keep])
    if cf < 1:
        # drops, and the groups' capacity decides them: one group over
        # all 256 tokens would keep another set
        assert (~keep).sum() > 0
        with torch.no_grad():
            flat = probs.reshape(1, -1, E)
            _, idx1 = tmoe.route(torch.from_numpy(flat), k)
            _, keep1 = tmoe.assign(idx1, E, tmoe.capacity(256, E, k, cf))
        assert not np.array_equal(keep1.numpy().reshape(keep.shape), keep)


def test_grouped_dispatch_gradients_equal_reference_on_mesh42(mesh42):
    arch, cf = "granite-moe-3b-a800m", 0.5
    m, w, E, k = _layer(arch)
    x = np.random.default_rng(8).normal(size=(8, 32, 64)).astype(np.float32)

    def jloss(w, x):
        y, aux = jmoe.moe_ffn(w, x, n_experts=E, top_k=k,
                              capacity_factor=cf)
        return jnp.sum(y * y) + aux

    with jset_mesh(mesh42):
        jg, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
            w, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    m.requires_grad_(True)
    params = dict(m.named_parameters())
    with shd.set_mesh(MESH):
        y, aux = tmoe.moe_ffn(m, xt, n_experts=E, top_k=k,
                              capacity_factor=cf)
        g = torch.autograd.grad(torch.sum(y * y) + aux,
                                [xt, *params.values()])
    for name, got in zip(["x", *params], g):
        want = np.asarray(jgx if name == "x" else jg[name])
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=REL * np.abs(want).max(),
                                   err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_small_batch_is_one_group_bit_for_bit(arch, mesh42):
    """N // G < 64: one group, the result without a mesh bit for bit
    (and the reference's under mesh42)."""
    m, w, E, k = _layer(arch)
    x = np.random.default_rng(9).normal(size=(4, 16, 64)).astype(np.float32)
    with torch.no_grad():
        plain, paux = tmoe.moe_ffn(m, torch.from_numpy(x), n_experts=E,
                                   top_k=k)
        with shd.set_mesh(MESH):
            assert tmoe.groups(64) == 1
            got, aux = tmoe.moe_ffn(m, torch.from_numpy(x), n_experts=E,
                                    top_k=k)
    assert torch.equal(got, plain) and torch.equal(aux, paux)
    want, waux, *_ = _reference(w, x, E, k, 1.25, mesh42)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=REL * np.abs(want).max())
    assert abs(float(aux) - waux) <= REL * abs(waux)


@pytest.mark.parametrize("n,want", [(256, 4), (512, 4), (255, 1), (192, 1),
                                    (130, 2), (64, 1)])
def test_group_count_is_the_references(n, want):
    """G = batch_shards() = 4 on the (4, 2) mesh, halved until it divides
    N, 1 below 64 tokens a group; 1 without a mesh."""
    assert tmoe.groups(n) == 1
    with shd.set_mesh(MESH):
        assert tmoe.groups(n) == want
