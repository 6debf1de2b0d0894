"""The port's MoE dispatch (``repro_torch.models.moe``) against the JAX
package's ``repro.models.moe``.

Inputs are seeded numpy; the reference runs outside any mesh, where its
group count ``batch_shards()`` is 1.  Tolerances: the output and the aux
loss within atol 1e-5.

Routing is compared exactly: the port's ``route`` must pick the experts
``lax.top_k`` picks from the reference's probabilities, in its order.
Near ties are handled by a margin the test asserts: the probabilities of
the two implementations agree within 1e-6, and every row's gap between
its k-th and (k+1)-th probability is above that, so both rank the row
alike; exact ties (equal router columns) are their own case, broken to
the smaller expert id by both.  The drop set (which ``(token, k)``
assignments are kept, at which slot) is compared with the reference's
position-in-expert lines (``src/repro/models/moe.py:106-110``), at the
default ``capacity_factor`` and at one low enough to drop.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import build_model as jbuild
from repro.models import moe as jmoe
import repro_torch.configs as tconfigs
from repro_torch import convert
from repro_torch.models import build_model
from repro_torch.models import moe as tmoe

torch.set_num_threads(1)

MARGIN = 1e-6


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _pair(rng, d=32, f=48, E=6):
    w = {"router": rng.normal(size=(d, E)) / np.sqrt(d),
         "w_gate": rng.normal(size=(E, d, f)) / np.sqrt(d),
         "w_up": rng.normal(size=(E, d, f)) / np.sqrt(d),
         "w_down": rng.normal(size=(E, f, d)) / np.sqrt(f)}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    m = tmoe.MoE(d, f, E)
    m.load_state_dict({k: _t(v) for k, v in w.items()})
    return w, m


def _reference_routing(w, x, top_k, cf, E):
    """The reference's probabilities, top-k and its position-in-expert
    rule (``src/repro/models/moe.py:93-110``, G = 1), in JAX."""
    xt = jnp.asarray(x.reshape(-1, x.shape[-1]))
    probs = jax.nn.softmax((xt @ w["router"]).astype(jnp.float32), -1)
    gate, idx = jax.lax.top_k(probs, top_k)
    C = jmoe.capacity(xt.shape[0], E, top_k, cf)
    onehot = jax.nn.one_hot(idx, E, dtype=jnp.int32)
    flat = onehot.reshape(-1, E)
    pos = jnp.cumsum(flat, axis=0) - flat
    pos = jnp.sum(pos * flat, axis=-1).reshape(idx.shape)
    return (np.asarray(probs), np.asarray(idx), np.asarray(pos),
            np.asarray(pos < C), C)


@pytest.mark.parametrize("n,E,k,cf", [(1, 40, 8, 1.25), (8, 40, 8, 1.25),
                                      (1024, 40, 8, 1.25), (32, 16, 2, 1.25),
                                      (4096, 16, 2, 8.0), (7, 3, 2, 0.5)])
def test_capacity_equals_reference(n, E, k, cf):
    assert tmoe.capacity(n, E, k, cf) == jmoe.capacity(n, E, k, cf)


def test_route_breaks_exact_ties_to_the_smaller_expert():
    probs = np.array([[0.2, 0.3, 0.3, 0.2], [0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.4, 0.1, 0.4]], np.float32)
    gate, idx = tmoe.route(torch.from_numpy(probs), 2)
    jg, ji = jax.lax.top_k(jnp.asarray(probs), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_allclose(gate.numpy(),
                               np.asarray(jg / jg.sum(-1, keepdims=True)),
                               atol=1e-7)


@pytest.mark.parametrize("cf", [1.25, 0.25])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_moe_ffn_equals_reference(rng, cf, k):
    E = 6
    w, m = _pair(rng, E=E)
    x = rng.normal(size=(2, 32, 32)).astype(np.float32)   # 64 > E * 8
    want, waux = jmoe.moe_ffn(w, jnp.asarray(x), n_experts=E, top_k=k,
                              capacity_factor=cf)
    with torch.no_grad():
        got, aux = tmoe.moe_ffn(m, _t(x), n_experts=E, top_k=k,
                                capacity_factor=cf)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert abs(float(aux) - float(waux)) <= 1e-5

    # the routing, under the asserted margin
    probs, idx, pos, keep, C = _reference_routing(w, x, k, cf, E)
    with torch.no_grad():
        tprobs = torch.softmax(_t(x).reshape(-1, 32) @ m.router, -1)
    assert float((tprobs - _t(probs)).abs().max()) < MARGIN
    srt = np.sort(probs, -1)[:, ::-1]
    assert (srt[:, k - 1] - srt[:, k]).min() > MARGIN
    _, tidx = tmoe.route(tprobs, k)
    np.testing.assert_array_equal(tidx.numpy(), idx)
    tpos, tkeep = tmoe.assign(tidx, E, C)
    np.testing.assert_array_equal(tkeep.numpy(), keep)
    np.testing.assert_array_equal(tpos.numpy()[keep], pos[keep])
    if cf < 1:   # 64 k assignments cannot fit 6 experts of 8 slots
        assert (~keep).sum() > 0


def test_moe_ffn_gradients_equal_reference(rng):
    E, k, cf = 6, 2, 0.5
    w, m = _pair(rng, E=E)
    x = rng.normal(size=(2, 16, 32)).astype(np.float32)

    def jloss(w, x):
        y, aux = jmoe.moe_ffn(w, x, n_experts=E, top_k=k, capacity_factor=cf)
        return jnp.sum(y * y) + aux

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(w, jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    y, aux = tmoe.moe_ffn(m, xt, n_experts=E, top_k=k, capacity_factor=cf)
    (torch.sum(y * y) + aux).backward()
    for n, p in m.named_parameters():
        want = np.asarray(jg[n])
        np.testing.assert_allclose(p.grad.numpy(), want,
                                   atol=1e-4 * np.abs(want).max(), err_msg=n)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx),
                               atol=1e-4 * np.abs(np.asarray(jgx)).max())


def test_moe_combine_is_deterministic(rng):
    """The combine gathers each token's k outputs and sums them in a
    fixed order: two runs are bit-equal (no atomics to reorder)."""
    w, m = _pair(rng, E=8)
    x = _t(rng.normal(size=(4, 32, 32)))
    with torch.no_grad():
        a, _ = tmoe.moe_ffn(m, x, n_experts=8, top_k=4, capacity_factor=0.5)
        b, _ = tmoe.moe_ffn(m, x, n_experts=8, top_k=4, capacity_factor=0.5)
    assert torch.equal(a, b)


def test_dropped_assignment_passes_through(rng):
    """With every assignment dropped but the first C an expert takes, a
    token whose k experts are all full gets a zero FFN output (the
    residual carries it), in both packages."""
    E, k = 2, 2
    w, m = _pair(rng, E=E)
    x = rng.normal(size=(1, 40, 32)).astype(np.float32)
    want, _ = jmoe.moe_ffn(w, jnp.asarray(x), n_experts=E, top_k=k,
                           capacity_factor=0.1)
    with torch.no_grad():
        got, _ = tmoe.moe_ffn(m, _t(x), n_experts=E, top_k=k,
                              capacity_factor=0.1)
    assert tmoe.capacity(40, E, k, 0.1) == 8
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    zero = np.flatnonzero(np.abs(np.asarray(want)[0]).max(-1) == 0)
    np.testing.assert_array_equal(
        np.flatnonzero(got[0].abs().amax(-1).numpy() == 0), zero)
    assert zero.size == 40 - 8   # each expert's 8 slots, k = 2 = E


def test_dummy_experts_dropped_with_the_reference_outputs(rng):
    """The reference's ``test_dummy_experts_never_routed`` case: granite
    reduced with ``expert_pad_to=6`` (4 real experts, 6 physical).  The
    converted port holds the 4 real ones, keeps the reference's init
    scale (fan_in over the 6 physical), and gives the reference's logits
    and loss; the dummies' weights do not reach it."""
    cfg = dataclasses.replace(
        jconfigs.get("granite-moe-3b-a800m").reduced(), expert_pad_to=6)
    tcfg = dataclasses.replace(
        tconfigs.get("granite-moe-3b-a800m").reduced(), expert_pad_to=6)
    assert (cfg.n_experts_phys, cfg.n_experts) == (6, 4)
    api = jbuild(cfg)
    params = api.init_params(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.array, params)
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)}
    tapi = build_model(tcfg)
    model = tapi.init_params(0, device="cpu")
    sd = convert.params_from_jax(tree, tcfg)
    assert tuple(sd["blocks.0.moe.w_gate"].shape) == (4, cfg.d_model,
                                                      cfg.d_ff)
    model.load_state_dict(sd)
    jl, jaux = jax.jit(lambda p, b: api.forward(p, b))(params, batch)
    tl, taux = tapi.forward(model, batch)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               atol=1e-4)
    assert abs(float(taux) - float(jaux)) <= 1e-5
    jloss, _ = api.loss_fn(params, batch)
    tloss, _ = tapi.loss_fn(model, batch)
    assert abs(float(tloss) - float(jloss)) <= 1e-5
    # garbage in the dummies changes nothing in the port
    moe = tree["blocks"]["sub0"]["moe"]
    for name in ("w_gate", "w_up", "w_down"):
        moe[name][:, 4:] = 7.0
    sd2 = convert.params_from_jax(tree, tcfg)
    assert all(torch.equal(sd[n], sd2[n]) for n in sd)
    # the seeded init's scale is the reference's: fan_in over 6 x d
    fresh = tapi.init_params(1, device="cpu").blocks[0].moe
    want = 1.0 / np.sqrt(6 * cfg.d_model)
    assert float(fresh.w_gate.std()) == pytest.approx(want, rel=0.05)
    want = 1.0 / np.sqrt(6 * cfg.d_ff)
    assert float(fresh.w_down.std()) == pytest.approx(want, rel=0.05)
