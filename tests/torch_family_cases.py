"""Whole-model cases shared by ``tests/test_torch_family_*.py``: one
architecture of the moe, hybrid, vlm, audio or ssm family, reduced, run
through the JAX package and the port on the same seeded numpy inputs,
the port's weights the reference's carried across by
``convert.params_from_jax``.

Tolerances: logits within atol 1e-4, the aux loss and the loss within
1e-5, every gradient tensor within 1e-4 x its max |g|; one train step's
loss, ce and lr within 1e-6 relative, and its parameters as
``tests/test_torch_train.py`` holds five (each tensor's displacement
within 1% relative L2 of the reference's, 99% of all elements within
1e-5 x max |p|); the port's decode against its teacher-forced forward
within the reference's bounds (``tests/test_decode_consistency.py``:
TIGHT 5e-4 prefill / 5e-3 decode; the MoE families at
``capacity_factor=8.0`` 5e-3 / 0.2, granite with them); greedy
generation token for token.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.configs as jconfigs
from repro.models import build_model as jbuild
from repro.optim import AdamW as JAdamW
from repro.runtime import ServeConfig as JServeConfig
from repro.runtime import Server as JServer
from repro.runtime import TrainConfig as JTrainConfig
from repro.runtime import init_opt_state as jinit_opt_state
from repro.runtime import make_train_step as jmake_train_step
import repro_torch.configs as tconfigs
from repro_torch import convert
from repro_torch.models import build_model
from repro_torch.optim import AdamW
from repro_torch.runtime import (ServeConfig, Server, TrainConfig,
                                 init_opt_state, make_train_step)

TIGHT = ["xlstm-125m", "seamless-m4t-large-v2", "pixtral-12b"]
LOOSE = ["phi3.5-moe-42b-a6.6b", "jamba-1.5-large-398b",
         "granite-moe-3b-a800m"]
ATOL = 1e-4
B, S = 2, 16

_CACHE = {}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def pair(arch, **replace):
    """``(jax api, params, port api, port model)`` for the reduced
    config (with ``replace`` applied to both), cached per process."""
    key = (arch, tuple(sorted(replace.items())))
    if key not in _CACHE:
        cfg = dataclasses.replace(jconfigs.get(arch).reduced(), **replace)
        tcfg = dataclasses.replace(tconfigs.get(arch).reduced(), **replace)
        api = jbuild(cfg)
        params = api.init_params(jax.random.PRNGKey(0))
        tapi = build_model(tcfg)
        model = tapi.init_params(0, device="cpu")
        model.load_state_dict(convert.params_from_jax(_np(params), tcfg))
        _CACHE[key] = (api, params, tapi, model)
    return _CACHE[key]


def batch(cfg, rng, b=B, s=S, labels=True):
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if labels:
        out["labels"] = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    if cfg.family == "vlm":
        out["prefix_embeds"] = rng.normal(
            size=(b, cfg.num_prefix_embeds, cfg.d_model)).astype(np.float32)
    if cfg.is_encdec:
        out["frames"] = rng.normal(
            size=(b, cfg.frontend_frames, cfg.d_model)).astype(np.float32)
    return out


def prefix(cfg) -> int:
    return cfg.num_prefix_embeds if cfg.family == "vlm" else 0


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               atol=atol, rtol=0)


def forward(arch, rng):
    api, params, tapi, model = pair(arch)
    b = batch(api.cfg, rng, labels=False)
    jl, jaux = jax.jit(lambda p, x: api.forward(p, x))(params, b)
    with torch.no_grad():
        tl, taux = tapi.forward(model, b)
    assert tl.shape == (B, S + prefix(api.cfg), api.cfg.vocab)
    _close(tl, jl)
    assert abs(float(taux) - float(jaux)) <= 1e-5
    if api.cfg.n_experts:
        assert float(taux) > 0


def loss_and_gradients(arch, rng):
    api, params, tapi, model = pair(arch)
    b = batch(api.cfg, rng)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p, x: api.loss_fn(p, x), has_aux=True))(params, b)
    model.requires_grad_(True)
    try:
        loss, aux = tapi.loss_fn(model, b)
        names = [n for n, _ in model.named_parameters()]
        grads = torch.autograd.grad(loss, list(model.parameters()))
    finally:
        model.requires_grad_(False)
    assert abs(float(loss.detach()) - float(jl)) <= 1e-5
    assert abs(float(aux["ce"].detach()) - float(jaux["ce"])) <= 1e-5
    assert abs(float(aux["aux"].detach()) - float(jaux["aux"])) <= 1e-5
    want = convert.params_from_jax(_np(jg), tapi.cfg)
    assert sorted(want) == sorted(names)
    for n, g in zip(names, grads):
        scale = float(want[n].abs().max())
        assert float((g - want[n]).abs().max()) <= ATOL * scale, n


def prefill_and_decode(arch, rng, steps=4):
    api, params, tapi, model = pair(arch)
    b = batch(api.cfg, rng, labels=False)
    s_max = S + 8 + prefix(api.cfg)
    jc = api.init_cache(jax.random.PRNGKey(1), B, s_max, dtype=jnp.float32)
    jl, jc = jax.jit(lambda p, x, c: api.prefill(p, x, c))(params, b, jc)
    tc = tapi.init_cache(B, s_max, device="cpu")
    tl, tc = tapi.prefill(model, b, tc)
    _close(tl, jl)
    step = jax.jit(lambda p, t, c: api.decode_step(p, t, c))
    nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for _ in range(steps):
        jl, jc = step(params, jnp.asarray(nxt), jc)
        tl, tc = tapi.decode_step(model, torch.from_numpy(nxt), tc)
        _close(tl, jl)
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)


def teacher_forcing_errors(tapi, model, rng):
    """The port's prefill and first decode step against its own
    teacher-forced forward (the reference's ``_roundtrip``)."""
    cfg = tapi.cfg
    b = batch(cfg, rng, labels=False)
    cache = tapi.init_cache(B, S + 8 + prefix(cfg), device="cpu")
    lg0, cache = tapi.prefill(model, b, cache)
    nxt = torch.argmax(lg0, -1)
    lg1, cache = tapi.decode_step(model, nxt, cache)
    ext = dict(b, tokens=np.concatenate(
        [b["tokens"], nxt[:, None].numpy().astype(np.int32)], 1))
    with torch.no_grad():
        full, _ = tapi.forward(model, ext)
    return (float((lg0 - full[:, -2]).abs().max()),
            float((lg1 - full[:, -1]).abs().max()))


def decode_matches_teacher_forcing(arch, rng):
    if arch in TIGHT:
        tapi, model = pair(arch)[2:]
        e0, e1 = teacher_forcing_errors(tapi, model, rng)
        assert e0 < 5e-4 and e1 < 5e-3, (e0, e1)
        return
    assert arch in LOOSE
    tapi, model = pair(arch, capacity_factor=8.0)[2:]
    e0, e1 = teacher_forcing_errors(tapi, model, rng)
    assert e0 < 5e-3 and e1 < 0.2, (e0, e1)


def continuous_routing_control(arch, rng):
    """With top_k == n_experts the routing is continuous: the decode
    error collapses to the tight bound."""
    cfg = tconfigs.get(arch).reduced()
    tapi, model = pair(arch, moe_top_k=cfg.n_experts,
                       capacity_factor=8.0)[2:]
    _, e1 = teacher_forcing_errors(tapi, model, rng)
    assert e1 < 5e-3, e1


def train_step(arch, rng):
    api, params, tapi, model = pair(arch)
    b = batch(api.cfg, rng)
    kw = dict(grad_accum=2, peak_lr=3e-3, warmup_steps=2, total_steps=10)
    jt, tt = JTrainConfig(**kw), TrainConfig(**kw)
    jopt, topt = JAdamW(weight_decay=0.01), AdamW(weight_decay=0.01)
    jp, js, jm = jax.jit(jmake_train_step(api, jt, jopt))(
        params, jinit_opt_state(api, jt, jopt, params), b)
    trained = tapi.init_params(0, device="cpu", train=True)
    trained.load_state_dict(model.state_dict())
    start = {n: p.detach().clone() for n, p in trained.named_parameters()}
    ts = init_opt_state(tapi, tt, topt, trained)
    trained, ts, tm = make_train_step(tapi, tt, topt)(trained, ts, b)
    for k in ("loss", "ce", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6,
                                   err_msg=k)
    assert int(ts[2]) == int(js[2]) == 1
    want = convert.params_from_jax(_np(jp), tapi.cfg)
    pmax = max(float(w.abs().max()) for w in want.values())
    out = total = 0
    for n, p in trained.named_parameters():
        got = p.detach()
        out += int(((got - want[n]).abs() > 1e-5 * pmax).sum())
        total += got.numel()
        moved, moved_ref = got - start[n], want[n] - start[n]
        assert float((moved - moved_ref).norm()) <= 1e-2 * float(
            moved_ref.norm()) + 1e-12, n
    assert out <= 0.01 * total, (out, total)


def generate_equals_reference(arch, rng, shards):
    """Greedy (top_k 1) generation token for token with the JAX
    ``Server`` (no mesh), the port over ``shards`` vocabulary shards."""
    api, params, tapi, model = pair(arch)
    b = batch(api.cfg, rng, b=4, s=8, labels=False)
    steps = 6
    max_seq = 8 + steps + 8 + prefix(api.cfg)
    want, _ = JServer(api, params, JServeConfig(max_seq=max_seq, top_k=1),
                      cache_dtype=jnp.float32).generate(
                          b, steps, key=jax.random.PRNGKey(1))
    got, stats = Server(tapi, model, ServeConfig(max_seq=max_seq, top_k=1),
                        shards=shards).generate(b, steps, key=1)
    assert got.dtype == np.int32 and got.shape == (4, steps)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert stats["tok_per_s"] > 0
