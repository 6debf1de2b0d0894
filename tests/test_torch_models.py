"""The port's LM stack against the JAX reference: configs, every
family's module and parameter count, the layers, and the dense family's
whole models (the other families: ``tests/test_torch_family_*.py``).

Each layer runs through its JAX function and its port on the same numpy
inputs; whole models run from the reference's seeded parameters carried
across by ``convert.params_from_jax``, which drops the dummy heads of
``head_pad_to`` (``qwen2-0.5b``'s reduced config keeps 4 real heads of
16).  Prefill and decode logits agree within atol 1e-4; the port's own
decode agrees with its teacher-forced forward within the reference's
bounds (``tests/test_decode_consistency.py``: 5e-4 prefill, 5e-3
decode).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import attention as jattn
from repro.models import build_model as jbuild
from repro.models import layers as jlayers
from repro.models import mlp as jmlp
import repro_torch.configs as tconfigs
from repro_torch import convert
from repro_torch.models import attention as tattn
from repro_torch.models import build_model
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttr
from repro_torch.models.encdec import EncDec
from repro_torch.models.mlp import MLP

torch.set_num_threads(1)

DENSE = ["qwen2-0.5b", "qwen2.5-14b", "qwen1.5-4b", "yi-6b"]
OTHERS = ["phi3.5-moe-42b-a6.6b", "granite-moe-3b-a800m",
          "jamba-1.5-large-398b", "pixtral-12b", "seamless-m4t-large-v2",
          "xlstm-125m"]
ATOL = 1e-4


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _close(got, want, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               atol=atol, rtol=rtol)


# ---- configs -------------------------------------------------------------

def test_registry_and_configs_equal_reference():
    assert tconfigs.registry() == jconfigs.registry()
    for name in list(jconfigs.registry()) + list(jconfigs._ALIASES):
        want, got = jconfigs.get(name), tconfigs.get(name)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
    for name in jconfigs.registry():
        want, got = jconfigs.get(name), tconfigs.get(name)
        assert got.param_count() == want.param_count()
        assert (dataclasses.asdict(got.reduced())
                == dataclasses.asdict(want.reduced()))
        assert (got.n_heads_phys, got.n_kv_phys, got.head_group) == (
            want.n_heads_phys, want.n_kv_phys, want.head_group)


@pytest.mark.parametrize("arch", OTHERS)
def test_build_model_builds_every_family(arch):
    """``build_model`` takes each family; ``init_params`` on the meta
    device builds its module (a Transformer, or an EncDec for audio)
    without memory."""
    cfg = tconfigs.get(arch)
    api = build_model(cfg)
    model = api.init_params(device="meta")
    assert isinstance(model, EncDec if cfg.is_encdec else ttr.Transformer)
    assert all(p.is_meta for p in model.parameters())
    kinds = {blk.mixer for blk in getattr(model, "blocks", [])}
    want = {"granite-moe-3b-a800m": {"attn"},
            "phi3.5-moe-42b-a6.6b": {"attn"},
            "jamba-1.5-large-398b": {"attn", "mamba"},
            "pixtral-12b": {"attn"}, "seamless-m4t-large-v2": set(),
            "xlstm-125m": {"mlstm", "slstm"}}[arch]
    assert kinds == want


def _dummy_elements(cfg) -> int:
    """Elements of the reference's tree that ``convert.params_from_jax``
    drops: the dummy heads of every attention (the decoder's cross
    attention has no biases) and the dummy experts of every MoE layer."""
    d, hd = cfg.d_model, cfg.head_dim
    dq = (cfg.n_heads_phys - cfg.n_heads) * hd
    dkv = (cfg.n_kv_phys - cfg.n_kv_heads) * hd
    attn = 2 * d * dq + 2 * d * dkv
    bias = dq + 2 * dkv if cfg.qkv_bias else 0
    if cfg.is_encdec:
        n = (cfg.n_enc_layers + cfg.n_layers) * (attn + bias)
        return n + cfg.n_layers * attn
    n_attn = sum(cfg.is_attn_layer(i) for i in range(cfg.n_layers))
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
    if cfg.family == "ssm":
        n_attn = 0
    dummy_experts = (cfg.n_experts_phys - cfg.n_experts) * 3 * d * cfg.d_ff
    return n_attn * (attn + bias) + n_moe * dummy_experts


@pytest.mark.parametrize("arch", DENSE + OTHERS)
def test_parameter_count_at_full_width(arch):
    """The port's module holds the reference's parameters less the dummy
    heads and dummy experts it drops (built on the meta device, no
    memory; the reference's tree from ``param_shapes()``, which
    allocates nothing).  For the dense family that is ``param_count()``
    plus the final norm's scale, which the analytic count leaves out."""
    cfg = tconfigs.get(arch)
    model = build_model(cfg).init_params(device="meta")
    got = sum(p.numel() for p in model.parameters())
    shapes = jbuild(jconfigs.get(arch)).param_shapes()
    want = sum(math.prod(x.shape) for x in jax.tree.leaves(shapes))
    assert got == want - _dummy_elements(cfg)
    if arch in DENSE:
        assert got == cfg.param_count() + cfg.d_model


def test_seeded_init_follows_the_reference_rules():
    cfg = dataclasses.replace(tconfigs.get("qwen2-0.5b").reduced(),
                              d_model=128, d_ff=512, vocab=4096)
    model = build_model(cfg).init_params(3, device="cpu")
    blk = model.blocks[0]
    assert not any(p.requires_grad for p in model.parameters())
    assert float(model.embed.table.std()) == pytest.approx(0.02, rel=0.03)
    d = cfg.d_model
    for w, fan_in in ((blk.attn.wq, d), (blk.attn.wk, d),
                      (blk.ffn.w_up, d), (blk.ffn.w_down, cfg.d_ff),
                      (blk.attn.wo, cfg.n_heads_phys * cfg.head_dim)):
        assert float(w.std()) == pytest.approx(1 / math.sqrt(fan_in),
                                               rel=0.05)
    assert float(blk.attn.bq.abs().max()) == 0.0
    assert bool((blk.ln1.scale == 1).all())
    again = build_model(cfg).init_params(3, device="cpu")
    assert torch.equal(again.blocks[1].attn.wv, model.blocks[1].attn.wv)
    other = build_model(cfg).init_params(4, device="cpu")
    assert not torch.equal(other.blocks[1].attn.wv, model.blocks[1].attn.wv)


def test_seeded_init_of_the_other_families():
    """The reference's init rules for the new parameters
    (``src/repro/models/creator.py``): Mamba's ``a_log`` log(1..d_state)
    and ``dt_bias`` the softplus inverse of values in [1e-3, 1e-1],
    ``conv_b`` zeros, ``d_skip`` ones; the xLSTM gates' weights and
    biases zeros but the forget bias, ones; an expert weight's fan_in
    over the padded experts (granite: 48 physical for 40)."""
    jamba = dataclasses.replace(tconfigs.get("jamba-1.5-large-398b").reduced(),
                                mamba_d_state=16)
    mb = build_model(jamba).init_params(1, device="cpu").blocks[0].mamba
    assert torch.equal(mb.a_log, torch.log(torch.arange(1, 17.0)).expand(
        mb.a_log.shape))
    dt = torch.nn.functional.softplus(mb.dt_bias)
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5)
    assert float(dt.max()) <= 1e-1 * (1 + 1e-5)
    assert float(dt.log().std()) == pytest.approx(
        (math.log(1e-1) - math.log(1e-3)) / math.sqrt(12), rel=0.1)
    assert float(mb.conv_b.abs().max()) == 0 and bool((mb.d_skip == 1).all())
    assert float(mb.conv_w.std()) == pytest.approx(0.5, rel=0.1)  # 1/sqrt(4)
    x = build_model(tconfigs.get("xlstm-125m").reduced()).init_params(
        1, device="cpu")
    ml, sl = x.blocks[0].mlstm, x.blocks[1].slstm
    for z in (ml.w_i, ml.b_i, ml.w_f, sl.b_gates):
        assert float(z.abs().max()) == 0
    assert bool((ml.b_f == 1).all())
    cfg = dataclasses.replace(tconfigs.get("granite-moe-3b-a800m").reduced(),
                              d_model=128, d_ff=256, n_experts=8,
                              expert_pad_to=12)
    moe = build_model(cfg).init_params(2, device="cpu").blocks[0].moe
    assert moe.w_gate.shape[0] == 8
    assert float(moe.w_gate.std()) == pytest.approx(
        1 / math.sqrt(12 * 128), rel=0.05)
    assert float(moe.w_down.std()) == pytest.approx(
        1 / math.sqrt(12 * 256), rel=0.05)
    assert float(moe.router.std()) == pytest.approx(1 / math.sqrt(128),
                                                    rel=0.1)


# ---- layers ----------------------------------------------------------------

def test_rmsnorm_embed_unembed(rng):
    x = rng.normal(size=(2, 5, 16)).astype(np.float32) * 3
    scale = rng.normal(size=(16,)).astype(np.float32)
    want = jlayers.rmsnorm({"scale": scale}, x, 1e-6)
    _close(tlayers.rmsnorm(_t(x), _t(scale), 1e-6), want, atol=1e-5)
    table = rng.normal(size=(40, 16)).astype(np.float32)
    tok = rng.integers(0, 40, (2, 5)).astype(np.int32)
    _close(tlayers.embed(_t(table), torch.from_numpy(tok)),
           jlayers.embed({"table": table}, tok), atol=0)
    _close(tlayers.unembed(_t(x), _t(table)),
           jlayers.unembed({}, x, table=table), atol=1e-4)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_half_split(rng, theta):
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    pos = np.tile(np.arange(7, dtype=np.int32) * 13, (2, 1))
    want = jlayers.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = tlayers.rope(_t(x), torch.from_numpy(pos), theta)
    _close(got, want, atol=1e-5)
    # half-split, not interleaved: dim i pairs with dim i + 8
    assert got.shape == x.shape


def test_mlp(rng):
    d, f = 16, 48
    w = {n: rng.normal(size=s).astype(np.float32) / 4 for n, s in
         (("w_gate", (d, f)), ("w_up", (d, f)), ("w_down", (f, d)))}
    x = rng.normal(size=(2, 5, d)).astype(np.float32)
    m = MLP(d, f)
    m.load_state_dict({n: _t(v) for n, v in w.items()})
    _close(m(_t(x)), jmlp.mlp(w, x), atol=1e-5)


def _attn_pair(rng, d=32, H=4, KV=2, hd=8, bias=True):
    shapes = {"wq": (d, H * hd), "wk": (d, KV * hd), "wv": (d, KV * hd),
              "wo": (H * hd, d)}
    if bias:
        shapes.update(bq=(H * hd,), bk=(KV * hd,), bv=(KV * hd,))
    p = {n: rng.normal(size=s).astype(np.float32) / math.sqrt(s[0])
         for n, s in shapes.items()}
    m = tattn.Attention(d, H, KV, hd, bias)
    m.load_state_dict({n: _t(v) for n, v in p.items()})
    return p, m, dict(n_heads=H, n_kv=KV, head_dim=hd, rope_theta=1e6)


@pytest.mark.parametrize("S,q_chunk", [(12, 512), (16, 4)])
def test_causal_attention(rng, S, q_chunk):
    p, m, kw = _attn_pair(rng)
    x = rng.normal(size=(2, S, 32)).astype(np.float32)
    pos = np.tile(np.arange(S, dtype=np.int32), (2, 1))
    want = jattn.causal_attention(p, jnp.asarray(x), jnp.asarray(pos),
                                  q_chunk=q_chunk, **kw)
    got = tattn.causal_attention(m, _t(x), torch.from_numpy(pos),
                                 q_chunk=q_chunk, **kw)
    _close(got, want, atol=1e-5)


def test_prefill_and_decode_attention(rng):
    p, m, kw = _attn_pair(rng, bias=False)
    B, S, s_max = 2, 6, 12
    x = rng.normal(size=(B, S, 32)).astype(np.float32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    jc = jattn.KVCache(k=jnp.zeros((B, s_max, 2, 8)),
                       v=jnp.zeros((B, s_max, 2, 8)), length=jnp.int32(0))
    jo, jc = jattn.prefill_into_cache(p, jnp.asarray(x), jnp.asarray(pos),
                                      jc, **kw)
    tc = tattn.init_cache(B, s_max, 2, 8)
    to, tc = tattn.prefill_into_cache(m, _t(x), torch.from_numpy(pos), tc,
                                      **kw)
    _close(to, jo, atol=1e-5)
    _close(tc.k, jc.k, atol=1e-5)
    assert tc.length == S
    for _ in range(3):
        x1 = rng.normal(size=(B, 1, 32)).astype(np.float32)
        jo, jc = jattn.decode_attention(p, jnp.asarray(x1), jc, **kw)
        to, tc = tattn.decode_attention(m, _t(x1), tc, **kw)
        _close(to, jo, atol=1e-5)
        _close(tc.v, jc.v, atol=1e-5)
    assert tc.length == int(jc.length)


# ---- whole models ----------------------------------------------------------

def _pair(arch, seed=0):
    cfg = jconfigs.get(arch).reduced()
    api = jbuild(cfg)
    params = api.init_params(jax.random.PRNGKey(seed))
    tcfg = tconfigs.get(arch).reduced()
    tapi = build_model(tcfg)
    model = ttr.Transformer(tcfg)
    model.load_state_dict(convert.params_from_jax(
        jax.tree.map(np.asarray, params), tcfg))
    return api, params, tapi, model.requires_grad_(False)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_equal_reference(arch, rng):
    api, params, tapi, model = _pair(arch)
    cfg = api.cfg
    B, S, steps = 2, 10, 4
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    jc = api.init_cache(jax.random.PRNGKey(1), B, S + 8, dtype=jnp.float32)
    jl, jc = jax.jit(lambda p, b, c: api.prefill(p, b, c))(
        params, {"tokens": toks}, jc)
    tc = tapi.init_cache(B, S + 8, device="cpu")
    tl, tc = tapi.prefill(model, {"tokens": toks}, tc)
    _close(tl, jl)
    step = jax.jit(lambda p, t, c: api.decode_step(p, t, c))
    nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for _ in range(steps):
        jl, jc = step(params, jnp.asarray(nxt), jc)
        tl, tc = tapi.decode_step(model, torch.from_numpy(nxt), tc)
        _close(tl, jl)
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    jf, _ = jax.jit(lambda p, b: api.forward(p, b))(params,
                                                    {"tokens": toks})
    tf, _ = tapi.forward(model, {"tokens": toks})
    _close(tf, jf)


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_teacher_forcing(arch, rng):
    """The reference's decode-consistency bounds, on the port alone."""
    cfg = tconfigs.get(arch).reduced()
    api = build_model(cfg)
    model = api.init_params(0, device="cpu")
    B, S = 2, 16
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    cache = api.init_cache(B, S + 8, device="cpu")
    lg0, cache = api.prefill(model, {"tokens": toks}, cache)
    nxt = torch.argmax(lg0, -1)
    lg1, cache = api.decode_step(model, nxt, cache)
    ext = np.concatenate([toks, nxt[:, None].numpy().astype(np.int32)], 1)
    full, aux = api.forward(model, {"tokens": ext})
    assert float(aux) == 0.0
    assert float((lg0 - full[:, -2]).abs().max()) < 5e-4
    assert float((lg1 - full[:, -1]).abs().max()) < 5e-3


def test_dummy_heads_are_dropped(rng):
    """qwen2-0.5b reduced: the reference holds 16 query heads, kv-major,
    real where h % 8 < 2; the converted model keeps those 4 in order,
    and the dummy heads' weights do not reach it."""
    cfg = jconfigs.get("qwen2-0.5b").reduced()
    assert (cfg.n_heads_phys, cfg.n_heads) == (16, 4)
    heads = convert.real_heads(16, 2, 2, 2)
    assert heads == [0, 1, 8, 9]
    mask = np.asarray(jattn.make_head_mask(cfg))
    assert np.flatnonzero(mask).tolist() == heads

    params = jbuild(cfg).init_params(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.array, params)
    sd = convert.params_from_jax(tree, cfg)
    hd = cfg.head_dim
    assert tuple(sd["blocks.0.attn.wq"].shape) == (cfg.d_model, 4 * hd)
    assert tuple(sd["blocks.0.attn.wo"].shape) == (4 * hd, cfg.d_model)
    assert tuple(sd["blocks.0.attn.bq"].shape) == (4 * hd,)
    wq = tree["blocks"]["sub0"]["attn"]["wq"][1].reshape(cfg.d_model, 16, hd)
    np.testing.assert_array_equal(
        sd["blocks.1.attn.wq"].numpy().reshape(cfg.d_model, 4, hd),
        wq[:, heads])
    # garbage in every dummy head changes nothing in the port
    a = tree["blocks"]["sub0"]["attn"]
    dummy = [h for h in range(16) if h not in heads]
    a["wq"].reshape(*a["wq"].shape[:2], 16, hd)[:, :, dummy] = 7.0
    a["bq"].reshape(a["bq"].shape[0], 16, hd)[:, dummy] = 7.0
    a["wo"].reshape(a["wo"].shape[0], 16, hd, -1)[:, dummy] = 7.0
    sd2 = convert.params_from_jax(tree, cfg)
    assert all(torch.equal(sd[n], sd2[n]) for n in sd)
    assert sorted(sd) == sorted(ttr.Transformer(cfg).state_dict())


# ---- the KV cache's two divergences from the reference ----------------------

def test_full_kv_cache_raises_where_the_reference_clamps(rng):
    """At ``length == S_max`` the reference's ``dynamic_update_slice``
    clamps the write onto the last slot and attends over every slot
    (its output silently wrong; its length passes S_max); the port
    raises instead."""
    p, m, kw = _attn_pair(rng, bias=False)
    B, s_max = 2, 4
    x = rng.normal(size=(B, s_max, 32)).astype(np.float32)
    pos = np.tile(np.arange(s_max, dtype=np.int32), (B, 1))
    jc = jattn.KVCache(k=jnp.zeros((B, s_max, 2, 8)),
                       v=jnp.zeros((B, s_max, 2, 8)), length=jnp.int32(0))
    _, jc = jattn.prefill_into_cache(p, jnp.asarray(x), jnp.asarray(pos),
                                     jc, **kw)
    tc = tattn.init_cache(B, s_max, 2, 8)
    _, tc = tattn.prefill_into_cache(m, _t(x), torch.from_numpy(pos), tc,
                                     **kw)
    assert tc.length == int(jc.length) == s_max
    x1 = rng.normal(size=(B, 1, 32)).astype(np.float32)
    _, jc2 = jattn.decode_attention(p, jnp.asarray(x1), jc, **kw)
    assert int(jc2.length) == s_max + 1
    assert not np.array_equal(np.asarray(jc2.k[:, -1]),
                              np.asarray(jc.k[:, -1]))   # clamped write
    with pytest.raises(ValueError, match="KV cache full"):
        tattn.decode_attention(m, _t(x1), tc, **kw)


def test_kv_cache_is_written_in_place(rng):
    """The port writes k/v into the cache's storage: a cache object the
    caller kept shares it with the next one (the reference's arrays are
    immutable, so its older cache stays as it was)."""
    p, m, kw = _attn_pair(rng, bias=False)
    B, s_max = 2, 6
    x = rng.normal(size=(B, 3, 32)).astype(np.float32)
    pos = np.tile(np.arange(3, dtype=np.int32), (B, 1))
    tc = tattn.init_cache(B, s_max, 2, 8)
    _, kept = tattn.prefill_into_cache(m, _t(x), torch.from_numpy(pos), tc,
                                       **kw)
    before = kept.k.clone()
    x1 = rng.normal(size=(B, 1, 32)).astype(np.float32)
    _, nxt = tattn.decode_attention(m, _t(x1), kept, **kw)
    assert (kept.length, nxt.length) == (3, 4)
    assert nxt.k.data_ptr() == kept.k.data_ptr() == tc.k.data_ptr()
    assert not torch.equal(kept.k, before)             # slot 3 written
    assert torch.equal(kept.k[:, :3], before[:, :3])
    jc = jattn.KVCache(k=jnp.zeros((B, s_max, 2, 8)),
                       v=jnp.zeros((B, s_max, 2, 8)), length=jnp.int32(0))
    _, jkept = jattn.prefill_into_cache(p, jnp.asarray(x), jnp.asarray(pos),
                                        jc, **kw)
    jbefore = np.asarray(jkept.k).copy()
    jattn.decode_attention(p, jnp.asarray(x1), jkept, **kw)
    np.testing.assert_array_equal(np.asarray(jkept.k), jbefore)
