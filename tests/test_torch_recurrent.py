"""The port's recurrent mixers (Mamba, mLSTM, sLSTM) and the
encoder-decoder's attention against the JAX package.

Each block runs through its JAX function and its port on the same
seeded numpy inputs and weights (the reference's own init, with the
gates that it initialises to zero or one drawn at random so that they
matter).  Tolerance: atol 1e-4 on outputs and states, for the mLSTM
1e-4 x max(1, max |want|) (``_close_scaled``).  The Mamba scan is
held at a length that divides by its chunk of 16 and one that does not,
the mLSTM's at one that divides by 64 and one that does not, and the
clip of the chunked scan is held where it is active.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import mamba as jmamba
from repro.models import transformer as jtr
from repro.models import xlstm as jxlstm
from repro.models.config import ModelConfig as JModelConfig
from repro.models.creator import InitCreator
from repro_torch.models import attention as tattn
from repro_torch.models import mamba as tmamba
from repro_torch.models import xlstm as txlstm

torch.set_num_threads(1)

ATOL = 1e-4
D, H = 32, 4


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               atol=atol, rtol=0)


def _load(module, params):
    module.load_state_dict({k: _t(v) for k, v in params.items()})
    return module.requires_grad_(False)


def _randomise(params, rng, names, scale=0.5):
    out = {k: np.array(v, np.float32) for k, v in params.items()}
    for n in names:
        out[n] = (scale * rng.normal(size=out[n].shape)).astype(np.float32)
    return out


# ---- Mamba -----------------------------------------------------------------

def _mamba_pair(rng, d_state=8, dt_bias=None):
    p = jmamba.mamba_params(InitCreator(jax.random.PRNGKey(1)).scope("m"), D,
                            expand=2, d_state=d_state, d_conv=4)
    p = _randomise(p, rng, ["conv_b"], 0.1)
    if dt_bias is not None:
        p["dt_bias"] = np.full_like(p["dt_bias"], dt_bias)
    m = tmamba.Mamba(D, expand=2, d_state=d_state, d_conv=4)
    return p, _load(m, p)


@pytest.mark.parametrize("S", [32, 12])
def test_mamba_block_prefill_and_decode(rng, S):
    p, m = _mamba_pair(rng)
    B = 2
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    _close(tmamba.mamba_block(m, _t(x), d_state=8),
           jmamba.mamba_block(p, jnp.asarray(x), d_state=8))
    jc = jmamba.MambaCache(conv=jnp.zeros((B, 3, 2 * D)),
                           ssm=jnp.zeros((B, 2 * D, 8)))
    jo, jc = jmamba.mamba_prefill(p, jnp.asarray(x), jc, d_state=8)
    tc = tmamba.init_mamba_cache(B, D, expand=2, d_state=8, d_conv=4)
    to, tc2 = tmamba.mamba_prefill(m, _t(x), tc, d_state=8)
    _close(to, jo)
    _close(tc.conv, jc.conv)          # written in place
    _close(tc.ssm, jc.ssm)
    assert tc2.ssm.data_ptr() == tc.ssm.data_ptr()
    for _ in range(3):
        x1 = rng.normal(size=(B, 1, D)).astype(np.float32)
        jo, jc = jmamba.mamba_decode_step(p, jnp.asarray(x1), jc, d_state=8)
        to, tc = tmamba.mamba_decode_step(m, _t(x1), tc, d_state=8)
        _close(to, jo)
        _close(tc.ssm, jc.ssm)
        _close(tc.conv, jc.conv)


def test_mamba_chunked_scan_clip_mirrors_reference(rng):
    """dt ~ 3 with A = -(1..8): the in-chunk decay passes e^-35, so the
    reference's clip of exp(-L) is active.  The port gives the
    reference's clipped output and final state (both depart from the
    exact recurrence there, which the decode step runs)."""
    p, m = _mamba_pair(rng, dt_bias=3.0)
    B, S = 2, 16
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    jc = jmamba.MambaCache(conv=jnp.zeros((B, 3, 2 * D)),
                           ssm=jnp.zeros((B, 2 * D, 8)))
    jo, jc = jmamba.mamba_prefill(p, jnp.asarray(x), jc, d_state=8)
    tc = tmamba.init_mamba_cache(B, D, expand=2, d_state=8, d_conv=4)
    to, tc = tmamba.mamba_prefill(m, _t(x), tc, d_state=8)
    _close(to, jo)
    _close(tc.ssm, jc.ssm)
    # the exact recurrence over the same prompt, one token at a time
    ec = tmamba.init_mamba_cache(B, D, expand=2, d_state=8, d_conv=4)
    for t in range(S):
        eo, ec = tmamba.mamba_decode_step(m, _t(x[:, t:t + 1]), ec,
                                          d_state=8)
    with torch.no_grad():
        xs = torch.nn.functional.silu(tmamba._conv1d(
            m, (_t(x) @ m.in_proj)[..., :2 * D])[0])
        logdA, _, _ = tmamba._ssm_inputs(m, xs, d_state=8, log_space=True)
    assert float(-logdA.sum(1).min()) > 35.0        # the clip is active
    assert float((ec.ssm - tc.ssm).abs().max()) > ATOL


# ---- mLSTM -----------------------------------------------------------------

def _mlstm_pair(rng):
    p = jxlstm.mlstm_params(InitCreator(jax.random.PRNGKey(2)).scope("m"), D,
                            H, 2.0)
    p = _randomise(p, rng, ["w_i", "w_f", "b_i"], 0.3)
    return p, _load(txlstm.MLstm(D, H, 2.0), p)


def _mlstm_cfg():
    return JModelConfig(name="t", family="ssm", n_layers=2, d_model=D,
                        n_heads=H, n_kv_heads=H, d_ff=0, vocab=16)


def _close_scaled(got, want):
    """atol 1e-4 x max(1, max |want|): the mLSTM's exponential input
    gates grow its memory and outputs well past 1 over a long chunk, and
    f32 rounding, the reference's as the port's, grows with them."""
    _close(got, want, atol=ATOL * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("S", [128, 20])
def test_mlstm_block_prefill_and_decode(rng, S):
    p, m = _mlstm_pair(rng)
    B = 2
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    _close_scaled(txlstm.mlstm_block(m, _t(x), n_heads=H),
                  jxlstm.mlstm_block(p, jnp.asarray(x), n_heads=H))
    dh = 2 * D // H
    jc = jxlstm.MLstmCache(c=jnp.zeros((B, H, dh, dh)),
                           n=jnp.zeros((B, H, dh)))
    jo, jc = jtr._mlstm_prefill(p, jnp.asarray(x), jc, _mlstm_cfg())
    tc = txlstm.init_mlstm_cache(B, D, H, 2.0)
    to, tc = txlstm.mlstm_prefill(m, _t(x), tc, n_heads=H)
    _close_scaled(to, jo)
    _close_scaled(tc.c, jc.c)
    _close_scaled(tc.n, jc.n)
    for _ in range(3):
        x1 = rng.normal(size=(B, 1, D)).astype(np.float32)
        jo, jc = jxlstm.mlstm_decode_step(p, jnp.asarray(x1), jc, n_heads=H)
        to, tc = txlstm.mlstm_decode_step(m, _t(x1), tc, n_heads=H)
        _close_scaled(to, jo)
        _close_scaled(tc.c, jc.c)
        _close_scaled(tc.n, jc.n)


# ---- sLSTM -----------------------------------------------------------------

def _slstm_pair(rng):
    p = jxlstm.slstm_params(InitCreator(jax.random.PRNGKey(3)).scope("s"), D,
                            H, 1.3334)
    p = _randomise(p, rng, ["b_gates"], 0.5)
    return p, _load(txlstm.SLstm(D, H, 1.3334), p)


def test_slstm_block_prefill_and_decode(rng):
    p, m = _slstm_pair(rng)
    B, S = 2, 16
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    _close(txlstm.slstm_block(m, _t(x), n_heads=H),
           jxlstm.slstm_block(p, jnp.asarray(x), n_heads=H))
    jc = jxlstm.init_slstm_state(B, D, H)
    jo, jc = jtr._slstm_prefill(p, jnp.asarray(x), jc, _mlstm_cfg())
    tc = txlstm.init_slstm_state(B, D, H)
    assert all(float(t.abs().max()) == 0 for t in tc)   # m starts at 0
    to, tc = txlstm.slstm_prefill(m, _t(x), tc, n_heads=H)
    _close(to, jo)
    for name in ("c", "n", "h", "m"):
        _close(getattr(tc, name), getattr(jc, name))
    for _ in range(3):
        x1 = rng.normal(size=(B, 1, D)).astype(np.float32)
        jo, jc = jxlstm.slstm_decode_step(p, jnp.asarray(x1), jc, n_heads=H)
        to, tc = txlstm.slstm_decode_step(m, _t(x1), tc, n_heads=H)
        _close(to, jo)
        for name in ("c", "n", "h", "m"):
            _close(getattr(tc, name), getattr(jc, name))


def test_xlstm_projection_widths_round_to_8():
    assert txlstm.mlstm_width(768, 2.0) == jxlstm._round8(1536) == 1536
    assert txlstm.mlstm_width(768, 1.3334) == jxlstm._round8(
        int(768 * 1.3334)) == 1024
    assert txlstm.mlstm_width(64, 1.3334) == 80
    assert txlstm.mlstm_width(3, 1.0) == 8
    p = jxlstm.slstm_params(InitCreator(jax.random.PRNGKey(0)), 64, 4, 1.3334)
    assert tuple(txlstm.SLstm(64, 4, 1.3334).up.shape) == p["up"].shape


# ---- the encoder-decoder's attention -----------------------------------------

def _attn_pair(rng, d=32, Hq=4, KV=2, hd=8, bias=False):
    shapes = {"wq": (d, Hq * hd), "wk": (d, KV * hd), "wv": (d, KV * hd),
              "wo": (Hq * hd, d)}
    if bias:
        shapes.update(bq=(Hq * hd,), bk=(KV * hd,), bv=(KV * hd,))
    p = {n: rng.normal(size=s).astype(np.float32) / math.sqrt(s[0])
         for n, s in shapes.items()}
    m = _load(tattn.Attention(d, Hq, KV, hd, bias), p)
    return p, m, dict(n_heads=Hq, n_kv=KV, head_dim=hd)


@pytest.mark.parametrize("Sq,Se", [(1, 16), (6, 16), (5, 24)])
def test_cross_attention(rng, Sq, Se):
    p, m, kw = _attn_pair(rng)
    x = rng.normal(size=(2, Sq, 32)).astype(np.float32)
    enc = rng.normal(size=(2, Se, 32)).astype(np.float32)
    _close(tattn.cross_attention(m, _t(x), _t(enc), **kw),
           jattn.cross_attention(p, jnp.asarray(x), jnp.asarray(enc), **kw),
           atol=1e-5)


@pytest.mark.parametrize("S,q_chunk", [(16, 512), (16, 4)])
def test_non_causal_encoder_attention(rng, S, q_chunk):
    p, m, kw = _attn_pair(rng, bias=True)
    x = rng.normal(size=(2, S, 32)).astype(np.float32)
    pos = np.tile(np.arange(S, dtype=np.int32), (2, 1))
    want = jattn.causal_attention(p, jnp.asarray(x), jnp.asarray(pos),
                                  rope_theta=1e4, q_chunk=q_chunk,
                                  causal=False, **kw)
    got = tattn.causal_attention(m, _t(x), torch.from_numpy(pos),
                                 rope_theta=1e4, q_chunk=q_chunk,
                                 causal=False, **kw)
    _close(got, want, atol=1e-5)
    causal = tattn.causal_attention(m, _t(x), torch.from_numpy(pos),
                                    rope_theta=1e4, q_chunk=q_chunk, **kw)
    assert float((causal - got)[:, :-1].abs().max()) > 1e-3
    _close(causal[:, -1], got[:, -1], atol=1e-5)  # the last sees them all
