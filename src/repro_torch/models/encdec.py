"""Encoder-decoder transformer (the audio family: seamless-m4t).

Port of ``repro.models.encdec``.  The speech front end is a stub, as in
the reference: the encoder takes precomputed frame embeddings ``frames``
``(B, F, d_model)`` and runs non-causal self-attention over them; the
text decoder is a causal stack whose layers also cross-attend to the
encoder's output.  The decoder's cache holds one ``KVCache`` a layer and
the encoder states (``enc_out``), written in place at the prefill.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.mlp import MLP
from repro_torch.models.transformer import Table


class EncLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        kw = dict(device=device)
        d = cfg.d_model
        self.ln1 = layers.RMSNorm(d, cfg.norm_eps, **kw)
        self.attn = attn.Attention(d, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.head_dim, cfg.qkv_bias, **kw)
        self.ln2 = layers.RMSNorm(d, cfg.norm_eps, **kw)
        self.ffn = MLP(d, cfg.d_ff, **kw)


class DecLayer(nn.Module):
    """Causal self-attention (the reference's ``self``), cross-attention
    over the encoder states (no biases), SwiGLU; each pre-norm and
    residual."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        kw = dict(device=device)
        d = cfg.d_model
        self.ln1 = layers.RMSNorm(d, cfg.norm_eps, **kw)
        self.self_attn = attn.Attention(d, cfg.n_heads, cfg.n_kv_heads,
                                        cfg.head_dim, cfg.qkv_bias, **kw)
        self.lnx = layers.RMSNorm(d, cfg.norm_eps, **kw)
        self.cross = attn.Attention(d, cfg.n_heads, cfg.n_kv_heads,
                                    cfg.head_dim, False, **kw)
        self.ln2 = layers.RMSNorm(d, cfg.norm_eps, **kw)
        self.ffn = MLP(d, cfg.d_ff, **kw)


class EncDec(nn.Module):
    """The audio family's model, f32 (``.double()`` gives its f64
    twin)."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        kw = dict(device=device)
        self.cfg = cfg
        self.embed = Table(cfg.vocab, cfg.d_model, **kw)
        self.enc_blocks = nn.ModuleList(EncLayer(cfg, **kw)
                                        for _ in range(cfg.n_enc_layers))
        self.enc_ln = layers.RMSNorm(cfg.d_model, cfg.norm_eps, **kw)
        self.dec_blocks = nn.ModuleList(DecLayer(cfg, **kw)
                                        for _ in range(cfg.n_layers))
        self.final_ln = layers.RMSNorm(cfg.d_model, cfg.norm_eps, **kw)
        self.lm_head = (None if cfg.tie_embeddings
                        else Table(cfg.vocab, cfg.d_model, **kw))

    def head_table(self) -> torch.Tensor:
        return (self.embed.table if self.lm_head is None
                else self.lm_head.table)

    def attn_kwargs(self) -> dict:
        c = self.cfg
        return dict(n_heads=c.n_heads, n_kv=c.n_kv_heads,
                    head_dim=c.head_dim, rope_theta=c.rope_theta)


def _positions(x):
    B, S, _ = x.shape
    return torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)


def _enc_layer(lp: EncLayer, x, positions, kw):
    x = x + attn.causal_attention(lp.attn, lp.ln1(x), positions,
                                  causal=False, **kw)
    return x + lp.ffn(lp.ln2(x))


def encode(model: EncDec, frames, remat: bool = False):
    """``frames`` ``(B, F, D)`` stub front-end embeddings -> the encoder
    states, normed."""
    x = frames.to(model.embed.table.dtype)
    positions = _positions(x)
    kw = model.attn_kwargs()
    for lp in model.enc_blocks:
        x = (checkpoint(_enc_layer, lp, x, positions, kw, use_reentrant=False)
             if remat else _enc_layer(lp, x, positions, kw))
    return model.enc_ln(x)


def _cross_ffn(lp: DecLayer, x, enc_out, kw):
    x = x + attn.cross_attention(lp.cross, lp.lnx(x), enc_out,
                                 n_heads=kw["n_heads"], n_kv=kw["n_kv"],
                                 head_dim=kw["head_dim"])
    return x + lp.ffn(lp.ln2(x))


def _dec_layer(lp: DecLayer, x, positions, enc_out, kw):
    x = x + attn.causal_attention(lp.self_attn, lp.ln1(x), positions, **kw)
    return _cross_ffn(lp, x, enc_out, kw)


def _logits(model: EncDec, x):
    return layers.unembed(model.final_ln(x), model.head_table())


def forward(model: EncDec, tokens, frames, remat: bool = False):
    """Teacher-forced decode over ``tokens`` given the encoder ``frames``
    -> ``(logits (B, S, V), aux 0)``."""
    enc_out = encode(model, frames, remat=remat)
    x = layers.embed(model.embed.table, tokens)
    positions = _positions(x)
    kw = model.attn_kwargs()
    for lp in model.dec_blocks:
        x = (checkpoint(_dec_layer, lp, x, positions, enc_out, kw,
                        use_reentrant=False)
             if remat else _dec_layer(lp, x, positions, enc_out, kw))
    return _logits(model, x), x.new_zeros(())


def loss_fn(model: EncDec, batch: dict, remat: bool = True):
    """``batch``: ``{"tokens", "labels", "frames", "mask"?}`` tensors on
    the model's device -> ``(ce, {"ce", "aux"})``."""
    logits, aux = forward(model, batch["tokens"], batch["frames"],
                          remat=remat)
    ce = layers.cross_entropy(logits, batch["labels"], batch.get("mask"))
    return ce, {"ce": ce, "aux": aux}


def init_cache(cfg: ModelConfig, batch: int, s_max: int,
               dtype=torch.float32, device=None) -> dict:
    """``{"self": one KVCache a decoder layer, "enc_out": (B, F, D)}``."""
    return {"self": [attn.init_cache(batch, s_max, cfg.n_kv_heads,
                                     cfg.head_dim, dtype=dtype, device=device)
                     for _ in range(cfg.n_layers)],
            "enc_out": torch.zeros(batch, cfg.frontend_frames, cfg.d_model,
                                   dtype=dtype, device=device)}


def prefill(model: EncDec, tokens, frames, cache: dict):
    """Encode the frames into the cache, then the prompt's decoder pass:
    ``(last-position logits (B, V), updated cache)``."""
    enc_out = cache["enc_out"]
    enc_out.copy_(encode(model, frames))
    x = layers.embed(model.embed.table, tokens)
    positions = _positions(x)
    kw = model.attn_kwargs()
    new_self = []
    for lp, c in zip(model.dec_blocks, cache["self"]):
        y, c = attn.prefill_into_cache(lp.self_attn, lp.ln1(x), positions, c,
                                       **kw)
        x = _cross_ffn(lp, x + y, enc_out, kw)
        new_self.append(c)
    return _logits(model, x[:, -1:])[:, 0], {"self": new_self,
                                              "enc_out": enc_out}


def decode_step(model: EncDec, token, cache: dict):
    """One decode step: token ``(B,)`` -> ``(logits (B, V), updated
    cache)``."""
    x = layers.embed(model.embed.table, token[:, None])
    enc_out = cache["enc_out"]
    kw = model.attn_kwargs()
    new_self = []
    for lp, c in zip(model.dec_blocks, cache["self"]):
        y, c = attn.decode_attention(lp.self_attn, lp.ln1(x), c, **kw)
        x = _cross_ffn(lp, x + y, enc_out, kw)
        new_self.append(c)
    return _logits(model, x)[:, 0], {"self": new_self, "enc_out": enc_out}
