"""Decoder-only transformer, dense family: forward, prefill, decode.

Port of ``repro.models.transformer`` for ``family="dense"``.  The
reference stacks its layers into super-blocks driven by ``lax.scan``, a
compile economy; here the layers are a ``ModuleList`` run in order.
Entry points are plain functions on a :class:`Transformer`: ``forward``
(full-sequence logits), ``loss_fn`` (its cross entropy, for training),
``prefill`` (the prompt into the cache, the last position's logits),
``decode_step`` (one token), ``init_cache``.

:func:`init_params` is the seeded init of ``repro.models.creator``'s
rules: embedding tables ``0.02 * N(0, 1)``; matrices ``N(0, 1) /
sqrt(fan_in)``, fan_in the product of all but the last dim of the
reference's (unstacked) shape, whose attention output projection spans
the padded heads (``n_heads_phys * head_dim`` rows); biases zeros, norm
scales ones.  It draws from a ``torch.Generator``: the distributions
are the reference's, the streams are not.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.mlp import MLP


class Table(nn.Module):
    """An embedding (or untied unembedding) table ``(vocab, d)``."""

    def __init__(self, vocab: int, d: int, *, device=None):
        super().__init__()
        self.table = nn.Parameter(torch.empty(vocab, d, device=device))


class Block(nn.Module):
    """One pre-norm layer: attention then SwiGLU, each residual."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        kw = dict(device=device)
        d = cfg.d_model
        self.ln1 = layers.RMSNorm(d, cfg.norm_eps, **kw)
        self.attn = attn.Attention(d, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.head_dim, cfg.qkv_bias, **kw)
        self.ln2 = layers.RMSNorm(d, cfg.norm_eps, **kw)
        self.ffn = MLP(d, cfg.d_ff, **kw)


class Transformer(nn.Module):
    """The dense family's model, f32 (``.double()`` gives its f64
    twin)."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        if cfg.family != "dense" or cfg.is_encdec:
            raise NotImplementedError(f"family {cfg.family!r}")
        kw = dict(device=device)
        self.cfg = cfg
        self.embed = Table(cfg.vocab, cfg.d_model, **kw)
        self.blocks = nn.ModuleList(Block(cfg, **kw)
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


def _fan_in(cfg: ModelConfig, name: str, shape) -> int:
    """fan_in of a matrix under the reference's rule, over its physical
    (head-padded) shape."""
    if name.endswith("attn.wo"):
        return cfg.n_heads_phys * cfg.head_dim
    return math.prod(shape[:-1]) if len(shape) > 1 else shape[0]


@torch.no_grad()
def init_params(model: Transformer, gen: torch.Generator) -> Transformer:
    """Fill ``model`` in place by the reference's init rules (module
    docstring), drawing from ``gen`` on the model's device."""
    cfg = model.cfg
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "scale":
            p.fill_(1.0)
        elif leaf in ("bq", "bk", "bv"):
            p.zero_()
        else:
            x = torch.randn(p.shape, generator=gen, device=p.device)
            if leaf == "table":
                x.mul_(0.02)
            else:
                x.mul_(1.0 / math.sqrt(max(_fan_in(cfg, name, p.shape), 1)))
            p.copy_(x)
    return model


def _embed_inputs(model: Transformer, tokens):
    x = layers.embed(model.embed.table, tokens)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    return x, positions


def _mlp_residual(blk: Block, x):
    return x + blk.ffn(blk.ln2(x))


def _layer(blk: Block, x, positions, kw: dict):
    x = x + attn.causal_attention(blk.attn, blk.ln1(x), positions, **kw)
    return _mlp_residual(blk, x)


def forward(model: Transformer, tokens, remat: bool = False):
    """Full-sequence forward -> ``(logits (B, S, V), aux_loss)``; the
    dense family's aux loss is 0.  ``remat``: each layer runs under
    ``torch.utils.checkpoint`` and is recomputed in the backward pass
    (the reference's ``jax.checkpoint`` over its scanned blocks)."""
    x, positions = _embed_inputs(model, tokens)
    kw = model.attn_kwargs()
    for blk in model.blocks:
        if remat:
            x = checkpoint(_layer, blk, x, positions, kw,
                           use_reentrant=False)
        else:
            x = _layer(blk, x, positions, kw)
    x = model.final_ln(x)
    return layers.unembed(x, model.head_table()), x.new_zeros(())


def loss_fn(model: Transformer, batch: dict, remat: bool = True):
    """``batch``: ``{"tokens", "labels", "mask"?}`` tensors on the model's
    device -> ``(ce + 0.01 * aux, {"ce", "aux"})``."""
    logits, aux = forward(model, batch["tokens"], remat=remat)
    ce = layers.cross_entropy(logits, batch["labels"], batch.get("mask"))
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}


def init_cache(cfg: ModelConfig, batch: int, s_max: int,
               dtype=torch.float32, device=None) -> list:
    """One :class:`attention.KVCache` per layer."""
    return [attn.init_cache(batch, s_max, cfg.n_kv_heads, cfg.head_dim,
                            dtype=dtype, device=device)
            for _ in range(cfg.n_layers)]


def prefill(model: Transformer, tokens, cache: list):
    """Prompt phase: ``(last-position logits (B, V), updated cache)``."""
    x, positions = _embed_inputs(model, tokens)
    kw = model.attn_kwargs()
    new_cache = []
    for blk, c in zip(model.blocks, cache):
        y, c = attn.prefill_into_cache(blk.attn, blk.ln1(x), positions, c,
                                       **kw)
        x = _mlp_residual(blk, x + y)
        new_cache.append(c)
    x = model.final_ln(x[:, -1:])
    return layers.unembed(x, model.head_table())[:, 0], new_cache


def decode_step(model: Transformer, token, cache: list):
    """One decode step: token ``(B,)`` -> ``(logits (B, V), updated
    cache)``."""
    x = layers.embed(model.embed.table, token[:, None])          # (B, 1, D)
    kw = model.attn_kwargs()
    new_cache = []
    for blk, c in zip(model.blocks, cache):
        y, c = attn.decode_attention(blk.attn, blk.ln1(x), c, **kw)
        x = _mlp_residual(blk, x + y)
        new_cache.append(c)
    x = model.final_ln(x)
    return layers.unembed(x, model.head_table())[:, 0], new_cache
