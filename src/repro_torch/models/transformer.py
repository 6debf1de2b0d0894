"""Decoder-only model assembly: the dense, moe, hybrid, vlm and ssm
families.

Port of ``repro.models.transformer``.  The reference stacks its layers
into super-blocks (the smallest period of the layer pattern, see
:func:`superblock_size`) driven by ``lax.scan``, a compile economy; here
the layers are a ``ModuleList`` run in order, layer ``i`` built from
``cfg.is_attn_layer(i)``, ``is_moe_layer(i)`` and ``is_slstm_layer(i)``:

  dense / vlm  attention + SwiGLU
  moe          attention + MoE (``moe.py``)
  hybrid       Mamba (``mamba.py``) or, at position ``attn_period - 1`` of
               each period, attention; MoE at the ``moe_period`` positions,
               SwiGLU at the rest (jamba)
  ssm          mLSTM, or sLSTM at the ``slstm_period`` positions, and no
               FFN (``xlstm.py``; xlstm)

The vlm family puts its stub patch embeddings (``prefix_embeds``) ahead
of the tokens; ``loss_fn`` drops the prefix positions.  Entry points are
plain functions on a :class:`Transformer`: ``forward`` (full-sequence
logits and the MoE aux loss summed over the layers), ``loss_fn``,
``prefill``, ``decode_step``, ``init_cache`` (each layer's own cache:
``KVCache``, ``MambaCache``, ``MLstmCache`` or ``SLstmCache``, written in
place).

:func:`init_params` is the seeded init of ``repro.models.creator``'s
rules: embedding tables ``0.02 * N(0, 1)``; matrices ``N(0, 1) /
sqrt(fan_in)``, fan_in the product of all but the last dim of the
reference's (unstacked, physical) shape, so the attention output
projection counts the padded heads (``n_heads_phys * head_dim`` rows)
and an expert weight the padded experts (``n_experts_phys``); biases
and the xLSTM input and forget gates' weights zeros, the forget bias,
the Mamba skip and norm scales ones; Mamba's ``a_log`` ``log(1..d_state)``
and ``dt_bias`` the softplus inverse of log-uniform values in [1e-3,
1e-1].  It draws from a ``torch.Generator``: the distributions are the
reference's, the streams are not.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models import layers, mamba, moe, xlstm
from repro_torch.models.config import ModelConfig
from repro_torch.models.mlp import MLP
from repro_torch.models.sharding import constrain


def superblock_size(cfg: ModelConfig) -> int:
    """The period of the layer pattern: the reference stacks layer ``sb
    * p + j`` at ``blocks/sub{j}[sb]``."""
    if cfg.family == "ssm":
        return cfg.slstm_period
    p = 1
    if cfg.attn_period > 0:
        p = math.lcm(p, cfg.attn_period)
    if cfg.n_experts > 0:
        p = math.lcm(p, cfg.moe_period)
    return p


def mixer_kind(cfg: ModelConfig, i: int) -> str:
    """Layer ``i``'s sequence mixer: attn, mamba, mlstm or slstm."""
    if cfg.family == "ssm":
        return "slstm" if cfg.is_slstm_layer(i) else "mlstm"
    return "attn" if cfg.is_attn_layer(i) else "mamba"


class Table(nn.Module):
    """An embedding (or untied unembedding) table ``(vocab, d)``."""

    def __init__(self, vocab: int, d: int, *, device=None):
        super().__init__()
        self.table = nn.Parameter(torch.empty(vocab, d, device=device))


class Block(nn.Module):
    """Layer ``i``: a pre-norm mixer (``mixer``: attn, mamba, mlstm or
    slstm) then, where ``d_ff > 0``, a pre-norm SwiGLU or MoE
    (``ffn_kind``: ffn, moe or None), each residual."""

    def __init__(self, cfg: ModelConfig, i: int, *, device=None):
        super().__init__()
        kw = dict(device=device)
        d = cfg.d_model
        self.mixer = mixer_kind(cfg, i)
        self.ffn_kind = None
        if self.mixer == "slstm":
            self.ln = layers.RMSNorm(d, cfg.norm_eps, **kw)
            self.slstm = xlstm.SLstm(d, cfg.n_heads, cfg.slstm_proj_factor,
                                     **kw)
            return
        if self.mixer == "mlstm":
            self.ln = layers.RMSNorm(d, cfg.norm_eps, **kw)
            self.mlstm = xlstm.MLstm(d, cfg.n_heads, cfg.mlstm_proj_factor,
                                     **kw)
            return
        self.ln1 = layers.RMSNorm(d, cfg.norm_eps, **kw)
        if self.mixer == "attn":
            self.attn = attn.Attention(d, cfg.n_heads, cfg.n_kv_heads,
                                       cfg.head_dim, cfg.qkv_bias, **kw)
        else:
            self.mamba = mamba.Mamba(d, expand=cfg.mamba_expand,
                                     d_state=cfg.mamba_d_state,
                                     d_conv=cfg.mamba_d_conv, **kw)
        if cfg.d_ff > 0:
            self.ln2 = layers.RMSNorm(d, cfg.norm_eps, **kw)
            if cfg.is_moe_layer(i):
                self.ffn_kind = "moe"
                self.moe = moe.MoE(d, cfg.d_ff, cfg.n_experts, **kw)
            else:
                self.ffn_kind = "ffn"
                self.ffn = MLP(d, cfg.d_ff, **kw)

    def pre_norm(self, x):
        return (self.ln if self.mixer in ("mlstm", "slstm") else self.ln1)(x)


class Transformer(nn.Module):
    """A decoder-only model of any family but audio, f32 (``.double()``
    gives its f64 twin)."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        kw = dict(device=device)
        self.cfg = cfg
        self.embed = Table(cfg.vocab, cfg.d_model, **kw)
        self.blocks = nn.ModuleList(Block(cfg, i, **kw)
                                    for i in range(cfg.n_layers))
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


# ---- init --------------------------------------------------------------------

_ZEROS = ("bq", "bk", "bv", "conv_b", "w_i", "b_i", "w_f", "b_gates")
_ONES = ("scale", "b_f", "d_skip")


def _fan_in(cfg: ModelConfig, name: str, shape) -> int:
    """fan_in of a matrix under the reference's rule, over its physical
    (head- and expert-padded) shape."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "wo":
        return cfg.n_heads_phys * cfg.head_dim
    if ".moe." in name and leaf != "router":
        return cfg.n_experts_phys * shape[1]
    return math.prod(shape[:-1]) if len(shape) > 1 else shape[0]


@torch.no_grad()
def init_params(model: nn.Module, gen: torch.Generator) -> nn.Module:
    """Fill ``model`` (a :class:`Transformer` or an ``encdec.EncDec``) in
    place by the reference's init rules (module docstring), drawing from
    ``gen`` on the model's device."""
    cfg = model.cfg
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in _ONES:
            p.fill_(1.0)
        elif leaf in _ZEROS:
            p.zero_()
        elif leaf == "a_log":
            p.copy_(torch.log(torch.arange(1, p.shape[-1] + 1,
                                           dtype=p.dtype, device=p.device)))
        elif leaf == "dt_bias":
            lo, hi = math.log(1e-3), math.log(1e-1)
            u = torch.rand(p.shape, generator=gen, device=p.device)
            dt = torch.exp(lo + (hi - lo) * u)
            p.copy_(dt + torch.log(-torch.expm1(-dt)))
        else:
            x = torch.randn(p.shape, generator=gen, device=p.device)
            if leaf == "table":
                x.mul_(0.02)
            else:
                x.mul_(1.0 / math.sqrt(max(_fan_in(cfg, name, p.shape), 1)))
            p.copy_(x)
    return model


# ---- layers --------------------------------------------------------------------

def _embed_inputs(model: Transformer, tokens, prefix_embeds=None):
    x = layers.embed(model.embed.table, tokens)
    if prefix_embeds is not None:
        x = constrain(torch.cat([prefix_embeds.to(x.dtype), x], 1),
                      "batch", "seq", None)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    return x, positions


def _ffn_residual(blk: Block, cfg: ModelConfig, x):
    """``(x + ffn(ln2(x)), aux)``; aux is None but for an MoE layer."""
    if blk.ffn_kind is None:
        return x, None
    h = blk.ln2(x)
    if blk.ffn_kind == "moe":
        y, aux = moe.moe_ffn(blk.moe, h, n_experts=cfg.n_experts,
                             top_k=cfg.moe_top_k,
                             capacity_factor=cfg.capacity_factor)
        return x + y, aux
    return x + blk.ffn(h), None


def _layer(blk: Block, cfg: ModelConfig, x, positions, kw: dict):
    """One layer over the whole sequence, no cache -> ``(x, aux)``."""
    h = blk.pre_norm(x)
    if blk.mixer == "attn":
        y = attn.causal_attention(blk.attn, h, positions, **kw)
    elif blk.mixer == "mamba":
        y = mamba.mamba_block(blk.mamba, h, d_state=cfg.mamba_d_state)
    elif blk.mixer == "mlstm":
        y = xlstm.mlstm_block(blk.mlstm, h, n_heads=cfg.n_heads)
    else:
        y = xlstm.slstm_block(blk.slstm, h, n_heads=cfg.n_heads)
    return _ffn_residual(blk, cfg, x + y)


def _layer_step(blk: Block, cfg: ModelConfig, x, cache, kw: dict, *,
                positions=None):
    """One layer in cached mode: the prompt (``positions`` given) or one
    decode token -> ``(x, cache)``."""
    h = blk.pre_norm(x)
    prompt = positions is not None
    if blk.mixer == "attn":
        y, cache = (attn.prefill_into_cache(blk.attn, h, positions, cache,
                                            **kw) if prompt else
                    attn.decode_attention(blk.attn, h, cache, **kw))
    elif blk.mixer == "mamba":
        fn = mamba.mamba_prefill if prompt else mamba.mamba_decode_step
        y, cache = fn(blk.mamba, h, cache, d_state=cfg.mamba_d_state)
    elif blk.mixer == "mlstm":
        fn = xlstm.mlstm_prefill if prompt else xlstm.mlstm_decode_step
        y, cache = fn(blk.mlstm, h, cache, n_heads=cfg.n_heads)
    else:
        fn = xlstm.slstm_prefill if prompt else xlstm.slstm_decode_step
        y, cache = fn(blk.slstm, h, cache, n_heads=cfg.n_heads)
    return _ffn_residual(blk, cfg, x + y)[0], cache


# ---- whole-model entry points -------------------------------------------------

def forward(model: Transformer, tokens, prefix_embeds=None,
            remat: bool = False):
    """Full-sequence forward -> ``(logits (B, S, V), aux_loss)``, S
    counting the prefix; the aux loss is the MoE layers' sum (0 without
    them).  ``remat``: each layer runs under ``torch.utils.checkpoint``
    and is recomputed in the backward pass (the reference's
    ``jax.checkpoint`` over its scanned blocks)."""
    cfg = model.cfg
    x, positions = _embed_inputs(model, tokens, prefix_embeds)
    kw = model.attn_kwargs()
    aux = None
    for blk in model.blocks:
        if remat:
            x, a = checkpoint(_layer, blk, cfg, x, positions, kw,
                              use_reentrant=False)
        else:
            x, a = _layer(blk, cfg, x, positions, kw)
        if a is not None:
            aux = a if aux is None else aux + a
    x = model.final_ln(x)
    return (layers.unembed(x, model.head_table()),
            x.new_zeros(()) if aux is None else aux)


def loss_fn(model: Transformer, batch: dict, remat: bool = True):
    """``batch``: ``{"tokens", "labels", "mask"?, "prefix_embeds"?}``
    tensors on the model's device -> ``(ce + 0.01 * aux, {"ce",
    "aux"})``; the prefix positions carry no loss."""
    logits, aux = forward(model, batch["tokens"], batch.get("prefix_embeds"),
                          remat=remat)
    labels = batch["labels"]
    logits = logits[:, logits.shape[1] - labels.shape[1]:]
    ce = layers.cross_entropy(logits, labels, batch.get("mask"))
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}


def init_cache(cfg: ModelConfig, batch: int, s_max: int,
               dtype=torch.float32, device=None) -> list:
    """One cache a layer, of its mixer's kind; the recurrent states in
    f32 (f64 for an f64 ``dtype``)."""
    out = []
    for kind in (mixer_kind(cfg, i) for i in range(cfg.n_layers)):
        if kind == "attn":
            c = attn.init_cache(batch, s_max, cfg.n_kv_heads, cfg.head_dim,
                                dtype=dtype, device=device)
        elif kind == "mamba":
            c = mamba.init_mamba_cache(
                batch, cfg.d_model, expand=cfg.mamba_expand,
                d_state=cfg.mamba_d_state, d_conv=cfg.mamba_d_conv,
                dtype=dtype, device=device)
        elif kind == "mlstm":
            c = xlstm.init_mlstm_cache(batch, cfg.d_model, cfg.n_heads,
                                       cfg.mlstm_proj_factor, dtype=dtype,
                                       device=device)
        else:
            c = xlstm.init_slstm_state(batch, cfg.d_model, cfg.n_heads,
                                       dtype=dtype, device=device)
        out.append(c)
    return out


def prefill(model: Transformer, tokens, cache: list, prefix_embeds=None):
    """Prompt phase: ``(last-position logits (B, V), updated cache)``."""
    x, positions = _embed_inputs(model, tokens, prefix_embeds)
    kw = model.attn_kwargs()
    new_cache = []
    for blk, c in zip(model.blocks, cache):
        x, c = _layer_step(blk, model.cfg, x, c, kw, positions=positions)
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
        x, c = _layer_step(blk, model.cfg, x, c, kw)
        new_cache.append(c)
    x = model.final_ln(x)
    return layers.unembed(x, model.head_table())[:, 0], new_cache
