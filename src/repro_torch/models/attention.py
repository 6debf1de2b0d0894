"""GQA attention: chunked-causal prefill, cached decode, cross-attention.

Port of ``repro.models.attention``.  Query head h reads KV head ``h //
(n_heads // n_kv)``; the scores contract the grouped query against the
``(B, S, KV, hd)`` keys directly (no repeated copy of the cache).
Scores and softmax run in f32 (f64 for an f64 model,
``layers.compute_dtype``); the prefill takes queries in chunks of
``q_chunk``, so the live score block is ``(B, H, q_chunk, S)``.  The
encoder calls ``causal_attention(causal=False)``; the decoder of the
encoder-decoder family reads the encoder states by ``cross_attention``.

The port holds the real heads only: the reference's dummy heads, which
pad the head axis to tile its mesh (``head_pad_to``), are dropped when
its weights are converted (``convert.params_from_jax``), so no head
mask is needed here.

The KV cache is a static ``(B, S_max, KV, hd)`` buffer per layer with a
host-side length.  Unlike the reference's immutable arrays, a write
goes into the buffer in place (``prefill_into_cache`` and
``decode_attention`` return a cache over the same storage with the new
length); decode attends over the whole buffer with the ``s_pos <=
length`` mask, as the reference does.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from repro_torch.models.layers import compute_dtype, rope
from repro_torch.models.sharding import constrain

DEFAULT_Q_CHUNK = 512


class KVCache(NamedTuple):
    k: torch.Tensor     # (B, S_max, KV, hd)
    v: torch.Tensor     # (B, S_max, KV, hd)
    length: int         # tokens currently valid


class Attention(nn.Module):
    """The projections of one attention layer, in the reference's
    ``x @ w`` layout: ``wq`` ``(d, H*hd)``, ``wk``/``wv`` ``(d, KV*hd)``,
    ``wo`` ``(H*hd, d)``, and the optional QKV biases."""

    def __init__(self, d_model: int, n_heads: int, n_kv: int,
                 head_dim: int, qkv_bias: bool, *, device=None):
        super().__init__()
        kw = dict(device=device)
        self.wq = nn.Parameter(torch.empty(d_model, n_heads * head_dim, **kw))
        self.wk = nn.Parameter(torch.empty(d_model, n_kv * head_dim, **kw))
        self.wv = nn.Parameter(torch.empty(d_model, n_kv * head_dim, **kw))
        self.wo = nn.Parameter(torch.empty(n_heads * head_dim, d_model, **kw))
        if qkv_bias:
            self.bq = nn.Parameter(torch.zeros(n_heads * head_dim, **kw))
            self.bk = nn.Parameter(torch.zeros(n_kv * head_dim, **kw))
            self.bv = nn.Parameter(torch.zeros(n_kv * head_dim, **kw))
        else:
            self.bq = self.bk = self.bv = None


def _project_qkv(p: Attention, x, n_heads, n_kv, head_dim):
    B, S, _ = x.shape
    q, k, v = x @ p.wq, x @ p.wk, x @ p.wv
    if p.bq is not None:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    return (constrain(q.reshape(B, S, n_heads, head_dim),
                      "batch", "seq", "heads", None),
            constrain(k.reshape(B, S, n_kv, head_dim),
                      "batch", "seq", "heads", None),
            constrain(v.reshape(B, S, n_kv, head_dim),
                      "batch", "seq", "heads", None))


def _gqa_scores(q, k):
    """q: ``(B, Sq, H, hd)``, k: ``(B, Sk, KV, hd)`` -> ``(B, KV, g, Sq,
    Sk)`` scaled scores in the compute dtype."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    ct = compute_dtype(q)
    qg = q.reshape(B, Sq, KV, H // KV, hd).to(ct)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.to(ct))
    return s / math.sqrt(hd)


def _gqa_mix(probs, v):
    """probs: ``(B, KV, g, Sq, Sk)``, v: ``(B, Sk, KV, hd)`` ->
    ``(B, Sq, H*hd)``."""
    B, KV, g, Sq, _ = probs.shape
    o = torch.einsum("bkgqs,bskd->bqkgd", probs, v.to(probs.dtype))
    return o.reshape(B, Sq, KV * g * v.shape[-1])


def _causal_attend(q, k, v, positions, *, q_chunk, causal: bool = True):
    """Chunked-query softmax attention, causal unless ``causal=False``;
    returns ``(B, S, H*hd)`` in the compute dtype."""
    S = q.shape[1]
    c = min(q_chunk, S)
    outs = []
    for s0 in range(0, S, c):
        s = _gqa_scores(q[:, s0:s0 + c], k)           # (B, KV, g, c, S)
        if causal:
            pq = positions[:, s0:s0 + c]
            mask = (pq[:, None, None, :, None]
                    >= positions[:, None, None, None, :])
            s = s.masked_fill(~mask, float("-inf"))
        outs.append(_gqa_mix(torch.softmax(s, dim=-1), v))
    return outs[0] if len(outs) == 1 else torch.cat(outs, 1)


def causal_attention(p: Attention, x, positions, *, n_heads, n_kv, head_dim,
                     rope_theta, q_chunk: int = DEFAULT_Q_CHUNK,
                     causal: bool = True):
    """Full-sequence attention.  x: ``(B, S, D)``; positions: ``(B, S)``
    absolute positions (RoPE and the causal mask).  ``causal=False``
    lets every position see every other (the encoder's)."""
    q, k, v = _project_qkv(p, x, n_heads, n_kv, head_dim)
    q = rope(q, positions, rope_theta)
    k = rope(k, positions, rope_theta)
    out = _causal_attend(q, k, v, positions, q_chunk=q_chunk, causal=causal)
    return constrain(out.to(x.dtype) @ p.wo, "batch", "seq", None)


def init_cache(batch: int, s_max: int, n_kv: int, head_dim: int,
               dtype=torch.float32, device=None) -> KVCache:
    shape = (batch, s_max, n_kv, head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   length=0)


def prefill_into_cache(p: Attention, x, positions, cache: KVCache, *,
                       n_heads, n_kv, head_dim, rope_theta,
                       q_chunk: int = DEFAULT_Q_CHUNK):
    """Causal attention over the prompt, writing its k/v into the cache
    at ``[0, S)``.  A prompt longer than the cache raises ``ValueError``
    (the reference fails to trace its write)."""
    S = x.shape[1]
    if S > cache.k.shape[1]:
        raise ValueError(f"prefill of {S} positions does not fit the KV "
                         f"cache of {cache.k.shape[1]}")
    q, k, v = _project_qkv(p, x, n_heads, n_kv, head_dim)
    q = rope(q, positions, rope_theta)
    k = rope(k, positions, rope_theta)
    out = _causal_attend(q, k, v, positions, q_chunk=q_chunk)
    cache.k[:, :S] = k.to(cache.k.dtype)
    cache.v[:, :S] = v.to(cache.v.dtype)
    return out.to(x.dtype) @ p.wo, KVCache(cache.k, cache.v, S)


def decode_attention(p: Attention, x, cache: KVCache, *, n_heads, n_kv,
                     head_dim, rope_theta):
    """One-token decode: x ``(B, 1, D)`` attends to the cache.  The new
    k/v are written at ``cache.length``; the scores span the whole
    buffer, the slots past the new length masked."""
    B = x.shape[0]
    t = cache.length
    if t >= cache.k.shape[1]:
        raise ValueError(f"KV cache full: length {t} of {cache.k.shape[1]}")
    pos = torch.full((B, 1), t, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(p, x, n_heads, n_kv, head_dim)
    q = rope(q, pos, rope_theta)
    k = rope(k, pos, rope_theta)
    cache.k[:, t] = k[:, 0].to(cache.k.dtype)
    cache.v[:, t] = v[:, 0].to(cache.v.dtype)

    s = _gqa_scores(q.to(cache.k.dtype), cache.k)      # (B, KV, g, 1, S)
    s_pos = torch.arange(cache.k.shape[1], device=x.device)
    s = s.masked_fill(s_pos > t, float("-inf"))
    o = _gqa_mix(torch.softmax(s, dim=-1), cache.v)
    return o.to(x.dtype) @ p.wo, KVCache(cache.k, cache.v, t + 1)


# ---- cross attention (encoder-decoder) --------------------------------------

def cross_attention(p: Attention, x, enc, *, n_heads, n_kv, head_dim):
    """x ``(B, Sq, D)`` queries over the encoder states ``enc`` ``(B, Se,
    D)``: no rotation (the positions live in the encoder states) and no
    mask."""
    B, Sq, _ = x.shape
    Se = enc.shape[1]
    q = (x @ p.wq).reshape(B, Sq, n_heads, head_dim)
    k = (enc @ p.wk).reshape(B, Se, n_kv, head_dim)
    v = (enc @ p.wv).reshape(B, Se, n_kv, head_dim)
    o = _gqa_mix(torch.softmax(_gqa_scores(q, k), dim=-1), v)
    return o.to(x.dtype) @ p.wo
