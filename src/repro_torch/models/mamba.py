"""Mamba (S6) block: the selective state-space layer of the hybrid
family.

Port of ``repro.models.mamba``.  The prompt runs the reference's chunked
scan: chunks of ``DEFAULT_CHUNK`` tokens when the length divides by it,
else the whole sequence as one chunk, each chunk in log space with two
cumulative sums,

    L_t = cumsum(log dA),   h_t = exp(L_t) * (h_0 + cumsum(exp(-L_s) dBx_s)),

with ``exp(-L)`` clipped at ``e^35``, and the state carried from chunk to
chunk.  Decode is the exact one-step recurrence on a ``(B, d_inner,
d_state)`` state.  Where the in-chunk decay passes ``e^-35`` the clipped
prompt departs from that recurrence, as the reference's does.

The state and the conv tail are written into the cache in place, as the
KV cache is (``attention.py``).
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import NamedTuple

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.models import sharding as shd
from repro_torch.models.layers import compute_dtype, softplus
from repro_torch.models.sharding import constrain

DEFAULT_CHUNK = 16
CLIP = 35.0


class MambaCache(NamedTuple):
    conv: torch.Tensor  # (B, d_conv - 1, d_inner): depthwise conv tail
    ssm: torch.Tensor   # (B, d_inner, d_state): recurrent state, f32


class Mamba(nn.Module):
    """The block's parameters in the reference's layout (``x @ w``)."""

    def __init__(self, d_model: int, *, expand: int, d_state: int,
                 d_conv: int, device=None):
        super().__init__()
        kw = dict(device=device)
        di = expand * d_model
        r = max(16, d_model // 16)
        self.in_proj = nn.Parameter(torch.empty(d_model, 2 * di, **kw))
        self.conv_w = nn.Parameter(torch.empty(d_conv, di, **kw))
        self.conv_b = nn.Parameter(torch.zeros(di, **kw))
        self.x_proj = nn.Parameter(torch.empty(di, r + 2 * d_state, **kw))
        self.dt_proj = nn.Parameter(torch.empty(r, di, **kw))
        self.dt_bias = nn.Parameter(torch.empty(di, **kw))
        self.a_log = nn.Parameter(torch.empty(di, d_state, **kw))
        self.d_skip = nn.Parameter(torch.ones(di, **kw))
        self.out_proj = nn.Parameter(torch.empty(di, d_model, **kw))


def _ssm_inputs(p: Mamba, xs, *, d_state: int, log_space: bool = False):
    """xs ``(..., d_inner)`` post-conv activations -> ``(dA | log dA,
    dBx, C)``, in f32 (f64 for an f64 model)."""
    ct = compute_dtype(xs)
    r = p.dt_proj.shape[0]
    proj = xs @ p.x_proj                               # (..., r + 2 ds)
    dt = softplus((proj[..., :r] @ p.dt_proj + p.dt_bias).to(ct))
    Bm = proj[..., r:r + d_state].to(ct)
    Cm = proj[..., r + d_state:].to(ct)
    A = -torch.exp(p.a_log.to(ct))                     # (d_inner, ds)
    logdA = dt[..., None] * A
    dBx = (dt * xs.to(ct))[..., None] * Bm[..., None, :]
    if log_space:
        return logdA, dBx, Cm
    return torch.exp(logdA), dBx, Cm


def _conv1d(p: Mamba, x, tail=None):
    """Depthwise causal conv over ``(B, S, d_inner)``; ``tail`` is the
    cached ``(B, d_conv - 1, d_inner)`` prefix.  Returns the output and
    the new tail."""
    d_conv = p.conv_w.shape[0]
    if tail is None:
        tail = x.new_zeros(x.shape[0], d_conv - 1, x.shape[-1])
    xp = torch.cat([tail.to(x.dtype), x], 1)
    S = x.shape[1]
    out = xp[:, :S] * p.conv_w[0]
    for i in range(1, d_conv):
        out = out + xp[:, i:i + S] * p.conv_w[i]
    return out + p.conv_b, xp[:, -(d_conv - 1):]


_SSM_PARAMS = ("x_proj", "dt_proj", "dt_bias", "a_log")


def _chunked_ssm(p: Mamba, xs, *, d_state: int, chunk: int, h=None):
    """The selective scan over ``(B, S, d_inner)`` from state ``h`` (zeros
    when None): ``(y (B, S, d_inner) f32, final state (B, d_inner,
    d_state))``.  Each chunk's ``(B, c, d_inner, d_state)`` terms are made
    inside its step, never at full length.  Under a live mesh each rank
    scans its own rows as plain tensors with the scan's parameters
    gathered whole (the scan is row-local; the cumulative sums' gradient
    has no DTensor rule in every release)."""
    if shd.is_dtensor(xs):
        xs = shd.rows(xs)
        w = SimpleNamespace(**dict(zip(_SSM_PARAMS, shd.whole_for_rows(
            [getattr(p, n) for n in _SSM_PARAMS], xs.placements))))
        y, h = _chunked_ssm(w, xs.to_local(), d_state=d_state, chunk=chunk,
                            h=None if h is None else shd.local(
                                shd.to_layout(h, xs)))
        return shd.like(y, xs), shd.like(h, xs)
    B, S, di = xs.shape
    c = chunk if S % chunk == 0 else S
    if h is None:
        h = xs.new_zeros(B, di, d_state, dtype=compute_dtype(xs))
    ys = []
    for s0 in range(0, S, c):
        logdA, dBx, Cm = _ssm_inputs(p, xs[:, s0:s0 + c], d_state=d_state,
                                     log_space=True)
        L = torch.cumsum(logdA, 1)                     # (B, c, dI, ds) <= 0
        w = torch.exp(torch.clamp(-L, max=CLIP)) * dBx
        hs = torch.exp(L) * (h[:, None] + torch.cumsum(w, 1))
        ys.append(torch.einsum("bcds,bcs->bcd", hs, Cm))
        h = hs[:, -1]
    return (ys[0] if len(ys) == 1 else torch.cat(ys, 1)), h


def _gate_out(p: Mamba, y, xs, z, dtype):
    y = y + p.d_skip.to(y.dtype) * xs.to(y.dtype)
    y = constrain((y * F.silu(z.to(y.dtype))).to(dtype), "batch", "seq",
                  "mlp")
    return constrain(y @ p.out_proj, "batch", "seq", None)


def _mamba(p: Mamba, x, *, d_state: int, chunk: int):
    xs, z = (x @ p.in_proj).chunk(2, dim=-1)           # (B, S, d_inner)
    xs = constrain(xs, "batch", "seq", "mlp")
    xs, tail = _conv1d(p, xs)
    xs = F.silu(xs)
    y, h = _chunked_ssm(p, xs, d_state=d_state, chunk=chunk)
    return _gate_out(p, y, xs, z, x.dtype), tail, h


def mamba_block(p: Mamba, x, *, d_state: int, chunk: int = DEFAULT_CHUNK):
    """Train / full-sequence forward: x ``(B, S, D)`` -> ``(B, S, D)``."""
    return _mamba(p, x, d_state=d_state, chunk=chunk)[0]


def init_mamba_cache(batch: int, d_model: int, *, expand: int, d_state: int,
                     d_conv: int, dtype=torch.float32,
                     device=None) -> MambaCache:
    """Zero state: the conv tail in ``dtype``, the SSM state in f32 (f64
    for an f64 cache)."""
    di = expand * d_model
    return MambaCache(
        conv=torch.zeros(batch, d_conv - 1, di, dtype=dtype, device=device),
        ssm=torch.zeros(batch, di, d_state, device=device,
                        dtype=torch.promote_types(dtype, torch.float32)))


def mamba_prefill(p: Mamba, x, cache: MambaCache, *, d_state: int,
                  chunk: int = DEFAULT_CHUNK):
    """The prompt's forward, its final state and conv tail written into
    the cache."""
    out, tail, h = _mamba(p, x, d_state=d_state, chunk=chunk)
    cache.conv.copy_(shd.to_layout(tail, cache.conv))
    cache.ssm.copy_(shd.to_layout(h, cache.ssm))
    return out, cache


def mamba_decode_step(p: Mamba, x, cache: MambaCache, *, d_state: int):
    """x ``(B, 1, D)``, one token: the exact recurrence update."""
    xs, z = (x @ p.in_proj).chunk(2, dim=-1)
    xs, tail = _conv1d(p, xs, tail=cache.conv)
    xs = F.silu(xs)
    dA, dBx, Cm = _ssm_inputs(p, xs, d_state=d_state)  # (B, 1, dI, ds)
    h = dA[:, 0] * cache.ssm + dBx[:, 0]               # (B, dI, ds)
    y = torch.einsum("bds,bs->bd", h, Cm[:, 0])[:, None]
    out = _gate_out(p, y, xs, z, x.dtype)
    cache.conv.copy_(shd.to_layout(tail, cache.conv))
    cache.ssm.copy_(shd.to_layout(h, cache.ssm))
    return out, cache
