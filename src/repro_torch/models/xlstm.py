"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory).

Port of ``repro.models.xlstm``.

* mLSTM runs the reference's chunked parallel form: chunks of
  ``MLSTM_CHUNK`` tokens when the length divides by it, else one chunk;
  inside a chunk a quadratic gated attention with cumulative log forget
  gates, across chunks the ``(B, H, dh, dh)`` memory and ``(B, H, dh)``
  normaliser carried; ``den = max(|n . q|, 1)``.  Decode is the one-step
  recurrence.
* sLSTM is sequential: exponential gating with a max stabiliser whose
  state starts at ``m = 0``.  The input's gate products ``x @ w_gates``
  are made for the whole prompt in one product, so each step is the
  recurrent product and the gate arithmetic.

Both blocks are pre-norm residual blocks with their own up and down
projections (``d_ff = 0``: no separate FFN).  The states are written
into their caches in place, as the KV cache is (``attention.py``).
Under a live mesh the sLSTM's per-token loop runs on each rank's own
rows as plain tensors (:func:`_slstm_scan_rows`), since DTensor's
dispatch on each of its small ops would cost more than the ops.
"""

from __future__ import annotations

import math
from types import SimpleNamespace
from typing import NamedTuple

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.models import sharding as shd
from repro_torch.models.layers import compute_dtype, log_sigmoid
from repro_torch.models.sharding import constrain

MLSTM_CHUNK = 64


class MLstmCache(NamedTuple):
    c: torch.Tensor   # (B, H, dh, dh) matrix memory, f32
    n: torch.Tensor   # (B, H, dh) normaliser, f32


class SLstmCache(NamedTuple):
    c: torch.Tensor   # (B, H, dh) cell, f32
    n: torch.Tensor   # (B, H, dh) normaliser, f32
    h: torch.Tensor   # (B, H, dh) hidden (recurrent input), f32
    m: torch.Tensor   # (B, H, dh) max stabiliser, f32


def _round8(x: int) -> int:
    return max(8, (x // 8) * 8)


def mlstm_width(d_model: int, proj_factor: float) -> int:
    return _round8(int(d_model * proj_factor))


# ---------------------------------------------------------------- mLSTM ----

class MLstm(nn.Module):
    def __init__(self, d_model: int, n_heads: int, proj_factor: float, *,
                 device=None):
        super().__init__()
        kw = dict(device=device)
        dp = mlstm_width(d_model, proj_factor)
        self.up = nn.Parameter(torch.empty(d_model, 2 * dp, **kw))
        self.wq = nn.Parameter(torch.empty(dp, dp, **kw))
        self.wk = nn.Parameter(torch.empty(dp, dp, **kw))
        self.wv = nn.Parameter(torch.empty(dp, dp, **kw))
        self.w_i = nn.Parameter(torch.zeros(dp, n_heads, **kw))
        self.b_i = nn.Parameter(torch.zeros(n_heads, **kw))
        self.w_f = nn.Parameter(torch.zeros(dp, n_heads, **kw))
        self.b_f = nn.Parameter(torch.ones(n_heads, **kw))
        self.down = nn.Parameter(torch.empty(dp, d_model, **kw))


def _mlstm_qkvg(p: MLstm, x, n_heads: int):
    B, S, _ = x.shape
    xi, z = (x @ p.up).chunk(2, dim=-1)                 # (B, S, dp)
    dh = xi.shape[-1] // n_heads
    ct = compute_dtype(x)
    q = (xi @ p.wq).reshape(B, S, n_heads, dh)
    k = (xi @ p.wk).reshape(B, S, n_heads, dh) / math.sqrt(dh)
    v = (xi @ p.wv).reshape(B, S, n_heads, dh)
    logf = log_sigmoid((xi @ p.w_f).to(ct) + p.b_f.to(ct))   # (B, S, H)
    logi = (xi @ p.w_i).to(ct) + p.b_i.to(ct)
    return q, k, v, logf, logi, z


def _mlstm_chunks(q, k, v, logf, logi, *, chunk: int):
    """The chunked parallel mLSTM from a zero state -> ``(B, S, H*dh)``
    in the compute dtype.  Under a live mesh each rank runs the chunks
    of its own rows as plain tensors (the recurrence is row-local; the
    cumulative sums' gradient has no DTensor rule in every release)."""
    if shd.is_dtensor(q):
        ref = shd.rows(logf)
        y = _mlstm_chunks(*(shd.local(shd.rows(t)) for t in (
            q, k, v, logf, logi)), chunk=chunk)
        return shd.like(y, ref)
    B, S, H, dh = q.shape
    ct = logf.dtype
    c = chunk if S % chunk == 0 else S
    C0 = q.new_zeros(B, H, dh, dh, dtype=ct)
    n0 = q.new_zeros(B, H, dh, dtype=ct)
    idx = torch.arange(c, device=q.device)
    causal = (idx[:, None] >= idx[None, :])[None, :, :, None]
    ys = []
    for s0 in range(0, S, c):
        sl = slice(s0, s0 + c)
        qc, kc, vc = q[:, sl].to(ct), k[:, sl].to(ct), v[:, sl].to(ct)
        lf, li = logf[:, sl], logi[:, sl]
        Fc = torch.cumsum(lf, 1)                        # (B, c, H)
        tot = Fc[:, -1]                                 # (B, H)
        qd = qc * torch.exp(Fc)[..., None]
        inter = torch.einsum("bche,bhef->bchf", qd, C0)
        inter_n = torch.einsum("bche,bhe->bch", qd, n0)
        # intra-chunk weight(t, s) = exp(F_t - F_s + logi_s), s <= t
        w = Fc[:, :, None, :] - Fc[:, None, :, :] + li[:, None, :, :]
        a = torch.exp(w.masked_fill(~causal, float("-inf")))  # (B,c,c,H)
        scores = torch.einsum("bche,bshe->bcsh", qc, kc) * a
        num = inter + torch.einsum("bcsh,bshe->bche", scores, vc)
        den = torch.abs(inter_n + scores.sum(2))         # (B, c, H)
        ys.append(num / torch.clamp(den, min=1.0)[..., None])
        decay_tot = torch.exp(tot)
        kg = kc * torch.exp(tot[:, None] - Fc + li)[..., None]
        C0 = C0 * decay_tot[..., None, None] + torch.einsum(
            "bche,bchf->bhef", kg, vc)
        n0 = n0 * decay_tot[..., None] + kg.sum(1)
    y = ys[0] if len(ys) == 1 else torch.cat(ys, 1)
    return y.reshape(B, S, H * dh)


def _mlstm_out(p: MLstm, y, z):
    return constrain((y * F.silu(z)) @ p.down, "batch", "seq", None)


def mlstm_block(p: MLstm, x, *, n_heads: int, chunk: int = MLSTM_CHUNK):
    """Chunked parallel mLSTM: x ``(B, S, D)`` -> ``(B, S, D)``."""
    q, k, v, logf, logi, z = _mlstm_qkvg(p, x, n_heads)
    y = _mlstm_chunks(q, k, v, logf, logi, chunk=chunk)
    return _mlstm_out(p, y.to(x.dtype), z)


def init_mlstm_cache(batch: int, d_model: int, n_heads: int,
                     proj_factor: float, *, dtype=torch.float32,
                     device=None) -> MLstmCache:
    dh = mlstm_width(d_model, proj_factor) // n_heads
    ct = torch.promote_types(dtype, torch.float32)
    return MLstmCache(
        c=torch.zeros(batch, n_heads, dh, dh, dtype=ct, device=device),
        n=torch.zeros(batch, n_heads, dh, dtype=ct, device=device))


def mlstm_prefill(p: MLstm, x, cache: MLstmCache, *, n_heads: int,
                  chunk: int = MLSTM_CHUNK):
    """The chunked forward, then the final ``(C, n)`` rebuilt from the
    cache's state over the whole prompt in one step (the reference's
    ``transformer._mlstm_prefill``), written into the cache."""
    q, k, v, logf, logi, z = _mlstm_qkvg(p, x, n_heads)
    y = _mlstm_chunks(q, k, v, logf, logi, chunk=chunk)
    ct = logf.dtype
    kc, vc = k.to(ct), v.to(ct)
    Fc = torch.cumsum(logf, 1)
    tot = Fc[:, -1]                                     # (B, H)
    kg = kc * torch.exp(tot[:, None] - Fc + logi)[..., None]
    cache.c.copy_(cache.c * torch.exp(tot)[..., None, None] + torch.einsum(
        "bshe,bshf->bhef", kg, vc))
    cache.n.copy_(cache.n * torch.exp(tot)[..., None] + kg.sum(1))
    return _mlstm_out(p, y.to(x.dtype), z), cache


def mlstm_decode_step(p: MLstm, x, cache: MLstmCache, *, n_heads: int):
    B = x.shape[0]
    q, k, v, logf, logi, z = _mlstm_qkvg(p, x, n_heads)
    ct = logf.dtype
    qc, kc, vc = q[:, 0].to(ct), k[:, 0].to(ct), v[:, 0].to(ct)  # (B, H, dh)
    f = torch.exp(logf[:, 0])[..., None]                # (B, H, 1)
    i = torch.exp(logi[:, 0])[..., None]
    C1 = cache.c * f[..., None] + i[..., None] * (
        kc[..., :, None] * vc[..., None, :])
    n1 = cache.n * f + i * kc
    num = torch.einsum("bhe,bhef->bhf", qc, C1)
    den = torch.abs(torch.einsum("bhe,bhe->bh", qc, n1))
    y = (num / torch.clamp(den, min=1.0)[..., None]).reshape(B, 1, -1)
    cache.c.copy_(C1)
    cache.n.copy_(n1)
    return _mlstm_out(p, y.to(x.dtype), z), cache


# ---------------------------------------------------------------- sLSTM ----

class SLstm(nn.Module):
    def __init__(self, d_model: int, n_heads: int, proj_factor: float, *,
                 device=None):
        super().__init__()
        kw = dict(device=device)
        dp = mlstm_width(d_model, proj_factor)
        self.w_gates = nn.Parameter(torch.empty(d_model, 4 * d_model, **kw))
        self.r_gates = nn.Parameter(torch.empty(d_model, 4 * d_model, **kw))
        self.b_gates = nn.Parameter(torch.zeros(4 * d_model, **kw))
        self.up = nn.Parameter(torch.empty(d_model, dp, **kw))
        self.down = nn.Parameter(torch.empty(dp, d_model, **kw))


def init_slstm_state(batch: int, d_model: int, n_heads: int, *,
                     dtype=torch.float32, device=None) -> SLstmCache:
    """Zero state (``m = 0``, as the reference starts it), f32 (f64 for an
    f64 ``dtype``)."""
    shp = (batch, n_heads, d_model // n_heads)
    ct = torch.promote_types(dtype, torch.float32)
    return SLstmCache(*(torch.zeros(shp, dtype=ct, device=device)
                        for _ in range(4)))


def _slstm_step(p: SLstm, xw_t, state: SLstmCache, n_heads: int):
    """One timestep from ``xw_t = x_t @ w_gates`` ``(B, 4D)``."""
    B, D4 = xw_t.shape
    D = D4 // 4
    h_prev = state.h.reshape(B, D).to(xw_t.dtype)
    gates = torch.addmm(xw_t, h_prev, p.r_gates).to(state.c.dtype) \
        + p.b_gates.to(state.c.dtype)
    zi, ii, fi, oi = (t.reshape(B, n_heads, D // n_heads)
                      for t in gates.chunk(4, dim=-1))
    zi = torch.tanh(zi)
    o = torch.sigmoid(oi)
    logf_m = log_sigmoid(fi) + state.m
    m_new = torch.maximum(logf_m, ii)
    i_g = torch.exp(ii - m_new)
    f_g = torch.exp(logf_m - m_new)
    c_new = f_g * state.c + i_g * zi
    n_new = f_g * state.n + i_g
    h_new = o * c_new / torch.clamp(torch.abs(n_new), min=1e-6)
    return SLstmCache(c=c_new, n=n_new, h=h_new, m=m_new)


def _slstm_scan(p: SLstm, x, state: SLstmCache | None, n_heads: int):
    """Steps over ``(B, S, D)`` from ``state`` (zeros when None) ->
    ``(hs (B, S, D) in x's dtype, final state)``."""
    B, S, D = x.shape
    xw = x @ p.w_gates                                  # (B, S, 4D)
    if shd.is_dtensor(xw):
        return _slstm_scan_rows(p, xw, state, n_heads, x.dtype)
    if state is None:
        state = init_slstm_state(B, D, n_heads, dtype=x.dtype,
                                 device=x.device)
    hs = []
    for t in range(S):
        state = _slstm_step(p, xw[:, t], state, n_heads)
        hs.append(state.h.reshape(B, D))
    return torch.stack(hs, 1).to(x.dtype), state


def _slstm_scan_rows(p: SLstm, xw, state, n_heads: int, dtype):
    """The loop of a sharded model.  Each of its S steps is a dozen small
    ops, and each would pay DTensor's dispatch, so every rank steps its
    own rows (``xw``'s block on the batch axes) as plain tensors, the
    same recurrence: the recurrent weights gathered once (their gradient
    comes back ``Partial`` over the batch axes and is summed into the
    parameters' shards), the outputs and the final state returned as
    DTensors laid out by those rows."""
    xw = shd.rows(xw)
    w = SimpleNamespace(**dict(zip(("r_gates", "b_gates"), shd.whole_for_rows(
        (p.r_gates, p.b_gates), xw.placements))))
    xl = xw.to_local()
    B, S, D = xl.shape[0], xl.shape[1], xl.shape[2] // 4
    if state is None:
        st = init_slstm_state(B, D, n_heads, dtype=dtype, device=xl.device)
    else:
        st = SLstmCache(*(shd.local(shd.to_layout(t, xw)) for t in state))
    hs = []
    for t in range(S):
        st = _slstm_step(w, xl[:, t], st, n_heads)
        hs.append(st.h.reshape(B, D))
    return (shd.like(torch.stack(hs, 1).to(dtype), xw),
            SLstmCache(*(shd.like(t, xw) for t in st)))


def _slstm_out(p: SLstm, y):
    return constrain(F.silu(y @ p.up) @ p.down, "batch", "seq", None)


def slstm_block(p: SLstm, x, *, n_heads: int):
    """Sequential sLSTM over ``(B, S, D)`` from the zero state."""
    return _slstm_out(p, _slstm_scan(p, x, None, n_heads)[0])


def slstm_prefill(p: SLstm, x, cache: SLstmCache, *, n_heads: int):
    """The prompt stepped from the cache's state; the final state written
    into the cache."""
    hs, final = _slstm_scan(p, x, cache, n_heads)
    for dst, src in zip(cache, final):
        dst.copy_(shd.to_layout(src, dst))
    return _slstm_out(p, hs), cache


def slstm_decode_step(p: SLstm, x, cache: SLstmCache, *, n_heads: int):
    B, _, D = x.shape
    new = _slstm_step(p, x[:, 0] @ p.w_gates, cache, n_heads)
    for dst, src in zip(cache, new):
        dst.copy_(src)
    return _slstm_out(p, new.h.reshape(B, 1, D).to(x.dtype)), cache
