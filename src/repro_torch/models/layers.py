"""Shared layers: RMS norm, embedding, unembedding and RoPE.

Port of ``repro.models.layers``.  Plain functions on tensors, plus the
norm as an ``nn.Module`` holding its scale.  Arithmetic that the
reference does in f32 is done in f32 here, or in f64 when the input is
f64 (``compute_dtype``), so one model can also run as its own f64
reference.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.sharding import constrain


def compute_dtype(x: torch.Tensor) -> torch.dtype:
    """f32, or f64 for f64 inputs: the precision the reference keeps for
    norms, RoPE and attention scores."""
    return torch.promote_types(x.dtype, torch.float32)


# ---- norms ----------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * scale`` in f32, cast back to x's
    dtype."""
    xf = x.to(compute_dtype(x))
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.to(xf.dtype)
    return out.to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float = 1e-6, *, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(d, device=device))

    def forward(self, x):
        return rmsnorm(x, self.scale, self.eps)


# ---- embedding / unembedding -----------------------------------------------

def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``(V, d)`` table, int tokens ``(B, S)`` -> ``(B, S, d)`` rows."""
    return constrain(table[tokens.long()], "batch", "seq", None)


def unembed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``(..., d) x (V, d) -> (..., V)`` vocabulary logits (a tied table
    is the embedding's)."""
    return constrain(torch.matmul(x, table.t()), "batch", "seq", "vocab")


# ---- rotary position embedding ---------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """``x``: ``(..., S, H, head_dim)``; ``positions``: broadcastable to
    ``(..., S)``.  Half-split layout: dims ``[0, half)`` pair with
    ``[half, head_dim)``, as in the reference."""
    head_dim = x.shape[-1]
    half = head_dim // 2
    ct = compute_dtype(x)
    freqs = torch.pow(theta, -torch.arange(0, half, dtype=ct,
                                           device=x.device) / half)
    angles = positions.unsqueeze(-1).to(ct) * freqs       # (..., S, half)
    cos = torch.cos(angles).unsqueeze(-2)                 # (..., S, 1, half)
    sin = torch.sin(angles).unsqueeze(-2)
    x1 = x[..., :half].to(ct)
    x2 = x[..., half:].to(ct)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


# ---- loss -------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean negative log-likelihood of ``labels`` under ``logits`` (B, S,
    V), in f32 (f64 for f64 logits): logsumexp minus the label's logit.
    With ``mask`` (B, S), the sum over valid tokens over the mask's sum,
    floored at 1.  Under a mesh the logits stay vocabulary-sharded; the
    log-sum-exp and the label's logit are reduced over the shards."""
    logits = logits.to(compute_dtype(logits))
    m = constrain(torch.logsumexp(logits, dim=-1), "batch", "seq")
    label_logit = constrain(logits.gather(-1, labels.long().unsqueeze(-1)),
                            "batch", "seq", None)[..., 0]
    nll = m - label_logit
    if mask is not None:
        mask = mask.to(nll.dtype)
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
