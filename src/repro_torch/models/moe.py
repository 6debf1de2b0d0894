"""Mixture-of-Experts FFN: token-choice top-k routing, capacity-bounded,
gather-based dispatch.

Port of ``repro.models.moe`` with one dispatch group, the reference's
``batch_shards()`` without a mesh (``models/sharding.py`` has the
count; dispatch in ``batch_shards()`` groups under a live mesh, with the
reference's ``constrain`` points, is not ported yet):

  1. router logits -> f32 softmax -> top-k (ties to the smaller expert
     id, :func:`route`), the gate values renormalised over the chosen k;
  2. the position of each ``(token, k)`` assignment within its expert
     by a token-major cumulative count; an assignment at position C
     (:func:`capacity`) or beyond is dropped, and the residual carries
     it;
  3. the kept token ids scattered into an ``(E, C)`` table and gathered
     into the ``(E, C, D)`` expert batch;
  4. the expert SwiGLU as batched products over the expert dimension;
  5. the combine: each token gathers its k ``(expert, slot)`` outputs,
     weights them by their gates and sums them over k.  The reference
     scatter-adds instead; on CUDA a floating-point scatter-add runs on
     atomics in no fixed order, and the gather makes a step replay bit
     for bit.

The reference pads the expert axis with dummy experts
(``expert_pad_to``) that the router never routes to; they exist to tile
its mesh, and ``convert.params_from_jax`` drops them, so the port holds
the ``n_experts`` real ones.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.models.layers import compute_dtype


class MoE(nn.Module):
    """Router ``(d, E)``; ``w_gate`` / ``w_up`` ``(E, d, f)``, ``w_down``
    ``(E, f, d)``, the reference's layout."""

    def __init__(self, d_model: int, d_ff: int, n_experts: int, *,
                 device=None):
        super().__init__()
        kw = dict(device=device)
        e = n_experts
        self.router = nn.Parameter(torch.empty(d_model, e, **kw))
        self.w_gate = nn.Parameter(torch.empty(e, d_model, d_ff, **kw))
        self.w_up = nn.Parameter(torch.empty(e, d_model, d_ff, **kw))
        self.w_down = nn.Parameter(torch.empty(e, d_ff, d_model, **kw))


def capacity(n_tokens: int, n_experts: int, top_k: int,
             capacity_factor: float) -> int:
    """Slots an expert holds: ``ceil(N k cf / E)``, padded up to a
    multiple of 8 and at least 8."""
    c = int(math.ceil(n_tokens * top_k * capacity_factor / n_experts))
    return max(8, ((c + 7) // 8) * 8)


def route(probs: torch.Tensor, top_k: int):
    """``probs`` ``(N, E)`` -> ``(gate_vals (N, k), expert_idx (N, k))``:
    each row's k largest probabilities in descending order, ties to the
    smaller expert id (``lax.top_k``'s order, by a stable sort), the
    gates renormalised to sum to 1."""
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals = srt.values[:, :top_k]
    expert_idx = srt.indices[:, :top_k]
    return gate_vals / gate_vals.sum(-1, keepdim=True), expert_idx


def assign(expert_idx: torch.Tensor, n_experts: int, cap: int):
    """Each ``(token, k)`` assignment's position within its expert, in
    token-major then k order, and whether it is kept (position < cap).
    ``expert_idx`` ``(N, k)`` -> ``(pos (N, k), keep (N, k))``."""
    flat = F.one_hot(expert_idx.reshape(-1), n_experts)     # (N*k, E)
    pos = torch.cumsum(flat, 0) - flat
    pos = (pos * flat).sum(-1).reshape(expert_idx.shape)
    return pos, pos < cap


def moe_ffn(p: MoE, x, *, n_experts: int, top_k: int,
            capacity_factor: float = 1.25):
    """x ``(B, S, D)`` -> ``(y (B, S, D), aux_loss)``."""
    B, S, D = x.shape
    N = B * S
    xt = x.reshape(N, D)
    ct = compute_dtype(x)
    probs = torch.softmax((xt @ p.router).to(ct), dim=-1)     # (N, E)
    gate_vals, expert_idx = route(probs, top_k)

    # load-balance auxiliary loss (Switch): E * sum_e f_e * p_e
    me = probs.mean(0)
    ce = F.one_hot(expert_idx[:, 0], n_experts).to(ct).mean(0)
    aux = n_experts * torch.sum(me * ce)

    C = capacity(N, n_experts, top_k, capacity_factor)
    pos, keep = assign(expert_idx, n_experts, C)
    # slot e * C + pos of the (E * C) expert batch; the dropped ones
    # point at slot E * C, a zero row
    slot = torch.where(keep, expert_idx * C + pos,
                       torch.full_like(pos, n_experts * C))
    table = torch.full((n_experts * C + 1,), N, dtype=torch.int64,
                       device=x.device)
    table[slot.reshape(-1)] = torch.arange(
        N, device=x.device).repeat_interleave(top_k)
    table = table[:-1]

    xpad = torch.cat([xt, xt.new_zeros(1, D)])                # (N + 1, D)
    ex_in = xpad[table].reshape(n_experts, C, D)
    h = F.silu(torch.bmm(ex_in, p.w_gate)) * torch.bmm(ex_in, p.w_up)
    ex_out = torch.bmm(h, p.w_down).reshape(n_experts * C, D)
    ex_out = torch.cat([ex_out, ex_out.new_zeros(1, D)])
    g = torch.where(keep, gate_vals, torch.zeros_like(gate_vals))
    y = (ex_out[slot] * g.to(ex_out.dtype).unsqueeze(-1)).sum(1)
    return y.reshape(B, S, D).to(x.dtype), aux
