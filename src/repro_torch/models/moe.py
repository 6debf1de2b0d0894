"""Mixture-of-Experts FFN: token-choice top-k routing, capacity-bounded,
gather-based dispatch in batch-shard groups.

Port of ``repro.models.moe``.  The tokens are cut into G groups, G the
reference's: ``batch_shards()`` (the mesh shards the batch axes span, 1
without a mesh) halved until it divides the token count N, and 1 when a
group would hold fewer than 64 tokens (:func:`groups`).  Within each
group, on its own:

  1. router logits -> f32 softmax -> top-k (ties to the smaller expert
     id, :func:`route`), the gate values renormalised over the chosen k;
  2. the position of each ``(token, k)`` assignment within its expert
     by a token-major cumulative count over the group; an assignment at
     position C (:func:`capacity` of the group's tokens) or beyond is
     dropped, and the residual carries it;
  3. the kept token ids scattered into a table and gathered into the
     group's C slots of each expert: an ``(E, G*C, D)`` expert batch,
     expert e's slots for group g at ``[g*C, (g+1)*C)``;
  4. the expert SwiGLU as batched products over the expert dimension;
  5. the combine: each token gathers its k ``(expert, slot)`` outputs,
     weights them by their gates and sums them over k.  The reference
     scatter-adds instead; on CUDA a floating-point scatter-add runs on
     atomics in no fixed order, and the gather makes a step replay bit
     for bit.

The aux loss is the Switch load-balance loss over all N tokens.  Under
a live mesh the groups are split over the batch axes (the reference's
``constrain`` points): steps 1-3 and 5 run on each rank's own groups as
plain tensors (``sharding.local`` / ``sharding.like``), since DTensor
has no rule for their scatter and gathers, and the expert batch moves
to ``experts`` on ``model`` and back by explicit redistributions around
step 4.  With G = 1 the dispatch is one group over all tokens.

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

from repro_torch.models import sharding as shd
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


def groups(n_tokens: int) -> int:
    """The dispatch group count G of ``n_tokens`` under the ambient mesh
    and rules (the reference's ``moe.py:81-89``)."""
    g = shd.batch_shards()
    while n_tokens % g:
        g //= 2
    return 1 if n_tokens // g < 64 else g


def route(probs: torch.Tensor, top_k: int):
    """``probs`` ``(..., E)`` -> ``(gate_vals (..., k), expert_idx (...,
    k))``:
    each row's k largest probabilities in descending order, ties to the
    smaller expert id (``lax.top_k``'s order, by a stable sort), the
    gates renormalised to sum to 1."""
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals = srt.values[..., :top_k]
    expert_idx = srt.indices[..., :top_k]
    return gate_vals / gate_vals.sum(-1, keepdim=True), expert_idx


def assign(expert_idx: torch.Tensor, n_experts: int, cap: int):
    """Each ``(token, k)`` assignment's position within its expert, in
    token-major then k order within its group, and whether it is kept
    (position < cap).  ``expert_idx`` ``(N, k)`` (one group) or ``(G,
    Ng, k)`` -> ``(pos, keep)`` of its shape."""
    flat = F.one_hot(expert_idx.flatten(-2), n_experts)     # (..., Ng*k, E)
    pos = torch.cumsum(flat, -2) - flat
    pos = (pos * flat).sum(-1).reshape(expert_idx.shape)
    return pos, pos < cap


def _groups_at(ref, dim: int) -> list:
    """``ref``'s placements (its group dim 0 split over the batch axes,
    or not) with the group dim at ``dim``."""
    from torch.distributed.tensor import Shard
    return [Shard(dim) if p.is_shard() else p for p in ref.placements]


def _regroup(x, G: int, gax):
    """x ``(B, S, D)`` -> ``(xt (G, Ng, D), rows)``.  Under a live mesh
    ``rows`` is x redistributed so that each rank's block of rows is the
    tokens of its own groups (the reference's ``constrain(xt, gax, None,
    None)``; all of them when B does not divide over the batch shards),
    and ``xt`` that block regrouped, as a DTensor with ``rows``'s
    placements: no DTensor view crosses the batch dim."""
    B, S, D = x.shape
    if not shd.is_dtensor(x):
        return x.reshape(G, B * S // G, D), None
    from torch.distributed.tensor import Replicate
    mesh = x.device_mesh
    want = shd.placements(shd.divisible(shd.spec(gax, None, None),
                                        (G, B * S // G, D), mesh), mesh)
    ways = math.prod(n for n, p in zip(mesh.shape, want) if p.is_shard())
    if B % ways:
        want = [Replicate()] * len(want)
    rows = x if tuple(x.placements) == tuple(want) else x.redistribute(
        mesh, want)
    return shd.like(shd.local(rows).reshape(-1, B * S // G, D), rows), rows


def moe_ffn(p: MoE, x, *, n_experts: int, top_k: int,
            capacity_factor: float = 1.25):
    """x ``(B, S, D)`` -> ``(y (B, S, D), aux_loss)``."""
    B, S, D = x.shape
    N, E = B * S, n_experts
    G = groups(N)
    Ng = N // G
    gax = "batch" if G > 1 else None      # never shard a size-1 group dim
    xt, rows = _regroup(x, G, gax)
    ct = compute_dtype(x)
    probs = shd.to_layout(torch.softmax((xt @ p.router).to(ct), dim=-1),
                          xt)                                  # (G, Ng, E)
    C = capacity(Ng, E, top_k, capacity_factor)

    # this rank's groups (all G without a mesh): route and place
    lp = shd.local(probs)
    Gl = lp.shape[0]
    gate_vals, expert_idx = route(lp, top_k)                   # (Gl, Ng, k)
    # load-balance auxiliary loss (Switch): E * sum_e f_e * p_e, over all
    # N tokens
    me = probs.mean((0, 1))
    ce = shd.like(F.one_hot(expert_idx[..., 0], E).to(ct), probs)
    aux = E * torch.sum(me * ce.mean((0, 1)))

    pos, keep = assign(expert_idx, E, C)
    # slot e * Gl*C + g * C + pos of the (E, Gl*C) expert batch; the
    # dropped ones point at slot E * Gl*C, a zero row
    dev = lp.device
    base = expert_idx * (Gl * C) + pos
    if Gl > 1:
        base = base + (torch.arange(Gl, device=dev) * C)[:, None, None]
    slot = torch.where(keep, base, torch.full_like(pos, E * Gl * C))
    table = torch.full((E * Gl * C + 1,), Gl * Ng, dtype=torch.int64,
                       device=dev)
    table[slot.reshape(-1)] = torch.arange(
        Gl * Ng, device=dev).repeat_interleave(top_k)
    table = table[:-1]

    xl = shd.local(xt).reshape(Gl * Ng, D)
    xpad = torch.cat([xl, xl.new_zeros(1, D)])                # (Gl*Ng+1, D)
    ex_in = shd.like(xpad[table].reshape(E, Gl * C, D), xt,
                     _groups_at(xt, 1) if shd.is_dtensor(xt) else None)
    grouped = ex_in
    ex_in = shd.constrain(ex_in, "experts", gax, None)
    h = F.silu(torch.bmm(ex_in, p.w_gate)) * torch.bmm(ex_in, p.w_up)
    ex_out = shd.constrain(torch.bmm(h, p.w_down), "experts", gax, None)
    ex_out = shd.local(shd.to_layout(ex_out, grouped))
    ex_out = ex_out.reshape(E * Gl * C, D)
    ex_out = torch.cat([ex_out, ex_out.new_zeros(1, D)])
    g = torch.where(keep, gate_vals, torch.zeros_like(gate_vals))
    y = (ex_out[slot] * g.to(ex_out.dtype).unsqueeze(-1)).sum(-2)
    if rows is None:
        return y.reshape(B, S, D).to(x.dtype), aux
    y = shd.like(y.reshape(-1, S, D).to(x.dtype), rows)
    return shd.constrain(y, "batch", "seq", None), aux
