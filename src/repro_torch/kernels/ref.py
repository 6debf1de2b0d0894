"""Plain PyTorch oracles for the distance and top-l kernels.

The counterparts of ``repro.kernels.ref``: each ``*_ref`` is the semantic
ground truth the hand-written CUDA kernels are held to, in f32.  They
broadcast over leading dimensions, so one call covers all k shards of a
``(k, m, dim)`` point tensor.

Tie order: the reference takes ``lax.top_k`` of the negated input, which
puts equal values in ascending index order.  ``torch.topk`` promises no
order among ties, so the oracle sorts with ``stable=True`` and slices.
"""

from __future__ import annotations

import torch

INT32_MAX = 2**31 - 1


def l2_distance_ref(queries: torch.Tensor, points: torch.Tensor):
    """``(B, d) x (..., m, d) -> (..., B, m)`` squared L2, f32.

    Same contraction as the kernel: ``|q|^2 - 2 q.p + |p|^2``, clamped at
    zero (the expansion can go epsilon-negative in finite precision).
    """
    q = queries.float()
    p = points.float()
    q2 = (q * q).sum(-1, keepdim=True)                 # (B, 1)
    p2 = (p * p).sum(-1).unsqueeze(-2)                 # (..., 1, m)
    qp = torch.matmul(q, p.transpose(-1, -2))          # (..., B, m)
    return torch.clamp(q2 - 2.0 * qp + p2, min=0.0)


def local_topk_ref(values: torch.Tensor, l: int):
    """``(..., m) -> ((..., l) ascending values, (..., l) int32 indices)``.

    The l smallest per row; ties go to the smaller index.
    """
    if not 0 < l <= values.shape[-1]:
        raise ValueError(f"l={l} outside [1, m={values.shape[-1]}]")
    v, idx = torch.sort(values.float(), dim=-1, stable=True)
    return v[..., :l], idx[..., :l].to(torch.int32)


def distance_topk_ref(queries, points, l: int):
    """Fused oracle: the l smallest squared distances and point indices."""
    return local_topk_ref(l2_distance_ref(queries, points), l)


def masked_l2_distance_ref(queries, points, valid):
    """Masked distance oracle: invalid points come back as +inf.

    ``valid``: ``(..., m)`` bool, the mutable store's live-slot mask.
    """
    d = l2_distance_ref(queries, points)
    return torch.where(valid.bool().unsqueeze(-2), d,
                       torch.full_like(d, float("inf")))


def masked_distance_topk_ref(queries, points, valid, l: int):
    """Masked fused oracle: top-l over live slots only; +inf slots report
    the INT32_MAX sentinel id, so a deleted point's id never surfaces."""
    v, i = local_topk_ref(masked_l2_distance_ref(queries, points, valid), l)
    return v, torch.where(torch.isfinite(v), i,
                          torch.full_like(i, INT32_MAX))
