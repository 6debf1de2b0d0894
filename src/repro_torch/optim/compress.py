"""Gradient compression with error feedback.

Port of ``repro.optim.compress``: gradients are cast to bf16 (halving
the bytes a data-parallel reduction would move) while the quantization
error is kept in a bf16 residual and added back the next step, so the
sum of the compressed gradients tracks the sum of the raw ones.  A tree
is a dict of name -> tensor.  Torch's f32 -> bf16 cast rounds to
nearest even, as XLA's does, so both packages give the same bits.

    grads_c, new_residual = compress(grads, residual)
"""

from __future__ import annotations

import torch


def init_residual(params: dict) -> dict:
    return {k: torch.zeros_like(p, dtype=torch.bfloat16, requires_grad=False)
            for k, p in params.items()}


@torch.no_grad()
def compress(grads: dict, residual: dict):
    """Returns ``(bf16 gradients to feed the optimizer, updated
    residual)``."""
    qs, rs = {}, {}
    for k, g in grads.items():
        corrected = g.float() + residual[k].float()
        qs[k] = corrected.to(torch.bfloat16)
        rs[k] = (corrected - qs[k].float()).to(torch.bfloat16)
    return qs, rs
