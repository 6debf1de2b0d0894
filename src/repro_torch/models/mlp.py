"""SwiGLU feed-forward (llama/qwen family).

Port of ``repro.models.mlp``.  The weights keep the reference's layout,
``x @ w`` with ``w_gate``/``w_up`` ``(d_model, d_ff)`` and ``w_down``
``(d_ff, d_model)``, so a converted tree is copied as it is.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F


def mlp(x, w_gate, w_up, w_down):
    h = F.silu(x @ w_gate) * (x @ w_up)
    return h @ w_down


class MLP(nn.Module):
    def __init__(self, d_model: int, d_ff: int, *, device=None):
        super().__init__()
        self.w_gate = nn.Parameter(torch.empty(d_model, d_ff, device=device))
        self.w_up = nn.Parameter(torch.empty(d_model, d_ff, device=device))
        self.w_down = nn.Parameter(torch.empty(d_ff, d_model, device=device))

    def forward(self, x):
        return mlp(x, self.w_gate, self.w_up, self.w_down)
