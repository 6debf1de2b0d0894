"""Learning-rate schedules (warmup + cosine decay).

Port of ``repro.optim.schedule``.  The arithmetic is f32 on 0-dim CPU
tensors, as the reference's is in ``jnp.float32``: a Python f64
schedule would drift from it in the last bits.  XLA's fused cosine and
the C library's differ by a few f32 ulps near the end of the decay.
"""

from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int,
                  total_steps: int, final_frac: float = 0.1) -> torch.Tensor:
    """The learning rate at ``step`` as a 0-dim f32 CPU tensor."""
    step = torch.as_tensor(step).to(torch.float32).cpu()
    # (step + 1): step 0 must already train (a zero first-step lr freezes
    # smoke tests and wastes the first global batch at scale)
    warm = peak_lr * (step + 1) / max(warmup_steps, 1)
    prog = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
    prog = prog.clamp(0.0, 1.0)
    cos = peak_lr * (final_frac + (1 - final_frac)
                     * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup_steps, warm, cos)
