"""Where the port's entry points run, and how a knob of a later slice
of the port is refused."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``None`` means the card; a missing card is an error, never a
    quiet move to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "plain versions on the CPU")
    return dev


def later_slice(what: str, item: int, name: str):
    """Refuse a knob that a later slice of the port brings."""
    raise NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, queue 1, item {item}: "
        f"{name})")
