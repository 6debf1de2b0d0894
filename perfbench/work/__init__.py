"""The operations and bytes of one step, one file each, and the chip's
published peaks (``peaks.json``)."""

from __future__ import annotations

import json
from pathlib import Path


def peaks() -> dict:
    with open(Path(__file__).resolve().parent / "peaks.json") as f:
        return json.load(f)


def bound_s(flops: float, nbytes: float, pk: dict) -> float:
    """The least time the chip could take: the larger of the operations
    over the f32 peak and the bytes over the memory's peak."""
    return max(flops / pk["f32_flops_per_s"], nbytes / pk["hbm_bytes_per_s"])
