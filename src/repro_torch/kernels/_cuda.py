"""What every kernel wrapper shares: input checks, the launch stream,
the C call's error check and a launch counter."""

from __future__ import annotations

import threading

import torch

MAX_L = 256                         # the top-l kernels' largest l
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


# per thread: the tally that launches are counted apart into, or None
_APART = threading.local()


class LaunchCounter:
    """Plain integer count of a wrapper's kernel launches.  A launch made
    inside ``ops.counted_apart()`` on the same thread lands in that
    block's tally instead."""

    def __init__(self, name: str):
        self.name = name
        self.n = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        tally = getattr(_APART, "tally", None)
        if tally is not None:
            tally[self.name] = tally.get(self.name, 0) + 1
            return
        with self._lock:
            self.n += 1

    def reset(self) -> None:
        with self._lock:
            self.n = 0


def dtype_code(*tensors: torch.Tensor) -> int:
    """The C ABI's dtype code; inputs must share f32 or bf16."""
    dt = tensors[0].dtype
    if dt not in _DTYPES or any(t.dtype != dt for t in tensors):
        raise TypeError(f"kernel inputs must all be float32 or all "
                        f"bfloat16, got {[t.dtype for t in tensors]}")
    return _DTYPES[dt]


def check_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: all operands must be on one CUDA "
                             f"device, got {[x.device for x in tensors]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


def check_l(name: str, l: int) -> None:
    if not 1 <= l <= MAX_L:
        raise ValueError(f"{name}: l={l} outside [1, {MAX_L}] on the card")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def ok(name: str, rc: int) -> None:
    """Raise when the C entry point reports a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
