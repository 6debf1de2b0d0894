"""Algorithm 1's device loop: the CUDA kernel's wrapper.

The kernel is ``csrc/select_loop.cu``: one block a row runs the row's
whole selection loop, so a batch is one launch with no read back to the
host.  ``kernels/plan.py``'s ``select`` gives its block; the host loop of
``core/selection.py`` is the plain version, the CPU's path.  The draws
are Philox streams keyed by one seed that :func:`select_loop_cuda` draws
on the device from the batch's generator; the threshold is the rank-l
key whatever the draws, so it equals the host loop's.

``COUNT`` counts the kernel's launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, _cuda, plan

COUNT = _cuda.LaunchCounter("select_loop")

# the C ABI's key codes: knn::kF32, knn::kBF16, and select_loop.cu's kF16
_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_SEED_HIGH = 2**62


def select_loop_cuda(v, i, l, gen: torch.Generator, *, valid=None,
                     max_iterations: int, num_pivots: int = 1):
    """``(thr_v (B,), thr_i (B,) int32, converged (B,) bool, iterations
    (B,) int32)`` of Algorithm 1 over ``(k, B, m)`` keys ``v`` (f32, bf16
    or f16) and int32 ids ``i``, all on the device; ``l`` an int or a
    ``(B,)`` int tensor, ``valid`` ``(k, B, m)`` bool or None;
    ``num_pivots > 1`` evaluates every shard's proposal an iteration.  A
    row's iterations are those until it was done, ``max_iterations``
    where it was not."""
    _cuda.check_cuda("select_loop", v, i)
    if v.dtype not in _CODES:
        raise TypeError(f"select_loop: keys must be float32, bfloat16 or "
                        f"float16, got {v.dtype}")
    if i.dtype != torch.int32 or i.shape != v.shape or v.dim() != 3:
        raise ValueError(f"select_loop: keys {tuple(v.shape)} and ids "
                         f"{tuple(i.shape)} {i.dtype}: want (k, B, m), int32")
    k, B, m = v.shape
    pivots = 1 if num_pivots <= 1 else k
    sp = plan.select(k * m, v.element_size(), pivots)
    if sp.unsupported:
        raise ValueError(sp.unsupported)
    dev = v.device
    if valid is not None:
        valid = valid.to(torch.bool).expand(k, B, m).contiguous()
        _cuda.check_cuda("select_loop", v, valid)
    ls = None
    if not isinstance(l, int):
        ls = torch.as_tensor(l, dtype=torch.int32, device=dev).expand(
            B).contiguous()
        l = 0
    seed = torch.randint(0, _SEED_HIGH, (1,), generator=gen, device=dev)
    thr_v = torch.empty(B, dtype=v.dtype, device=dev)
    thr_i = torch.empty(B, dtype=torch.int32, device=dev)
    conv = torch.empty(B, dtype=torch.bool, device=dev)
    iters = torch.empty(B, dtype=torch.int32, device=dev)
    if B:
        _cuda.ok("select_loop", _build.library().knn_select_loop(
            v.data_ptr(), i.data_ptr(),
            None if valid is None else valid.data_ptr(),
            None if ls is None else ls.data_ptr(), l, seed.data_ptr(),
            thr_v.data_ptr(), thr_i.data_ptr(), conv.data_ptr(),
            iters.data_ptr(), B, k, m, int(max_iterations), sp.threads,
            sp.per, pivots, int(sp.smem_keys), _CODES[v.dtype],
            _cuda.stream_of(v)))
        COUNT.add()
    return thr_v, thr_i, conv, iters
