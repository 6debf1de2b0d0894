"""Squared-L2 distance matrix: the CUDA kernel's wrapper and its plain
PyTorch version.

Port of ``repro.kernels.l2_distance`` (Pallas).  The kernel is
``csrc/l2_distance.cu``, with two main loops, each designed in its
header: the 32-row loop of ``csrc/distance_tile.cuh`` (shared with
distance_topk; the query tile resident in shared memory) and the
whole-bucket loop of ``csrc/l2_distance_wide.cuh`` (queries and points
streamed along d, each point byte read once a launch; its launches are
also counted apart, ``COUNT_WIDE``).  ``kernels/plan.py`` says which a
bucket takes, with its tile and blocks.

Both write bit-equal distances.  The kernel takes an optional ``(k, m)``
valid mask and writes +inf at masked points, without reading the points
of a tile that has none valid.  The plain version is the same contraction in
PyTorch (the dispatcher, ``kernels/ops.py``, masks its output); the
tests and ``chip_smoke.py`` hold the kernel against it, and the
dispatcher takes it only for CPU tensors.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, _cuda, plan, ref
from repro_torch.kernels import local_topk as _ltk

COUNT = _cuda.LaunchCounter("l2_distance")            # every launch
COUNT_WIDE = _cuda.LaunchCounter("l2_distance_wide")  # the B > 32 loop


def valid_flags(valid, k: int, m: int, device) -> torch.Tensor:
    """``(k, m)`` (or ``(m,)``) bool mask -> contiguous uint8 flags."""
    v = valid.to(device=device, dtype=torch.bool).reshape(k, m)
    return v.contiguous().view(torch.uint8)


def l2_distance_plain(queries: torch.Tensor, points: torch.Tensor):
    """``(B, d) x (..., m, d) -> (..., B, m)`` f32 squared distances."""
    return ref.l2_distance_ref(queries, points)


def l2_distance_cuda(queries: torch.Tensor, points: torch.Tensor,
                     valid=None):
    """The kernel: ``(B, d) x (m, d) -> (B, m)`` or
    ``(B, d) x (k, m, d) -> (k, B, m)``, all k shards in one launch;
    ``valid`` (``(m,)`` or ``(k, m)`` bool) writes +inf at masked points."""
    flat = points.dim() == 2
    p3 = points.unsqueeze(0) if flat else points
    _cuda.check_cuda("l2_distance", queries, p3)
    code = _cuda.dtype_code(queries, p3)
    if queries.dim() != 2 or p3.dim() != 3 or queries.shape[1] != p3.shape[2]:
        raise ValueError(f"l2_distance: shapes {tuple(queries.shape)} x "
                         f"{tuple(points.shape)} do not contract")
    B, d = queries.shape
    k, m, _ = p3.shape
    lp = plan.l2(B, d, p3.element_size(),
                 _ltk.sm_count(queries.device.index or 0))
    if lp.unsupported:
        raise ValueError(f"l2_distance: {lp.unsupported}")
    vf = None if valid is None else valid_flags(valid, k, m, queries.device)
    out = torch.empty((k, B, m), dtype=torch.float32, device=queries.device)
    if out.numel():
        lib = _build.library()
        args = (queries.data_ptr(), p3.data_ptr(),
                None if vf is None else vf.data_ptr(), out.data_ptr(), B, k,
                m, d, code)
        stream = _cuda.stream_of(queries)
        if lp.wide:
            _cuda.ok("l2_distance", lib.knn_l2_distance_wide(*args, lp.tile,
                                                             stream))
            COUNT_WIDE.add()
        else:
            _cuda.ok("l2_distance", lib.knn_l2_distance(*args, lp.blocks,
                                                        stream))
        COUNT.add()
    return out[0] if flat else out
