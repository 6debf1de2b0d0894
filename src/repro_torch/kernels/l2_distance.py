"""Squared-L2 distance matrix: the CUDA kernel's wrapper and its plain
PyTorch version.

Port of ``repro.kernels.l2_distance`` (Pallas).  The kernel is
``csrc/l2_distance.cu``; its note says what bounds it on the card.  The
plain version is the same contraction in PyTorch; the tests and
``chip_smoke.py`` hold the kernel against it, and the dispatcher
(``kernels/ops.py``) takes it only for CPU tensors.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, _cuda, ref

COUNT = _cuda.LaunchCounter("l2_distance")


def l2_distance_plain(queries: torch.Tensor, points: torch.Tensor):
    """``(B, d) x (..., m, d) -> (..., B, m)`` f32 squared distances."""
    return ref.l2_distance_ref(queries, points)


def l2_distance_cuda(queries: torch.Tensor, points: torch.Tensor):
    """The kernel: ``(B, d) x (m, d) -> (B, m)`` or
    ``(B, d) x (k, m, d) -> (k, B, m)``, all k shards in one launch."""
    flat = points.dim() == 2
    p3 = points.unsqueeze(0) if flat else points
    _cuda.check_cuda("l2_distance", queries, p3)
    code = _cuda.dtype_code(queries, p3)
    if queries.dim() != 2 or p3.dim() != 3 or queries.shape[1] != p3.shape[2]:
        raise ValueError(f"l2_distance: shapes {tuple(queries.shape)} x "
                         f"{tuple(points.shape)} do not contract")
    B, d = queries.shape
    k, m, _ = p3.shape
    out = torch.empty((k, B, m), dtype=torch.float32, device=queries.device)
    if out.numel():
        lib = _build.library()
        _cuda.ok("l2_distance", lib.knn_l2_distance(
            queries.data_ptr(), p3.data_ptr(), out.data_ptr(), B, k, m, d,
            code, _cuda.stream_of(queries)))
        COUNT.add()
    return out[0] if flat else out
