"""Squared-L2 distance matrix: the CUDA kernel's wrapper and its plain
PyTorch version.

Port of ``repro.kernels.l2_distance`` (Pallas).  The kernel is
``csrc/l2_distance.cu`` over the distance main loop of
``csrc/distance_tile.cuh`` (shared with distance_topk); their notes say
what bounds it on the card.  It takes an optional ``(k, m)`` valid mask
and writes +inf at masked points, without reading the points of a tile
that has none valid.  The plain version is the same contraction in
PyTorch (the dispatcher, ``kernels/ops.py``, masks its output); the
tests and ``chip_smoke.py`` hold the kernel against it, and the
dispatcher takes it only for CPU tensors.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, _cuda, ref
from repro_torch.kernels import local_topk as _ltk

COUNT = _cuda.LaunchCounter("l2_distance")

# csrc/distance_tile.cuh: a block's tile and its shared-memory ring
QUERY_TILE = 32
POINT_TILE = 64
STAGES = 4
SLAB_BYTES = POINT_TILE * 128
BLOCKS_PER_SM = 4          # persistent l2_distance blocks per SM
SMEM_MAX = 232448          # dynamic shared memory a block may use (H100)


def loop_smem(d: int, elem_bytes: int) -> int:
    """Shared memory of the distance main loop at width ``d``."""
    bk = 8 * (16 // elem_bytes)                 # dims per slab
    dq = -(-d // bk) * bk + 4
    return (STAGES * SLAB_BYTES + 4 * (QUERY_TILE * dq + QUERY_TILE
                                       + 2 * POINT_TILE)
            + 4 * (STAGES + 4))


def check_smem(name: str, nbytes: int, d: int) -> None:
    if nbytes > SMEM_MAX:
        raise ValueError(f"{name}: d={d} needs {nbytes} bytes of shared "
                         f"memory a block, above the card's {SMEM_MAX}")


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
    check_smem("l2_distance", loop_smem(d, p3.element_size()), d)
    vf = None if valid is None else valid_flags(valid, k, m, queries.device)
    out = torch.empty((k, B, m), dtype=torch.float32, device=queries.device)
    if out.numel():
        blocks = BLOCKS_PER_SM * _ltk.sm_count(queries.device.index or 0)
        _cuda.ok("l2_distance", _build.library().knn_l2_distance(
            queries.data_ptr(), p3.data_ptr(),
            None if vf is None else vf.data_ptr(), out.data_ptr(), B, k, m,
            d, code, blocks, _cuda.stream_of(queries)))
        COUNT.add()
    return out[0] if flat else out
