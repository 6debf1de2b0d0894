"""Squared-L2 distance matrix: the CUDA kernel's wrapper and its plain
PyTorch version.

Port of ``repro.kernels.l2_distance`` (Pallas).  The kernel is
``csrc/l2_distance.cu``, with two main loops chosen by the bucket's rows
B alone (:func:`row_tiles`):

- B <= 32: the distance main loop of ``csrc/distance_tile.cuh`` (shared
  with distance_topk), a 32-row query tile resident in shared memory;
- B > 32: ``csrc/l2_distance_wide.cuh``, one block's tile spanning the
  bucket (64 or 128 rows; above 128, tiles of 128) with queries and
  points streamed along d, so its shared memory does not grow with d.
  At the service's large buckets (B = 128, d = 1,024: 64 FLOP per byte
  of points) the kernel is bound by the f32 FMAs; this loop runs 8 x 8
  register tiles in 8 warps an SM with up to 255 registers a thread and
  reads each point byte from device memory once a launch, where the
  32-row loop held one 4-warp block an SM with 4 x 4 tiles and swept the
  points once per query tile.  Its launches are also counted apart
  (``COUNT_WIDE``).

Both write bit-equal distances.  The kernel takes an optional ``(k, m)``
valid mask and writes +inf at masked points, without reading the points
of a tile that has none valid.  The plain version is the same contraction in
PyTorch (the dispatcher, ``kernels/ops.py``, masks its output); the
tests and ``chip_smoke.py`` hold the kernel against it, and the
dispatcher takes it only for CPU tensors.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, _cuda, ref
from repro_torch.kernels import local_topk as _ltk

COUNT = _cuda.LaunchCounter("l2_distance")            # every launch
COUNT_WIDE = _cuda.LaunchCounter("l2_distance_wide")  # the B > 32 loop

# csrc/distance_tile.cuh: a block's tile and its shared-memory ring
QUERY_TILE = 32
POINT_TILE = 64
STAGES = 4
SLAB_BYTES = POINT_TILE * 128
BLOCKS_PER_SM = 4          # persistent l2_distance blocks per SM
SMEM_MAX = 232448          # dynamic shared memory a block may use (H100)
# csrc/l2_distance_wide.cuh: row tiles of 64 or 128 by 128 points
WIDE_POINT_TILE = 128
WIDE_STAGES = 3


def loop_smem(d: int, elem_bytes: int) -> int:
    """Shared memory of the distance main loop at width ``d``."""
    bk = 8 * (16 // elem_bytes)                 # dims per slab
    dq = -(-d // bk) * bk + 4
    return (STAGES * SLAB_BYTES + 4 * (QUERY_TILE * dq + QUERY_TILE
                                       + 2 * POINT_TILE)
            + 4 * (STAGES + 4))


def row_tiles(B: int) -> tuple[int, int]:
    """``(rows a tile, tiles)`` of a bucket of ``B`` rows: today's 32-row
    tile up to 32 rows, then one tile of 64, then tiles of 128."""
    tile = QUERY_TILE if B <= QUERY_TILE else 64 if B <= 64 else 128
    return tile, -(-B // tile)


def wide_smem(row_tile: int) -> int:
    """Shared memory of the whole-bucket loop's block, at any width: its
    slab rows are 256 bytes at 128 rows, 128 at 64."""
    stage = (row_tile + WIDE_POINT_TILE) * (256 if row_tile == 128 else 128)
    return (WIDE_STAGES * stage + 4 * 2 * (WIDE_POINT_TILE + row_tile)
            + 4 * (WIDE_STAGES + 2 * row_tile // 32))


def smem_of(B: int, d: int, elem_bytes: int) -> int:
    """Shared memory a block of the loop that ``B`` rows take."""
    tile, _ = row_tiles(B)
    return (loop_smem(d, elem_bytes) if tile == QUERY_TILE
            else wide_smem(tile))


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
    check_smem("l2_distance", smem_of(B, d, p3.element_size()), d)
    vf = None if valid is None else valid_flags(valid, k, m, queries.device)
    out = torch.empty((k, B, m), dtype=torch.float32, device=queries.device)
    if out.numel():
        lib, tile = _build.library(), row_tiles(B)[0]
        args = (queries.data_ptr(), p3.data_ptr(),
                None if vf is None else vf.data_ptr(), out.data_ptr(), B, k,
                m, d, code)
        stream = _cuda.stream_of(queries)
        if tile == QUERY_TILE:
            blocks = BLOCKS_PER_SM * _ltk.sm_count(queries.device.index or 0)
            _cuda.ok("l2_distance", lib.knn_l2_distance(*args, blocks,
                                                        stream))
        else:
            _cuda.ok("l2_distance", lib.knn_l2_distance_wide(*args, tile,
                                                             stream))
            COUNT_WIDE.add()
        COUNT.add()
    return out[0] if flat else out
