"""Fused squared-L2 distance and running top-l: the CUDA kernel's wrapper
and its plain PyTorch version.

Port of ``repro.kernels.distance_topk`` (Pallas).  The kernel is
``csrc/distance_topk.cu`` over the distance main loop of
``csrc/distance_tile.cuh``: a persistent block per (point chunk, query
tile) walks its chunk in every shard in turn, keeping each query's
running top-l in shared memory, so the ``(B, m)`` matrix is never
written; the chunks' partial lists are merged by the local_topk kernel
with ids carried.  Points with ``valid == 0`` never win a slot (a tile
with none valid is not even read), and a slot that no point fills
reports ``(+inf, 2**31-1)``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, _cuda, ref
from repro_torch.kernels import l2_distance as _l2
from repro_torch.kernels import local_topk as _ltk

COUNT = _cuda.LaunchCounter("distance_topk")

QUERY_TILE = _l2.QUERY_TILE    # queries per block (distance_tile.cuh TB)
POINT_TILE = _l2.POINT_TILE    # points per tile; chunks are multiples of it
BLOCKS_PER_SM = 2              # ~106 KB of shared memory a block at l=128
MIN_CHUNK = 1024               # points per chunk, at least


# the key of (+inf, 2**31-1): float bits of +inf above the id
INF_KEY = (0x7F800000 << 32) | 0x7FFFFFFF


def slots(l: int) -> int:
    """A query row's (value, id) slots in a block: pow2 >= l + 64."""
    return 1 << (l + POINT_TILE - 1).bit_length()


def smem(d: int, l: int, elem_bytes: int) -> int:
    """Shared memory of one block: the main loop, then each query row's
    threshold key, slots and run and candidate counts."""
    return _l2.loop_smem(d, elem_bytes) + QUERY_TILE * (8 + 8 * slots(l)
                                                        + 8)


def distance_topk_plain(queries, points, l: int, valid=None):
    """``(B, d) x (..., m, d) -> ((..., B, l) ascending f32, int32 ids)``.

    ``valid`` (``(..., m)`` bool, optional) puts masked points at +inf;
    every +inf slot reports the ``2**31-1`` sentinel id.
    """
    if valid is None:
        d = ref.l2_distance_ref(queries, points)
    else:
        d = ref.masked_l2_distance_ref(queries, points, valid)
    v, i = _ltk.local_topk_plain(d, l)
    return v, torch.where(torch.isfinite(v), i,
                          torch.full_like(i, ref.INT32_MAX))


def chunking(B: int, k: int, m: int, device) -> int:
    """Points per chunk.  Every block walks its chunk in all k shards, so
    the card is filled by chunks x query tiles blocks, whatever k and
    whichever shards a mask leaves alive; chunks are whole tiles."""
    q_tiles = -(-B // QUERY_TILE)
    target = BLOCKS_PER_SM * _ltk.sm_count(device.index or 0)
    nchunks = max(1, min(-(-target // q_tiles), m // MIN_CHUNK))
    chunk = -(-m // nchunks)
    return -(-chunk // POINT_TILE) * POINT_TILE


def distance_topk_cuda(queries, points, l: int, valid=None):
    """The kernel: ``(B, d) x (m, d)`` or ``(k, m, d)`` points ->
    ``((B, l) or (k, B, l) ascending f32, int32 local point indices)``."""
    flat = points.dim() == 2
    p3 = points.unsqueeze(0) if flat else points
    _cuda.check_cuda("distance_topk", queries, p3)
    _cuda.check_l("distance_topk", l)
    code = _cuda.dtype_code(queries, p3)
    if queries.dim() != 2 or p3.dim() != 3 or queries.shape[1] != p3.shape[2]:
        raise ValueError(f"distance_topk: shapes {tuple(queries.shape)} x "
                         f"{tuple(points.shape)} do not contract")
    B, d = queries.shape
    k, m, _ = p3.shape
    _l2.check_smem("distance_topk", smem(d, l, p3.element_size()), d)
    vf = (None if valid is None
          else _l2.valid_flags(valid, k, m, queries.device))
    if B == 0 or k == 0 or m == 0:
        v = torch.full((k, B, l), float("inf"), device=queries.device)
        i = torch.full((k, B, l), ref.INT32_MAX, dtype=torch.int32,
                       device=queries.device)
    else:
        chunk = chunking(B, k, m, queries.device)
        nchunks = -(-m // chunk)
        # one chunk: the answer; else each chunk's row slots, unmerged
        width = l if nchunks == 1 else slots(l)
        pv = torch.empty((k * B, nchunks, width), dtype=torch.float32,
                         device=queries.device)
        pi = torch.empty((k * B, nchunks, width), dtype=torch.int32,
                         device=queries.device)
        # per-(shard, query) threshold keys the blocks lower together
        gthr = torch.full((k, B), INF_KEY, dtype=torch.int64,
                          device=queries.device)
        _cuda.ok("distance_topk", _build.library().knn_distance_topk(
            queries.data_ptr(), p3.data_ptr(),
            None if vf is None else vf.data_ptr(), gthr.data_ptr(),
            pv.data_ptr(), pi.data_ptr(), B, k, m, d, l, chunk, code,
            _cuda.stream_of(queries)))
        COUNT.add()
        v, i = _ltk.merge_partials(pv, pi, l)
        v, i = v.reshape(k, B, l), i.reshape(k, B, l)
    return (v[0], i[0]) if flat else (v, i)
