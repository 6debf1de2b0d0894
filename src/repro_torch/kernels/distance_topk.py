"""Fused squared-L2 distance and running top-l: the CUDA kernel's wrapper
and its plain PyTorch version.

Port of ``repro.kernels.distance_topk`` (Pallas).  The kernel is
``csrc/distance_topk.cu``: one block per (query tile, point chunk, shard)
computes its distance tiles and keeps each query's running top-l in
shared memory, so the ``(B, m)`` matrix is never written; the chunks'
partial lists are merged by the local_topk kernel with ids carried.
Points with ``valid == 0`` never win a slot, and a slot that no point
fills reports ``(+inf, 2**31-1)``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, _cuda, ref
from repro_torch.kernels import local_topk as _ltk

COUNT = _cuda.LaunchCounter("distance_topk")

QUERY_TILE = 32        # queries per block (csrc/distance_topk.cu TB)
POINT_TILE = 64        # points per tile; chunks are multiples of it
BLOCKS_PER_SM = 2
MIN_CHUNK = 1024


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
    """Points per block: enough blocks to fill the card, whole tiles."""
    q_tiles = -(-B // QUERY_TILE)
    target = BLOCKS_PER_SM * _ltk.sm_count(device.index or 0)
    nchunks = max(1, min(-(-target // (k * q_tiles)), m // MIN_CHUNK))
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
    vf = None
    if valid is not None:
        vf = valid.to(device=queries.device, dtype=torch.float32)
        vf = vf.reshape(k, m).contiguous()
    if B == 0 or k == 0 or m == 0:
        v = torch.full((k, B, l), float("inf"), device=queries.device)
        i = torch.full((k, B, l), ref.INT32_MAX, dtype=torch.int32,
                       device=queries.device)
    else:
        chunk = chunking(B, k, m, queries.device)
        nchunks = -(-m // chunk)
        pv = torch.empty((k * B, nchunks, l), dtype=torch.float32,
                         device=queries.device)
        pi = torch.empty((k * B, nchunks, l), dtype=torch.int32,
                         device=queries.device)
        _cuda.ok("distance_topk", _build.library().knn_distance_topk(
            queries.data_ptr(), p3.data_ptr(),
            None if vf is None else vf.data_ptr(), pv.data_ptr(),
            pi.data_ptr(), B, k, m, d, l, chunk, code,
            _cuda.stream_of(queries)))
        COUNT.add()
        v, i = _ltk.merge_partials(pv, pi, l)
        v, i = v.reshape(k, B, l), i.reshape(k, B, l)
    return (v[0], i[0]) if flat else (v, i)
