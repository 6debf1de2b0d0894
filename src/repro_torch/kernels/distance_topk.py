"""Fused squared-L2 distance and running top-l: the CUDA kernel's wrapper
and its plain PyTorch version.

Port of ``repro.kernels.distance_topk`` (Pallas).  The kernel is
``csrc/distance_topk.cu``, with two paths, each designed in its header:
the 32-row kernel over the distance main loop of ``csrc/distance_tile.cuh``
(a persistent block per point chunk and query tile, each query's running
top-l in shared memory) and the whole-bucket path of
``csrc/distance_topk_wide.cuh`` (one block's tile spanning the bucket,
each row's sorted run in its partial in device memory; its launches are
also counted apart, ``COUNT_WIDE``).  ``kernels/plan.py`` says which a
bucket takes, with its tile, layout and chunks.

Both give the same values and ids, bit for bit: the distances are
bit-equal and the keys order as (value, id), ties to the smaller id.  The
``(B, m)`` matrix is never written; the chunks' partial lists are merged
by the local_topk kernel with ids carried.  Points with ``valid == 0``
never win a slot (a tile with none valid is not even read), and a slot
that no point fills reports ``(+inf, 2**31-1)``.

uint8 points (with uint8 queries) take a third kernel,
``csrc/distance_topk_u8.cu``: the whole-bucket walk with its product on
the int8 tensor cores (counted in ``COUNT`` and apart, ``COUNT_U8``).
Their distances are exact integers, exact in f32 up to d = 258, so the
kernel equals :func:`distance_topk_u8_plain` (an f64 product rounded once)
bit for bit.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, _cuda, plan, ref
from repro_torch.kernels import l2_distance as _l2
from repro_torch.kernels import local_topk as _ltk

COUNT = _cuda.LaunchCounter("distance_topk")            # every launch
COUNT_WIDE = _cuda.LaunchCounter("distance_topk_wide")  # the B > 32 path
COUNT_U8 = _cuda.LaunchCounter("distance_topk_u8")      # uint8 points

# the key of (+inf, 2**31-1): float bits of +inf above the id; equal to
# INF_KEY of csrc/common.cuh
INF_KEY = (0x7F800000 << 32) | 0x7FFFFFFF


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


def distance_topk_u8_plain(queries, points, l: int, valid=None):
    """``(B, d) x (..., m, d)`` uint8 -> ``((..., B, l) ascending f32, int32
    ids)``: the squared distances in f64 (exact integers), rounded once to
    f32 (exact up to d = 258); ``valid`` and sentinels as
    :func:`distance_topk_plain`."""
    q, p = queries.double(), points.double()
    d = ((q * q).sum(-1, keepdim=True) + (p * p).sum(-1).unsqueeze(-2)
         - 2.0 * torch.matmul(q, p.transpose(-1, -2))).float()
    if valid is not None:
        d = torch.where(valid.bool().unsqueeze(-2), d,
                        torch.full_like(d, float("inf")))
    v, i = _ltk.local_topk_plain(d, l)
    return v, torch.where(torch.isfinite(v), i,
                          torch.full_like(i, ref.INT32_MAX))


def distance_topk_cuda(queries, points, l: int, valid=None):
    """The kernel: ``(B, d) x (m, d)`` or ``(k, m, d)`` points ->
    ``((B, l) or (k, B, l) ascending f32, int32 local point indices)``.
    Queries and points both f32, both bf16 or both uint8."""
    flat = points.dim() == 2
    p3 = points.unsqueeze(0) if flat else points
    _cuda.check_cuda("distance_topk", queries, p3)
    _cuda.check_l("distance_topk", l)
    u8 = p3.dtype == torch.uint8
    if u8 and queries.dtype != torch.uint8:
        raise TypeError(f"distance_topk: uint8 points take uint8 queries, "
                        f"got {queries.dtype}")
    code = None if u8 else _cuda.dtype_code(queries, p3)
    if queries.dim() != 2 or p3.dim() != 3 or queries.shape[1] != p3.shape[2]:
        raise ValueError(f"distance_topk: shapes {tuple(queries.shape)} x "
                         f"{tuple(points.shape)} do not contract")
    B, d = queries.shape
    k, m, _ = p3.shape
    sms = _ltk.sm_count(queries.device.index or 0)
    tp = (plan.topk_u8(B, d, l, m, sms) if u8
          else plan.topk(B, d, l, p3.element_size(), m, sms))
    if tp.unsupported:
        raise ValueError(f"distance_topk: {tp.unsupported}")
    vf = (None if valid is None
          else _l2.valid_flags(valid, k, m, queries.device))
    if B == 0 or k == 0 or m == 0:
        v = torch.full((k, B, l), float("inf"), device=queries.device)
        i = torch.full((k, B, l), ref.INT32_MAX, dtype=torch.int32,
                       device=queries.device)
    else:
        shape = (k * B, tp.nchunks, tp.width)
        pv = torch.empty(shape, dtype=torch.float32, device=queries.device)
        pi = torch.empty(shape, dtype=torch.int32, device=queries.device)
        # per-(shard, query) threshold keys the blocks lower together
        gthr = torch.full((k, B), INF_KEY, dtype=torch.int64,
                          device=queries.device)
        lib = _build.library()
        args = (queries.data_ptr(), p3.data_ptr(),
                None if vf is None else vf.data_ptr(), gthr.data_ptr(),
                pv.data_ptr(), pi.data_ptr(), B, k, m, d, l, tp.chunk)
        stream = _cuda.stream_of(queries)
        if u8:
            _cuda.ok("distance_topk", lib.knn_distance_topk_u8(
                *args, tp.tile, tp.cand, stream))
            COUNT_U8.add()
        elif tp.wide:
            _cuda.ok("distance_topk", lib.knn_distance_topk_wide(
                *args, code, tp.tile, tp.groups, tp.cand, stream))
            COUNT_WIDE.add()
        else:
            _cuda.ok("distance_topk", lib.knn_distance_topk(*args, code,
                                                            stream))
        COUNT.add()
        v, i = _ltk.merge_partials(pv, pi, l)
        v, i = v.reshape(k, B, l), i.reshape(k, B, l)
    return (v[0], i[0]) if flat else (v, i)
