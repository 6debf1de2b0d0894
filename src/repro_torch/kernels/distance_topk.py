"""Fused squared-L2 distance and running top-l: the CUDA kernel's wrapper
and its plain PyTorch version.

Port of ``repro.kernels.distance_topk`` (Pallas).  The kernel is
``csrc/distance_topk.cu``, with two paths chosen by the bucket's shape
alone (:func:`row_tile`):

- B <= 32 (and any bucket whose whole-bucket block does not fit in shared
  memory at its width): the 32-row kernel over the distance main loop of
  ``csrc/distance_tile.cuh``: a persistent block per (point chunk, query
  tile) walks its chunk in every shard in turn, keeping each query's
  running top-l in shared memory;
- B > 32: ``csrc/distance_topk_wide.cuh``, one block's tile spanning the
  bucket (64 or 128 rows; above 128, tiles of 128) by 128 points.  At
  deep1b's step (B = 128, d = 96, l = 100: 2 * 128 * 96 / (96 * 4) = 64
  FLOP per byte of points) the kernel is bound by the f32 FMAs; this path
  runs 8 x 8 register tiles in one 8-warp block an SM and reads each point
  into shared memory once a launch, where the 32-row kernel held two
  4-warp blocks an SM with 4 x 4 tiles (each row's 256 slots of running
  top-l, 64 KB for 32 rows) and copied each point once per query tile.
  Each row's sorted run lives in its partial in device memory (L2), beside
  an area of candidate keys in shared memory.  Its launches are also
  counted apart (``COUNT_WIDE``).

Both give the same values and ids, bit for bit: the distances are
bit-equal and the keys order as (value, id), ties to the smaller id.  The
``(B, m)`` matrix is never written; the chunks' partial lists are merged
by the local_topk kernel with ids carried.  Points with ``valid == 0``
never win a slot (a tile with none valid is not even read), and a slot
that no point fills reports ``(+inf, 2**31-1)``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, _cuda, ref
from repro_torch.kernels import l2_distance as _l2
from repro_torch.kernels import local_topk as _ltk

COUNT = _cuda.LaunchCounter("distance_topk")            # every launch
COUNT_WIDE = _cuda.LaunchCounter("distance_topk_wide")  # the B > 32 path

QUERY_TILE = _l2.QUERY_TILE    # queries per block (distance_tile.cuh TB)
POINT_TILE = _l2.POINT_TILE    # points per tile; chunks are multiples of it
BLOCKS_PER_SM = 2              # ~106 KB of shared memory a block at l=128
MIN_CHUNK = 1024               # points per chunk, at least
# csrc/distance_topk_wide.cuh: row tiles of 64 or 128 by 128 points
WIDE_POINT_TILE = 128
WIDE_BLOCKS_PER_SM = {64: 2, 128: 1}
# shared memory a block may use at that many blocks an SM (H100: 228 KB an
# SM, 1 KB of it reserved a block, 227 KB a block at most)
WIDE_SMEM = {64: 115712, 128: _l2.SMEM_MAX}
WIDE_MAX_CAND = 128            # candidate keys a row, at most
WIDE_MIN_CAND = {2: 64, 3: 32}  # at least, by the ring's groups

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


def wide_fixed_smem(tile: int, d: int, elem_bytes: int, groups: int) -> int:
    """Shared memory of the whole-bucket block less its candidate areas:
    the resident query slabs of 128-byte rows, the ring (two whole point
    tiles at ``groups`` 2, three slabs at 3), the thresholds, the |p|^2
    partials, |q|^2, the counts, the group tiles and the vote's ballots."""
    nk = -(-d // (8 * (16 // elem_bytes)))       # 128-byte slabs
    ring = 2 * nk if groups == 2 else 3
    return ((nk * tile + ring * WIDE_POINT_TILE) * 128 + 8 * tile
            + 4 * (2 * nk * WIDE_POINT_TILE + tile) + 4 * (2 * tile + groups)
            + 4 * (2 * tile // 32))


def wide_layout(tile: int, d: int, elem_bytes: int):
    """``(groups, candidate keys a row)`` of the whole-bucket block at
    (d, dtype), or None where it does not fit.  A ring of two whole point
    tiles (one barrier a tile) where it leaves ``WIDE_MIN_CAND[2]`` keys a
    row, else a ring of three slabs; the keys are what the budget leaves,
    at most ``WIDE_MAX_CAND``.  Neither depends on l: the rows' runs live
    in the output."""
    for groups in (2, 3):
        free = WIDE_SMEM[tile] - wide_fixed_smem(tile, d, elem_bytes, groups)
        cand = min(WIDE_MAX_CAND, free // (8 * tile))
        if cand >= WIDE_MIN_CAND[groups]:
            return groups, cand
    return None


def row_tile(B: int, d: int, l: int, elem_bytes: int) -> int:
    """Rows of the query tile that a bucket of ``B`` rows takes at width
    ``d``, rank ``l`` and element size ``elem_bytes``: 32 (the 32-row
    kernel) up to 32 rows, else 64 up to 64 rows and 128 above where the
    whole-bucket block fits (:func:`wide_layout`); the 32-row kernel
    where it does not (a wide d)."""
    del l  # the whole-bucket block's shared memory does not grow with l
    if B <= QUERY_TILE:
        return QUERY_TILE
    tile = 64 if B <= 64 else 128
    return tile if wide_layout(tile, d, elem_bytes) else QUERY_TILE


def wide_smem(tile: int, d: int, elem_bytes: int) -> int:
    """Shared memory of the whole-bucket block at (d, dtype), where it
    fits."""
    groups, cand = wide_layout(tile, d, elem_bytes)
    return wide_fixed_smem(tile, d, elem_bytes, groups) + 8 * tile * cand


def smem_of(B: int, d: int, l: int, elem_bytes: int) -> int:
    """Shared memory a block of the path that ``B`` rows take."""
    tile = row_tile(B, d, l, elem_bytes)
    return (smem(d, l, elem_bytes) if tile == QUERY_TILE
            else wide_smem(tile, d, elem_bytes))


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


def chunking(B: int, k: int, m: int, device, tile: int = QUERY_TILE) -> int:
    """Points per chunk of the path whose query tile has ``tile`` rows.
    Every block walks its chunk in all k shards, so the card is filled by
    chunks x query tiles blocks (two 32-row blocks an SM, one 128-row
    block, two 64-row blocks), whatever k and whichever shards a mask
    leaves alive; chunks are whole point tiles."""
    per_sm, ptile = ((BLOCKS_PER_SM, POINT_TILE) if tile == QUERY_TILE
                     else (WIDE_BLOCKS_PER_SM[tile], WIDE_POINT_TILE))
    q_tiles = -(-B // tile)
    target = per_sm * _ltk.sm_count(device.index or 0)
    nchunks = max(1, min(-(-target // q_tiles), m // MIN_CHUNK))
    chunk = -(-m // nchunks)
    return -(-chunk // ptile) * ptile


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
    eb = p3.element_size()
    tile = row_tile(B, d, l, eb)
    _l2.check_smem("distance_topk", smem_of(B, d, l, eb), d)
    vf = (None if valid is None
          else _l2.valid_flags(valid, k, m, queries.device))
    if B == 0 or k == 0 or m == 0:
        v = torch.full((k, B, l), float("inf"), device=queries.device)
        i = torch.full((k, B, l), ref.INT32_MAX, dtype=torch.int32,
                       device=queries.device)
    else:
        chunk = chunking(B, k, m, queries.device, tile)
        nchunks = -(-m // chunk)
        # one chunk: the answer; else each chunk's partial: the 32-row
        # kernel's row slots unmerged, the whole-bucket path's l smallest
        width = l if nchunks == 1 or tile != QUERY_TILE else slots(l)
        pv = torch.empty((k * B, nchunks, width), dtype=torch.float32,
                         device=queries.device)
        pi = torch.empty((k * B, nchunks, width), dtype=torch.int32,
                         device=queries.device)
        # per-(shard, query) threshold keys the blocks lower together
        gthr = torch.full((k, B), INF_KEY, dtype=torch.int64,
                          device=queries.device)
        lib = _build.library()
        args = (queries.data_ptr(), p3.data_ptr(),
                None if vf is None else vf.data_ptr(), gthr.data_ptr(),
                pv.data_ptr(), pi.data_ptr(), B, k, m, d, l, chunk, code)
        stream = _cuda.stream_of(queries)
        if tile == QUERY_TILE:
            _cuda.ok("distance_topk", lib.knn_distance_topk(*args, stream))
        else:
            _cuda.ok("distance_topk", lib.knn_distance_topk_wide(
                *args, tile, *wide_layout(tile, d, eb), stream))
            COUNT_WIDE.add()
        COUNT.add()
        v, i = _ltk.merge_partials(pv, pi, l)
        v, i = v.reshape(k, B, l), i.reshape(k, B, l)
    return (v[0], i[0]) if flat else (v, i)
