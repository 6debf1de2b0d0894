"""What runs on the card for a distance + top-l step: the one place that
maps a bucket's shape to its kernels, tiles, layouts and chunks.

Inputs: the bucket's rows B, the width d, the rank l, the element size
(4 or 2, or 1 for uint8 points), the points a shard m and the card's SM
count.  The kernel
wrappers launch what the plan says, ``ops.distance_topk`` branches on
its path and ``ops.service_envelope`` reports its fields.  The dispatch
rule:

- the step is the fused ``distance_topk`` where ``l <= MAX_L`` and the
  32-row kernel's block fits in shared memory at (d, dtype), whatever
  tile B takes (at d = 896, f32: up to l = 192); else ``l2_distance``
  then ``local_topk`` in passes of ``MAX_L`` slots;
- ``l2_distance``: B <= 32 the 32-row loop (``csrc/distance_tile.cuh``),
  ``L2_BLOCKS_PER_SM`` persistent blocks an SM a query tile; above, the
  whole-bucket loop (``csrc/l2_distance_wide.cuh``), one tile of 64 rows
  up to 64, else tiles of 128, its blocks from the occupancy API;
- ``distance_topk``: B <= 32 the 32-row kernel (``csrc/distance_topk.cu``);
  above, the whole-bucket path (``csrc/distance_topk_wide.cuh``, 64 rows
  up to 64, else 128) where its block fits at (d, dtype), else the 32-row
  kernel.  Each shard's points are cut into chunks of whole point tiles
  so that chunks x query tiles fill the SMs ``TOPK_BLOCKS_PER_SM`` or
  ``WIDE_BLOCKS_PER_SM`` times over;
- uint8 points (element size 1) take one kernel whatever B, l and d:
  ``distance_topk_u8`` (``csrc/distance_topk_u8.cu``), the whole-bucket
  walk with its product on the int8 tensor cores, a tile of 64 rows up to
  64 (a smaller bucket padded), else 128, a ring of three 128-byte slabs;
  l above ``MAX_L`` or d above ``U8_MAX_D`` has no uint8 kernel;
- a block above ``SMEM_MAX`` bytes of shared memory has no kernel: the
  plan says why in ``unsupported`` and the wrappers raise it;
- Algorithm 1 (``select``) is the device loop (``csrc/select_loop.cu``),
  one block a row of k*m keys, ``SELECT_PER`` keys a thread up to
  ``SELECT_MAX_THREADS`` threads and more a thread beyond; the keys in
  shared memory where they fit beside the in-range bits, else read where
  they lie; 2-byte or 4-byte keys, 1 pivot or k (``num_pivots > 1``).

The tile and shared-memory constants are declared here once; the C
sources hold their own copies.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

from repro_torch.kernels._cuda import MAX_L

SMEM_MAX = 232448          # dynamic shared memory a block may use (H100)
# csrc/distance_tile.cuh: the 32-row tile and its ring of slabs
QUERY_TILE = 32
POINT_TILE = 64
STAGES = 4
SLAB_BYTES = POINT_TILE * 128
L2_BLOCKS_PER_SM = 4
TOPK_BLOCKS_PER_SM = 2     # ~106 KB of shared memory a block at l=128
MIN_CHUNK = 1024           # points a chunk, at least
# the whole-bucket loops: row tiles of 64 or 128 by 128 points
WIDE_POINT_TILE = 128
WIDE_STAGES = 3            # l2_distance_wide.cuh's ring
WIDE_BLOCKS_PER_SM = {64: 2, 128: 1}   # distance_topk_wide.cuh's
# shared memory a block may use at that many blocks an SM (H100: 228 KB an
# SM, 1 KB of it reserved a block, 227 KB a block at most)
WIDE_SMEM = {64: 115712, 128: SMEM_MAX}
WIDE_MAX_CAND = 128        # candidate keys a row, at most
WIDE_MIN_CAND = {2: 64, 3: 32}  # at least, by the ring's groups

# csrc/select_loop.cu: threads a block, and the keys a thread is given
# where the row allows
SELECT_MAX_THREADS = 1024
SELECT_PER = 8

# uint8 points: the distance d * 255**2 is an exact f32 up to this width
U8_ELEM, U8_MAX_D = 1, 258
U8_GROUPS = 3              # distance_topk_u8.cu's ring: three slabs
U8_BARS = 8 * (U8_GROUPS + 1)   # its mbarriers a slab, 8-byte aligned

DISTANCE_TOPK, L2_LOCAL_TOPK = "distance_topk", "l2+local_topk"
DISTANCE_TOPK_U8 = "distance_topk_u8"


@dataclasses.dataclass(frozen=True)
class L2Plan:
    tile: int                   # query rows a block: 32, 64 or 128
    smem: int                   # shared memory a block, bytes
    blocks: Optional[int]       # the 32-row loop's blocks a query tile
    unsupported: Optional[str]

    @property
    def wide(self) -> bool:
        return self.tile != QUERY_TILE


@dataclasses.dataclass(frozen=True)
class TopkPlan:
    tile: int                   # query rows a block: 32, 64 or 128
    groups: Optional[int]       # the whole-bucket ring's groups: 2 or 3
    cand: Optional[int]         # its candidate keys a row
    smem: int
    chunk: Optional[int]        # points a chunk; None where B or m is 0
    nchunks: Optional[int]
    width: Optional[int]        # slots a row of a chunk's partial
    blocks: Optional[int]       # chunks x query tiles
    unsupported: Optional[str]

    @property
    def wide(self) -> bool:
        return self.tile != QUERY_TILE


@dataclasses.dataclass(frozen=True)
class StepPlan:
    path: str                   # DISTANCE_TOPK, L2_LOCAL_TOPK or _U8
    l2: Optional[L2Plan]        # None for uint8 points
    topk: Optional[TopkPlan]    # None above MAX_L (f32, bf16)
    passes: Optional[int]       # local_topk's, on L2_LOCAL_TOPK
    unsupported: Optional[str]  # of the path's first kernel


def _unsupported(smem: int, d: int) -> Optional[str]:
    if smem > SMEM_MAX:
        return (f"d={d} needs {smem} bytes of shared memory a block, above "
                f"the card's {SMEM_MAX}")
    return None


def _slots(l: int) -> int:
    """A row's (value, id) slots in a 32-row block: pow2 >= l + 64."""
    return 1 << (l + POINT_TILE - 1).bit_length()


def _loop_smem(d: int, elem: int) -> int:
    """The 32-row distance main loop's."""
    dq = -(-d // (128 // elem)) * (128 // elem) + 4     # padded query row
    return (STAGES * SLAB_BYTES
            + 4 * (QUERY_TILE * dq + QUERY_TILE + 2 * POINT_TILE)
            + 4 * (STAGES + 4))


def _topk32_smem(d: int, l: int, elem: int) -> int:
    """The loop's, then each row's threshold key, slots and counts."""
    return _loop_smem(d, elem) + QUERY_TILE * (8 + 8 * _slots(l) + 8)


def _wide_fixed_smem(tile: int, d: int, elem: int, groups: int) -> int:
    """The whole-bucket distance_topk block's less its candidate keys: the
    resident query slabs of 128-byte rows, the ring (two whole point tiles
    at ``groups`` 2, three slabs at 3), the thresholds, the |p|^2
    partials, |q|^2, the counts, the group tiles and the vote."""
    nk = -(-d // (128 // elem))                 # 128-byte slabs
    ring = 2 * nk if groups == 2 else 3
    return ((nk * tile + ring * WIDE_POINT_TILE) * 128 + 8 * tile
            + 4 * (2 * nk * WIDE_POINT_TILE + tile) + 4 * (2 * tile + groups)
            + 4 * (2 * tile // 32))


def _wide_layout(tile: int, d: int, elem: int):
    """``(groups, candidate keys a row)``, or None where the block does not
    fit: two whole point tiles (one barrier a tile) where they leave
    ``WIDE_MIN_CAND[2]`` keys, else three slabs; the keys are what the
    budget leaves, at most ``WIDE_MAX_CAND``.  Neither depends on l (the
    rows' runs live in the output)."""
    for groups in (2, 3):
        free = WIDE_SMEM[tile] - _wide_fixed_smem(tile, d, elem, groups)
        cand = min(WIDE_MAX_CAND, free // (8 * tile))
        if cand >= WIDE_MIN_CAND[groups]:
            return groups, cand
    return None


@functools.lru_cache(maxsize=1024)
def l2(B: int, d: int, elem: int, sms: int) -> L2Plan:
    """``l2_distance``'s loop over a bucket of B rows."""
    tile = QUERY_TILE if B <= QUERY_TILE else 64 if B <= 64 else 128
    if tile == QUERY_TILE:
        smem, blocks = _loop_smem(d, elem), L2_BLOCKS_PER_SM * sms
    else:
        # slab rows of 256 bytes at 128 rows, 128 at 64, at any width
        smem = (WIDE_STAGES * (tile + WIDE_POINT_TILE) * (2 * tile)
                + 4 * 2 * (WIDE_POINT_TILE + tile)
                + 4 * (WIDE_STAGES + 2 * tile // 32))
        blocks = None
    return L2Plan(tile, smem, blocks, _unsupported(smem, d))


@functools.lru_cache(maxsize=1024)
def topk(B: int, d: int, l: int, elem: int, m: int, sms: int,
         tile: Optional[int] = None) -> TopkPlan:
    """``distance_topk``'s path over a bucket of B rows; ``tile`` forces a
    row tile (an ablation's; the wrappers give none)."""
    if tile is None:
        tile = QUERY_TILE if B <= QUERY_TILE else 64 if B <= 64 else 128
        if tile != QUERY_TILE and not _wide_layout(tile, d, elem):
            tile = QUERY_TILE
    if tile == QUERY_TILE:
        groups = cand = None
        smem = _topk32_smem(d, l, elem)
        per_sm, ptile = TOPK_BLOCKS_PER_SM, POINT_TILE
    else:
        groups, cand = _wide_layout(tile, d, elem)
        smem = _wide_fixed_smem(tile, d, elem, groups) + 8 * tile * cand
        per_sm, ptile = WIDE_BLOCKS_PER_SM[tile], WIDE_POINT_TILE
    return TopkPlan(tile, groups, cand, smem,
                    *_chunks(B, m, l, tile, per_sm, ptile, sms),
                    _unsupported(smem, d))


def _chunks(B: int, m: int, l: int, tile: int, per_sm: int, ptile: int,
            sms: int) -> tuple:
    """``(chunk, nchunks, width, blocks)`` of a distance_topk launch; all
    None where B or m is 0."""
    if not (B and m):
        return None, None, None, None
    # every block walks its chunk in all k shards: the card is filled by
    # chunks x query tiles, whatever k and whichever shards a mask leaves
    # alive
    q_tiles = -(-B // tile)
    n = max(1, min(-(-per_sm * sms // q_tiles), m // MIN_CHUNK))
    chunk = -(-m // n)
    chunk = -(-chunk // ptile) * ptile
    nchunks = -(-m // chunk)
    # one chunk: the answer; else the 32-row kernel's slots unmerged, the
    # whole-bucket paths' l smallest
    width = l if nchunks == 1 or tile != QUERY_TILE else _slots(l)
    return chunk, nchunks, width, nchunks * q_tiles


@functools.lru_cache(maxsize=1024)
def topk_u8(B: int, d: int, l: int, m: int, sms: int) -> TopkPlan:
    """``distance_topk_u8``'s launch over a bucket of B rows of uint8
    queries against uint8 points: the whole-bucket block's layout at
    ``U8_GROUPS`` ring slabs (a slab of 128 dims), its candidate keys what
    the budget leaves, at most ``WIDE_MAX_CAND``."""
    tile = 64 if B <= 64 else 128
    fixed = _wide_fixed_smem(tile, d, U8_ELEM, U8_GROUPS) + U8_BARS
    cand = min(WIDE_MAX_CAND, (WIDE_SMEM[tile] - fixed) // (8 * tile))
    smem = fixed + 8 * tile * max(cand, 0)
    why = _unsupported(smem, d)
    if d > U8_MAX_D:
        why = (f"uint8 points at d={d}: a distance reaches d * 255**2, an "
               f"exact f32 only up to d={U8_MAX_D}")
    elif not 1 <= l <= MAX_L:
        why = (f"l={l} outside [1, {MAX_L}] with uint8 points (their step "
               f"is one kernel, with no passes)")
    elif cand < WIDE_MIN_CAND[U8_GROUPS]:
        why = (f"d={d}: {cand} candidate keys a row fit beside the uint8 "
               f"block, below {WIDE_MIN_CAND[U8_GROUPS]}")
    return TopkPlan(tile, U8_GROUPS, cand, smem,
                    *_chunks(B, m, l, tile, WIDE_BLOCKS_PER_SM[tile],
                             WIDE_POINT_TILE, sms), why)


@functools.lru_cache(maxsize=1024)
def step(B: int, d: int, l: int, elem: int, m: int, sms: int) -> StepPlan:
    """The step over a bucket of B rows: its path and its kernels'."""
    if elem == U8_ELEM:
        tp = topk_u8(B, d, l, m, sms)
        return StepPlan(DISTANCE_TOPK_U8, None, tp, None, tp.unsupported)
    lp = l2(B, d, elem, sms)
    tp = topk(B, d, l, elem, m, sms) if l <= MAX_L else None
    if tp is not None and _topk32_smem(d, l, elem) <= SMEM_MAX:
        return StepPlan(DISTANCE_TOPK, lp, tp, None, tp.unsupported)
    return StepPlan(L2_LOCAL_TOPK, lp, tp, -(-min(l, m) // MAX_L),
                    lp.unsupported)


@dataclasses.dataclass(frozen=True)
class SelectPlan:
    threads: int                # a block (one block a row)
    per: int                    # keys a thread
    smem_keys: bool             # the row's keys in shared memory
    smem: int                   # dynamic shared memory a block, bytes
    unsupported: Optional[str]  # why no block holds the row


@functools.lru_cache(maxsize=1024)
def select(n: int, elem: int, pivots: int) -> SelectPlan:
    """Algorithm 1's device loop over rows of ``n`` = k*m keys of ``elem``
    bytes with ``pivots`` pivots an iteration (1, or k where
    ``num_pivots > 1``): ``SELECT_PER`` keys a thread (32 threads at
    least), more where 1,024 threads do not hold the row.  A block holds
    a bit a key (in words of 32 a thread), each warp's two partial sums
    and a key a pivot, and the keys (8 bytes each) where they fit too."""
    threads = min(SELECT_MAX_THREADS,
                  max(32, -(-n // (32 * SELECT_PER)) * 32))
    per = -(-n // threads)
    fixed = 4 * -(-per // 32) * threads + 8 * pivots * (threads // 32 + 1)
    keys = 8 * threads * per
    why = None
    if elem not in (2, 4):
        why = f"select: {elem}-byte keys (the device loop takes 2 or 4)"
    elif fixed > SMEM_MAX:
        why = (f"select: {n} keys a row with {pivots} pivots need {fixed} "
               f"bytes of shared memory (limit {SMEM_MAX})")
    smem_keys = keys + fixed <= SMEM_MAX
    return SelectPlan(threads, per, smem_keys,
                      fixed + keys if smem_keys else fixed, why)
