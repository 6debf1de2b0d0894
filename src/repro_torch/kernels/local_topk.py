"""The l smallest per row, with indices: the CUDA kernel's wrapper and its
plain PyTorch version.

Port of ``repro.kernels.local_topk`` (Pallas).  The kernel is
``csrc/local_topk.cu``.  The rows, flattened, are cut into items of equal
size that a persistent grid of exactly the card's resident blocks takes
in turn (:func:`plan`), so a long row is split over several blocks and
the launch is one whole wave; a block writes one partial top-l list per
row segment of its item.  Further launches of the same kernel merge the
partials with their indices carried (:func:`merge_partials`), as they
merge distance_topk's partials.  Ties go to the smaller index, as
``lax.top_k`` does.

One pass writes at most ``MAX_L`` slots a row.  A larger l runs
:func:`passes`: pass p takes an exclusive floor per row, the (value, id)
of the last slot of pass p - 1, and writes the next slots; keys are
lexicographic and unique in a row, so the passes together are the one
top-l, ties to the smaller index.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, _cuda, ref

COUNT = _cuda.LaunchCounter("local_topk")

SPLIT_MIN = 16384      # a row shorter than this is one block's item
MIN_SHARE = 4096       # values a block takes at least when rows are split


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def blocks_per_sm(l: int, dtype_code: int, with_ids: bool,
                  with_floor: bool = False) -> int:
    """Resident blocks per SM of the kernel variant, from the occupancy
    API (its registers and its shared memory at this l)."""
    out = ctypes.c_int(0)
    _cuda.ok("local_topk", _build.library().knn_local_topk_blocks_per_sm(
        l, dtype_code, int(with_ids), int(with_floor), ctypes.byref(out)))
    if out.value < 1:
        raise RuntimeError(f"local_topk: no block fits an SM at l={l}")
    return out.value


@functools.lru_cache(maxsize=None)
def plan(rows: int, m: int, slots: int):
    """``(per, nparts, grid)`` of one launch over ``(rows, m)`` values on
    a card with ``slots`` resident blocks.

    Rows of fewer than ``SPLIT_MIN`` values, or at least ``slots`` rows,
    are items of their own (``per == m``, one partial a row, the answer).
    Otherwise the ``rows * m`` values are cut into ``grid <= slots`` items
    of ``per`` values (a multiple of 8, at least ``MIN_SHARE``), one a
    block: a single wave, every block the same work.  ``nparts`` is the
    most items a row meets.
    """
    if not rows or rows >= slots or m < SPLIT_MIN:
        return m, 1, min(rows, slots)
    total = rows * m
    grid = min(slots, -(-total // MIN_SHARE))
    per = -(-(-(-total // grid)) // 8) * 8
    grid = -(-total // per)
    nparts = max((r * m + m - 1) // per - (r * m) // per + 1
                 for r in range(rows))
    return per, nparts, grid


def merge_plans(rows: int, width: int, l: int, slots: int):
    """The :func:`plan` of each launch :func:`merge_partials` makes on
    ``(rows, width)`` pairs, in order, until one leaves one partial a
    row."""
    plans = [plan(rows, width, slots)]
    while plans[-1][1] > 1:
        plans.append(plan(rows, plans[-1][1] * l, slots))
    return plans


def local_topk_plain(values: torch.Tensor, l: int):
    """``(..., m) -> ((..., l) ascending f32, (..., l) int32 indices)``.

    Where ``l > m`` the missing slots are ``(+inf, 2**31-1)``, as the
    reference dispatcher's padded kernel returns them.
    """
    m = values.shape[-1]
    if l > m:
        pad = torch.full(values.shape[:-1] + (l - m,), float("inf"),
                         dtype=torch.float32, device=values.device)
        v, i = ref.local_topk_ref(torch.cat([values.float(), pad], -1), l)
        return v, torch.where(i < m, i, torch.full_like(i, ref.INT32_MAX))
    return ref.local_topk_ref(values, l)


def local_topk_floor_plain(values: torch.Tensor, l: int, floor=None):
    """One pass of :func:`passes` in PyTorch: ``(rows, m)`` values ->
    ``(rows, l)`` ascending (value, column) pairs whose key lies above the
    row's exclusive floor; ``floor`` is None or ``(floor_v, floor_i)``
    ``(rows,)``.  Slots with no such pair are ``(+inf, 2**31-1)``."""
    rows, m = values.shape
    sv, si = torch.sort(values.float(), dim=-1, stable=True)
    si = si.to(torch.int32)
    if floor is None:
        n_in = torch.full((rows, 1), m, device=values.device)
    else:
        fv, fi = floor[0].reshape(rows, 1), floor[1].reshape(rows, 1)
        out = (sv < fv) | ((sv == fv) & (si <= fi))
        order = torch.argsort(out.to(torch.int8), dim=-1, stable=True)
        sv, si = sv.gather(-1, order), si.gather(-1, order)
        n_in = (~out).sum(-1, keepdim=True)
    if m < l:
        pad = (rows, l - m)
        sv = torch.cat([sv, torch.full(pad, float("inf"),
                                       device=values.device)], -1)
        si = torch.cat([si, torch.zeros(pad, dtype=torch.int32,
                                        device=values.device)], -1)
    sv, si = sv[:, :l], si[:, :l]
    live = torch.arange(l, device=values.device) < n_in
    return (torch.where(live, sv, float("inf")),
            torch.where(live, si, ref.INT32_MAX))


def passes(one_pass, rows: int, m: int, l: int, device):
    """The l smallest (value, id) pairs of ``rows`` rows of ``m`` values,
    in passes of at most ``MAX_L`` slots.  ``one_pass(lp, floor)`` returns
    the ``(rows, lp)`` next pairs above ``floor`` (None, then the last
    slot's ``(values, ids)`` of the pass before).  A pass that would start
    at or past slot ``m`` is all sentinels ``(+inf, 2**31-1)``, written
    without a call."""
    vs, ids, floor = [], [], None
    for p0 in range(0, min(l, m), _cuda.MAX_L):
        v, i = one_pass(min(_cuda.MAX_L, l - p0), floor)
        vs.append(v)
        ids.append(i)
        floor = (v[:, -1].contiguous(), i[:, -1].contiguous())
    rest = l - sum(v.shape[1] for v in vs)
    if rest:
        vs.append(torch.full((rows, rest), float("inf"), device=device))
        ids.append(torch.full((rows, rest), ref.INT32_MAX, dtype=torch.int32,
                              device=device))
    if len(vs) == 1:
        return vs[0], ids[0]
    return torch.cat(vs, 1), torch.cat(ids, 1)


def merge_partials_plain(pv: torch.Tensor, pi: torch.Tensor, l: int):
    """``(rows, chunks, w)`` (value, id) partials -> ``(rows, l)``: the l
    smallest pairs of each row in lexicographic (value, id) order, by a
    stable sort; ``(+inf, 2**31-1)`` slots stay sentinels."""
    rows = pv.shape[0]
    v = pv.reshape(rows, -1).float()
    i = pi.reshape(rows, -1).to(torch.int32)
    if v.shape[1] < l:
        pad = (rows, l - v.shape[1])
        v = torch.cat([v, torch.full(pad, float("inf"), device=v.device)], 1)
        i = torch.cat([i, torch.full(pad, ref.INT32_MAX, dtype=torch.int32,
                                     device=i.device)], 1)
    by_id = torch.argsort(i, dim=1, stable=True)
    v, i = v.gather(1, by_id), i.gather(1, by_id)
    sv, by_v = torch.sort(v, dim=1, stable=True)
    return sv[:, :l], i.gather(1, by_v)[:, :l]


def card_slots(values: torch.Tensor, l: int, with_ids: bool,
               with_floor: bool = False) -> int:
    """Resident blocks on the card of ``values`` of the kernel variant
    for its dtype, ``l``, ``with_ids`` and ``with_floor``."""
    return (blocks_per_sm(l, _cuda.dtype_code(values), with_ids, with_floor)
            * sm_count(values.device.index or 0))


def launch(values: torch.Tensor, ids, l: int, launch_plan=None, floor=None):
    """One kernel launch over ``(rows, m)`` values (and int32 ids, or None
    for column indices): ``(rows, nparts, l)`` partial lists, by
    ``launch_plan`` or else :func:`plan` (``nparts == 1``: the answer).
    ``floor``: None, or ``(rows,)`` f32 values and int32 ids, each row's
    exclusive floor (column ids only)."""
    rows, m = values.shape
    code = _cuda.dtype_code(values)
    dev = values.device
    if not (rows and m):
        return (torch.full((rows, 1, l), float("inf"), device=dev),
                torch.full((rows, 1, l), ref.INT32_MAX, dtype=torch.int32,
                           device=dev))
    per, nparts, grid = launch_plan or plan(
        rows, m, card_slots(values, l, ids is not None, floor is not None))
    fv, fi = (None, None) if floor is None else floor
    out_v = torch.empty((rows, nparts, l), dtype=torch.float32, device=dev)
    out_i = torch.empty((rows, nparts, l), dtype=torch.int32, device=dev)
    _cuda.ok("local_topk", _build.library().knn_local_topk(
        values.data_ptr(), None if ids is None else ids.data_ptr(),
        None if fv is None else fv.data_ptr(),
        None if fi is None else fi.data_ptr(),
        out_v.data_ptr(), out_i.data_ptr(), rows, m, l, per, nparts, grid,
        code, _cuda.stream_of(values)))
    COUNT.add()
    return out_v, out_i


def merge_partials(pv: torch.Tensor, pi: torch.Tensor, l: int):
    """``(rows, chunks, w)`` partial lists with ids (one chunk of
    ``w == l``: already the answer) -> ``(rows, l)``.  On the card, one
    launch for each of :func:`merge_plans`."""
    if pv.device.type == "cpu":
        return merge_partials_plain(pv, pi, l)
    rows, n, w = pv.shape
    if n > 1 or w != l:
        for p in merge_plans(rows, n * w, l, card_slots(pv, l, True)):
            pv, pi = launch(pv.reshape(rows, -1), pi.reshape(rows, -1), l, p)
    return pv[:, 0], pi[:, 0]


def local_topk_cuda(values: torch.Tensor, l: int):
    """The kernel: ``(..., m) -> ((..., l) ascending f32, (..., l) int32)``,
    any ``l >= 1``: one pass (a launch and its merges) for each ``MAX_L``
    slots (:func:`passes`)."""
    _cuda.check_cuda("local_topk", values)
    if l < 1:
        raise ValueError(f"local_topk: l={l} < 1")
    _cuda.dtype_code(values)
    lead, m = values.shape[:-1], values.shape[-1]
    x = values.reshape(-1, m)

    def one_pass(lp, floor):
        pv, pi = launch(x, None, lp, floor=floor)
        return merge_partials(pv, pi, lp)

    v, i = passes(one_pass, x.shape[0], m, l, x.device)
    return v.reshape(lead + (l,)), i.reshape(lead + (l,))
