"""Entry points for the distance, top-l and routing kernels, dispatched
by device.

Port of ``repro.kernels.ops``.  The rule is the tensor's device and
nothing else: a CPU tensor takes the kernel's plain PyTorch version; a
CUDA tensor launches the hand-written kernels or raises (a wrong dtype,
a non-contiguous operand).  There is no mode switch that sends CUDA
tensors to the plain version, no fallback on error, and no counterpart
of the reference's shape gate that sent unaligned routing shapes to
jnp: at k = 8 the card runs the routing kernel.  Where the reference
sends ``l > 256`` to its jnp oracle, the card runs kernels too:
``distance_topk`` becomes l2_distance then the multi-pass local_topk
where the step's plan (``kernels/plan.py``) says so.  Each wrapper's
counter counts its kernel's launches where it launches it; the plain
versions count nothing.  A thread's launches inside :func:`counted_apart` are
counted in that block's tally instead.
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.kernels import _build, _cuda
from repro_torch.kernels import distance_topk as _dtk
from repro_torch.kernels import l2_distance as _l2
from repro_torch.kernels import local_topk as _ltk
from repro_torch.kernels import plan
from repro_torch.kernels import routing as _rt
from repro_torch.kernels import ref
from repro_torch.kernels import select_loop as _sel

COUNTERS = {c.name: c for c in (_l2.COUNT, _l2.COUNT_WIDE, _dtk.COUNT,
                                _dtk.COUNT_WIDE, _ltk.COUNT, _rt.COUNT,
                                _sel.COUNT, _dtk.COUNT_U8)}
DEVICE_LOOP, HOST_LOOP = "device_loop", "host_loop"   # Algorithm 1's paths


def _path(entry: str, t: torch.Tensor) -> str:
    if t.device.type == "cuda":
        return "cuda"
    if t.device.type == "cpu":
        return "plain"
    raise ValueError(f"{entry}: no kernel for device {t.device}")


def l2_distance(queries, points, *, valid=None):
    """``(B, d) x (m, d) -> (B, m)`` or ``(k, m, d) -> (k, B, m)`` squared
    L2.  ``valid`` (``(m,)`` or ``(k, m)`` bool) puts masked columns at
    +inf: inside the kernel on the card, after the plain version (as the
    reference's unfused path does) on the CPU."""
    if _path("l2_distance", queries) == "cuda":
        return _l2.l2_distance_cuda(queries, points, valid=valid)
    out = _l2.l2_distance_plain(queries, points)
    if valid is not None:
        out = torch.where(valid.bool().unsqueeze(-2), out,
                          torch.full_like(out, float("inf")))
    return out


def distance_topk(queries, points, l: int, *, valid=None):
    """Fused distance + top-l: ``((..., B, l) ascending, int32 indices
    into the point axis)``; +inf slots carry ``2**31-1``.  On the card,
    where the plan's path is not a fused kernel, the distances are
    written by l2_distance and their top-l taken in passes by
    local_topk.  uint8 points take uint8 queries and exact integer
    distances (``distance_topk_u8``; on the CPU its plain version)."""
    if _path("distance_topk", queries) == "cuda":
        sp = plan.step(queries.shape[0], queries.shape[-1], l,
                       points.element_size(), points.shape[-2],
                       _ltk.sm_count(queries.device.index or 0))
        if sp.path in (plan.DISTANCE_TOPK, plan.DISTANCE_TOPK_U8):
            return _dtk.distance_topk_cuda(queries, points, l, valid=valid)
        v, i = _ltk.local_topk_cuda(
            _l2.l2_distance_cuda(queries, points, valid=valid), l)
        return v, torch.where(torch.isfinite(v), i, ref.INT32_MAX)
    if points.dtype == torch.uint8:
        return _dtk.distance_topk_u8_plain(queries, points, l, valid=valid)
    return _dtk.distance_topk_plain(queries, points, l, valid=valid)


def local_topk(values, l: int):
    """``(..., m) -> ((..., l) ascending, (..., l) int32 indices)``."""
    if _path("local_topk", values) == "cuda":
        return _ltk.local_topk_cuda(values, l)
    return _ltk.local_topk_plain(values, l)


def select_path(v) -> str:
    """Where Algorithm 1 runs over keys ``v``: ``DEVICE_LOOP`` on the card
    (``csrc/select_loop.cu``), ``HOST_LOOP`` on the CPU (the plain
    version, ``core/selection.py``'s ``host_loop``)."""
    return DEVICE_LOOP if _path("select", v) == "cuda" else HOST_LOOP


def select_loop(v, i, l, gen, *, valid=None, max_iterations: int,
                num_pivots: int = 1):
    """Algorithm 1's device loop, one launch: ``(thr_v, thr_i, converged,
    iterations (B,) int32)`` (``kernels/select_loop.py``)."""
    return _sel.select_loop_cuda(v, i, l, gen, valid=valid,
                                 max_iterations=max_iterations,
                                 num_pivots=num_pivots)


def _rows_i32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(torch.int32).reshape(
        -1).contiguous()


def route_index(queries, ls, packed, rows=None, *, with_rows: bool = True):
    """The routing prologue of one batch: ``(rows (B, k) int32 or None,
    bucket rows (B, k*b) int32 or None, unions (k [+ k*b],) bool)``, the
    shards and buckets any row keeps.  ``packed``: a
    ``routing.PackedRouting`` on the queries' device; ``rows``: the
    caller's routing rows for index-only operands; ``with_rows=False``:
    the unions alone.  One launch on the card."""
    if _path("route_index", queries) == "cuda":
        return _rt.route_index_cuda(queries, ls, packed, rows,
                                    with_rows=with_rows)
    return _rt.route_index_plain(queries, ls, packed, rows,
                                 with_rows=with_rows)


def route_mask(queries, ls, packed, *, slack: float = 1e-4):
    """``(B, k)`` bool active mask, the ``route_shards`` decision on the
    device (kernels/routing.py).  ``ls``: ``(B,)`` ranks, 0 for padding
    rows; ``packed``: ``routing.pack_summaries`` operands (numpy, or
    tensors already on the queries' device), packed anew each call."""
    dev = queries.device
    pr = _rt.PackedRouting(packed, device=dev, slack=slack)
    out, _, _ = route_index(queries.to(torch.float32).contiguous(),
                            _rows_i32(ls, dev), pr)
    return out != 0


def index_mask(queries, ls, rows, packed, *, oversample: float = 2.0):
    """``(B, k*b)`` bool bucket keep, the ``search="approx"`` candidate
    decision on the device.  ``rows``: the ``(B, k)`` routing keep (bool
    or int); ``packed``: ``routing.pack_index`` operands."""
    dev = queries.device
    r = torch.as_tensor(rows, device=dev).to(torch.int32).contiguous()
    pr = _rt.PackedRouting(index=packed, device=dev, k=r.shape[1],
                           oversample=oversample)
    _, out, _ = route_index(queries.to(torch.float32).contiguous(),
                            _rows_i32(ls, dev), pr, r)
    return out != 0


@contextlib.contextmanager
def counted_apart():
    """Count this thread's launches inside the block apart from
    :func:`launch_counts`: yields a ``{kernel: launches}`` dict that fills
    as the block runs (the shadow audit's replay, which is not part of
    the served path)."""
    prev = getattr(_cuda._APART, "tally", None)
    tally = {}
    _cuda._APART.tally = tally
    try:
        yield tally
    finally:
        _cuda._APART.tally = prev


def load_library() -> None:
    """Build (a checkout's first use) and load the card's kernel library
    now rather than at the first launch."""
    _build.library()


def launch_counts() -> dict:
    return {name: c.n for name, c in COUNTERS.items()}


def reset_launch_counts() -> None:
    for c in COUNTERS.values():
        c.reset()


def service_envelope(bucket_b: int, m_local: int, dim: int, l: int, *,
                     k: int, device, dtype=torch.float32) -> dict:
    """Which path each kernel takes for one service bucket shape, without
    launching anything: ``cuda`` on the card, ``plain`` on the CPU.  On
    the card, the step's plan (``kernels/plan.py``) for points of
    ``dtype`` (``points_dtype``; any type but uint8 is planned as f32)
    under these keys: its path (``dtk_path``), the fused kernel's tile,
    chunk and blocks or local_topk's passes, l2_distance's tile and blocks
    (None for uint8 points, whose step is ``distance_topk_u8``); all None
    on the CPU, and on the card where the plan is ``unsupported``.
    ``select_path``: where Algorithm 1 runs, ``device_loop`` on the card
    and ``host_loop`` on the CPU.
    """
    dev = torch.device(device)
    path = "cuda" if dev.type == "cuda" else "plain"
    u8 = dtype == torch.uint8
    env = {"bucket_b": bucket_b, "m_local": m_local, "dim": dim, "l": l,
           "k": k, "path": path, "points_dtype": str(dtype).split(".")[-1],
           "dtk_path": None, "dtk_tile": None,
           "dtk_chunk": None, "dtk_blocks": None, "ltk_passes": None,
           "l2_tile": None, "l2_blocks": None, "unsupported": None,
           "select_path": HOST_LOOP}
    if path == "plain":
        return env
    env["select_path"] = DEVICE_LOOP
    sp = plan.step(bucket_b, dim, l, plan.U8_ELEM if u8 else 4, m_local,
                   _ltk.sm_count(dev.index or 0))
    if sp.unsupported:
        env["unsupported"] = sp.unsupported
        return env
    env.update(dtk_path=sp.path, ltk_passes=sp.passes)
    if not u8:
        env.update(l2_tile=sp.l2.tile, l2_blocks=sp.l2.blocks)
    if sp.path != plan.L2_LOCAL_TOPK:
        env.update(dtk_tile=sp.topk.tile, dtk_chunk=sp.topk.chunk,
                   dtk_blocks=sp.topk.blocks)
    return env
