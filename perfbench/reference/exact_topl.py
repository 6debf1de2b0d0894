"""Exact top-l over a point set streamed in chunks, and the control.

:func:`scan` walks the chunks once.  For each query it keeps the ``l``
nearest points by squared L2, ties to the smaller id, computed in f64
(``precision="f64"``: the reference); it also computes, in f64 and by
direct differences, the distance of every id an answer under test
named, and the largest squared norm of any point.

``precision="tf32"`` is the control: the same top-l computed from f32
distances whose product runs in TF32 (on the card with TF32 switched
on; on the CPU by rounding both operands to TF32's 10-bit mantissa
first, which is what the tensor cores do).  It stands in for the
program computed one precision below the f32 the configuration states.
"""

from __future__ import annotations

import contextlib

import torch

ID_PAD = torch.iinfo(torch.int64).max


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) rounded to nearest, ties to even, at TF32's 10-bit
    mantissa."""
    i = x.contiguous().view(torch.int32)
    low = torch.bitwise_and(torch.bitwise_right_shift(i, 13), 1)
    i = torch.bitwise_and(i + 0x0FFF + low, ~0x1FFF)
    return i.view(torch.float32)


@contextlib.contextmanager
def _tf32(on: bool):
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _distances(q: torch.Tensor, p: torch.Tensor, pn: torch.Tensor,
               precision: str):
    """``(S, d) x (R, d) -> (S, R)`` squared L2 by the expanded form;
    ``pn`` holds the points' squared norms."""
    if precision == "f64":
        q = q.double()
        prod = q @ p.T
    elif precision == "tf32":
        q, p = q.float(), p.float()
        if q.device.type == "cuda":
            with _tf32(True):
                prod = q @ p.T
        else:
            with _tf32(False):
                prod = round_tf32(q) @ round_tf32(p).T
    else:
        raise ValueError(f"precision {precision!r}")
    qn = (q * q).sum(1, keepdim=True)
    return prod.mul_(-2.0).add_(pn.unsqueeze(0)).add_(qn)


def _lexi_first(d: torch.Tensor, ids: torch.Tensor, l: int):
    """Per row, the ``l`` smallest by (distance, id)."""
    o = torch.argsort(ids, dim=1)
    d, ids = d.gather(1, o), ids.gather(1, o)
    o = torch.argsort(d, dim=1, stable=True)[:, :l]
    return d.gather(1, o), ids.gather(1, o)


def _block_top(d: torch.Tensor, row0: int, l: int):
    """The ``l`` smallest of each row of ``d`` (columns are ids ``row0``
    on), ties at the cut to the smaller id."""
    S, R = d.shape
    l = min(l, R)
    v, j = torch.topk(d, l, dim=1, largest=False, sorted=True)
    t = v[:, -1:]
    short = ((d == t).sum(1) > (v == t).sum(1)).nonzero().flatten()
    for r in short.tolist():
        # a tie at the cut left out an equal point of smaller id: take
        # every point below the cut and the first of those at it
        row = d[r]
        below = row < t[r]
        at = row == t[r]
        need = l - int(below.sum())
        keep = below | (at & (torch.cumsum(at.to(torch.int64), 0) <= need))
        j[r] = keep.nonzero().flatten()
        v[r] = row[j[r]]
    return v, j.to(torch.int64) + row0


def scan(queries: torch.Tensor, l: int, chunks, served_ids=None, *,
         precision: str = "f64", block_bytes: int = 1 << 33) -> dict:
    """One pass over ``chunks`` (``(first row, (R, d) f32)`` in order).

    ``queries``: ``(S, d)`` f32 on the chunks' device; they are taken
    in blocks whose distances to one chunk hold ``block_bytes`` at most.  ``served_ids``:
    optional ``(S, L)`` int64, the ids answers under test named (-1 for
    none).  Returns ``top_d`` ``(S, l)`` (f64, or f32 for the control),
    ``top_i`` ``(S, l)`` int64 (``ID_PAD`` where fewer than l points
    exist), ``served_d`` ``(S, L)`` f64 (NaN where no id was named or
    the id lies outside the points) and ``max_norm2``, the largest
    squared norm of a point.
    """
    dev = queries.device
    S = queries.shape[0]
    dt = torch.float64 if precision == "f64" else torch.float32
    top_d = torch.full((S, l), float("inf"), dtype=dt, device=dev)
    top_i = torch.full((S, l), ID_PAD, dtype=torch.int64, device=dev)
    served_d = None
    if served_ids is not None:
        served_ids = served_ids.to(dev)
        served_d = torch.full(served_ids.shape, float("nan"),
                              dtype=torch.float64, device=dev)
        owner = torch.arange(S, device=dev).unsqueeze(1).expand_as(
            served_ids)
    q64 = queries.double()
    max_norm2 = 0.0
    for row0, p in chunks:
        R = p.shape[0]
        p64 = p.double()
        pn64 = (p64 * p64).sum(1)
        max_norm2 = max(max_norm2, float(pn64.max()))
        if precision == "f64":
            pd, pn = p64, pn64
        else:
            pd, pn = p, (p * p).sum(1)
        query_block = max(1, block_bytes // (8 * R))
        for s0 in range(0, S, query_block):
            s1 = min(S, s0 + query_block)
            d = _distances(queries[s0:s1], pd, pn, precision)
            v, i = _block_top(d, row0, l)
            del d
            if v.shape[1] < l:
                pad = l - v.shape[1]
                v = torch.cat([v, v.new_full((s1 - s0, pad), float("inf"))],
                              1)
                i = torch.cat([i, i.new_full((s1 - s0, pad), ID_PAD)], 1)
            top_d[s0:s1], top_i[s0:s1] = _lexi_first(
                torch.cat([top_d[s0:s1], v], 1),
                torch.cat([top_i[s0:s1], i], 1), l)
        if served_ids is not None:
            hit = (served_ids >= row0) & (served_ids < row0 + R)
            where = hit.nonzero(as_tuple=True)
            step = max(1, (1 << 28) // (8 * p.shape[1]))
            for h0 in range(0, where[0].numel(), step):
                sel = tuple(w[h0:h0 + step] for w in where)
                rows = p64[served_ids[sel] - row0]
                served_d[sel] = ((rows - q64[owner[sel]]) ** 2).sum(1)
        del p, p64, pd, pn, pn64
    return {"top_d": top_d, "top_i": top_i, "served_d": served_d,
            "max_norm2": max_norm2}
