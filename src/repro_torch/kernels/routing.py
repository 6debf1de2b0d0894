"""Shard routing and the bucket keep on the device: the CUDA kernel's
wrapper, the plain PyTorch versions, and the operand packing.

Port of ``repro.kernels.routing`` (Pallas ``route_mask`` and
``index_mask``).  One kernel, ``csrc/route_index_mask.cu``, computes
both masks and their batch unions in one launch, in three modes: route,
route + index, and index with the caller's routing rows; its note says
what bounds it on the card.

**Parity.**  ``route_mask`` is held to the host f64 ``route_shards``
bit for bit on the test instances, as the reference's kernel is: the f32
bounds carry the same structure (direct-difference distances, never the
``|q|^2 - 2q.c + |c|^2`` expansion; a sort-free cumulative-live
threshold that counts ties as the host's stable-argsort prefix does;
the ``T*(1+slack) + err`` margin), so the two disagree only where a
bound lands within f32 rounding of the threshold.  On the card the
kernel equals its plain version bit for bit: both take every sum over
the coordinates in order, round every product and sum on its own (no
fused multiply-add), and use IEEE square roots.  The live-count sums are
of integers below 2^24, exact in any order.  The projection dots are
sequential sums here, where the reference leaves them to XLA's dot.
``index_mask`` is the same construction at bucket granularity; the
reference calls that tier approximate against its host rule
(``store/index.py`` ``bucket_keep``).

``pack_summaries`` / ``pack_index`` give the reference's operand
layouts, as host numpy; :class:`PackedRouting` puts them in one device
buffer, so a call checks two tensors and makes one ctypes call.  The
static server packs once; a store-backed server packs each generation's
summaries and index into a new one.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build, _cuda

COUNT = _cuda.LaunchCounter("route_index_mask")
MODES = {"route": 0, "route+index": 1, "index": 2}

_F32_EPS = float(np.finfo(np.float32).eps)       # 2^-23


def pack_summaries(s) -> tuple[np.ndarray, ...]:
    """A :class:`~repro_torch.store.ShardSummaries` as the kernel's f32
    operands, k on the last dimension throughout: ``centsT`` (dim, k),
    ``radii``/``live`` (1, k), ``loT``/``hiT`` (r, k), ``pivT`` (m*dim, k)
    slot-major, ``pivrT``/``occT``/``pliveT`` (m, k), ``rmax`` (1, 1),
    ``dirsT`` (dim, r).  Single-pivot summaries pack one unoccupied slot;
    no sketch packs one neutral interval."""
    k, dim = s.centroids.shape
    centsT = np.ascontiguousarray(s.centroids.T, np.float32)
    radii = s.radii[None].astype(np.float32)
    live = s.live[None].astype(np.float32)
    if s.directions.shape[0]:
        loT = np.ascontiguousarray(s.proj_lo.T, np.float32)
        hiT = np.ascontiguousarray(s.proj_hi.T, np.float32)
        dirsT = np.ascontiguousarray(s.directions.T, np.float32)
    else:
        loT = np.full((1, k), -np.inf, np.float32)
        hiT = np.full((1, k), np.inf, np.float32)
        dirsT = np.zeros((dim, 1), np.float32)
    if s.pivots is None:
        pivT = np.zeros((dim, k), np.float32)
        pivrT = np.zeros((1, k), np.float32)
        occT = np.zeros((1, k), np.float32)
        pliveT = np.zeros((1, k), np.float32)
    else:
        m = s.pivots.shape[1]
        pivT = np.ascontiguousarray(
            np.transpose(s.pivots, (1, 2, 0)).reshape(m * dim, k),
            np.float32)
        pivrT = np.ascontiguousarray(s.pivot_radii.T, np.float32)
        occT = (np.arange(m)[:, None]
                < s.pivot_count[None, :]).astype(np.float32)
        pliveT = (np.ascontiguousarray(s.pivot_live.T, np.float32)
                  if s.pivot_live is not None
                  else np.zeros((m, k), np.float32))
    alive = s.live > 0
    R = (float((np.linalg.norm(s.centroids[alive], axis=1)
                + s.radii[alive]).max()) if alive.any() else 0.0)
    rmax = np.full((1, 1), R, np.float32)
    return (centsT, radii, live, loT, hiT, pivT, pivrT, occT, pliveT,
            rmax, dirsT)


def pack_index(index) -> tuple[np.ndarray, ...]:
    """A :class:`~repro_torch.store.ShardIndex` as the index kernel's f32
    operands: ``bcentsT`` (dim, k*b), column ``j*b + t`` for shard j
    bucket t, and ``bradii``/``blive`` (1, k*b); unoccupied or emptied
    buckets carry live 0."""
    k, b, dim = index.centers.shape
    occ = ((np.arange(b)[None, :] < index.count[:, None])
           & (index.live > 0))
    bcentsT = np.ascontiguousarray(
        index.centers.reshape(k * b, dim).T, np.float32)
    bradii = np.where(occ, index.radii, 0.0).reshape(1, -1).astype(
        np.float32)
    blive = np.where(occ, index.live, 0).reshape(1, -1).astype(np.float32)
    return bcentsT, bradii, blive


def on_device(packed, device) -> tuple[torch.Tensor, ...]:
    """Packed operands as contiguous f32 tensors on ``device``."""
    return tuple(torch.as_tensor(x, dtype=torch.float32,
                                 device=device).contiguous()
                 for x in packed)


def _route_constants(dim: int, slack: float) -> tuple[float, float]:
    """``(1 + slack, 16*(dim+1)*eps)`` rounded to f32, as the reference
    rounds them; kernel and plain version take the same two numbers."""
    return (float(np.float32(1.0 + slack)),
            float(np.float32(16.0 * (dim + 1) * _F32_EPS)))


def _sq_dists(q, matT, row0: int, dim: int):
    """(B, cols) squared direct-difference distances from each query row
    to the columns of ``matT`` rows ``[row0, row0+dim)``, summed
    coordinate by coordinate."""
    acc = torch.zeros((q.shape[0], matT.shape[1]), dtype=torch.float32,
                      device=q.device)
    for d in range(dim):
        diff = q[:, d:d + 1] - matT[row0 + d:row0 + d + 1, :]
        acc = acc + diff * diff
    return acc


def _sort_free_threshold(ub, live, lf):
    """``min{ub_c : sum_j live_j [ub_j <= ub_c] >= l}`` per row (+inf
    when no candidate reaches l): ``ub`` (B, n), ``live`` (1, n) or
    (B, n), ``lf`` (B, 1)."""
    cnt = torch.where(ub.unsqueeze(1) <= ub.unsqueeze(2),
                      live.unsqueeze(1), 0.0).sum(-1)          # (B, n)
    inf = torch.full_like(ub, float("inf"))
    return torch.where(cnt >= lf, ub, inf).amin(1, keepdim=True)


def route_mask_plain(queries, ls, packed, *, slack: float = 1e-4):
    """``(B, dim)`` queries, ``(B,)`` ls -> ``(B, k)`` int32 keep (1 =
    shard active): the kernel's arithmetic in PyTorch, op for op."""
    (centsT, radii, live, loT, hiT, pivT, pivrT, occT, pliveT, rmax,
     dirsT) = packed
    q = queries.to(torch.float32)
    B, dim = q.shape
    k = centsT.shape[1]
    m = occT.shape[0]
    r = loT.shape[0]
    l2 = ls.reshape(-1, 1).to(torch.int32)
    inf = torch.tensor(float("inf"), device=q.device)
    slack1, errc = _route_constants(dim, slack)

    dc = _sq_dists(q, centsT, 0, dim).sqrt()
    lbd = torch.clamp(dc - radii, min=0.0)
    ubd = dc + radii

    # pivot-ball union bracket; unoccupied slots are neutral
    plb = torch.full((B, k), float("inf"), device=q.device)
    pub = torch.full((B, k), -float("inf"), device=q.device)
    dp_slots = []
    for p in range(m):
        dp = _sq_dists(q, pivT, p * dim, dim).sqrt()
        dp_slots.append(dp)
        occ = occT[p:p + 1, :] > 0.0
        plb = torch.minimum(plb, torch.where(
            occ, torch.clamp(dp - pivrT[p:p + 1, :], min=0.0), inf))
        pub = torch.maximum(pub, torch.where(
            occ, dp + pivrT[p:p + 1, :], -inf))
    has = occT.amax(0, keepdim=True) > 0.0
    lbd = torch.maximum(lbd, torch.where(has, plb, 0.0))
    ubd = torch.minimum(ubd, torch.where(has, pub, inf))

    # projection-sketch lower bound, dots summed coordinate by coordinate
    qp = torch.zeros((B, r), dtype=torch.float32, device=q.device)
    for d in range(dim):
        qp = qp + q[:, d:d + 1] * dirsT[d:d + 1, :]
    for rr in range(r):
        gap = torch.clamp(torch.maximum(
            loT[rr:rr + 1, :] - qp[:, rr:rr + 1],
            qp[:, rr:rr + 1] - hiT[rr:rr + 1, :]), min=0.0)
        lbd = torch.maximum(lbd, gap)

    alive = live > 0.0
    lb = torch.where(alive, lbd * lbd, inf)
    ub = torch.where(alive, ubd * ubd, inf)

    lf = l2.to(torch.float32)
    T = _sort_free_threshold(ub, live, lf)
    # ball-granular threshold from the pivot balls' live credits
    tubs = []
    for p in range(m):
        credit = (occT[p:p + 1, :] > 0.0) & (pliveT[p:p + 1, :] > 0.0)
        bub = dp_slots[p] + pivrT[p:p + 1, :]
        tubs.append(torch.where(credit, bub * bub, inf))
    T = torch.minimum(T, _sort_free_threshold(
        torch.cat(tubs, 1), pliveT.reshape(1, -1), lf))

    # f32-pipeline error margin: 16*(dim+1)*eps*(|q| + R)^2
    q2 = torch.zeros((B, 1), dtype=torch.float32, device=q.device)
    for d in range(dim):
        q2 = q2 + q[:, d:d + 1] * q[:, d:d + 1]
    s = q2.sqrt() + rmax
    t_eff = T * slack1 + errc * (s * s)
    keep = alive & (lb <= t_eff) & (l2 > 0)
    return keep.to(torch.int32)


def index_parts(queries, ls, rows, packed, *, oversample: float = 2.0):
    """The bucket rule's working, ``(g, lb, T)``: the gated columns
    (B, k*b) bool, their squared lower bounds (B, k*b) and each row's
    threshold (B, 1), as :func:`index_mask_plain` computes them."""
    bcentsT, bradii, blive = packed
    q = queries.to(torch.float32)
    B, dim = q.shape
    kb = bcentsT.shape[1]
    k = rows.shape[1]
    b = kb // k
    l2 = ls.reshape(-1, 1).to(torch.int32)
    inf = torch.tensor(float("inf"), device=q.device)
    d = _sq_dists(q, bcentsT, 0, dim).sqrt()
    col_shard = torch.arange(kb, device=q.device) // b
    gate = rows[:, col_shard] != 0
    g = gate & (blive > 0.0)
    lbd = torch.clamp(d - bradii, min=0.0)
    lb = torch.where(g, lbd * lbd, inf)
    ubd = d + bradii
    ub = torch.where(g, ubd * ubd, inf)
    lf = l2.to(torch.float32)
    over = torch.tensor(float(np.float32(oversample)), device=q.device)
    target = torch.maximum(lf, torch.ceil(over * lf))
    return g, lb, _sort_free_threshold(ub, blive, target)


def index_mask_plain(queries, ls, rows, packed, *, oversample: float = 2.0):
    """``(B, dim)`` queries, ``(B,)`` ls, ``(B, k)`` routing keep ->
    ``(B, k*b)`` int32 bucket keep: the kernel's arithmetic in PyTorch."""
    g, lb, T = index_parts(queries, ls, rows, packed, oversample=oversample)
    l2 = ls.reshape(-1, 1)
    return (g & (lb <= T) & (l2 > 0)).to(torch.int32)


class PackedRouting:
    """The routing kernel's operands in one contiguous f32 buffer on one
    device, with its f32 constants rounded once.

    ``summaries``: the 11 :func:`pack_summaries` operands, or None (index
    mode, which then needs ``k``); ``index``: the 3 :func:`pack_index`
    operands, or None.  The buffer holds them flattened in that order
    (``csrc/route_index_mask.cu`` ``Ops`` reads the same layout), padded
    to whole float4s; :meth:`route_ops` and :meth:`index_ops` are views
    of it, for the plain versions.
    """

    def __init__(self, summaries=None, index=None, *, device, k=None,
                 slack: float = 1e-4, oversample: float = 2.0):
        if summaries is None and index is None:
            raise ValueError("PackedRouting needs summaries or an index")
        parts = [torch.as_tensor(x, dtype=torch.float32, device=device)
                 for x in (*(summaries or ()), *(index or ()))]
        if summaries is not None:
            self.dim, self.k = parts[0].shape
            self.m, self.r = parts[7].shape[0], parts[3].shape[0]
        else:
            self.dim, self.k, self.m, self.r = parts[0].shape[0], k, 0, 0
        self.kb = 0 if index is None else parts[-3].shape[1]
        self.route, self.index = summaries is not None, index is not None
        self.shapes = self._shapes()
        if [tuple(x.shape) for x in parts] != self.shapes:
            raise ValueError(f"packed operands {[tuple(x.shape) for x in parts]}"
                             f" do not fit dim={self.dim}, k={self.k}, "
                             f"m={self.m}, r={self.r}, kb={self.kb}")
        if self.index and (not self.k or self.kb % self.k):
            raise ValueError(f"k*b={self.kb} columns for k={self.k} shards")
        n = sum(x.numel() for x in parts)
        self.buf = torch.zeros(-(-n // 4) * 4, dtype=torch.float32,
                               device=device)
        self.buf[:n] = torch.cat([x.reshape(-1) for x in parts])
        self.slack, self.oversample = slack, oversample
        self.slack1, self.errc = _route_constants(self.dim, slack)
        self.over = float(np.float32(oversample))

    def _shapes(self):
        dim, k, m, r, kb = self.dim, self.k, self.m, self.r, self.kb
        route = [(dim, k), (1, k), (1, k), (r, k), (r, k), (m * dim, k),
                 (m, k), (m, k), (m, k), (1, 1), (dim, r)]
        return ((route if self.route else [])
                + ([(dim, kb), (1, kb), (1, kb)] if self.index else []))

    def _views(self):
        out, o = [], 0
        for shape in self.shapes:
            n = shape[0] * shape[1]
            out.append(self.buf[o:o + n].view(shape))
            o += n
        return out

    def route_ops(self) -> tuple[torch.Tensor, ...]:
        return tuple(self._views()[:11])

    def index_ops(self) -> tuple[torch.Tensor, ...]:
        return tuple(self._views()[-3:])

    def mode(self, rows) -> str:
        """The kernel's mode for a call with ``rows`` (None or given):
        route, route + index, or index, which takes index-only operands
        (the kernel reads the buffer by the mode)."""
        if rows is not None:
            if self.route or not self.index:
                raise ValueError("routing rows go with index-only operands")
            return "index"
        if not self.route:
            raise ValueError("index-only operands need the routing rows")
        return "route+index" if self.index else "route"


def route_index_plain(queries, ls, packed: PackedRouting, rows=None, *,
                      with_rows: bool = True):
    """The kernel's function in PyTorch: ``(rows (B, k) int32 or None,
    bucket rows (B, k*b) int32 or None, unions (k [+ k*b],) bool)`` by
    :func:`route_mask_plain` and :func:`index_mask_plain`, the unions
    their ``any(0)``; ``with_rows=False`` returns the unions alone."""
    mode = packed.mode(rows)
    route = idx = None
    if mode != "index":
        rows = route = route_mask_plain(queries, ls, packed.route_ops(),
                                        slack=packed.slack)
    unions = [rows.any(0)]
    if mode != "route":
        idx = index_mask_plain(queries, ls, rows, packed.index_ops(),
                               oversample=packed.oversample)
        unions.append(idx.any(0))
    if not with_rows:
        route = idx = None
    return route, idx, torch.cat(unions)


def route_index_cuda(queries, ls, packed: PackedRouting, rows=None, *,
                     with_rows: bool = True):
    """The kernel, one launch for any B: ``(rows (B, k) int32 or None,
    bucket rows (B, k*b) int32 or None, unions (k [+ k*b],) bool)``; the
    mode as :meth:`PackedRouting.mode`.  ``with_rows=False`` (the
    server's prologue) has the kernel write the unions alone."""
    mode = packed.mode(rows)
    dev = queries.device
    if (queries.device.type != "cuda" or packed.buf.device != dev
            or ls.device != dev):
        raise ValueError(f"route_index_mask: queries, ls and the packed "
                         f"operands must be on one CUDA device, got "
                         f"{queries.device}, {ls.device}, {packed.buf.device}")
    B = queries.shape[0]
    if (queries.dtype != torch.float32 or queries.shape != (B, packed.dim)
            or not queries.is_contiguous()):
        raise TypeError(f"route_index_mask: queries must be contiguous "
                        f"({B}, {packed.dim}) float32, got "
                        f"{tuple(queries.shape)} {queries.dtype}")
    if ls.dtype != torch.int32 or ls.shape != (B,):
        raise TypeError(f"route_index_mask: ls must be ({B},) int32, got "
                        f"{tuple(ls.shape)} {ls.dtype}")
    k, kb = packed.k, packed.kb if mode != "route" else 0
    if rows is not None and (rows.dtype != torch.int32 or rows.shape != (B, k)
                             or rows.device != dev
                             or not rows.is_contiguous()):
        raise TypeError(f"route_index_mask: rows must be contiguous ({B}, "
                        f"{k}) int32 on {dev}")
    route = idx = None
    if with_rows and mode != "index":
        route = torch.empty((B, k), dtype=torch.int32, device=dev)
    if with_rows and kb:
        idx = torch.empty((B, kb), dtype=torch.int32, device=dev)
    unions = torch.empty(k + kb, dtype=torch.bool, device=dev)
    if not B:
        unions.zero_()
        return route, idx, unions
    _cuda.ok("route_index_mask", _build.library().knn_route_index_mask(
        queries.data_ptr(), ls.data_ptr(), packed.buf.data_ptr(),
        None if rows is None else rows.data_ptr(),
        None if route is None else route.data_ptr(),
        None if idx is None else idx.data_ptr(), unions.data_ptr(), B,
        packed.dim, k, packed.m, packed.r, packed.kb, MODES[mode],
        packed.slack1, packed.errc, packed.over, _cuda.stream_of(queries)))
    COUNT.add()
    return route, idx, unions
