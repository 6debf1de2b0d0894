"""Algorithm 1 — distributed randomized selection over k shards.

Port of ``repro.core.selection``.  The paper's k machines are dimension 0
of every per-shard tensor (``parallel/collectives.py``); control state
(the open interval (lo, hi) over composite keys, the remaining rank, the
per-row done flags) is held once, replicated, as the reference's
leaderless SPMD form holds it identically on every shard.

Per iteration, each shard proposes a uniform element of its in-range set
(independent draws, shape ``(k, B)``), one weighted draw per row picks a
shard with probability n_i / n (Lemma 2.1), and one count of the
elements at or below the pivot narrows the interval.  Both bounds are
exclusive, so the pivot leaves the candidate set every iteration and the
loop ends deterministically.  ``num_pivots > 1`` (beyond the paper)
evaluates every shard's proposal in the same two rounds.  The iteration
cap is the reference's ``8*ceil(log2(m*k))+16``.

The loop runs on one of two paths, by the keys' device
(``kernels.ops.select_path``):

* on the card, the device loop (``kernels/csrc/select_loop.cu``): one
  launch runs every row's whole loop, one block a row, as the
  reference's ``lax.while_loop`` runs it inside one program, and nothing
  is read back (``host_syncs`` 0);
* on the CPU, :func:`host_loop`, the plain version: every row in
  lockstep through ``_select_body``, whose ``all(done)`` check reads a
  flag each iteration, counted in ``host_syncs``.

Both give each row's iteration count as a ``(B,)`` tensor on the keys'
device, ``SelectionResult.row_iterations``; ``iterations``, the batch's
(the largest row's, the lockstep loop's count), reads it, a sync on the
card, so a hot caller reads the counts with its own readback instead.

Randomness comes from one ``torch.Generator`` on the data's device (the
device loop draws one Philox seed from it); the reference's
``jax.random`` streams cannot be reproduced, but the selection is exact
(Las Vegas), so the thresholds do not depend on them: both paths give
the same ones.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core import counting as ck
from repro_torch.kernels import ops as kops
from repro_torch.parallel.collectives import all_gather, psum

_INF = float("inf")


class SelectionResult(NamedTuple):
    """Replicated result of one batched selection.

    An element x is selected iff ``x <= (threshold_v, threshold_i)`` in
    composite order.  ``row_iterations``: each row's iterations until it
    was done (the cap where it was not), on the keys' device;
    ``host_syncs``: the reads the selection made, a host int.
    """

    threshold_v: torch.Tensor     # (B,) float
    threshold_i: torch.Tensor     # (B,) int32
    converged: torch.Tensor       # (B,) bool — False only if the cap was hit
    row_iterations: torch.Tensor  # (B,) int32
    host_syncs: int

    @property
    def iterations(self) -> int:
        """The batch's iterations, the largest row's (one read on the
        card)."""
        rows = self.row_iterations
        return int(rows.max()) if rows.numel() else 0


class _State(NamedTuple):
    lo_v: torch.Tensor
    lo_i: torch.Tensor
    hi_v: torch.Tensor
    hi_i: torch.Tensor
    rank: torch.Tensor     # remaining rank within (lo, hi), (B,) int32
    done: torch.Tensor     # (B,) bool
    thr_v: torch.Tensor
    thr_i: torch.Tensor


def _propose_local_pivot(v, i, cand, gen):
    """Every shard draws one uniform element of its in-range set
    (Algorithm 1, line 5(2)); an empty shard proposes the +inf sentinel,
    and its zero count gives it probability zero in the machine draw."""
    n_i = cand.sum(-1, dtype=torch.int32)                       # (k, B)
    r = torch.rand(n_i.shape, generator=gen, device=v.device)
    u = torch.floor(r * n_i.clamp(min=1)).to(torch.int32)
    u = torch.minimum(u, (n_i - 1).clamp(min=0))
    idx = ck.masked_select_nth(cand, u).unsqueeze(-1)
    pv = v.gather(-1, idx).squeeze(-1)
    pi = i.gather(-1, idx).squeeze(-1)
    empty = n_i == 0
    return (torch.where(empty, _INF, pv), torch.where(empty, ck.ID_HI, pi),
            n_i)


def _weighted_machine(g_n, gen):
    """One draw per row: shard j with probability n_j / sum(n)."""
    cum = torch.cumsum(g_n.to(torch.int64), dim=0)              # (k, B)
    total = cum[-1]
    r = torch.rand(total.shape, generator=gen, device=g_n.device)
    pick = torch.minimum(torch.floor(r * total).to(torch.int64),
                         (total - 1).clamp(min=0))
    choice = (cum <= pick.unsqueeze(0)).sum(0)
    return choice.clamp(max=g_n.shape[0] - 1)


def _key_argmin(v, i):
    """Lexicographic min over dimension 0 of (P, B) keys."""
    mv = v.min(0).values
    mi = torch.where(v == mv.unsqueeze(0), i, ck.ID_HI).min(0).values
    return mv, mi


def _key_argmax(v, i, payload):
    """Lexicographic max over dimension 0, carrying an int payload."""
    mv = v.max(0).values
    tie = v == mv.unsqueeze(0)
    mi = torch.where(tie, i, ck.ID_LO).max(0).values
    sel = tie & (i == mi.unsqueeze(0))
    mp = torch.where(sel, payload, ck.ID_LO).max(0).values
    return mv, mi, mp


def _select_body(st: _State, v, i, valid, gen, num_pivots) -> _State:
    b3 = lambda x: x[None, :, None]                             # noqa: E731
    cand = ck.in_open_interval(v, i, b3(st.lo_v), b3(st.lo_i),
                               b3(st.hi_v), b3(st.hi_i))
    if valid is not None:
        cand = cand & valid
    pv, pi, n_i = _propose_local_pivot(v, i, cand, gen)

    # ---- paper round 1: pivot selection (all-gather of k triples) -------
    g_pv, g_pi, g_n = all_gather(pv), all_gather(pi), all_gather(n_i)
    if num_pivots <= 1:
        choice = _weighted_machine(g_n, gen).unsqueeze(0)       # (1, B)
        piv_v, piv_i = g_pv.gather(0, choice), g_pi.gather(0, choice)
    else:
        piv_v, piv_i = g_pv, g_pi                               # (k, B)

    # ---- paper round 2: getSize(lo, p], one psum ------------------------
    le = ck.key_le(v.unsqueeze(0), i.unsqueeze(0),
                   piv_v[:, None, :, None], piv_i[:, None, :, None])
    local_cnt = (le & cand.unsqueeze(0)).sum(-1, dtype=torch.int32)
    cnt = psum(local_cnt.transpose(0, 1))                       # (P, B)

    rank = st.rank.unsqueeze(0)
    b2 = lambda x: x.unsqueeze(0)                               # noqa: E731
    pvalid = ck.in_open_interval(piv_v, piv_i, b2(st.lo_v), b2(st.lo_i),
                                 b2(st.hi_v), b2(st.hi_i))
    hit = pvalid & (cnt == rank)
    below = pvalid & (cnt < rank)
    above = pvalid & (cnt > rank)

    best_lo_v, best_lo_i, best_lo_cnt = _key_argmax(
        torch.where(below, piv_v, -_INF), torch.where(below, piv_i, ck.ID_LO),
        cnt)
    best_hi_v, best_hi_i = _key_argmin(
        torch.where(above, piv_v, _INF), torch.where(above, piv_i, ck.ID_HI))
    hit_v, hit_i = _key_argmin(torch.where(hit, piv_v, _INF),
                               torch.where(hit, piv_i, ck.ID_HI))
    any_hit = hit.any(0)
    has_lo = below.any(0)
    has_hi = above.any(0)

    done_now = any_hit & ~st.done
    keep = st.done

    def upd(cond, new, old):
        return torch.where(keep, old, torch.where(cond, new, old))

    return _State(
        lo_v=upd(has_lo, best_lo_v, st.lo_v),
        lo_i=upd(has_lo, best_lo_i, st.lo_i),
        hi_v=upd(has_hi, best_hi_v, st.hi_v),
        hi_i=upd(has_hi, best_hi_i, st.hi_i),
        rank=upd(has_lo, st.rank - best_lo_cnt, st.rank),
        done=st.done | any_hit,
        thr_v=torch.where(done_now, hit_v, st.thr_v),
        thr_i=torch.where(done_now, hit_i, st.thr_i),
    )


def iteration_cap(n_global: int) -> int:
    """Theorem 2.2 w.h.p. bound with the reference's generous constant."""
    return 8 * max(1, math.ceil(math.log2(max(n_global, 2)))) + 16


def select_l_smallest(v, i, l, gen: torch.Generator, *, valid=None,
                      max_iterations: int | None = None,
                      num_pivots: int = 1) -> SelectionResult:
    """Composite-key threshold of the ``l`` smallest elements over k shards.

    ``v``/``i``: ``(k, B, m)`` per-shard values and int32 global ids
    (``(k, m)`` for one problem).  ``+inf`` entries are sentinels.  ``l``
    is an int or ``(B,)`` int tensor; rows with ``l == 0`` are done at
    once with the ``(-inf, ID_LO)`` threshold, rows asking for every
    element with ``(+inf, ID_HI)``.  ``valid`` (``(k, B, m)`` bool)
    hides elements from the search.  Rows that reach the cap report
    ``converged=False``.  The device loop runs it on the card,
    :func:`host_loop` on the CPU (module docstring).
    """
    if v.dim() == 2:
        v, i = v.unsqueeze(1), i.unsqueeze(1)
        if valid is not None and valid.dim() == 2:
            valid = valid.unsqueeze(1)
    k, _, m = v.shape
    if max_iterations is None:
        max_iterations = iteration_cap(m * k)
    if kops.select_path(v) == kops.HOST_LOOP:
        return host_loop(v, i, l, gen, valid=valid,
                         max_iterations=max_iterations,
                         num_pivots=num_pivots)
    thr_v, thr_i, conv, rows = kops.select_loop(
        v.contiguous(), i.contiguous(), l, gen, valid=valid,
        max_iterations=max_iterations, num_pivots=num_pivots)
    return SelectionResult(threshold_v=thr_v, threshold_i=thr_i,
                           converged=conv, row_iterations=rows, host_syncs=0)


def host_loop(v, i, l, gen: torch.Generator, *, valid=None,
              max_iterations: int, num_pivots: int = 1) -> SelectionResult:
    """The host-paced loop over ``(k, B, m)`` keys, every row in lockstep:
    the plain version, :func:`select_l_smallest`'s path on the CPU."""
    k, B, m = v.shape
    dev = v.device
    l = torch.as_tensor(l, dtype=torch.int32, device=dev).expand(B)
    if valid is None:
        total = torch.full((B,), m * k, dtype=torch.int32, device=dev)
    else:
        total = psum(valid.sum(-1, dtype=torch.int32))
    l = torch.minimum(l, total)
    zero = l <= 0
    allsel = l >= total

    def full(val, dtype):
        return torch.full((B,), val, dtype=dtype, device=dev)

    st = _State(
        lo_v=full(-_INF, v.dtype), lo_i=full(ck.ID_LO, torch.int32),
        hi_v=full(_INF, v.dtype), hi_i=full(ck.ID_HI, torch.int32),
        rank=l.clone(), done=zero | allsel,
        thr_v=torch.where(allsel, _INF, -_INF).to(v.dtype),
        thr_i=torch.where(allsel, ck.ID_HI, ck.ID_LO).to(torch.int32),
    )
    rows = torch.zeros(B, dtype=torch.int32, device=dev)
    it = syncs = 0
    while it < max_iterations:
        syncs += 1
        if bool(st.done.all()):
            break
        rows += ~st.done
        st = _select_body(st, v, i, valid, gen, num_pivots)
        it += 1
    return SelectionResult(threshold_v=st.thr_v, threshold_i=st.thr_i,
                           converged=st.done, row_iterations=rows,
                           host_syncs=syncs)


def selected_mask(v, i, result: SelectionResult, valid=None):
    """Per-shard ``(k, B, m)`` mask of the globally selected elements."""
    m = ck.key_le(v, i, result.threshold_v[None, :, None],
                  result.threshold_i[None, :, None])
    if valid is not None:
        m = m & valid
    return m
