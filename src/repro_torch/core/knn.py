"""Algorithm 2 — distributed l-nearest-neighbors over k shards, end to end.

Port of ``repro.core.knn``.  Per query batch, with the shard as
dimension 0 of every per-shard tensor:

  1-2. distances and the per-shard top-L (Steps 8 and 2): one fused
       distance_topk kernel on the card (``local_distance_top_l``; f32
       points, or uint8 points and queries with exact distances)
  3.   sample-and-prune to O(l) survivors (``core.sampling``)
  4.   Algorithm 1 selection on the survivors (``core.selection``)
  5.   per-shard winner mask, and optionally the replicated (B, l)
       result gather (``gather_selected``)

The kernels are reached through ``kernels.ops``, which dispatches by the
tensors' device: the hand-written kernels for CUDA tensors, their plain
versions for CPU tensors.  ``knn_simple`` is the paper's baseline
"simple method": the same steps 1-2, then gather every shard's local
top-l and reduce.

Three optional masks fold into one ``(k, m)`` valid mask ahead of the
distance step, and a masked point competes as the paper's +inf fake
point: ``point_valid`` (live slots), ``shard_active`` (``(k,)``, the
pruned-routing flag per shard) and ``point_candidates`` (the approx
index's kept slots).  The mask reaches ``kops.distance_topk(valid=)`` on
the fused path and ``kops.l2_distance(valid=)`` elsewhere.

``phases`` (an :class:`repro_torch.obs.PhaseClock`, optional) marks the
steps as they are issued: ``topl`` (1-2), ``prune`` (3), ``select`` (4,
with its ``host_syncs``; the iterations stay on the device for the
caller's readback) and ``gather`` (5); in
``knn_simple`` ``topl`` and ``merge`` (the gather and the reduction).
The last phase stays open for the caller, who marks its readback and
closes the clock.  Marks add no sync and change no result.

``point_labels`` (``(k, m)`` f32, optional) is the prediction plane's
per-slot payload: gathered at the slot indices the top-l step returns
(the counterpart of the reference's ``take_along_axis``), it reaches
``KnnResult.local_labels`` aligned with the winner mask, so
:func:`knn_classify` / :func:`knn_regress` vote over exactly the
selected winners.  No kernel carries it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import sampling
from repro_torch.core.selection import (SelectionResult, select_l_smallest,
                                        selected_mask)
from repro_torch.kernels import ops as kops
from repro_torch.obs.trace import NULL_PHASES
from repro_torch.parallel.collectives import all_gather, psum

INT32_MAX = 2**31 - 1


class KnnResult(NamedTuple):
    """Distributed l-NN answer.  ``mask``/``local_dists``/``local_ids``
    are per-shard ``(k, B, L)``; ``dists``/``ids`` are the replicated
    ``(B, L)`` winners when gathered, else None; ``local_labels`` the
    ``(k, B, L)`` label payload aligned with ``mask``, when one was
    given."""

    mask: torch.Tensor
    local_dists: torch.Tensor
    local_ids: torch.Tensor
    selection: SelectionResult
    prune: sampling.PruneResult
    dists: Optional[torch.Tensor]
    ids: Optional[torch.Tensor]
    local_labels: Optional[torch.Tensor] = None   # (k, B, L), with mask


def squared_l2_distances(queries, points):
    """``(B, d) x (k, m, d) -> (k, B, m)`` squared euclidean distances."""
    return kops.l2_distance(queries, points)


def _gather_at(values, idx, fill):
    """The per-slot ``values`` (``(..., m)`` or ``(..., B, m)``: global
    ids, or the label payload) behind local indices ``idx`` (``(..., B,
    l)``); the sentinel index maps to ``fill`` (the sentinel id; label 0,
    which never votes, since its slot is +inf)."""
    m = values.shape[-1]
    if values.dim() == idx.dim() - 1:
        values = values.unsqueeze(-2).expand(idx.shape[:-1] + (m,))
    out = values.gather(-1, idx.clamp(max=m - 1).long())
    return torch.where(idx == INT32_MAX, fill, out)


def local_top_l(d, ids, l: int, extra=None):
    """Per-shard top-l smallest of ``d`` (``(..., B, m)``), +inf padded.

    ``ids`` is ``(..., m)`` or ``(..., B, m)``.  A shard with ``m <= l``
    points is padded with the paper's fake +inf points (id 2**31-1) and
    left in place, as the reference does.  ``extra`` (shaped like
    ``ids``, optional) is a per-slot payload reordered with the ids; with
    it the return is a 3-tuple, pad slots carrying 0.
    """
    m = d.shape[-1]
    if ids.dim() == d.dim() - 1:
        ids = ids.unsqueeze(-2).expand(d.shape)
    if m <= l:
        pad = d.shape[:-1] + (l - m,)
        out = (torch.cat([d, torch.full(pad, float("inf"), dtype=d.dtype,
                                        device=d.device)], -1),
               torch.cat([ids, torch.full(pad, INT32_MAX, dtype=ids.dtype,
                                          device=d.device)], -1))
        if extra is None:
            return out
        if extra.dim() == d.dim() - 1:
            extra = extra.unsqueeze(-2).expand(d.shape)
        return out + (torch.cat([extra, torch.zeros(
            pad, dtype=extra.dtype, device=d.device)], -1),)
    v, idx = kops.local_topk(d, l)
    if extra is None:
        return v, _gather_at(ids, idx, INT32_MAX)
    return v, _gather_at(ids, idx, INT32_MAX), _gather_at(extra, idx, 0.0)


def local_distance_top_l(queries, points, point_ids, l: int, valid=None,
                         extra=None):
    """Steps 8 and 2 fused: ``(B, d) x (k, m, d) -> (k, B, l)`` distances
    and global ids, without the ``(k, B, m)`` matrix (distance_topk).
    ``valid`` (``(k, m)`` bool) puts masked points at +inf; ``extra``
    (``(k, m)``, optional) adds the payload behind each slot as a third
    output (:func:`local_top_l`).  uint8 points take the uint8 step
    whatever m and l: the queries, integers in [0, 255], are converted
    to uint8 here, once a batch."""
    if points.dtype == torch.uint8:
        queries = queries.to(torch.uint8)
    elif points.shape[-2] <= l:
        return local_top_l(kops.l2_distance(queries, points, valid=valid),
                           point_ids, l, extra=extra)
    v, idx = kops.distance_topk(queries, points, l, valid=valid)
    if extra is None:
        return v, _gather_at(point_ids, idx, INT32_MAX)
    return (v, _gather_at(point_ids, idx, INT32_MAX),
            _gather_at(extra, idx, 0.0))


def _apply_shard_routing(point_valid, shard_active, k: int, m: int):
    """Fold the ``route="pruned"`` flags (``(k,)`` bool) into the ``(k, m)``
    point mask: a routed-away shard's points all enter at +inf.  The flags
    must come from a sound bound on the same point set."""
    if shard_active is None:
        return point_valid
    flag = shard_active.to(torch.bool).reshape(k, 1).expand(k, m)
    return flag if point_valid is None else point_valid & flag


def _fold_candidates(point_valid, point_candidates):
    """Fold the ``search="approx"`` candidate mask (``(k, m)`` bool) into
    the point mask.  Unlike the two masks above it is not exact: the
    caller opts in to a measured recall."""
    if point_candidates is None:
        return point_valid
    pc = point_candidates.to(torch.bool)
    return pc if point_valid is None else point_valid & pc


def _point_mask(points, point_valid, shard_active, point_candidates):
    k, m = points.shape[0], points.shape[1]
    if point_valid is not None:
        point_valid = point_valid.to(torch.bool)
    valid = _apply_shard_routing(point_valid, shard_active, k, m)
    return _fold_candidates(valid, point_candidates)


def gather_selected(d, gid, mask, l: int):
    """Pack the selected elements into replicated ``(B, l)`` buffers.

    Rank-stable pack: shard j's winners land after those of shards < j
    (an exclusive cumsum of the counts over dimension 0).  The
    reference's scatter-add "drop" of unselected elements becomes an
    extra column ``l`` that is sliced away.  Unfilled slots are +inf /
    2**31-1.
    """
    k, B, L = d.shape
    my_cnt = mask.sum(-1, dtype=torch.int32)                     # (k, B)
    all_cnt = all_gather(my_cnt)
    offset = torch.cumsum(all_cnt, 0, dtype=torch.int32) - all_cnt
    rank = torch.cumsum(mask.to(torch.int32), -1, dtype=torch.int32) - 1
    col = torch.where(mask, offset.unsqueeze(-1) + rank, l).clamp(max=l)
    col = col.long()
    dbuf = torch.zeros((k, B, l + 1), dtype=d.dtype, device=d.device)
    dbuf.scatter_add_(-1, col, torch.where(mask, d, 0.0))
    ibuf = torch.zeros((k, B, l + 1), dtype=torch.int32, device=d.device)
    ibuf.scatter_add_(-1, col, torch.where(mask, gid, 0).to(torch.int32))
    dists = psum(dbuf[..., :l])
    ids = psum(ibuf[..., :l])
    filled = (torch.arange(l, device=d.device).unsqueeze(0)
              < psum(my_cnt).unsqueeze(-1))
    return (torch.where(filled, dists, float("inf")),
            torch.where(filled, ids, INT32_MAX))


def _knn_pipeline(points, point_ids, queries, l_buf, l_run, gen, *,
                  use_sampling, num_pivots, gather_results, point_valid=None,
                  shard_active=None, point_candidates=None,
                  point_labels=None, phases=None) -> KnnResult:
    """Shared Algorithm 2 body: ``l_buf`` is the static per-shard buffer
    width, ``l_run`` the selection rank (an int or a ``(B,)`` tensor);
    the masks, ``point_labels`` and ``phases`` as in the module
    docstring.  The step is called through the module's global
    ``local_distance_top_l``, which a caller may wrap."""
    ph = NULL_PHASES if phases is None else phases
    valid = _point_mask(points, point_valid, shard_active, point_candidates)
    labels_top = None
    ph.mark("topl")
    if point_labels is None:
        d, gid = local_distance_top_l(queries, points, point_ids, l_buf,
                                      valid=valid)
    else:
        d, gid, labels_top = local_distance_top_l(
            queries, points, point_ids, l_buf, valid=valid,
            extra=point_labels)
    ph.mark("prune")
    if use_sampling:
        prune = sampling.sample_prune(d, gen, l_run)
    else:
        finite = torch.isfinite(d)
        B = d.shape[1]
        prune = sampling.PruneResult(
            valid=finite,
            radius=torch.full((B,), float("inf"), device=d.device),
            survivors=psum(finite.sum(-1, dtype=torch.int32)),
            applied=torch.zeros(B, dtype=torch.bool, device=d.device))
    ph.mark("select")
    sel = select_l_smallest(d, gid, l_run, gen, valid=prune.valid,
                            num_pivots=num_pivots)
    ph.annotate(host_syncs=sel.host_syncs)
    ph.mark("gather")
    mask = selected_mask(d, gid, sel, valid=prune.valid)
    dists = ids = None
    if gather_results:
        dists, ids = gather_selected(d, gid, mask, l_buf)
    return KnnResult(mask=mask, local_dists=d, local_ids=gid, selection=sel,
                     prune=prune, dists=dists, ids=ids,
                     local_labels=labels_top)


def knn_query(points, point_ids, queries, l: int, gen: torch.Generator, *,
              use_sampling: bool = True, num_pivots: int = 1,
              gather_results: bool = True, point_valid=None,
              shard_active=None, point_candidates=None,
              point_labels=None) -> KnnResult:
    """Full Algorithm 2: ``points`` ``(k, m, dim)``, ``point_ids``
    ``(k, m)`` int32 globally unique, ``queries`` ``(B, dim)``.
    ``point_valid`` / ``point_candidates`` are ``(k, m)`` bool,
    ``shard_active`` ``(k,)`` bool and ``point_labels`` ``(k, m)`` f32
    (module docstring)."""
    return _knn_pipeline(points, point_ids, queries, l, l, gen,
                         use_sampling=use_sampling, num_pivots=num_pivots,
                         gather_results=gather_results,
                         point_valid=point_valid, shard_active=shard_active,
                         point_candidates=point_candidates,
                         point_labels=point_labels)


def knn_query_batched(points, point_ids, queries, l_max: int, l,
                      gen: torch.Generator, *, use_sampling: bool = True,
                      num_pivots: int = 1, gather_results: bool = True,
                      point_valid=None, shard_active=None,
                      point_candidates=None, point_labels=None,
                      phases=None) -> KnnResult:
    """Algorithm 2 with a per-request neighbor count, the serving form.

    Buffers are sized by ``l_max``; ``l`` is a ``(B,)`` int tensor with
    ``0 <= l[b] <= l_max``.  All rows run in lockstep through the same
    Algorithm 1 loop.  Rows with ``l[b] == 0`` (bucket padding) select
    nothing and come back all +inf / 2**31-1.  Masks and
    ``point_labels`` as in :func:`knn_query`, ``phases`` as in the
    module docstring.
    """
    B = queries.shape[0]
    l = torch.as_tensor(l, dtype=torch.int32, device=queries.device)
    l = torch.clamp(l.expand(B), max=l_max)
    return _knn_pipeline(points, point_ids, queries, l_max, l, gen,
                         use_sampling=use_sampling, num_pivots=num_pivots,
                         gather_results=gather_results,
                         point_valid=point_valid, shard_active=shard_active,
                         point_candidates=point_candidates,
                         point_labels=point_labels, phases=phases)


def knn_simple(points, point_ids, queries, l: int, *, point_valid=None,
               shard_active=None, point_candidates=None, phases=None):
    """The paper's baseline "simple method" (Section 3): local top-l, then
    gather all k*l candidates and reduce.  Returns replicated ascending
    ``(B, l)`` distances and ids; +inf slots carry 2**31-1.  Masks as in
    :func:`knn_query`, ``phases`` as in the module docstring.  The local
    step is the module's global ``local_distance_top_l``, as in
    Algorithm 2, so no ``(k, B, m)`` matrix is built where every shard
    holds more than l points and the fused kernel takes l."""
    ph = NULL_PHASES if phases is None else phases
    valid = _point_mask(points, point_valid, shard_active, point_candidates)
    ph.mark("topl")
    d, gid = local_distance_top_l(queries, points, point_ids, l,
                                  valid=valid)
    ph.mark("merge")
    k, B, _ = d.shape
    flat_d = all_gather(d).transpose(0, 1).reshape(B, k * l)
    flat_i = all_gather(gid).transpose(0, 1).reshape(B, k * l)
    dists, idx = kops.local_topk(flat_d, l)
    ids = flat_i.gather(-1, idx.long())
    return dists, torch.where(torch.isfinite(dists), ids, INT32_MAX)


def knn_classify(mask, labels, num_classes: int):
    """Majority vote over the selected neighbors: ``labels`` ``(k, B, L)``
    int aligned with the knn buffers; only the label histogram crosses
    the shards (one psum).  Out-of-range labels vote for nothing."""
    classes = torch.arange(num_classes, device=labels.device)
    onehot = (labels.unsqueeze(-1) == classes) & mask.unsqueeze(-1)
    hist = psum(onehot.sum(-2, dtype=torch.int32))               # (B, C)
    return torch.argmax(hist, dim=-1), hist


def knn_regress(mask, values):
    """Mean of the selected neighbors' target values (one psum)."""
    num = psum(torch.where(mask, values, 0.0).sum(-1))
    den = psum(mask.sum(-1).to(torch.float32))
    return num / torch.clamp(den, min=1.0)
