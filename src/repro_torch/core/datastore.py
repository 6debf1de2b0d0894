"""Sharded kNN-LM datastore: the paper's l-NN as a serving-time feature.

Port of ``repro.core.datastore``.  kNN-LM (Khandelwal et al., ICLR 2020)
interpolates the LM's next-token distribution with a nearest-neighbour
distribution over a datastore of (hidden-state key, next-token value)
pairs.  The datastore is split over k shards, the leading dimension of
its tensors; retrieval is Algorithm 2 (``core.knn.knn_query``), and
only distances and token values are packed across the shards
(``gather_selected`` carries the winners' token values in place of
their ids).

The kNN mixture comes back sparse, (token, weight) pairs for the l
winners, and :func:`interp_logits` scatters it into the
vocabulary-sharded logits ``(k, B, V/k)`` (``core.topk.shard_vocab``),
adding the weights of a token that several winners carry.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import knn as knn_mod
from repro_torch.parallel.collectives import axis_index, psum

INT32_MAX = 2**31 - 1


class Datastore(NamedTuple):
    """The (keys, values) store over k shards.

    keys:   (k, m, d)  hidden-state keys (f32 or bf16)
    values: (k, m)     int32 next-token ids
    ids:    (k, m)     globally unique int32 point ids
    """

    keys: torch.Tensor
    values: torch.Tensor
    ids: torch.Tensor


def build_local(keys: torch.Tensor, values: torch.Tensor) -> Datastore:
    """Wrap ``(k, m, d)`` keys and ``(k, m)`` values, assigning shard j
    the contiguous ids ``[j*m, (j+1)*m)``."""
    k, m = keys.shape[0], keys.shape[1]
    ids = (axis_index(values) * m
           + torch.arange(m, device=keys.device)).to(torch.int32)
    return Datastore(keys=keys, values=values.to(torch.int32), ids=ids)


class RetrievalResult(NamedTuple):
    tokens: torch.Tensor   # (B, l) winner token values (2**31-1 unfilled)
    weights: torch.Tensor  # (B, l) softmax(-d / T) weights
    dists: torch.Tensor    # (B, l) distances, ascending (+inf unfilled)
    iterations: int        # selection iterations (round-count telemetry)


def retrieve(store: Datastore, queries: torch.Tensor, l: int,
             gen: torch.Generator, *, temperature: float = 10.0,
             num_pivots: int = 1) -> RetrievalResult:
    """Algorithm 2 retrieval of ``queries`` ``(B, d)`` and the softmax
    weighting of the l winners."""
    res = knn_mod.knn_query(store.keys, store.ids, queries, l, gen,
                            num_pivots=num_pivots, gather_results=False)
    # the winners' token values through the rank-stable pack, in place of
    # their ids; a global id maps back to its shard row as id - j*m
    m = store.keys.shape[1]
    row = (res.local_ids.long() - axis_index(res.local_ids) * m).clamp(
        0, m - 1)
    vals = store.values.gather(-1, row.flatten(1)).view(row.shape)
    dists, tokens = knn_mod.gather_selected(
        res.local_dists, torch.where(res.mask, vals, 0), res.mask, l)
    logit = torch.where(torch.isfinite(dists), -dists / temperature,
                        float("-inf"))
    return RetrievalResult(tokens=tokens, weights=torch.softmax(logit, -1),
                           dists=dists, iterations=res.selection.iterations)


def interp_logits(lm_logits: torch.Tensor, retrieval: RetrievalResult,
                  lam: float) -> torch.Tensor:
    """``log((1 - lam) p_LM + lam p_kNN)`` on vocabulary-sharded logits
    ``(k, B, V/k)``.  ``p_LM`` is the softmax over all shards (a max and
    a sum across them); each shard adds the kNN weights of the tokens it
    holds, a token carried by several winners getting their sum, and
    drops every token out of its range."""
    k, B, v_local = lm_logits.shape
    mx = lm_logits.amax(-1).amax(0)                              # (B,)
    e = torch.exp(lm_logits - mx[:, None])
    z = psum(e.sum(-1))
    p_lm = e / z[:, None]

    local_tok = retrieval.tokens.long().unsqueeze(0) - (
        axis_index(lm_logits) * v_local)                        # (k, B, l)
    in_range = (local_tok >= 0) & (local_tok < v_local)
    cols = torch.where(in_range, local_tok, v_local)
    w = torch.where(in_range, retrieval.weights.unsqueeze(0), 0.0).to(
        p_lm.dtype)
    p_knn = torch.zeros((k, B, v_local + 1), dtype=p_lm.dtype,
                        device=p_lm.device)
    p_knn.scatter_add_(-1, cols, w)
    mixed = (1.0 - lam) * p_lm + lam * p_knn[..., :v_local]
    return torch.log(torch.clamp(mixed, min=1e-30))
