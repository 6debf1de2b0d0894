"""Distributed top-k over vocabulary shards: the LM-serving face of the
paper.

Port of ``repro.core.topk``.  At decode time the ``(B, V)`` logits are
held as ``(k, B, V/k)``: shard j holds vocabulary ids ``[j*V/k,
(j+1)*V/k)``, the layout of the reference's model-sharded vocab
(:func:`shard_vocab` pads V with -inf logits to a multiple of k).  The
sampler runs the paper's pipeline on negated logits:

  local top-k (the local_topk kernel on the ``(k*B, V/k)`` rows)
  ->  Algorithm 1 selection  ->  pack the k winners (``gather_selected``)

``method="gather"`` is the simple-method baseline: every shard's local
top-k, then the top-k of the ``k*k`` candidates (local_topk again).
Padded -inf logits become +inf distances, which the selection never
takes (``valid = isfinite``).  Ties go to the smaller vocabulary id, as
``lax.top_k`` breaks them.

Random numbers: the reference's ``key`` is an int seed here.
:func:`fold_in` derives a seed from a seed and an int, and
:func:`generator` makes a ``torch.Generator`` from one.  ``topk_sample``
draws the selection's pivots from ``fold_in(seed, 0)`` and the
categorical from ``fold_in(seed, 1)``, each a generator of its own, so
the draw does not depend on how many numbers the selection consumed:
selection and gather give the same token under one seed.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import knn as knn_mod
from repro_torch.core.selection import select_l_smallest, selected_mask
from repro_torch.kernels import ops as kops
from repro_torch.parallel.collectives import all_gather, axis_index

INT32_MAX = 2**31 - 1
_MASK64 = (1 << 64) - 1


class TopKResult(NamedTuple):
    values: torch.Tensor    # (B, k) top-k logits, descending
    indices: torch.Tensor   # (B, k) int32 global vocabulary ids
    iterations: int         # selection iterations (0 for gather)
    host_syncs: int = 0     # device-to-host reads of the selection loop


def fold_in(seed: int, data: int) -> int:
    """A new 63-bit seed from ``seed`` and ``data`` (a splitmix64 round
    over their mix), the counterpart of ``jax.random.fold_in``."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(data) + 1) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def shard_vocab(logits: torch.Tensor, k: int) -> torch.Tensor:
    """``(B, V)`` -> ``(k, B, ceil(V/k))``: shard j holds ids ``[j*V/k,
    (j+1)*V/k)``; the tail is padded with -inf logits, which never win a
    top-k slot."""
    B, V = logits.shape
    pad = (-V) % k
    if pad:
        logits = torch.cat([logits, logits.new_full((B, pad),
                                                    float("-inf"))], 1)
    return logits.reshape(B, k, -1).transpose(0, 1)


def _global_ids(logits: torch.Tensor) -> torch.Tensor:
    """``(k, 1, V/k)`` int32 global vocabulary ids of every shard."""
    v_local = logits.shape[-1]
    start = axis_index(logits[:, :1, :1]) * v_local
    return (start + torch.arange(v_local, device=logits.device)).to(
        torch.int32)


def distributed_topk(logits: torch.Tensor, k: int, gen: torch.Generator, *,
                     method: str = "selection",
                     num_pivots: int = 1) -> TopKResult:
    """Top-k largest over the vocabulary shards of ``logits``
    ``(shards, B, V_local)``, sorted descending, ties to the smaller id.

    method="selection": the paper's algorithm (negated logits are
    distances); method="gather": the simple-method baseline.
    """
    shards, B, v_local = logits.shape
    gid = _global_ids(logits).expand(shards, B, v_local)
    neg = (-logits.float()).contiguous()

    # Step-2 analogue: only the local top-k can be global winners.
    d, ids = knn_mod.local_top_l(neg, gid, k)                # (shards, B, k)

    if method == "gather":
        flat_d = all_gather(d).transpose(0, 1).reshape(B, shards * k)
        flat_i = all_gather(ids).transpose(0, 1).reshape(B, shards * k)
        top, idx = kops.local_topk(flat_d.contiguous(), k)
        return TopKResult(values=-top,
                          indices=flat_i.gather(-1, idx.long()),
                          iterations=0)

    if method != "selection":
        raise ValueError(f"unknown method {method!r}")

    finite = torch.isfinite(d)
    sel = select_l_smallest(d, ids, k, gen, valid=finite,
                            num_pivots=num_pivots)
    mask = selected_mask(d, ids, sel, valid=finite)
    dists, out_ids = knn_mod.gather_selected(d, ids, mask, k)
    # ascending negated logits == descending logits; the pack is in id
    # order among equal values, which a stable sort keeps
    order = torch.argsort(dists, dim=-1, stable=True)
    values, indices = -dists.gather(-1, order), out_ids.gather(-1, order)
    # the device loop's counts, read after the answer
    return TopKResult(values=values, indices=indices,
                      iterations=sel.iterations,
                      host_syncs=sel.host_syncs + sel.row_iterations.is_cuda)


def categorical(gen: torch.Generator, logits: torch.Tensor) -> torch.Tensor:
    """One draw per row of the softmax of ``logits`` ``(B, n)`` (the
    Gumbel-max form of ``jax.random.categorical``) -> ``(B,)`` int64."""
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    tiny = torch.finfo(u.dtype).tiny
    gumbel = -torch.log(-torch.log(u.clamp(min=tiny)))
    return torch.argmax(logits.float() + gumbel, dim=-1)


def topk_sample(logits: torch.Tensor, k: int, temperature: float,
                seed: int, *, method: str = "selection",
                num_pivots: int = 1, observe=None) -> torch.Tensor:
    """Top-k temperature sampling over sharded logits ``(shards, B,
    V_local)`` -> ``(B,)`` int32 token ids.  ``observe`` (optional) is
    called with the :class:`TopKResult`."""
    dev = logits.device
    res = distributed_topk(logits, k, generator(fold_in(seed, 0), dev),
                           method=method, num_pivots=num_pivots)
    if observe is not None:
        observe(res)
    scaled = res.values / max(temperature, 1e-6)
    choice = categorical(generator(fold_in(seed, 1), dev), scaled)
    return res.indices.gather(-1, choice[:, None])[:, 0]


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """Argmax over the vocabulary shards ``(shards, B, V_local)``: one
    (value, id) pair a shard; value ties go to the smaller global id."""
    gid = _global_ids(logits)[:, 0]                          # (shards, V)
    loc_v, loc_a = torch.max(logits, dim=-1)                 # (shards, B)
    loc_i = gid.gather(-1, loc_a)
    all_v, all_i = all_gather(loc_v), all_gather(loc_i)
    best_v = all_v.max(0).values
    tie = all_v == best_v.unsqueeze(0)
    return torch.where(tie, all_i, INT32_MAX).min(0).values
