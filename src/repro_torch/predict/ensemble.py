"""Ensemble prediction: one message per routed shard, no collective.

Port of ``repro.predict.ensemble``.  Device side (:func:`local_vote` /
:func:`local_mean`, on the ``(k, B, L)`` buffers of every shard at once,
with no sum over the shard dimension): each shard reduces its masked
local top-l to a class histogram or a (sum, count) pair over its first
``kl`` finite candidates.  The ``(k, B, C)`` result is read back once
and aggregated on the host (:func:`aggregate_vote` /
:func:`aggregate_regress`): the majority of the per-shard votes, or the
mean of the per-shard means (Duan, Qiao and Cheng, arXiv 1812.05005).  A
shard with no live candidate for a row abstains; ties go to the lowest
label, as in the exact mode, so on one shard the two agree byte for
byte.

:func:`local_k_for`: ``kl = ceil(l / touched)`` by default, or a fixed
``local_k``; padding rows (l = 0) get 0.
"""

from __future__ import annotations

import numpy as np
import torch


# ---- device side (per shard; no collective) -------------------------------

def _keep_mask(d, kl):
    """``(..., B, L)`` bool: the ``kl[b]`` nearest finite candidates of row
    b.  By rank, not position (a shard no wider than l keeps its slots in
    slot order): two stable argsorts give each slot's ascending rank,
    distance ties to the lower slot, as the reference's stable
    ``jnp.argsort`` does; +inf slots never vote."""
    order = torch.argsort(d, dim=-1, stable=True)
    rank = torch.argsort(order, dim=-1, stable=True)
    return (rank < kl.unsqueeze(-1)) & torch.isfinite(d)


def local_vote(d, labels_top, kl, num_classes: int):
    """Each shard's local-kNN class histogram, ``(..., B, C)`` int32.

    ``d`` / ``labels_top``: the shards' ascending local top-l distances
    and aligned labels (``core.knn.local_distance_top_l`` with
    ``extra=``); ``kl``: ``(B,)`` local neighbour counts.  Labels outside
    ``[0, C)`` vote for nothing."""
    keep = _keep_mask(d, kl)
    classes = torch.arange(num_classes, device=d.device)
    onehot = (labels_top.to(torch.int32).unsqueeze(-1) == classes) & (
        keep.unsqueeze(-1))
    return onehot.sum(-2, dtype=torch.int32)


def local_mean(d, labels_top, kl):
    """Each shard's local-kNN ``[sum, count]``, ``(..., B, 2)`` f32; the
    host turns it into a local mean, and count 0 abstains."""
    keep = _keep_mask(d, kl)
    s = torch.where(keep, labels_top, 0.0).sum(-1)
    c = keep.to(torch.float32).sum(-1)
    return torch.stack([s, c], dim=-1)


# ---- host side ------------------------------------------------------------

def local_k_for(l: np.ndarray, touched: int, local_k: int,
                l_max: int) -> np.ndarray:
    """``(B,)`` int32 local neighbour counts: ``ceil(l / touched)`` when
    ``local_k == 0`` (one shard: ``kl == l``), else ``local_k``; both
    clamped to ``[1, l_max]``, and 0 where ``l == 0``."""
    l = np.asarray(l, np.int64)
    t = max(int(touched), 1)
    kl = -(-l // t) if local_k == 0 else np.full_like(l, int(local_k))
    kl = np.minimum(np.maximum(kl, 1), l_max)
    return np.where(l > 0, kl, 0).astype(np.int32)


def aggregate_vote(hists: np.ndarray, active: np.ndarray):
    """Majority of the per-shard votes: ``(label, confidence, votes)``.

    ``hists``: ``(k, B, C)`` per-shard histograms; ``active``: ``(k,)``
    routing flags (a routed-away shard is zeroed, so it abstains).
    ``votes``: ``(B, C)`` shards voting each class.  ``label`` is -1 with
    confidence 0 where every shard abstained.
    """
    hists = np.asarray(hists)
    k, B, C = hists.shape
    hists = np.where(np.asarray(active, bool)[:, None, None], hists, 0)
    totals = hists.sum(axis=-1)                     # (k, B)
    voting = totals > 0                             # abstain on empty
    shard_vote = hists.argmax(axis=-1)              # (k, B) ties -> lowest
    votes = np.zeros((B, C), np.int64)
    rows = np.broadcast_to(np.arange(B)[None, :], (k, B))
    np.add.at(votes, (rows[voting], shard_vote[voting]), 1)
    label = votes.argmax(axis=-1)                   # ties -> lowest
    n_voting = voting.sum(axis=0)                   # (B,)
    conf = votes[np.arange(B), label] / np.maximum(n_voting, 1)
    label = np.where(n_voting > 0, label, -1)
    return (label.astype(np.float32), conf.astype(np.float32), votes)


def aggregate_regress(sumcnt: np.ndarray, active: np.ndarray):
    """Mean of the per-shard means: ``(value, confidence)``.

    ``sumcnt``: ``(k, B, 2)`` per-shard [sum, count]; ``confidence`` is
    the share of the routed shards that had candidates.
    """
    sumcnt = np.asarray(sumcnt)
    active = np.asarray(active, bool)
    s, c = sumcnt[..., 0], sumcnt[..., 1]
    voting = (c > 0) & active[:, None]              # (k, B)
    means = np.where(voting, s / np.maximum(c, 1.0), 0.0)
    n_voting = voting.sum(axis=0)
    value = means.sum(axis=0) / np.maximum(n_voting, 1)
    conf = n_voting / max(int(active.sum()), 1)
    return value.astype(np.float32), conf.astype(np.float32)
