"""The k machines as a leading tensor dimension on one device.

The reference runs the paper's k machines as the shards of a mesh axis
and each paper round as one collective over that axis.  The port keeps
all k shards on one device: every per-shard tensor carries the shard as
dimension 0 (points ``(k, m, dim)``, ids ``(k, m)``, buffers
``(k, B, L)``), and a value that the reference holds replicated on every
shard is held once, without that dimension.  The collectives then become
views and reductions over dimension 0:

* ``all_gather(x)`` — every shard sees the ``(k, ...)`` stack, which is
  ``x`` itself;
* ``psum(x)`` — the sum over dimension 0, replicated;
* ``axis_index(x)`` — shard j's own index, shaped to broadcast against
  ``x``;
* ``replicate(x)`` — the reference needs it to prove to shard_map that a
  value is the same on every shard; here such a value is stored once,
  so it is the identity.

:func:`accounting` is the k-machine bill (rounds, messages) of one
served batch, the formula the reference server charges.
"""

from __future__ import annotations

import torch


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """``(k, ...)`` per-shard values, visible to every shard."""
    return x


def psum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the shard dimension; the result is replicated.

    int32 sums stay int32 (torch would widen them to int64).
    """
    if x.dtype == torch.int32:
        return x.sum(0, dtype=torch.int32)
    return x.sum(0)


def axis_index(x: torch.Tensor) -> torch.Tensor:
    """Shard index of every slice of ``x`` along dimension 0, shaped
    ``(k, 1, ..., 1)`` to broadcast against ``x``."""
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    return torch.arange(x.shape[0], device=x.device).reshape(shape)


def replicate(x: torch.Tensor) -> torch.Tensor:
    """A replicated value is stored once; nothing to prove."""
    return x


def axis_size(x: torch.Tensor) -> int:
    """k, the number of shards of a per-shard tensor."""
    return int(x.shape[0])


def accounting(*, sampler: str, iterations: int, touched: int, l_max: int,
               use_sampling: bool, predict: str = "none",
               predict_mode: str = "exact") -> tuple[int, int]:
    """k-machine ``(rounds, messages)`` for one dispatched batch.

    ``touched`` shards take part (k for exact routing).  The gather
    sampler is one all-gather whose per-peer payload is ``l_max``
    scalars.  The selection sampler pays 2 rounds per Algorithm 1
    iteration (pivot all-gather + count psum), 2 for the Lemma 2.3
    sample and its verification, and 2 for the result gather (count +
    pack); each round carries ``touched - 1`` O(1)-word messages.
    Prediction (``predict`` other than ``"none"``): the ensemble replaces
    all of it with one local pass and one O(C) answer a touched shard (1
    round, ``touched`` messages); the exact fold adds the histogram or
    value-sum psum (+1 round, +``touched - 1`` messages).
    """
    t = max(int(touched), 1)
    predicting = predict != "none"
    if predicting and predict_mode == "ensemble":
        return 1, t
    if sampler == "gather":
        return 1, (t - 1) * int(l_max)
    rounds = 2 * int(iterations)
    rounds += 2 if use_sampling else 0
    rounds += 2
    messages = (t - 1) * rounds
    if predicting:
        rounds += 1
        messages += t - 1
    return rounds, messages
