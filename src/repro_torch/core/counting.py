"""Composite-key comparisons and masked range counting.

Port of ``repro.core.counting``.  Ties between equal distances are broken
by a deterministic composite key ``(value, global id)`` compared
lexicographically, in place of the paper's random ids.  A key is a pair
of tensors ``(v, i)``: ``v`` floating, ``i`` int32.  ``+inf`` sentinels
carry ``i = ID_HI`` so they sort after every real element; the lower
bound sentinel is ``(-inf, ID_LO)``.
"""

from __future__ import annotations

import torch

ID_LO = -2_147_483_648   # pairs with -inf
ID_HI = 2_147_483_647    # pairs with +inf


def key_lt(av, ai, bv, bi):
    """Lexicographic ``(av, ai) < (bv, bi)`` (NaN-free by contract)."""
    return (av < bv) | ((av == bv) & (ai < bi))


def key_le(av, ai, bv, bi):
    return (av < bv) | ((av == bv) & (ai <= bi))


def in_open_interval(v, i, lo_v, lo_i, hi_v, hi_i):
    """Mask of ``lo < (v, i) < hi``, both bounds exclusive, so the pivot
    leaves the candidate set every iteration and Algorithm 1 terminates
    deterministically."""
    return key_lt(lo_v, lo_i, v, i) & key_lt(v, i, hi_v, hi_i)


def masked_select_nth(mask, n):
    """Index of the ``n``-th True entry of ``mask`` (0-based) along the
    last axis; an arbitrary index when there are fewer (callers guard on
    the count).  Relies on ``torch.argmax`` returning the first maximal
    index, as ``jnp.argmax`` does."""
    csum = torch.cumsum(mask.to(torch.int32), dim=-1)
    hit = (csum == (n + 1).unsqueeze(-1)) & mask
    return torch.argmax(hit.to(torch.int32), dim=-1)
