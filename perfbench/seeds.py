"""Seeds for every random stream a run draws, derived from ``--seed``."""

from __future__ import annotations

import hashlib


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed for the stream named by ``tags`` under ``seed``: the
    same ``(seed, tags)`` always gives the same number, and any whole
    ``seed`` (beyond 32 bits too) is taken."""
    text = ":".join([str(int(seed))] + [str(t) for t in tags])
    return int.from_bytes(hashlib.blake2b(text.encode(),
                                          digest_size=8).digest(),
                          "little") >> 1
