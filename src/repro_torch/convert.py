"""Carry the reference server's state across to the port's layout.

The JAX server shards an ``(n, dim)`` point array over its mesh axis with
``P(axis)``: shard j holds rows ``[j*m, (j+1)*m)``, m = n / k, and ids
are ``arange(n)``.  The port holds the same split as a leading shard
dimension: points ``(k, m, dim)``, ids ``(k, m)``.
"""

from __future__ import annotations

import numpy as np
import torch


def shards_from_numpy(points, k: int, values=None, *, device="cpu"):
    """``(n, dim)`` numpy points -> ``((k, m, dim) f32, (k, m) int32 ids,
    values)`` tensors on ``device``, by the reference's row -> shard rule.

    ``values`` (optional ``(n,)`` int payload) is returned as an int32
    numpy array, since the server looks it up on the host.  Raises when
    ``n`` is not a multiple of ``k``, as the reference server does.
    """
    points = np.ascontiguousarray(points, np.float32)
    if values is not None:
        values = np.asarray(values, np.int32)
        if values.shape != points.shape[:1]:
            raise ValueError(f"values shape {values.shape} != "
                             f"({points.shape[0]},)")
    pts, ids = shards_from_tensor(torch.from_numpy(points).to(device), k)
    return pts, ids, values


def shards_from_tensor(points: torch.Tensor, k: int):
    """The same split for an ``(n, dim)`` tensor already on its device
    (a view, no copy): ``((k, m, dim), (k, m) int32 ids)``."""
    if points.dim() != 2:
        raise ValueError(f"points must be (n, dim), got "
                         f"{tuple(points.shape)}")
    n, dim = points.shape
    if k < 1 or n % k:
        raise ValueError(f"n_points={n} must divide the shard count {k}")
    ids = torch.arange(n, dtype=torch.int32, device=points.device)
    return points.reshape(k, n // k, dim), ids.reshape(k, -1)
