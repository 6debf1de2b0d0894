"""Synthetic point sets for the port's routing and store workloads.

The port's own copies of ``repro.data.synthetic``'s ``sharded_clusters``
and ``drifting_clusters``.  ``sharded_clusters``: one Gaussian cluster
per shard, laid out contiguously, so shard j owns rows ``[j*m, (j+1)*m)``,
all near ``centers[j]``.  Its numpy path gives the reference's seeded
output exactly; its torch path (``device=``) makes the points on that
device from a ``torch.Generator``, so a full-width set (2^22 x 64) never
passes through host memory, and its numbers differ from the numpy
path's, as the two generators do.  ``drifting_clusters``: the clustered
stream the store's tests and the chip run ingest, numpy only, the
reference's seeded output exactly.
"""

from __future__ import annotations

import numpy as np
import torch


def sharded_clusters(k: int, per_shard: int, dim: int, *, scale: float = 8.0,
                     shift: float = 0.0, seed: int = 0, rng=None,
                     device=None):
    """``(points (k*m, dim) f32, centers (k, dim) f64 numpy)``.

    ``shift`` pushes every center away from the origin.  Without
    ``device`` the points are a numpy array drawn from ``rng`` (or
    ``default_rng(seed)``), as in the reference; with ``device`` they are
    a float32 tensor on that device, drawn from a generator seeded with
    ``seed``.
    """
    if device is None:
        if rng is None:
            rng = np.random.default_rng(seed)
        centers = rng.normal(scale=scale, size=(k, dim)) + shift
        pts = np.concatenate(
            [centers[j] + rng.normal(size=(per_shard, dim))
             for j in range(k)])
        return pts.astype(np.float32), centers
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    centers = (torch.randn((k, dim), generator=gen, device=dev,
                           dtype=torch.float64) * scale + shift)
    pts = torch.empty((k * per_shard, dim), dtype=torch.float32, device=dev)
    for j in range(k):
        noise = torch.randn((per_shard, dim), generator=gen, device=dev,
                            dtype=torch.float64)
        pts[j * per_shard:(j + 1) * per_shard] = centers[j] + noise
    return pts, centers.cpu().numpy()


def drifting_clusters(k: int, per_step: int, dim: int, *, steps: int,
                      drift: float = 4.0, scale: float = 12.0,
                      seed: int = 0):
    """Drifting-cluster stream: k Gaussian clusters whose centres take a
    length-``drift`` random-walk step between emissions.

    Yields ``steps`` pairs of (points (k*per_step, dim) f32 cluster-major,
    rows ``[c*per_step, (c+1)*per_step)`` near that step's
    ``centers[c]``, and centers (k, dim) f64 as used for that batch).
    Seeded: the same arguments replay the same stream.
    """
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=scale, size=(k, dim))
    for _ in range(steps):
        pts = np.concatenate(
            [centers[c] + rng.normal(size=(per_step, dim))
             for c in range(k)])
        yield pts.astype(np.float32), centers.copy()
        step = rng.normal(size=(k, dim))
        centers = centers + drift * step / np.maximum(
            np.linalg.norm(step, axis=1, keepdims=True), 1e-30)
