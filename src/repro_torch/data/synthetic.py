"""Synthetic data: the LM token stream and the port's point sets.

``MarkovTokens``: the reference's order-2 Markov token stream, numpy
only, its batches the reference's bit for bit at any ``(step, batch,
seq_len)`` (a restart from the checkpoint at step s regenerates exactly
the batches after s).  The port's own copies of ``repro.data.synthetic``'s ``sharded_clusters``
and ``drifting_clusters``.  ``sharded_clusters``: one Gaussian cluster
per shard, laid out contiguously, so shard j owns rows ``[j*m, (j+1)*m)``,
all near ``centers[j]``.  Its numpy path gives the reference's seeded
output exactly; its torch path (``device=``) makes the points on that
device from a ``torch.Generator``, so a full-width set (2^22 x 64) never
passes through host memory, and its numbers differ from the numpy
path's, as the two generators do.  ``drifting_clusters``: the clustered
stream the store's tests and the chip run ingest, numpy only, the
reference's seeded output exactly.  ``labeled_mixture`` and
``bayes_labels``: the prediction plane's labeled workload and its
Bayes-optimal labels, numpy only, the reference's output exactly.
``uniform_points`` (the paper's dataset) and ``gaussian_clusters`` (the
l-NN service's labeled clusters, ``launch/serve.py``): numpy only, the
reference's output exactly.
"""

from __future__ import annotations

import numpy as np
import torch


class MarkovTokens:
    """Order-2 Markov token stream: p(x_t | x_{t-1}, x_{t-2}) concentrated
    on a few successors, so a small LM's loss falls quickly below the
    uniform baseline (the train-smoke criterion)."""

    def __init__(self, vocab: int, seed: int = 0, branch: int = 4,
                 n_contexts: int = 61):
        self.vocab = vocab
        self.branch = branch
        self.n_contexts = n_contexts
        rng = np.random.default_rng(seed)
        # successor table: for each (prev mixed hash) a few allowed tokens
        self._succ = rng.integers(0, vocab, size=(n_contexts, branch),
                                  dtype=np.int64)

    def batch(self, step: int, batch: int, seq_len: int):
        """Returns (tokens, labels) int32 of shape (batch, seq_len)."""
        rng = np.random.default_rng((step << 20) + 17)
        out = np.empty((batch, seq_len + 1), np.int64)
        out[:, 0] = rng.integers(0, self.vocab, batch)
        out[:, 1] = rng.integers(0, self.vocab, batch)
        choices = rng.integers(0, self.branch, size=(batch, seq_len + 1))
        for t in range(2, seq_len + 1):
            h = (out[:, t - 1] * 31 + out[:, t - 2]) % self.n_contexts
            out[:, t] = self._succ[h, choices[:, t]]
        tokens = out[:, :-1].astype(np.int32)
        labels = out[:, 1:].astype(np.int32)
        return tokens, labels

    @property
    def entropy_floor(self) -> float:
        """Ideal CE of the stream (log branch) — the learnability target."""
        return float(np.log(self.branch))


def uniform_points(n: int, dim: int, seed: int = 0,
                   high: float = 2**32 - 1) -> np.ndarray:
    """The paper's dataset: n points uniform in [0, high)^dim (f32)."""
    rng = np.random.default_rng(seed)
    return (rng.random((n, dim)) * high).astype(np.float32)


def gaussian_clusters(n: int, dim: int, num_classes: int, seed: int = 0):
    """Labeled clusters for the kNN classification example:
    ``(points (n, dim) f32, labels (n,) int32)``."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=8.0, size=(num_classes, dim))
    labels = rng.integers(0, num_classes, n)
    pts = centers[labels] + rng.normal(size=(n, dim))
    return pts.astype(np.float32), labels.astype(np.int32)


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


def labeled_mixture(n: int, dim: int, num_classes: int, *,
                    separation: float = 6.0, seed: int = 0):
    """Equal-prior isotropic Gaussian mixture with known Bayes-optimal
    labels: ``num_classes`` unit-variance components whose centres lie
    ``separation`` from their centroid.  Returns ``(points (n, dim) f32,
    labels (n,) int32, centers (num_classes, dim) f64)``; the labels are
    the component assignments.  Seeded: the same arguments replay the
    same instance."""
    rng = np.random.default_rng(seed)
    raw = rng.normal(size=(num_classes, dim))
    raw = raw - raw.mean(axis=0)
    centers = raw / np.maximum(
        np.linalg.norm(raw, axis=1, keepdims=True), 1e-30) * separation
    labels = rng.integers(0, num_classes, n)
    pts = centers[labels] + rng.normal(size=(n, dim))
    return pts.astype(np.float32), labels.astype(np.int32), centers


def bayes_labels(points, centers) -> np.ndarray:
    """The Bayes-optimal label of each point under
    :func:`labeled_mixture`: the nearest component centre (equal priors
    and covariances), in f64, ties to the lowest class."""
    pts = np.asarray(points, np.float64)
    d = ((pts[:, None, :] - np.asarray(centers)[None]) ** 2).sum(-1)
    return d.argmin(axis=1).astype(np.int32)
