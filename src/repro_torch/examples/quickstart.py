"""Quickstart: the paper's distributed l-NN served through the query service.

Port of the repository's ``examples/quickstart.py``; ``--device`` is the
card unless ``cpu`` is given.  Builds a ``KnnServer`` over a point set
held as k = 8 shards, submits a handful of requests, each with its
*own* neighbour count l, lets the micro-batcher coalesce them into one
padded device batch, and checks every answer against brute force.  The
printed telemetry is the paper's theorem accounting: Algorithm 1
iterations (Theorem 2.4: O(log l), k-independent), k-machine rounds and
messages, and the Lemma 2.3 post-prune survivor counts.

  PYTHONPATH=src python -m repro_torch.examples.quickstart
  PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs.knn_service import CONFIG
from repro_torch.runtime import KnnServer

K = 8          # machines (shards)
DIM = 32
L_MAX = 32     # shared static bound; requests pick any l <= L_MAX


def main(argv=None):
    """Serve and check; returns the requests' ``QueryResult``s."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", type=int, default=K * 4096)
    ap.add_argument("--device", default=None,
                    help="torch device; the card when omitted")
    args = ap.parse_args(argv)
    n = args.points
    rng = np.random.default_rng(0)
    points = rng.normal(size=(n, DIM)).astype(np.float32)

    cfg = CONFIG.replace(dim=DIM, l=16, l_max=L_MAX,
                         bucket_sizes=(1, 2, 4, 8))
    server = KnnServer(points, cfg=cfg, shards=K, device=args.device)
    server.warmup()

    queries = rng.normal(size=(5, DIM)).astype(np.float32)
    ls = [16, 1, 32, 7, 16]            # heterogeneous per-request l
    results = server.query_batch(queries, ls)

    print(f"{n} points on {K} machines; {len(queries)} requests "
          f"micro-batched into {server.stats.batches} device batch(es) "
          f"(bucket counts {server.stats.bucket_counts}, "
          f"{server.stats.padded_rows} padded rows)")
    r0 = results[0]
    print(f"selection iterations: {r0.iterations} "
          f"(Theorem 2.4 bound ~ O(log l), l_max = {L_MAX})")
    print(f"k-machine cost of the batch: {r0.rounds} rounds, "
          f"{r0.messages} O(1)-word messages")
    print(f"post-prune candidates: {[r.survivors for r in results]} "
          f"(Lemma 2.3 bound {11 * L_MAX})")

    # verify every request against brute force
    full = ((queries[:, None, :].astype(np.float64)
             - points[None].astype(np.float64)) ** 2).sum(-1)
    for r, row in zip(results, full):
        want = np.sort(row)[:r.l]
        np.testing.assert_allclose(np.sort(r.dists), want, rtol=1e-4)
    print("all requests match brute force — OK")
    server.close()
    return results


if __name__ == "__main__":
    main()
