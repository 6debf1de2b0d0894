#!/usr/bin/env python3
"""Time the device-routed prologue of the PyTorch port's KnnServer on one
NVIDIA GPU, for the package under ``--src``: one tree against another in
one call, on one card.

    python3 scripts/time_route_prologue.py [--src DIR] [--reps N]

The server is chip_smoke.py's serve_routed run d (route="pruned",
route_compute="device", search="approx") on its data (8 Gaussian
clusters of 524,288 points, dim 64, one a shard, seed 43), and the batch
is that run's first burst of 32 requests.  Two walls, each the host
clock around the call and a synchronise, median and quartiles in ms over
``--reps`` calls after 10 warm-up calls:

* ``prologue``: ``KnnServer._prologue``, the routing and bucket masks,
  their readback, the candidate mask it queues and the candidate
  fraction;
* ``routing``: the routing step alone, up to its readback, as the
  tree's ``_prologue`` makes it: one ``route_index`` launch where the
  server packs its operands (``_operands``, or ``_routing`` in older
  trees), else ``route_mask``, its ``any(0)``, ``index_mask``, its
  ``any(0)`` and a ``cat``.

Prints one JSON line with the card and its power limit and the tree.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

K, M, DIM, L, B = 8, 524288, 64, 128, 32


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"),
                    help="the src/ directory holding repro_torch")
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("time_route_prologue: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    from repro_torch.configs import CONFIG
    from repro_torch.data import sharded_clusters
    from repro_torch.runtime import KnnServer

    dev = torch.device("cuda", 0)
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    points, centers = sharded_clusters(K, M, DIM, scale=8.0, seed=43,
                                       device=dev)
    rng = np.random.default_rng(43)
    c = centers[int(rng.integers(0, K))]         # chip_smoke's first burst
    q = (c + rng.normal(size=(B, DIM))).astype(np.float32)
    ls = rng.integers(1, L + 1, B).astype(np.int32)
    ls[0], ls[1] = 1, L
    cfg = CONFIG.replace(route="pruned", route_compute="device",
                         search="approx")
    srv = KnnServer(points, cfg=cfg, shards=K, device=dev, seed=0)
    qt, lt = torch.as_tensor(q, device=dev), torch.as_tensor(ls, device=dev)
    from repro_torch.kernels import ops as kops

    packed = (srv._operands(srv._summaries, srv._index)[0]
              if hasattr(srv, "_operands") else getattr(srv, "_routing", None))
    if packed is not None:
        def routing():
            return kops.route_index(qt, lt, packed, with_rows=False)[2].cpu()
    else:
        def routing():
            rows = kops.route_mask(qt, lt, srv._route_ops,
                                   slack=cfg.route_slack)
            keep = kops.index_mask(qt, lt, rows, srv._index_ops,
                                   oversample=cfg.index_oversample)
            return torch.cat([rows.any(0), keep.any(0)]).cpu()
    out = {"gpu": gpu, "src": args.src, "reps": args.reps}
    for name, fn in (("prologue", lambda: srv._prologue(q, ls, qt, lt)),
                     ("routing", routing)):
        def call():
            fn()
            torch.cuda.synchronize()
        for _ in range(10):
            call()
        walls = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            call()
            walls.append((time.perf_counter() - t0) * 1e3)
        walls.sort()
        n = len(walls)
        out.update({f"{name}_ms_p50": walls[n // 2],
                    f"{name}_ms_q1": walls[n // 4],
                    f"{name}_ms_q3": walls[3 * n // 4]})
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
