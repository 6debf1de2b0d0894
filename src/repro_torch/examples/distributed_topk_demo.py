"""Demo: the paper's selection as a vocabulary top-k sampler, against the
gather baseline: the production Figure-2 comparison.

Port of the repository's ``examples/distributed_topk_demo.py``;
``--device`` is the card unless ``cpu`` is given.  Sweeps k_sel and
prints the wall time and the wire-byte model of both methods over a
152k vocabulary held as 8 vocabulary shards (``core.topk.shard_vocab``),
and checks each method's top-k against a stable sort of the rows.

  PYTHONPATH=src python -m repro_torch.examples.distributed_topk_demo
  PYTHONPATH=src python -m repro_torch.examples.distributed_topk_demo \\
      --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import topk
from repro_torch.device import resolve_device

K = 8
V = K * 19008      # ~152k, qwen-sized
B = 16


def wire_bytes(method: str, ksel: int, iterations: int, batch: int) -> float:
    """The demo's wire-byte model: gather moves every shard's k (value,
    id) pairs; selection moves 12 bytes a shard an iteration plus the k
    winners' values both ways."""
    if method == "gather":
        return K * ksel * 8 * batch
    return float(iterations) * K * 12 * batch + 2 * ksel * 4 * batch


def main(argv=None):
    """Sweep and check; returns ``[(k, method, wall ms, wire bytes,
    iterations)]``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--vocab", type=int, default=V)
    ap.add_argument("--batch", type=int, default=B)
    ap.add_argument("--ks", default="8,64,256")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device; the card when omitted")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.normal(size=(args.batch, args.vocab))
                              .astype(np.float32)).to(dev)
    shards = topk.shard_vocab(logits, K)
    order = torch.argsort(-logits, dim=-1, stable=True)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    print(f"vocab {args.vocab} sharded over {K} machines, batch "
          f"{args.batch}")
    print(f"{'k':>6} {'method':>10} {'wall_ms':>9} {'wire_bytes':>11} "
          f"{'rounds':>7}")
    rows = []
    for ksel in (int(k) for k in args.ks.split(",")):
        want = order[:, :ksel]
        for method in ("selection", "gather"):
            def run():
                return topk.distributed_topk(shards, ksel,
                                             topk.generator(0, dev),
                                             method=method)
            r = run()              # warm-up, and the check
            if not torch.equal(r.indices.long(), want) or not torch.equal(
                    r.values, logits.gather(-1, want)):
                raise AssertionError(f"{method} k={ksel}: the top-k differs "
                                     f"from a stable sort")
            sync()
            t0 = time.perf_counter()
            for _ in range(args.reps):
                r = run()
            sync()
            dt = (time.perf_counter() - t0) / args.reps
            wire = wire_bytes(method, ksel, r.iterations, args.batch)
            rows.append((ksel, method, dt * 1e3, wire, r.iterations))
            print(f"{ksel:>6} {method:>10} {dt*1e3:>9.2f} {wire:>11.0f} "
                  f"{float(r.iterations):>7.0f}")
    print("\nselection moves O(k log l) scalars/query vs gather's O(k*l);"
          "\neach method's top-k equals a stable sort of the rows — OK")
    return rows


if __name__ == "__main__":
    main()
