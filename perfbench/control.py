"""The control: the reference one precision below the configuration's
f32, put in the program's place.

    python3 perfbench/control.py --workload <cell> --seeds 4,5,6 \\
        [--out <file.jsonl>]

On the card, at the cell's own size.  For each seed it makes the cell's
points and query pool, lets the reference computed in TF32
(``reference.exact_topl`` with ``precision="tf32"``) answer as many
sampled pool rows at the cell's rank as a run's check judges, and
compares those answers as a run's are (``harness.compare``).  The
readings, beside the program's, set the check's limits (PERF.md); the
CPU test runs the same at a tiny size.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def control(cell, seed: int, device) -> dict:
    """The control's compared numbers under ``seed``."""
    import torch

    from perfbench import harness, spec
    from perfbench.reference import exact_topl
    from perfbench.seeds import sub_seed

    cfg, wl = cell.config, cell.workload
    gen = spec.load_module("data", cfg["data"]["generator"], cell.base)
    n, d = int(cfg["n_points"]), int(cfg["dim"])
    pool = gen.queries(int(wl["query_pool"]), d, cfg["data"]["params"],
                       seed, device).cpu().numpy()
    rng = np.random.default_rng(sub_seed(seed, "check"))
    rows = np.sort(rng.choice(len(pool), int(wl["check"]["sample"]),
                              replace=False))
    l = int(wl["params"]["l"])
    q = torch.from_numpy(pool[rows]).to(device)
    ans = exact_topl.scan(q, l, gen.chunks(n, d, cfg["data"]["params"], seed,
                                           device), precision="tf32")
    served_d = list(ans["top_d"].float().cpu().numpy())
    served_i = list(ans["top_i"].cpu().numpy())
    return harness.compare(cell, pool[rows], [l] * len(rows), served_d,
                           served_i, gen, seed, device)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--out")
    args = p.parse_args(argv)

    from perfbench import spec

    cell = spec.cell(args.workload)
    for s in [int(x) for x in args.seeds.split(",")]:
        t = time.perf_counter()
        text = json.dumps({"workload": cell.name, "side": "control_tf32",
                           "seed": s, "values": control(cell, s, "cuda"),
                           "seconds": time.perf_counter() - t})
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
    return 0


if __name__ == "__main__":
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(root / "src"), str(root)]
    sys.exit(main())
