#!/usr/bin/env python3
"""Algorithm 1 on the card: the device loop (``csrc/select_loop.cu``)
against the host-paced loop (``core.selection.host_loop``), at the
selection shapes of the benchmark's three selection cells.

    python3 scripts/ablate_select.py      # needs one card and nvcc
    python3 scripts/ablate_select.py --cells knnlm.score128_l1024 \
        --reps 20 --seed 7 --out build/ablate/select.jsonl

From the root of a checkout.  For each cell, its configuration's points
(``perfbench/configs``, made on the card from the seed by the cell's
generator; ``--points-scale`` takes a share of them) and one bucket of
queries: 128 rows at l = 100 (``deep1b.batch128_l100``) or l = 1,024
(``knnlm.score128_l1024``); a bucket of 64 with ``--open-rows`` rows at
l = 10 and the rest padding (``deep1b.open_l10``).  The inputs of the
selection are made by the real step and prune
(``core.knn.local_distance_top_l``, ``core.sampling.sample_prune``), once;
then each path runs ``--reps`` times, each with a generator of its own
seed, and is timed by CUDA events around the call and by the host's
clock to the read of its thresholds.  One more call of each path under
``torch.profiler`` counts its kernel launches.  Printed, a path a line
and appended to ``--out``: ms a batch (events: median, min, max; host
wall median), launches, iterations a batch (the largest row's: median,
max), the launch counters' change over the timed calls,
and whether every threshold and converged flag is ``torch.equal`` to the
device loop's first.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

CELLS = ("deep1b.batch128_l100", "knnlm.score128_l1024", "deep1b.open_l10")


def bucket(cell, open_rows: int):
    """``(rows, [l a row])`` of one bucket of the cell's traffic."""
    params = cell.workload["params"]
    l = int(params["l"])
    if cell.workload["generator"] == "closed_loop":
        rows = int(params["requests_per_round"])
        return rows, [l] * rows
    return 64, [l] * open_rows + [0] * (64 - open_rows)


def inputs(cell, seed: int, scale: float, open_rows: int, dev):
    """The selection's inputs at the cell's shape: ``(d, gid, ls, valid)``,
    by the step and the prune."""
    import torch

    from perfbench import spec
    from repro_torch.core import knn, sampling

    cfg = cell.config
    k, d = int(cfg["shards"]), int(cfg["dim"])
    params = cfg["data"]["params"]
    gen = spec.load_module("data", cfg["data"]["generator"], cell.base)
    m = int(int(cfg["n_points"]) * scale) // k
    points = gen.points(k * m, d, params, seed, dev).view(k, m, d)
    ids = torch.arange(k * m, dtype=torch.int32, device=dev).view(k, m)
    rows, ls = bucket(cell, open_rows)
    q = gen.queries(rows, d, params, seed, dev)
    L = int(cfg["service"]["l_max"])
    lt = torch.tensor(ls, dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    dist, gid = knn.local_distance_top_l(q, points, ids, L)
    prune = sampling.sample_prune(dist, g, lt)
    torch.cuda.synchronize()
    return dist, gid, lt, prune.valid, m


def run_path(name: str, sel_fn, reps: int, seed: int, dev):
    """Time ``sel_fn(gen)`` ``reps`` times: ``(line, the results)``."""
    import torch

    from repro_torch.kernels import ops

    def call(s):
        g = torch.Generator(device=dev)
        g.manual_seed(s)
        return sel_fn(g)

    call(seed)                                   # build, load, warm
    torch.cuda.synchronize()
    before = ops.launch_counts()
    ev_ms, wall_ms, its, results = [], [], [], []
    for r in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e0.record()
        res = call(seed + 1 + r)
        e1.record()
        res.threshold_v.cpu()
        wall_ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        ev_ms.append(e0.elapsed_time(e1))
        its.append(res.iterations)
        results.append(res)
    after = ops.launch_counts()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        call(seed).row_iterations.cpu()
        torch.cuda.synchronize()
    launches = sum(1 for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    line = {"path": name,
            "ms": {"median": statistics.median(ev_ms), "min": min(ev_ms),
                   "max": max(ev_ms)},
            "wall_ms_median": statistics.median(wall_ms),
            "launches": launches or None,
            "iterations": {"median": statistics.median(its),
                           "max": max(its)},
            "counters": {k: after[k] - before[k] for k in after
                         if after[k] != before[k]}}
    return line, results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cells", default=",".join(CELLS))
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--points-scale", type=float, default=1.0)
    p.add_argument("--open-rows", type=int, default=41)
    p.add_argument("--out", default="build/ablate/select.jsonl")
    args = p.parse_args(argv)

    import torch

    from perfbench import spec
    from repro_torch.core import selection
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    card = torch.cuda.get_device_name(dev)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    for name in args.cells.split(","):
        cell = spec.cell(name)
        d, gid, lt, valid, m = inputs(cell, args.seed, args.points_scale,
                                      args.open_rows, dev)
        k, B, L = d.shape
        cap = selection.iteration_cap(k * L)
        path = ops.select_path(d)
        paths = {
            "device_loop": lambda g: selection.select_l_smallest(
                d, gid, lt, g, valid=valid),
            "host_loop": lambda g: selection.host_loop(
                d, gid, lt, g, valid=valid, max_iterations=cap)}
        lines, first = [], None
        for pname, fn in paths.items():
            line, results = run_path(pname, fn, args.reps, args.seed, dev)
            if first is None:
                first = results[0]
            line["equal"] = all(
                torch.equal(r.threshold_v, first.threshold_v)
                and torch.equal(r.threshold_i, first.threshold_i)
                and torch.equal(r.converged, first.converged)
                for r in results)
            line.update(cell=name, card=card, rows=B, keys_a_row=k * L,
                        m_local=m, select_path=path, survivors_mean=float(
                            valid.sum((0, 2)).float().mean()))
            lines.append(line)
            print(json.dumps(line), flush=True)
        with open(out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
        del d, gid, valid
        torch.cuda.empty_cache()
        if path != ops.DEVICE_LOOP or not all(x["equal"] for x in lines):
            print(f"ablate_select: {name}: path {path}, equal "
                  f"{[x['equal'] for x in lines]}", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
