#!/usr/bin/env python3
"""Sweep an open-loop benchmark cell's arrival rate on the card and find
its knee: the highest rate whose backlog does not grow through the
window.

    python3 scripts/knee_sweep.py --workload deep1b.open_l10 --seed <n> \
        --seconds 51 --rates 300,350,400 [--src DIR] [--out FILE]

From the root of a checkout.  The cell's points, query pool and server
are made once, as ``perfbench.harness.run_cell`` makes them, and warmed
with the cell's own warm-up; then each rate of ``--rates`` (ascending)
runs one window of the cell's open loop.  A window's backlog at time t
is the requests due by t less those answered by t, read each second;
the backlog grows where the least-squares line through its readings
from the fifth second on rises by more than one full bucket over the
window.  The sweep stops after ``--stop-after`` growing rates in a row.
``--src`` names the source tree the port is imported from (the
checkout's ``src`` by default), so one benchmark tree can sweep
another commit's program; every line records the package it imported
(``program``), and the sweep refuses to run where that is not under
``--src``.  Prints a line a rate and a last line with the knee;
appends them to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def backlog(reqs, t0: float, seconds: float) -> tuple[list, float]:
    """The backlog read each second of the window, and its growth over
    the window by the least-squares line from the fifth second on."""
    due = np.sort([r.t_due - t0 for r in reqs])
    done = np.sort([r.t_answer - t0 for r in reqs
                    if r.t_answer is not None])
    ts = np.arange(1.0, np.floor(seconds) + 1.0)
    depth = (np.searchsorted(due, ts, side="right")
             - np.searchsorted(done, ts, side="right"))
    late = ts >= 5.0
    if late.sum() < 2:
        return depth.tolist(), 0.0
    slope = np.polyfit(ts[late], depth[late], 1)[0]
    return depth.tolist(), float(slope * (ts[late][-1] - ts[late][0]))


def window_line(win, rate: float, seconds: float, bucket: int) -> dict:
    reqs = win.requests
    answered = win.answered()
    lat = np.array([r.latency_s for r in answered]) * 1e3
    depth, growth = backlog(reqs, win.t0, seconds)
    batches = len({r.batch for r in answered})
    return {"rate": rate, "sent": len(reqs), "answered": len(answered),
            "offered_per_s": len(reqs) / seconds,
            "answered_per_s": len(answered) / max(win.seconds, 1e-9),
            "latency_p50_ms": float(np.quantile(lat, 0.5)) if len(lat)
            else None,
            "latency_p95_ms": float(np.quantile(lat, 0.95)) if len(lat)
            else None,
            "rows_per_batch": len(answered) / batches if batches else None,
            "lateness_p99_ms": float(np.quantile(win.lateness_s, 0.99))
            * 1e3 if win.lateness_s else None,
            "backlog_end": depth[-1] if depth else None,
            "backlog_max": max(depth) if depth else None,
            "backlog_growth": growth, "grows": growth > bucket,
            "backlog_each_s": depth}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--stop-after", type=int, default=2)
    p.add_argument("--src", type=Path, default=ROOT / "src")
    p.add_argument("--out", type=Path)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from perfbench.run import _paths

    _paths()
    src = args.src.resolve()
    sys.path.insert(0, str(src))       # ahead of the checkout's src
    import repro_torch
    import torch

    from perfbench import harness, spec

    program = Path(repro_torch.__file__).resolve().parent
    if not program.is_relative_to(src):
        print(f"knee_sweep: repro_torch came from {program}, not from "
              f"{src}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("knee_sweep: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.runtime.knn_server import KnnServer

    cell = spec.cell(args.workload)
    cfg, wl = cell.config, cell.workload
    dev = torch.device("cuda")
    gen = spec.load_module("data", cfg["data"]["generator"], cell.base)
    traffic = spec.load_module("traffic", wl["generator"], cell.base)
    n, d = int(cfg["n_points"]), int(cfg["dim"])
    params = cfg["data"]["params"]
    t = time.perf_counter()
    points = gen.points(n, d, params, args.seed, dev)
    pool = gen.queries(int(wl["query_pool"]), d, params, args.seed,
                       dev).cpu().numpy()
    scfg = harness.service_config(cfg)
    server = KnnServer(points, cfg=scfg, shards=int(cfg["shards"]),
                       device=dev, seed=args.seed)
    head = {"workload": cell.name, "seed": args.seed,
            "program": str(program), "card": harness.card_limits()}
    rates = [float(r) for r in args.rates.split(",")]
    growing, lines = 0, []
    with server.serving():
        traffic.warmup(server, pool, wl["params"], args.seed)
        torch.cuda.synchronize()
        head["setup_s"] = time.perf_counter() - t
        for rate in rates:
            win = traffic.run(server, pool, dict(wl["params"], rate=rate),
                              args.seed, args.seconds)
            line = dict(head, **window_line(win, rate, args.seconds,
                                            scfg.bucket_sizes[-1]))
            lines.append(line)
            _emit(line, args.out)
            growing = growing + 1 if line["grows"] else 0
            if growing >= args.stop_after:
                break
    server.close()
    knee = None
    for line in lines:
        if line["grows"]:
            break
        knee = line["rate"]
    _emit(dict(head, knee=knee, rates=[x["rate"] for x in lines],
               grows=[x["grows"] for x in lines]), args.out)
    return 0


def _emit(line: dict, out) -> None:
    text = json.dumps(line)
    print(text, flush=True)
    if out is not None:
        with open(out, "a") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    sys.exit(main())
