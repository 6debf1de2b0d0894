#!/usr/bin/env python3
"""One traced run of a benchmark cell with the server's own tracer on,
and the device's idle time split by the server's spans.

    python3 scripts/trace_spans.py --workload <cell> --seed <n> \
        --seconds <s> [--program-trace 0|1] [--out FILE]

From the root of a checkout, on the card.  The run is
``perfbench.harness.run_cell`` with ``--trace 1`` and two changes that
the harness does not make: the server is built with ``obs_trace`` on and
a ring of ``1 << 18`` spans (the window holds ~3 spans a request and
~12 a batch, ~85k in all), and the profiler's events and the tracer's
spans are kept and passed to ``perfbench.spans.summarize``.  The result
line is the harness's, with ``spans`` added, the readers of the spans'
numbers among its ``metrics`` and ``anchor_gap_ns``, the tracer's widest
anchor, ``launches_per_batch``: each kernel wrapper's launches
(``kernels.ops.launch_counts``) over the server's batches, warm-up
included, and ``idle_ms_per_batch``: the device's idle time inside each
span of ``SPANS`` (Algorithm 2's phases, the gather sampler's ``merge``,
the serving spans, and time between dispatches) over the window's
batches.  ``--program-trace 0`` leaves the server's tracer off: the
harness's traced run as it is, for the tracer's cost.  Prints the line
and appends it to ``--out``.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CAPACITY = 1 << 18
# the readers of perfbench/spans.py's numbers, with their units
READERS = {"alg.select_launches_per_batch": "launches",
           "alg.idle_share": "%", "serve.idle_share": "%"}
# the spans the idle time a batch is listed by (perfbench/spans.py)
SPANS = ("topl", "prune", "select", "gather", "merge", "readback",
         "predict", "kernel", "snapshot", "route", "shadow_audit",
         "resolve", "dispatch", "between_dispatches")


def traced_run(cell, seed: int, seconds: float, program_trace: bool,
               device: str, t_start: float) -> dict:
    """The harness's traced run of ``cell`` (module docstring)."""
    from perfbench import harness, spans, spec, trace
    from repro_torch.kernels import ops as kops
    from repro_torch.runtime import knn_server

    kept = {"records": [], "dropped": 0, "anchor_gap_ns": 0}
    service_config = harness.service_config
    from_profiler = trace.from_profiler
    server_cls = knn_server.KnnServer

    class KeptServer(server_cls):
        def close(self):
            super().close()
            stats = self.obs.tracer.stats()
            kept.update(records=self.obs.tracer.spans(),
                        dropped=stats["dropped"],
                        anchor_gap_ns=stats.get("anchor_gap_ns", 0),
                        launches=kops.launch_counts(),
                        batches=self.stats.batches)

    def traced_config(config):
        return service_config(config).replace(
            obs_trace=True, obs_trace_capacity=CAPACITY)

    def keep_events(prof):
        kept["events"] = from_profiler(prof)
        return kept["events"]

    knn_server.KnnServer = KeptServer
    trace.from_profiler = keep_events
    if program_trace:
        harness.service_config = traced_config
    try:
        line = harness.run_cell(cell, seed, seconds, True, device, t_start)
    finally:
        knn_server.KnnServer = server_cls
        trace.from_profiler = from_profiler
        harness.service_config = service_config
    summary = spans.summarize(kept.get("events", []), kept["records"],
                              kept["dropped"])
    ctx = harness.Context(cell=cell, window=None, setup_s=0.0, stats0={},
                          stats1={}, batches=[], peaks={})
    ctx.spans = summary
    for name, unit in READERS.items():
        value = spec.load_module("metrics", name, cell.base).read(ctx)
        if value is not None:
            line["metrics"][name] = {"value": float(value), "unit": unit}
    line["spans"] = summary
    if summary is not None:
        n = max(line["batches"]["count"], 1)
        line["idle_ms_per_batch"] = {
            name: 1e3 * summary["idle"].get(name, 0.0) / n
            for name in SPANS}
    line["anchor_gap_ns"] = kept["anchor_gap_ns"]
    line["launches_per_batch"] = {
        name: n / max(kept["batches"], 1)
        for name, n in kept["launches"].items()}
    line["program_trace"] = bool(program_trace)
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--program-trace", type=int, choices=(0, 1), default=1)
    p.add_argument("--out", type=Path)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from perfbench.run import _paths

    _paths()          # the benchmark command's paths and environment
    import torch

    from perfbench import harness, spec

    if not torch.cuda.is_available():
        print("trace_spans: no CUDA device", file=sys.stderr)
        return 2
    line = traced_run(spec.cell(args.workload), args.seed, args.seconds,
                      bool(args.program_trace), "cuda", T_START)
    line["card"] = harness.card_limits()
    line["workload"], line["seed"] = args.workload, args.seed
    text = json.dumps(line)
    print(text)
    if args.out is not None:
        with open(args.out, "a") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
