"""One run of one cell: set-up, the measured window, the check, the line.

``main`` is the command's body.  :func:`run_cell` is the run itself,
on any device: the command calls it on the card only, the CPU tests at
small sizes with the kernels' plain versions.

A run: make the points and the query pool from the seed on the device,
start ``KnnServer`` over the points, warm the cell's own shapes with its
own traffic, then measure ``--seconds`` of that traffic (under the
profiler with ``--trace 1``).  Once the window has closed, the peak
memory is read and the server and its points are freed; the reference
then makes the points again chunk by chunk and judges a sample of the
window's answers (``check``).  The metrics are read by one reader a
metric (``metrics/<name>.py``).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import subprocess
import sys
import time
from typing import Optional

import numpy as np

from perfbench import check, spec, trace, work
from perfbench.reference import exact_topl
from perfbench.seeds import sub_seed

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Context:
    """What a metric reader reads (``metrics/<name>.py``: ``read(ctx)``,
    a number or None where it finds nothing to read)."""

    cell: spec.Cell
    window: object                 # window.Window
    setup_s: float
    stats0: dict                   # ServerStats before and after the window
    stats1: dict
    batches: list                  # one dict a batch of the window
    peaks: dict
    trace: Optional[dict] = None   # trace.summarize of a --trace 1 run


def forbidden_modules(names=None) -> list:
    """Loaded modules (``names``, by default ``sys.modules``) whose
    top-level name is JAX's or the JAX package's, compared as whole
    names: ``repro_torch`` is not ``repro``."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


@contextlib.contextmanager
def step_marks(knn_mod, device, traced: bool):
    """In a traced run on the card, mark every call of the distance +
    top-l step (``core.knn.local_distance_top_l``, which
    ``_knn_pipeline`` calls) with a one-element int16 fill before it and
    one after: kernels that nothing else launches, whose launches the
    profiler records on the server's thread, where it records no host
    range (``trace``).  Elsewhere nothing changes."""
    import torch

    if not traced or torch.device(device).type != "cuda":
        yield
        return
    orig = knn_mod.local_distance_top_l
    mark = torch.zeros(1, dtype=torch.int16, device=device)

    def marked(*args, **kwargs):
        mark.fill_(1)
        try:
            return orig(*args, **kwargs)
        finally:
            mark.fill_(2)

    knn_mod.local_distance_top_l = marked
    try:
        yield
    finally:
        knn_mod.local_distance_top_l = orig


def service_config(config: dict):
    """The ``KnnServiceConfig`` of a configuration file."""
    from repro_torch.configs.knn_service import CONFIG

    svc = dict(config["service"])
    svc["bucket_sizes"] = tuple(svc["bucket_sizes"])
    return dataclasses.replace(CONFIG, dim=int(config["dim"]),
                               l=int(svc["l_max"]), **svc)


def batches_of(window) -> list:
    """One dict a batch of the window, from its requests."""
    out = {}
    for r in window.answered():
        b = out.setdefault(r.batch, {"batch": r.batch, "n_real": 0,
                                     "bucket": r.bucket,
                                     "iterations": r.iterations,
                                     "host_syncs": r.host_syncs})
        b["n_real"] += 1
    return [out[k] for k in sorted(out)]


def sample_of(cell, window, seed: int) -> list:
    """The answered requests the check judges: ``check.sample`` of them
    (or all), drawn from the seed."""
    answered = window.answered()
    want = int(cell.workload["check"]["sample"])
    rng = np.random.default_rng(sub_seed(seed, "check"))
    pick = rng.choice(len(answered), min(want, len(answered)),
                      replace=False)
    return [answered[i] for i in sorted(pick.tolist())]


def compare(cell, queries, ls, served_d, served_i, gen, seed: int,
            device) -> dict:
    """The compared numbers (``check.numbers``) of answers to the pool
    rows ``queries`` (numpy), against the reference, which makes the
    points again from the seed chunk by chunk."""
    import torch

    cfg = cell.config
    n, d = int(cfg["n_points"]), int(cfg["dim"])
    q = torch.from_numpy(np.ascontiguousarray(queries)).to(device)
    width = max(ls)
    ref = exact_topl.scan(
        q, width, gen.chunks(n, d, cfg["data"]["params"], seed, device),
        torch.from_numpy(check.served_matrix(served_i, width)))
    return check.numbers(served_d, served_i, ls, ref, n,
                         (q.double() ** 2).sum(1).cpu().numpy())


def _check(cell, window, pool, gen, seed, device) -> tuple[bool, dict]:
    sample = sample_of(cell, window, seed)
    values = {"unanswered": len(window.requests) - len(window.answered())}
    if sample:
        values.update(compare(cell, pool[[r.index for r in sample]],
                              [r.l for r in sample],
                              [r.dists for r in sample],
                              [r.ids for r in sample], gen, seed, device))
    ok, table = check.verdict(values, cell.workload["check"]["limits"])
    table["sampled"] = {"value": len(sample), "limit": None}
    return ok and bool(sample), table


def card_limits() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        p = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return p.stdout.strip() or None


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             device: str, t_start: float) -> dict:
    """One run (module docstring); the result line's keys, the checks
    last."""
    import torch

    from repro_torch.core import knn as knn_mod
    from repro_torch.runtime.knn_server import KnnServer

    cfg, wl = cell.config, cell.workload
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    gen = spec.load_module("data", cfg["data"]["generator"], cell.base)
    traffic = spec.load_module("traffic", wl["generator"], cell.base)
    n, d = int(cfg["n_points"]), int(cfg["dim"])
    params = cfg["data"]["params"]
    clock = time.perf_counter
    phases = {"start": clock() - t_start}
    t = clock()
    points = gen.points(n, d, params, seed, dev)
    pool = gen.queries(int(wl["query_pool"]), d, params, seed,
                       dev).cpu().numpy()
    if cuda:
        torch.cuda.synchronize(dev)
    phases["data"], t = clock() - t, clock()
    server = KnnServer(points, cfg=service_config(cfg),
                       shards=int(cfg["shards"]), device=dev, seed=seed)
    phases["server"], t = clock() - t, clock()
    prof = None
    try:
        with step_marks(knn_mod, dev, traced), server.serving():
            warm = traffic.warmup(server, pool, wl["params"], seed)
            if len(warm.answered()) != len(warm.requests):
                raise RuntimeError("a set-up request was not answered")
            if cuda:
                torch.cuda.synchronize(dev)
            stats0 = server.stats.snapshot()
            phases["warmup"], t = clock() - t, clock()
            if traced:
                acts = [torch.profiler.ProfilerActivity.CPU]
                if cuda:
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                prof = torch.profiler.profile(activities=acts)
                prof.start()
            try:
                with torch.profiler.record_function(trace.WINDOW):
                    win = traffic.run(server, pool, wl["params"], seed,
                                      seconds)
                    if cuda:
                        torch.cuda.synchronize(dev)
            finally:
                if prof is not None:
                    prof.stop()
            stats1 = server.stats.snapshot()
        peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    finally:
        server.close()
    setup_s = win.t0 - t_start
    del server, points
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    phases["window"], t = clock() - t, clock()
    summary = trace.summarize(trace.from_profiler(prof)) if prof else None
    prof = None
    phases["trace"], t = clock() - t, clock()
    ok, checks = _check(cell, win, pool, gen, seed, dev)
    phases["check"] = clock() - t

    ctx = Context(cell=cell, window=win, setup_s=setup_s, stats0=stats0,
                  stats1=stats1, batches=batches_of(win),
                  peaks=work.peaks(), trace=summary)
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = spec.load_module("metrics", m["name"], cell.base).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda
                   else "cpu",
                   "count": cell.chips, "memory_peak_bytes": peak}
    line = {"correct": bool(ok), "attempted": len(win.requests),
            "failed": checks["unanswered"]["value"], "metrics": metrics,
            "device": device_info}
    if summary is not None:
        device_info["busy_s"] = summary["busy_s"]
        device_info["window_s"] = summary["window_s"]
        line["breakdown"] = {"device_ops": summary["device_ops"],
                             "idle_gaps": summary["idle_gaps"]}
    line["phases"] = phases
    b = ctx.batches
    line["batches"] = {
        "count": len(b),
        "iterations_mean": sum(x["iterations"] for x in b) / max(len(b), 1),
        "wall_ms_mean": 1e3 * win.seconds / max(len(b), 1)}
    if summary is not None:
        line["trace"] = {k: summary[k] for k in
                         ("step_device_s", "steps", "step_launches",
                          "marks")}
    line["checks"] = checks
    return line


def parse(argv):
    p = argparse.ArgumentParser(prog="perfbench/run.py",
                                description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("perfbench: no CUDA device; the benchmark runs on the card "
              "only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    line = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                    "cuda", t_start)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {bad}: the benchmark drives the "
              f"port only", file=sys.stderr)
        return 3
    line["card"] = card_limits()
    checks = line.pop("checks")
    line["checks"] = checks
    print("phases, s: " + ", ".join(f"{k} {v:.3f}" for k, v in
                                    line["phases"].items()),
          file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(line))
    return 0
