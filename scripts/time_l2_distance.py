#!/usr/bin/env python3
"""Time l2_distance's two main loops on the card, and check that they
write bit-equal distances.

    python3 scripts/time_l2_distance.py [--out chiprun_out/l2_time.json]
                                        [--reps 3]       # one card, nvcc

Builds the kernel library and prints the compiler's report (registers,
spills) for ``l2_distance.cu``.  Then, for each shape ``(B, k, m, d)``
in f32: the 32-row loop (``knn_l2_distance``, launched over all B rows
as one grid of 32-row query tiles) and the whole-bucket loop
(``knn_l2_distance_wide``, the row tile that B takes; at B <= 32, where
the wrapper takes the 32-row loop, its smallest tile, 64), alternated
32-row, wide, wide, 32-row, each launch timed with CUDA events, and
each loop's kernel time from the profiler over one more launch; the two
outputs compared with ``torch.equal``.  Shapes: the
``knnlm.score128_l1024`` step (B = 128, 8 shards of m = 1,612,899, d =
1,024), B = 64 on the same points, and B = 128 at d = 96 on the same m;
then the buckets the wrapper keeps on the 32-row loop, B = 8 and 32 over
8 shards of 2^19 points at d = 64 (the service's default width) and
d = 896 (the kNN-LM example's datastore).
Bound: max(points + output bytes / 3.35 TB/s, 2 B k m d / 67 TFLOP/s).
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import _build, _cuda  # noqa: E402
from repro_torch.kernels import local_topk as ltk  # noqa: E402
from repro_torch.kernels import plan  # noqa: E402

PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12
M = 1_612_899
SHAPES = [(128, 8, M, 1024), (64, 8, M, 1024), (128, 8, M, 96),
          (8, 8, 1 << 19, 64), (32, 8, 1 << 19, 64), (8, 8, 1 << 19, 896),
          (32, 8, 1 << 19, 896)]


def wide_tile(B: int) -> int:
    """The whole-bucket loop's row tile for ``B`` rows: the wrapper's,
    or 64, its smallest, where the wrapper takes the 32-row loop (the tile
    is B's alone: any width, element size and SM count give it)."""
    return max(plan.l2(B, 64, 4, 1).tile, 64)


def launch(lib, wide: bool, q, p, out):
    B, d = q.shape
    k, m, _ = p.shape
    args = (q.data_ptr(), p.data_ptr(), None, out.data_ptr(), B, k, m, d, 0)
    stream = _cuda.stream_of(q)
    if wide:
        rc = lib.knn_l2_distance_wide(*args, wide_tile(B), stream)
    else:
        blocks = plan.L2_BLOCKS_PER_SM * ltk.sm_count(q.device.index or 0)
        rc = lib.knn_l2_distance(*args, blocks, stream)
    _cuda.ok("l2_distance", rc)


def profiled_ms(lib, wide, q, p, out) -> float:
    """The kernel's device time in one launch, from the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        launch(lib, wide, q, p, out)
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
             for e in prof.key_averages() if "l2_distance" in e.key)
    return us / 1e3


def ptxas_report(log: str) -> list:
    """The compiler's lines for l2_distance.cu: each entry's registers,
    stack and spills."""
    part = log.split("== l2_distance.cu", 1)[-1].split("\n== ", 1)[0]
    keep = re.compile(r"Compiling entry|Used \d+ registers|spill")
    return [ln.strip() for ln in part.splitlines() if keep.search(ln)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    lib = _build.library()
    report = ptxas_report(_build.build_log)
    for ln in report:
        print(ln)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    res = {"card": card.strip(), "ptxas": report, "shapes": []}
    g = torch.Generator(device=dev)
    p = None
    for B, k, m, d in SHAPES:
        if p is None or p.shape != (k, m, d):
            p = None
            torch.cuda.empty_cache()
            g.manual_seed(d)
            p = torch.randn((k, m, d), generator=g, device=dev)
        g.manual_seed(B)
        q = torch.randn((B, d), generator=g, device=dev)
        outs = {w: torch.empty((k, B, m), device=dev) for w in (False, True)}
        for w in (False, True):          # warm (and build) both
            launch(lib, w, q, p, outs[w])
        torch.cuda.synchronize()
        times = {False: [], True: []}
        for _ in range(args.reps):
            for w in (False, True, True, False):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                launch(lib, w, q, p, outs[w])
                e1.record()
                torch.cuda.synchronize()
                times[w].append(e0.elapsed_time(e1))
        equal = bool(torch.equal(outs[False], outs[True]))
        prof = {w: profiled_ms(lib, w, q, p, outs[w]) for w in (False, True)}
        flops = 2.0 * B * k * m * d
        nbytes = 4.0 * (k * m * d + B * d + k * B * m)
        bound = 1e3 * max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)
        row = {"B": B, "k": k, "m": m, "d": d, "row_tile": wide_tile(B),
               "wrapper_tile": plan.l2(B, d, 4, 1).tile,
               "bit_equal": equal,
               "bound_ms": bound, "loop32_ms": times[False],
               "wide_ms": times[True],
               "loop32_ms_median": statistics.median(times[False]),
               "wide_ms_median": statistics.median(times[True]),
               "loop32_profiler_ms": prof[False],
               "wide_profiler_ms": prof[True]}
        row["wide_f32_peak_share"] = 100 * flops / PEAK_FLOPS / (
            row["wide_ms_median"] / 1e3)
        print(json.dumps(row), flush=True)
        res["shapes"].append(row)
        del outs, q
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    ok = all(r["bit_equal"] for r in res["shapes"])
    print(json.dumps({"ok": ok, "card": res["card"]}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
