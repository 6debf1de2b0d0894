#!/usr/bin/env python3
"""Time the uint8 distance + top-l step alone at the bigann cell's shape
on the card, against its bound.

    python3 scripts/ablate_u8_step.py --out chiprun_out/u8_step.json
    python3 scripts/ablate_u8_step.py --points-scale 0.1   # a tenth

Makes the cell's points (``perfbench/configs/bigann-128d-u8.json``: 5e8
uint8 points of d = 128, ``data/mixture_u8.py``, k = 8 shards) and 128
queries from the same mixture on the card, then times with CUDA events,
each at B = 128, 64, 32 and 1 rows:

- ``kernel``: ``distance_topk_cuda`` on uint8 queries (the kernel and
  local_topk's merge of its partials);
- ``step``: ``core.knn.local_distance_top_l`` on f32 queries, what the
  server's ``topl`` phase runs (the conversion, the kernel, the merge and
  the id gather);
- ``read``: one PyTorch reduction over the same bytes (the points viewed
  as int64), a yardstick of what reading them takes.

The bound is ``perfbench/work/topl_step_u8.py``'s: the larger of the
operations over the int8 dense tensor peak and the bytes over 3.35 TB/s.
One JSON line a shape, then the card's name and power limit.

``--variants`` also builds patched copies of ``distance_topk_u8.cu``
under ``build/ablate_u8/<variant>`` (the package's sources stay as they
are) and times each kernel alone (the C entry point, no merge) at B =
128 and 64:

- ``base``: the kernel as it is;
- ``noinsert``: every distance is computed and tested, none becomes a
  candidate (a test no pair passes, which the compiler cannot fold);
- ``noepi_mma``: no epilogue, the products kept (their sums folded into
  a store no run makes: without a reader the compiler drops them);
- ``copyonly``: the copies, waits and barriers alone;
- ``cpasync``: the threads' cp.async copies in place of the TMA's boxes;
- ``clock``: clock64 cycles of thread 0 of each block a slab, by phase:
  the wait and barrier, the epilogue (and inside it its set-up, the
  threshold test, the inserts, the vote and merges), the products'
  issue, the copies' issue, the norms.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "ablate_u8"
CU = "distance_topk_u8.cu"
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

TICK = ("    {{ long long t_ = clock64(); {a}[{x}] += t_ - tq_; "
        "tq_ = t_; }}\n")
CLOCK = [
    ("  for (int u = 0; u < issued; ++u) {\n",
     "  long long ck_[5] = {0, 0, 0, 0, 0};\n"
     "  long long tq_ = clock64();\n"
     "  for (int u = 0; u < issued; ++u) {\n"),
    ("    const int slot = u % NG;\n",
     TICK.format(a="ck_", x=0) + "    const int slot = u % NG;\n"),
    ("      pend = -1;\n    }\n",
     "      pend = -1;\n    }\n" + TICK.format(a="ck_", x=1)),
    ("               acc);\n", "               acc);\n"
     + TICK.format(a="ck_", x=2)),
    ("    produce((u + NG - 1) % NG);\n",
     "    produce((u + NG - 1) % NG);\n" + TICK.format(a="ck_", x=3)),
    ("    norm_rows<PT, S::NT>(slab, pnp + buf * PT, ck > 0);\n",
     "    norm_rows<PT, S::NT>(slab, pnp + buf * PT, ck > 0);\n"
     + TICK.format(a="ck_", x=4)),
    ("  int pre_step;                  // the step it was read in\n",
     "  int pre_step;                  // the step it was read in\n"
     "  long long e_[5];\n  int d_;\n"),
    ("  w.pre_step = -1;\n",
     "  w.pre_step = -1;\n  w.d_ = d;\n"
     "  for (int x = 0; x < 5; ++x) w.e_[x] = 0;\n"),
    ("    const int i = g / this->tpc, t = g % this->tpc;\n",
     "    long long tq_ = clock64();\n"
     "    {\n      int x_ = 0;\n"
     "      for (int a = 0; a < 8; ++a)\n"
     "        for (int b = 0; b < 8; ++b) x_ ^= acc[a][b];\n"
     "      if (x_ == 0x7fffffff) this->e_[4] += 1;\n    }\n"
     + TICK.format(a="this->e_", x=4)
     + "    const int i = g / this->tpc, t = g % this->tpc;\n"),
    ("    const unsigned long long bits = maybe(acc, pn, s, n0);\n",
     TICK.format(a="this->e_", x=0)
     + "    const unsigned long long bits = maybe(acc, pn, s, n0);\n"
     + TICK.format(a="this->e_", x=1)),
    ("    unsigned long long pend = bits ? insert(acc, pn, n0, bits) : 0;\n",
     "    unsigned long long pend = bits ? insert(acc, pn, n0, bits) : 0;\n"
     + TICK.format(a="this->e_", x=2)),
    ("      pend = insert(acc, pn, n0, pend);\n    }\n",
     "      pend = insert(acc, pn, n0, pend);\n    }\n"
     + TICK.format(a="this->e_", x=3)),
    ("  w.advance_to(k);\n}\n",
     "  w.advance_to(k);\n"
     "  if (threadIdx.x == 0) {\n"
     "    for (int x = 0; x < 5; ++x)\n"
     "      atomicAdd(&u8dbg[x], (unsigned long long)ck_[x]);\n"
     "    for (int x = 0; x < 5; ++x)\n"
     "      atomicAdd(&u8dbg[7 + x], (unsigned long long)w.e_[x]);\n"
     "    atomicAdd(&u8dbg[5], (unsigned long long)issued);\n"
     "    atomicAdd(&u8dbg[6], 1ULL);\n  }\n}\n"),
    ("constexpr int NG = 3;",
     "__device__ unsigned long long u8dbg[12];\nconstexpr int NG = 3;"),
    ('extern "C" int knn_distance_topk_u8(',
     'extern "C" int knn_u8_dbg(unsigned long long* h, int reset) {\n'
     '  if (reset) {\n    unsigned long long z[12] = {0};\n'
     '    return (int)cudaMemcpyToSymbol(knn::u8::u8dbg, z, 96);\n  }\n'
     '  return (int)cudaMemcpyFromSymbol(h, knn::u8::u8dbg, 96);\n}\n'
     'extern "C" int knn_distance_topk_u8('),
]
VARIANTS = {
    "base": [],
    "noinsert": [("      if (least <= t && this->rw.b0",
                  "      if (least <= t && t < 0 && this->rw.b0")],
    # the products kept (their sums folded into a store no run makes)
    "noepi_mma": [("    if (pend >= 0) {\n      w.epilogue(",
                   "    if (pend >= 0) {\n      int x_ = 0;\n"
                   "      for (int i = 0; i < 8; ++i)\n"
                   "        for (int j = 0; j < 8; ++j) x_ ^= acc[i][j];\n"
                   "      if (x_ == 0x7fffffff) pnp[0] = x_;\n"
                   "      if (d < 0) w.epilogue(")],
    # the copies, waits and barriers alone
    "copyonly": [("    score_slab(sm.q()", "    if (d < 0) score_slab(sm.q()"),
                 ("    norm_rows<PT, S::NT>(slab",
                  "    if (d < 0) norm_rows<PT, S::NT>(slab"),
                 ("    if (pend >= 0) {\n      w.epilogue(",
                  "    if (pend >= 0) {\n      if (d < 0) w.epilogue(")],
    # the threads' cp.async copies in place of the TMA's boxes
    "cpasync": [("const bool tma = tma_ok &&", "const bool tma = d < 0 && tma_ok &&")],
    # clock64 a block's loop phases (thread 0): the wait and barrier, the
    # epilogue, the score loop's issue, the copies' issue, the norms; and
    # inside the epilogue: the products' drain, its set-up, the threshold
    # test, the inserts, the vote and the merges
    "clock": CLOCK,
}


def build(name, patches, nvcc):
    """A patched copy of the sources, compiled alone into a library."""
    d = OUT / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(CSRC, d)
    text = (d / CU).read_text()
    for old, new in patches:
        if old not in text:
            raise SystemExit(f"{name}: patch target not in {CU}: {old!r}")
        text = text.replace(old, new, 1)
    (d / CU).write_text(text)
    return subprocess.Popen(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v", "-I",
         str(d), "-o", str(d / "lib.so"), str(d / CU)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def events_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    times.sort()
    return times[len(times) // 2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--points-scale", type=float, default=1.0)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=2**33 + 17)
    ap.add_argument("--variants", nargs="*", choices=sorted(VARIANTS))
    ap.add_argument("--sass", help="write the kernel's SASS here")
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    from perfbench import spec, work
    from perfbench.work import topl_step_u8
    from repro_torch.core import knn as knn_mod
    from repro_torch.kernels import distance_topk as dtk
    from repro_torch.kernels import local_topk as ltk
    from repro_torch.kernels import plan

    if not torch.cuda.is_available():
        print("ablate_u8_step: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cfg = spec.load_json(spec.HERE / "configs" / "bigann-128d-u8.json")
    gen = spec.load_module("data", cfg["data"]["generator"])
    k, d = int(cfg["shards"]), int(cfg["dim"])
    l = int(cfg["service"]["l_max"])
    n = int(cfg["n_points"] * args.points_scale) // k * k
    m = n // k
    params = cfg["data"]["params"]
    pts = gen.points(n, d, params, args.seed, dev).view(k, m, d)
    ids = torch.arange(n, dtype=torch.int32, device=dev).view(k, m)
    qs = gen.queries(128, d, params, args.seed, dev)
    torch.cuda.synchronize()
    pk = work.peaks()
    sms = ltk.sm_count(0)
    lines = []
    read_ms = events_ms(lambda: pts.view(torch.int64).max(), args.reps)
    for b in (128, 64, 32, 1):
        q8 = qs[:b].contiguous()
        qf = q8.float()
        tp = plan.topk_u8(b, d, l, m, sms)
        n0 = dtk.COUNT_U8.n
        kernel_ms = events_ms(lambda: dtk.distance_topk_cuda(q8, pts, l),
                              args.reps)
        step_ms = events_ms(
            lambda: knn_mod.local_distance_top_l(qf, pts, ids, l), args.reps)
        launches = (dtk.COUNT_U8.n - n0) / (2 * (args.reps + 1))
        ops, nbytes = topl_step_u8.work(n, d, k, b, l)
        bound_ms = 1e3 * topl_step_u8.bound_s(ops, nbytes, pk)
        line = dict(B=b, k=k, m=m, d=d, l=l, tile=tp.tile, cand=tp.cand,
                    chunk=tp.chunk, blocks=tp.blocks, kernel_ms=kernel_ms,
                    step_ms=step_ms, read_ms=read_ms, bound_ms=bound_ms,
                    bound_by=("bytes" if nbytes / pk["hbm_bytes_per_s"] >=
                              ops / topl_step_u8.INT8_DENSE_OPS_PER_S
                              else "operations"),
                    roofline_pct=100 * bound_ms / step_ms,
                    read_gb_s=nbytes / step_ms / 1e6,
                    u8_launches_per_call=launches)
        print(json.dumps(line), flush=True)
        lines.append(line)
    if args.variants:
        lines.extend(time_variants(args, pts, qs, l))
    if args.sass:
        from repro_torch.kernels import _build
        lib = _build.build()
        sass = subprocess.run(
            [str(Path(_build.find_nvcc()).parent / "cuobjdump"), "-sass",
             str(lib)], capture_output=True, text=True).stdout
        keep, out = False, []
        for row in sass.splitlines():
            if "Function :" in row:
                keep = "distance_topk_u8" in row
            if keep:
                out.append(row)
        Path(args.sass).parent.mkdir(parents=True, exist_ok=True)
        Path(args.sass).write_text("\n".join(out))
    p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True)
    card = p.stdout.strip()
    print(json.dumps({"card": card}))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"card": card, "lines": lines},
                                             indent=1))
    return 0


def time_variants(args, pts, qs, l) -> list:
    """Each variant's kernel alone at B = 128 and 64 (module docstring)."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import distance_topk as dtk
    from repro_torch.kernels import local_topk as ltk
    from repro_torch.kernels import plan

    nvcc = _build.find_nvcc()
    procs = {n: build(n, VARIANTS[n], nvcc) for n in args.variants}
    libs, libs_dbg = {}, {}
    for n, p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"{n}: nvcc failed\n{log}")
        for row in log.splitlines():
            if "registers" in row or "stack" in row:
                print(f"{n}: {row.strip()}", flush=True)
        lib = ctypes.CDLL(str(OUT / n / "lib.so"))
        fn = lib.knn_distance_topk_u8
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        libs[n] = fn
        if n.startswith("clock"):
            lib.knn_u8_dbg.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.knn_u8_dbg.restype = ctypes.c_int
            libs_dbg[n] = lib.knn_u8_dbg
    k, m, d = pts.shape
    stream = torch.cuda.current_stream().cuda_stream
    out = []
    for b in (128, 64):
        q = qs[:b].contiguous()
        tp = plan.topk_u8(b, d, l, m, ltk.sm_count(0))
        pv = torch.empty((k * b, tp.nchunks, tp.width), device=pts.device)
        pi = torch.empty(pv.shape, dtype=torch.int32, device=pts.device)
        gthr = torch.empty((k, b), dtype=torch.int64, device=pts.device)
        for n, fn in libs.items():
            def launch():
                gthr.fill_(dtk.INF_KEY)
                rc = fn(q.data_ptr(), pts.data_ptr(), None, gthr.data_ptr(),
                        pv.data_ptr(), pi.data_ptr(), b, k, m, d, l,
                        tp.chunk, tp.tile, tp.cand, stream)
                if rc:
                    raise RuntimeError(f"{n}: CUDA error {rc}")
            if n.startswith("clock"):
                dbg = libs_dbg[n]
                dbg(None, 1)
            line = dict(variant=n, B=b, kernel_ms=events_ms(launch,
                                                            args.reps))
            if n.startswith("clock"):
                h = (ctypes.c_ulonglong * 12)()
                dbg(h, 0)
                slabs = max(h[5], 1)
                names = {0: "wait", 1: "epilogue", 2: "score", 3: "copies",
                         4: "norms", 11: "epi_drain", 7: "epi_setup",
                         8: "epi_test", 9: "epi_insert",
                         10: "epi_vote_merge"}
                line["cycles_per_slab"] = {
                    name: h[x] / slabs for x, name in names.items()}
                line["slabs_per_block"] = h[5] / max(h[6], 1)
            print(json.dumps(line), flush=True)
            out.append(line)
    return out


if __name__ == "__main__":
    sys.exit(main())
