#!/usr/bin/env python3
"""Split distance_topk's time on the card by ablation, for both of its
paths: the 32-row kernel (``distance_topk.cu``) and the whole-bucket path
(``distance_topk_wide.cuh``).

    python3 scripts/ablate_distance_topk.py      # needs one card and nvcc
    python3 scripts/ablate_distance_topk.py --shape deep1b --extra u1

Copies ``src/repro_torch/kernels/csrc`` into ``build/ablate/<variant>``,
patches the copies there (the sources in the package stay as they are),
builds each copy with ``nvcc`` in parallel, and times each path alone
with CUDA events (the C entry point, without the merge of the partials):

- ``small``: ``chip_smoke.py`` phase 4's shape, B = 32, k = 8 x m =
  524,288, d = 64, l = 128, f32, without the mask and with 1 of 8 shards
  valid; the 32-row kernel (B <= 32 never takes the other path);
- ``deep1b``: the deep1b cell's step, B = 128, k = 8 x m = 15,625,000
  unit rows, d = 96, l = 100, f32 (48 GB of points), unmasked; both
  paths, and their merged answers compared with ``torch.equal``.

Variants:

- ``base``: the kernels as they are;
- ``noinsert``: every distance is computed and tested, but none becomes
  a candidate (a test no point passes, which the compiler cannot fold),
  so no row is merged: the distance main loop, the tests, the votes and
  the partial writes;
- ``count``: device counters (they slow the kernels).  The 32-row kernel:
  row merges, their mean size and clock64 cycles, candidates, and each
  block's cycles in the merge phase, the inserts and in all.  The
  whole-bucket path: row merges, their mean candidates and cycles,
  candidates, overflow rounds, and each block's cycles in the epilogues,
  in the shard-end merges and in all;
- ``--extra u1``: the whole-bucket path's loop one quad a step (it runs two).
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "ablate"
sys.path.insert(0, str(ROOT / "src"))

CU, WIDE = "distance_topk.cu", "distance_topk_wide.cuh"

# the 32-row kernel (distance_topk.cu)
INS = "        if (key_of(dist, nl0 + j) < th) {"
POS = "          const int pos = run[r] + atomicAdd(&cnt[r], 1);"
COUNT = [
    ("using knn::Key;",
     "using knn::Key;\n__device__ unsigned long long dbg[8];"),
    ("}  // namespace\n\n// q: (B, d)",
     '}  // namespace\nextern "C" int knn_dbg(unsigned long long* h) {\n'
     "  cudaMemcpyFromSymbol(h, dbg, 64);\n"
     "  unsigned long long z[8] = {0};\n"
     "  cudaMemcpyToSymbol(dbg, z, 64);\n  return 0;\n}\n\n// q: (B, d)"),
    ("    const int r0 = run[r], n = r0 + c;\n",
     "    const int r0 = run[r], n = r0 + c;\n"
     "    const long long c0k = clock64();\n"
     "    if (lane == 0) { atomicAdd(&dbg[0], 1ULL);"
     " atomicAdd(&dbg[1], (unsigned long long)n); }\n"),
    ("      run[r] = nr;\n",
     "      run[r] = nr;\n"
     "      atomicAdd(&dbg[4], (unsigned long long)(clock64() - c0k));\n"),
    (POS, POS + "\n          atomicAdd(&dbg[2], 1ULL);"),
    ("    const int i = g / tpc, t = g % tpc;\n",
     "    const long long e0k = clock64();\n"
     "    const int i = g / tpc, t = g % tpc;\n"),
    ("    __syncthreads();\n    const int nl0",
     "    __syncthreads();\n    const long long e1k = clock64();\n"
     "    if (threadIdx.x == 0)"
     " atomicAdd(&dbg[5], (unsigned long long)(e1k - e0k));\n"
     "    const int nl0"),
    ("          bi[(size_t)r * S + pos] = nl0 + j;\n        }\n      }\n    }\n",
     "          bi[(size_t)r * S + pos] = nl0 + j;\n        }\n      }\n    }\n"
     "    if (threadIdx.x == 0)"
     " atomicAdd(&dbg[6], (unsigned long long)(clock64() - e1k));\n"),
    ("  load_queries<T>(sm, q, B, d, b0);\n",
     "  const long long a0k = clock64();\n"
     "  load_queries<T>(sm, q, B, d, b0);\n"),
    ("  w.advance_to(k);\n}",
     "  w.advance_to(k);\n  if (threadIdx.x == 0)"
     " atomicAdd(&dbg[7], (unsigned long long)(clock64() - a0k));\n}"),
]

# the whole-bucket path (distance_topk_wide.cuh)
W_INS = "                  !(q2 - 2.f * acc[i][j] + pn[j] > thv)) << j;"
W_POS = "      int pos = atomicAdd(&sm.cnt()[r], __popc(cand));\n"
W_COUNT = [
    ("constexpr unsigned FULL = 0xffffffffu;",
     "constexpr unsigned FULL = 0xffffffffu;\n"
     "__device__ unsigned long long dbgw[8];"),
    ("  const int c = min(sm.cnt()[r], C), nr = sm.run()[r];\n",
     "  const int c = min(sm.cnt()[r], C), nr = sm.run()[r];\n"
     "  const long long m0k = clock64();\n"
     "  if (lane == 0) { atomicAdd(&dbgw[0], 1ULL);"
     " atomicAdd(&dbgw[1], (unsigned long long)c); }\n"),
    ("  __syncwarp();\n}\n\n// Every row",
     "  if (lane == 0)"
     " atomicAdd(&dbgw[2], (unsigned long long)(clock64() - m0k));\n"
     "  __syncwarp();\n}\n\n// Every row"),
    (W_POS, W_POS + "      atomicAdd(&dbgw[3],"
     " (unsigned long long)__popc(cand));\n"),
    ("      merge_rows<RT>(rw, sm, s, (sm.C + 1) / 2, false);\n",
     "      if (threadIdx.x == 0) atomicAdd(&dbgw[4], 1ULL);\n"
     "      merge_rows<RT>(rw, sm, s, (sm.C + 1) / 2, false);\n"),
    ("    const int i = g / tpc, t = g % tpc;\n    advance_to(i);\n",
     "    const long long e0k = clock64();\n"
     "    const int i = g / tpc, t = g % tpc;\n    advance_to(i);\n"),
    ("      pend = insert(acc, pn, n0, pend);\n    }\n  }\n",
     "      pend = insert(acc, pn, n0, pend);\n    }\n"
     "    if (threadIdx.x == 0)"
     " atomicAdd(&dbgw[5], (unsigned long long)(clock64() - e0k));\n  }\n"),
    ("      merge_rows<RT>(rw, sm, shard(cur), 1, true);\n",
     "      const long long f0k = clock64();\n"
     "      merge_rows<RT>(rw, sm, shard(cur), 1, true);\n"
     "      if (threadIdx.x == 0)"
     " atomicAdd(&dbgw[6], (unsigned long long)(clock64() - f0k));\n"),
    ("  w.reset(0);\n", "  const long long a0k = clock64();\n  w.reset(0);\n"),
    ("  w.advance_to(k);\n}\n\ntemplate <typename T, int RT>",
     "  w.advance_to(k);\n  if (threadIdx.x == 0)"
     " atomicAdd(&dbgw[7], (unsigned long long)(clock64() - a0k));\n"
     "}\n\ntemplate <typename T, int RT>"),
]
W_DBG = ('\nextern "C" int knn_dbg_wide(unsigned long long* h) {\n'
         "  cudaMemcpyFromSymbol(h, knn::topw::dbgw, 64);\n"
         "  unsigned long long z[8] = {0};\n"
         "  cudaMemcpyToSymbol(knn::topw::dbgw, z, 64);\n  return 0;\n}\n")

VARIANTS = {
    "base": {},
    "noinsert": {CU: [(INS, INS.replace(" < th)", " < th && nl0 < 0)"))],
                 WIDE: [(W_INS, W_INS.replace("!(", "q2 < 0.f && !("))]},
    "count": {CU: COUNT, WIDE: W_COUNT},
}
EXTRA = {
    "u1": {WIDE: [("N = Quad<T>::N, U = 2;", "N = Quad<T>::N, U = 1;")]},
}


def build(name, patches, nvcc):
    d = OUT / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(CSRC, d)
    for fname, pats in patches.items():
        f = d / fname
        text = f.read_text()
        for old, new in pats:
            if old not in text:
                raise SystemExit(f"{name}: patch target not in {fname}: "
                                 f"{old!r}")
            text = text.replace(old, new, 1)
        f.write_text(text)
    if name == "count":
        (d / CU).write_text((d / CU).read_text() + W_DBG)
    return subprocess.Popen(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-Xcompiler", "-fPIC", "-shared", "-I", str(d), "-o",
         str(d / "lib.so"), str(d / CU)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", choices=["small", "deep1b", "both"],
                    default="both")
    ap.add_argument("--extra", nargs="*", default=[], choices=sorted(EXTRA))
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ablate: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels import distance_topk as dtk
    from repro_torch.kernels import local_topk as ltk
    from repro_torch.kernels import plan
    nvcc = _build.find_nvcc()
    variants = dict(VARIANTS, **{n: EXTRA[n] for n in args.extra})
    procs = {n: build(n, p, nvcc) for n, p in variants.items()}
    libs = {}
    for n, p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            print(log)
            return 1
        lib = ctypes.CDLL(str(OUT / n / "lib.so"))
        for fn, ints in (("knn_distance_topk", 7),
                         ("knn_distance_topk_wide", 10)):
            getattr(lib, fn).argtypes = ([ctypes.c_void_p] * 6
                                         + [ctypes.c_int] * ints
                                         + [ctypes.c_void_p])
            getattr(lib, fn).restype = ctypes.c_int
        libs[n] = lib

    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    print(torch.cuda.get_device_name(0), flush=True)

    def run_shape(label, q, p, L, paths, masks):
        B, D = q.shape
        K, M, _ = p.shape
        runs = {}
        for path in paths:
            tp = plan.topk(B, D, L, 4, M, ltk.sm_count(0), tile=(
                plan.QUERY_TILE if path == "32-row" else None))
            shape = (K * B, tp.nchunks, tp.width)
            pv = torch.empty(shape, device=dev)
            pi = torch.empty(shape, dtype=torch.int32, device=dev)
            gthr = torch.empty((K, B), dtype=torch.int64, device=dev)
            runs[path] = (tp, pv, pi, gthr)

        def launch(lib, path, v):
            tp, pv, pi, gthr = runs[path]
            gthr.fill_(dtk.INF_KEY)
            a = (q.data_ptr(), p.data_ptr(), v, gthr.data_ptr(),
                 pv.data_ptr(), pi.data_ptr(), B, K, M, D, L, tp.chunk, 0)
            rc = (lib.knn_distance_topk(*a, stream) if path == "32-row"
                  else lib.knn_distance_topk_wide(
                      *a, tp.tile, tp.groups, tp.cand, stream))
            if rc:
                raise RuntimeError(f"launch failed: CUDA error {rc}")

        def median_ms(lib, path, v):
            launch(lib, path, v)
            torch.cuda.synchronize()
            ts = []
            for _ in range(args.reps):
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                s.record()
                launch(lib, path, v)
                e.record()
                torch.cuda.synchronize()
                ts.append(s.elapsed_time(e))
            return sorted(ts)[len(ts) // 2]

        for path in paths:
            tp = runs[path][0]
            blocks = tp.blocks
            print(f"{label} {path}: B={B} k={K} m={M} d={D} l={L}, tile "
                  f"{tp.tile}, chunk {tp.chunk}, {tp.nchunks} chunks, "
                  f"{blocks} blocks", flush=True)
            for n, lib in libs.items():
                for mlabel, v in masks:
                    line = (f"  {n} {mlabel}: "
                            f"{median_ms(lib, path, v):.4f} ms")
                    if n == "count":
                        h = (ctypes.c_ulonglong * 8)()
                        rd = (lib.knn_dbg if path == "32-row"
                              else lib.knn_dbg_wide)
                        rd.argtypes = [ctypes.c_void_p]
                        rd(h)
                        launch(lib, path, v)
                        torch.cuda.synchronize()
                        rd(h)
                        mg = max(h[0], 1)
                        if path == "32-row":
                            line += (
                                f"; merges {h[0]}, mean size "
                                f"{h[1] / mg:.1f}, {h[4] / mg:.0f} cycles "
                                f"each; candidates {h[2]}; per block: "
                                f"merge phase {h[5] / blocks:.0f}, inserts "
                                f"{h[6] / blocks:.0f}, all "
                                f"{h[7] / blocks:.0f} cycles")
                        else:
                            line += (
                                f"; merges {h[0]}, mean candidates "
                                f"{h[1] / mg:.1f}, {h[2] / mg:.0f} cycles "
                                f"each; candidates {h[3]}; overflow rounds "
                                f"{h[4]}; per block: epilogues "
                                f"{h[5] / blocks:.0f}, shard-end merges "
                                f"{h[6] / blocks:.0f}, all "
                                f"{h[7] / blocks:.0f} cycles")
                    print(line, flush=True)
        if len(paths) == 2:
            got = []
            for path in paths:
                launch(libs["base"], path, None)
                _, pv, pi, _ = runs[path]
                got.append(ltk.merge_partials(pv, pi, L))
            same = all(torch.equal(a, b) for a, b in zip(*got))
            print(f"{label}: the two paths' merged answers torch.equal: "
                  f"{same}", flush=True)

    g = torch.Generator(device=dev)
    g.manual_seed(7)
    if args.shape in ("small", "both"):
        B, K, M, D, L = 32, 8, 1 << 19, 64, 128
        q = torch.randn((B, D), generator=g, device=dev)
        p = torch.randn((K, M, D), generator=g, device=dev)
        valid = torch.zeros((K, M), dtype=torch.uint8, device=dev)
        valid[3] = 1
        run_shape("small", q, p, L, ["32-row"],
                  [("unmasked", None),
                   ("1 of 8 shards valid", valid.data_ptr())])
        del q, p, valid
    if args.shape in ("deep1b", "both"):
        B, K, M, D, L = 128, 8, 15_625_000, 96, 100
        p = torch.empty((K, M, D), device=dev)
        for s in range(K):
            p[s].normal_(generator=g)
            p[s] /= p[s].norm(dim=-1, keepdim=True)
        q = torch.randn((B, D), generator=g, device=dev)
        q /= q.norm(dim=-1, keepdim=True)
        run_shape("deep1b", q, p, L, ["32-row", "whole-bucket"],
                  [("unmasked", None)])
    return 0


if __name__ == "__main__":
    sys.exit(main())
