#!/usr/bin/env python3
"""Split distance_topk's time on the card by ablation.

    python3 scripts/ablate_distance_topk.py      # needs one card and nvcc

Copies ``src/repro_torch/kernels/csrc`` into ``build/ablate/<variant>``,
patches ``distance_topk.cu`` there (the sources in the package stay as
they are), builds each copy with ``nvcc`` in parallel, and times the
kernel alone with CUDA events at ``chip_smoke.py`` phase 4's shape
(B = 32, k = 8 x m = 524,288, d = 64, l = 128, f32), without the mask
and with 1 of 8 shards valid.  Variants:

- ``base``: the kernel as it is;
- ``noinsert``: no distance ever becomes a candidate, so no row is
  merged: the distance main loop, the votes and the partial writes;
- ``count``: the kernel with device counters: row merges, their mean
  size and clock64 cycles, candidates, and each block's cycles in the
  merge phase, the inserts and in all (the counters slow it).
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "ablate"
sys.path.insert(0, str(ROOT / "src"))

INS = "        if (key_of(dist, nl0 + j) < th) {"
POS = "          const int pos = run[r] + atomicAdd(&cnt[r], 1);"
COUNT = [
    ("using Key = unsigned long long;",
     "using Key = unsigned long long;\n__device__ unsigned long long dbg[8];"),
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
VARIANTS = {
    "base": [],
    "noinsert": [(INS, INS.replace(" < th)", " < th && false)"))],
    "count": COUNT,
}


def build(name, patches, nvcc):
    d = OUT / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(CSRC, d)
    src = d / "distance_topk.cu"
    text = src.read_text()
    for old, new in patches:
        if old not in text:
            raise SystemExit(f"{name}: patch target not found: {old!r}")
        text = text.replace(old, new, 1)
    src.write_text(text)
    return subprocess.Popen(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-Xcompiler", "-fPIC", "-shared", "-I", str(d), "-o",
         str(d / "lib.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("ablate: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels import distance_topk as dtk
    nvcc = _build.find_nvcc()
    procs = {n: build(n, p, nvcc) for n, p in VARIANTS.items()}
    libs = {}
    for n, p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            print(log)
            return 1
        lib = ctypes.CDLL(str(OUT / n / "lib.so"))
        lib.knn_distance_topk.argtypes = ([ctypes.c_void_p] * 6
                                          + [ctypes.c_int] * 7
                                          + [ctypes.c_void_p])
        lib.knn_distance_topk.restype = ctypes.c_int
        libs[n] = lib

    dev = torch.device("cuda")
    B, K, M, D, L = 32, 8, 1 << 19, 64, 128
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    q = torch.randn((B, D), generator=g, device=dev)
    p = torch.randn((K, M, D), generator=g, device=dev)
    valid = torch.zeros((K, M), dtype=torch.bool, device=dev)
    valid[3] = True
    chunk = dtk.chunking(B, K, M, dev)
    nch = -(-M // chunk)
    width = L if nch == 1 else dtk.slots(L)
    pv = torch.empty((K * B, nch, width), device=dev)
    pi = torch.empty((K * B, nch, width), dtype=torch.int32, device=dev)
    gthr = torch.empty((K, B), dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def launch(lib, v):
        gthr.fill_(dtk.INF_KEY)
        rc = lib.knn_distance_topk(
            q.data_ptr(), p.data_ptr(), v, gthr.data_ptr(), pv.data_ptr(),
            pi.data_ptr(), B, K, M, D, L, chunk, 0, stream)
        if rc:
            raise RuntimeError(f"launch failed: CUDA error {rc}")

    def median_ms(lib, v, iters=10):
        launch(lib, v)
        torch.cuda.synchronize()
        ts = []
        for _ in range(iters):
            gthr.fill_(dtk.INF_KEY)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            lib.knn_distance_topk(
                q.data_ptr(), p.data_ptr(), v, gthr.data_ptr(),
                pv.data_ptr(), pi.data_ptr(), B, K, M, D, L, chunk, 0,
                stream)
            e.record()
            torch.cuda.synchronize()
            ts.append(s.elapsed_time(e))
        return sorted(ts)[len(ts) // 2]

    print(torch.cuda.get_device_name(0), f"chunk {chunk}, {nch} chunks",
          flush=True)
    blocks = nch * -(-B // dtk.QUERY_TILE)
    for n, lib in libs.items():
        for label, v in (("unmasked", None),
                         ("1 of 8 shards valid", valid.data_ptr())):
            line = f"{n} {label}: {median_ms(lib, v):.4f} ms"
            if n == "count":
                h = (ctypes.c_ulonglong * 8)()
                lib.knn_dbg.argtypes = [ctypes.c_void_p]
                lib.knn_dbg(h)
                launch(lib, v)
                torch.cuda.synchronize()
                lib.knn_dbg(h)
                merges = max(h[0], 1)
                line += (f"; merges {h[0]}, mean size {h[1] / merges:.1f}, "
                         f"{h[4] / merges:.0f} cycles each; candidates "
                         f"{h[2]}; per block: merge phase "
                         f"{h[5] / blocks:.0f}, inserts {h[6] / blocks:.0f}"
                         f", all {h[7] / blocks:.0f} cycles")
            print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
