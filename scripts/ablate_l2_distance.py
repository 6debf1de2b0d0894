#!/usr/bin/env python3
"""Variants of l2_distance's whole-bucket loop, built and timed side by
side on the card.

    python3 scripts/ablate_l2_distance.py [--out chiprun_out/x.json]
                                          [VARIANT ...]   # one card, nvcc

Variants: ``base`` (the header as it is), ``parts1`` (128-byte slab rows
at 128 rows, where the loop takes 256) and ``nocopy_nonorm`` (the ring
keeps its first slabs and no norm is summed: the FMA loop, its shared
loads and the slab barrier alone; not bit-equal).

Copies ``src/repro_torch/kernels/csrc`` into ``build/ablate/l2_<variant>``,
patches ``l2_distance_wide.cuh`` there (the sources in the package stay
as they are), builds each copy's ``l2_distance.cu`` with ``nvcc -Xptxas
-v`` in parallel, prints each whole-bucket kernel's registers and
spills, and times ``knn_l2_distance_wide`` with CUDA events (median of
5 launches after one warm launch) on 8 shards of m = 1,612,899 f32
points: B = 128 at d = 1,024 (the ``knnlm.score128_l1024`` step), B = 64
at d = 1,024 and B = 128 at d = 96.
Every variant's output is compared with ``torch.equal`` against the
32-row loop's (``knn_l2_distance``) on the same inputs.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "ablate"
sys.path.insert(0, str(ROOT / "src"))

PARTS = "PARTS = RT == 128 ? 2 : 1;"
NOCOPY = [(f"copy_rows<T, {r}, S::NT, S::ROW>(",
           f"if (issued < STAGES) copy_rows<T, {r}, S::NT, S::ROW>(")
          for r in ("RT", "PT")]
NONORM = [("    if (tid < PT) {\n      const int np",
           "    if (false) {\n      const int np"),
          ("    if (qt >= 0) {\n      const int nq",
           "    if (false) {\n      const int nq")]
VARIANTS = {"base": [], "parts1": [(PARTS, "PARTS = 1;")],
            "nocopy_nonorm": NOCOPY + NONORM}
M = 1_612_899
SHAPES = [(128, 8, M, 1024), (64, 8, M, 1024), (128, 8, M, 96)]


def build(name, patches, nvcc):
    d = OUT / f"l2_{name}"
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(CSRC, d)
    hdr = d / "l2_distance_wide.cuh"
    text = hdr.read_text()
    for old, new in patches:
        if old not in text:
            raise SystemExit(f"{name}: patch target not found: {old!r}")
        text = text.replace(old, new, 1)
    hdr.write_text(text)
    return subprocess.Popen(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-shared", "-I",
         str(d), "-o", str(d / "lib.so"), str(d / "l2_distance.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def wide_report(log: str) -> list:
    """Registers and spills of each whole-bucket kernel."""
    out, entry = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            entry = m.group(1) if "wide" in m.group(1) else None
        elif entry and re.search(r"spill|Used \d+ registers", ln):
            out.append(f"{entry}: {ln.strip()}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", default=list(VARIANTS))
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("ablate: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels import local_topk as ltk
    from repro_torch.kernels import plan
    nvcc = _build.find_nvcc()
    procs = {n: build(n, VARIANTS[n], nvcc)
             for n in dict.fromkeys(args.variants)}
    libs, res = {}, {"variants": {}}
    for n, p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            print(log)
            return 1
        lib = ctypes.CDLL(str(OUT / f"l2_{n}" / "lib.so"))
        for fn in (lib.knn_l2_distance, lib.knn_l2_distance_wide):
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
        libs[n] = lib
        res["variants"][n] = {"ptxas": wide_report(log)}
        for ln in res["variants"][n]["ptxas"]:
            print(n, ln, flush=True)

    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device=dev)
    sms = ltk.sm_count(0)
    blocks = plan.L2_BLOCKS_PER_SM * sms
    p = None
    for B, k, m, d in SHAPES:
        if p is None or p.shape != (k, m, d):
            p = None
            torch.cuda.empty_cache()
            g.manual_seed(d)
            p = torch.randn((k, m, d), generator=g, device=dev)
        q = torch.randn((B, d), generator=g, device=dev)
        ref = torch.empty((k, B, m), device=dev)
        out = torch.empty_like(ref)
        a = (q.data_ptr(), p.data_ptr(), None)
        tile = plan.l2(B, d, 4, sms).tile
        rc = libs[args.variants[0]].knn_l2_distance(
            *a, ref.data_ptr(), B, k, m, d, 0, blocks, stream)
        assert rc == 0, rc
        torch.cuda.synchronize()
        for n, lib in libs.items():
            ts = []
            for _ in range(6):
                out.fill_(-1.0)
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                s.record()
                rc = lib.knn_l2_distance_wide(*a, out.data_ptr(), B, k, m,
                                              d, 0, tile, stream)
                e.record()
                torch.cuda.synchronize()
                assert rc == 0, (n, rc)
                ts.append(s.elapsed_time(e))
            ms = sorted(ts[1:])[2]
            eq = bool(torch.equal(out, ref))
            share = 100 * 2.0 * B * k * m * d / 67e12 / (ms / 1e3)
            res["variants"][n][f"B{B}_d{d}"] = {"ms": ms, "all_ms": ts,
                                           "bit_equal": eq,
                                           "f32_peak_share": share}
            print(f"{n} B={B} d={d}: {ms:.3f} ms ({share:.1f}% of the f32 "
                  f"peak), bit-equal {eq}", flush=True)
        del ref, out, q
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
