"""Build and load the port's CUDA kernels (one shared library, C ABI).

The sources under ``csrc/`` are compiled with ``nvcc`` for ``sm_90a``,
one ``nvcc -c`` per source, all started together, then linked into one
shared library with a plain C interface that :func:`library` loads with
``ctypes``.  The library lands in ``build/repro_torch_kernels/`` at the
root of the checkout, named by a hash of the sources and flags, so an
edited source rebuilds and an unchanged one is reused.  Nothing is built
when the module is imported: the first CUDA launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = (Path(__file__).resolve().parents[3] / "build"
             / "repro_torch_kernels")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong
_PI = ctypes.POINTER(ctypes.c_int)
# name -> (argtypes, restype) of every C entry point
SIGNATURES = {
    # q, p, valid, out; B, k, m, d, dtype, blocks; stream
    "knn_l2_distance": ([_P] * 4 + [_I] * 6 + [_P], _I),
    # q, p, valid, out; B, k, m, d, dtype, row_tile; stream
    "knn_l2_distance_wide": ([_P] * 4 + [_I] * 6 + [_P], _I),
    # x, ids, floor_v, floor_i, out_v, out_i; rows, m, l; per; nparts,
    # grid, dtype; stream
    "knn_local_topk": ([_P] * 6 + [_I] * 3 + [_LL] + [_I] * 3 + [_P], _I),
    # l, dtype, with_ids, with_floor; out
    "knn_local_topk_blocks_per_sm": ([_I] * 4 + [_PI], _I),
    # q, p, valid, gthr, out_v, out_i; B, k, m, d, l, chunk, dtype; stream
    "knn_distance_topk": ([_P] * 6 + [_I] * 7 + [_P], _I),
    # q, p, valid, gthr, out_v, out_i; B, k, m, d, l, chunk, dtype,
    # row_tile, groups, cand; stream
    "knn_distance_topk_wide": ([_P] * 6 + [_I] * 10 + [_P], _I),
    # q, p, valid, gthr, out_v, out_i; B, k, m, d, l, chunk, row_tile,
    # cand; stream
    "knn_distance_topk_u8": ([_P] * 6 + [_I] * 8 + [_P], _I),
    # v, ids, valid, ls; l_all; seed, thr_v, thr_i, converged, iters; B, k,
    # m, max_it, threads, per, pivots, smem_keys, dtype; stream
    "knn_select_loop": ([_P] * 4 + [_I] + [_P] * 5 + [_I] * 9 + [_P], _I),
    # q, ls, ops, rows_in, rows_out, idx_out, unions; B, dim, k, m, r, kb,
    # mode; slack1, errc, oversample; stream
    "knn_route_index_mask": ([_P] * 7 + [_I] * 7 + [_F] * 3 + [_P], _I),
}

_lock = threading.Lock()
_lib = None
build_log = ""     # compiler output of the build this process ran, if any


def find_nvcc() -> str:
    """``nvcc`` from ``CUDA_HOME``, ``/usr/local/cuda/bin`` or ``PATH``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(ARCH + FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile every source (in parallel) and link the library; returns
    its path.  Reuses a library already built from the same sources."""
    global build_log
    out = BUILD_DIR / f"libknn_{_digest()}.so"
    if out.is_file():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"tmp_{os.getpid()}"
    tmp.mkdir(exist_ok=True)
    procs = []
    for src in _sources():
        obj = tmp / (src.stem + ".o")
        cmd = [nvcc, *ARCH, *FLAGS, "-I", str(CSRC), "-c", str(src),
               "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for src, _, proc in procs:
        text, _ = proc.communicate()
        logs.append(f"== {src.name}\n{text}")
        if proc.returncode != 0:
            failed.append(src.name)
    build_log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
    link_tmp = tmp / out.name
    link = subprocess.run(
        [nvcc, *ARCH, "-shared", "-o", str(link_tmp),
         *[str(obj) for _, obj, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(link_tmp, out)
    shutil.rmtree(tmp, ignore_errors=True)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (args, res) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = res
            _lib = lib
        return _lib
