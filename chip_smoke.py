#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase; needs one card
    python3 chip_smoke.py --out FILE      # also write the details as JSON
    python3 chip_smoke.py --profile       # also profile one full bucket

Phases:
  1. build the CUDA kernels from src/repro_torch/kernels/csrc (nvcc,
     sm_90a) and print ptxas' register / shared-memory / spill lines;
  2. hold each kernel against its plain PyTorch version on the card, at
     the main path's shapes and at the edge cases;
  3. serve the static exact l-NN slice at full width (2**22 x 64 f32
     points, k = 8 shards, l <= 128, buckets <= 32) through
     KnnServer.query_batch under both samplers, check every answer
     against a brute-force top-l over all points, and check that each
     sampler's path launched its kernels;
  4. time each kernel, its plain version and one PyTorch yardstick call
     with CUDA events at the phase-3 shapes, beside the least time the
     card could take for the same work;
  5. print the kernels line, then the device line last.

Exits non-zero, and prints no result, without a CUDA device or without
the repository beside it.  Imports nothing of JAX or of src/repro.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

INT32_MAX = 2**31 - 1
# One H100 SXM (NVIDIA data sheet), at the full 700 W power limit.
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12          # f32 outside the tensor cores
F32_TOL = dict(rtol=1e-4, atol=1e-3)     # tests/test_kernels.py
BF16_TOL = dict(rtol=2e-2, atol=1.0)

# the phase-3 shapes: KnnServiceConfig defaults
N_POINTS, DIM, K, L, B = 1 << 22, 64, 8, 128, 32
M = N_POINTS // K

KERNELS = {
    "l2_distance": dict(
        source="src/repro_torch/kernels/csrc/l2_distance.cu",
        replaces="src/repro/kernels/l2_distance.py:67"),
    "distance_topk": dict(
        source="src/repro_torch/kernels/csrc/distance_topk.cu",
        replaces="src/repro/kernels/distance_topk.py:152"),
    "local_topk": dict(
        source="src/repro_torch/kernels/csrc/local_topk.cu",
        replaces="src/repro/kernels/local_topk.py:54"),
}
NOT_PORTED = [
    dict(name="route_mask", replaces="src/repro/kernels/routing.py:226",
         status="not ported"),
    dict(name="index_mask", replaces="src/repro/kernels/routing.py:339",
         status="not ported"),
]


class PhaseError(RuntimeError):
    pass


def log(*a):
    print(*a, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---- phase 2: each kernel against its plain version -----------------------

def topk_agree(v, i, rv, ri, full, tol):
    """Kernel (v, i) vs plain (rv, ri) top-l lists, row by row.

    Values within ``tol``.  Ids: each id the kernel returns is real,
    unique in its row and its true distance (``full``, the plain
    distance matrix) matches the value beside it; where the plain
    version's l-th and (l+1)-th values are farther apart than the
    tolerance, the id sets are equal.  Returns the max abs value error.
    """
    import torch
    if not torch.allclose(v, rv, **tol):
        raise PhaseError(f"values differ: max abs {(v - rv).abs().max()}")
    fin = torch.isfinite(rv)
    if not torch.equal(fin, torch.isfinite(v)):
        raise PhaseError("+inf slots differ")
    if not bool((i[~fin] == INT32_MAX).all()):
        raise PhaseError("a +inf slot carries a real id")
    l = v.shape[-1]
    v2, i2, rv2, ri2 = (x.reshape(-1, l) for x in (v, i, rv, ri))
    full2 = full.reshape(-1, full.shape[-1])
    fin2 = torch.isfinite(rv2)
    safe = torch.where(fin2, i2, 0).long()
    true = full2.gather(1, safe)
    if not torch.allclose(torch.where(fin2, true, 0),
                          torch.where(fin2, v2, 0), **tol):
        raise PhaseError("an id's true distance differs from its value")
    if full2.shape[1] <= l:          # every point is in the answer
        if not torch.equal(i.sort(-1).values, ri.sort(-1).values):
            raise PhaseError("id sets differ")
        return float(torch.where(fin, (v - rv).abs(), 0).max())
    srt = torch.sort(full2, dim=1).values
    nxt = srt[:, l]
    gap = (nxt - srt[:, l - 1]) > (tol["atol"] + tol["rtol"] * nxt.abs())
    for r in torch.nonzero(gap & fin2.all(1)).flatten().tolist():
        if set(i2[r].tolist()) != set(ri2[r].tolist()):
            raise PhaseError(f"row {r}: id sets differ")
        if len(set(i2[r].tolist())) != l:
            raise PhaseError(f"row {r}: repeated id")
    return float(torch.where(fin, (v - rv).abs(), 0).max())


def phase_kernels(dev, results):
    import torch
    from repro_torch.kernels import distance_topk as dtk
    from repro_torch.kernels import l2_distance as l2
    from repro_torch.kernels import local_topk as ltk
    from repro_torch.kernels import ref

    g = torch.Generator(device=dev)
    g.manual_seed(1234)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    errs = {name: 0.0 for name in KERNELS}
    main_err = {}
    # l2_distance: main shape, ragged edges, bf16
    for (b, k, m, d, dt) in [(B, K, M, DIM, torch.float32),
                             (13, 1, 777, 300, torch.float32),
                             (4, 3, 96, 64, torch.float32),
                             (B, K, M, DIM, torch.bfloat16),
                             (13, 2, 777, 300, torch.bfloat16)]:
        q, p = randn(b, d, dtype=dt), randn(k, m, d, dtype=dt)
        out = l2.l2_distance_cuda(q, p)
        torch.cuda.synchronize()
        want = l2.l2_distance_plain(q, p)
        tol = F32_TOL if dt == torch.float32 else BF16_TOL
        if not torch.allclose(out, want, **tol):
            raise PhaseError(f"l2_distance {(b, k, m, d, dt)}: max abs "
                             f"{(out - want).abs().max()}")
        err = float((out - want).abs().max())
        errs["l2_distance"] = max(errs["l2_distance"], err)
        main_err.setdefault("l2_distance", err)
        log(f"  l2_distance B={b} k={k} m={m} d={d} {dt}: max abs {err:.3g}")
        del out, want

    # distance_topk: main shape, l at 1/255/256, ragged, l > m, ties,
    # random valid mask, all-invalid, bf16
    cases = [(B, K, M, DIM, L, torch.float32, None),
             (13, 1, 777, 300, 1, torch.float32, None),
             (13, 1, 777, 300, 255, torch.float32, None),
             (13, 2, 777, 300, 256, torch.float32, None),
             (4, 2, 96, 64, 128, torch.float32, None),
             (5, K, 4096, 32, 16, torch.float32, "random"),
             (4, 2, 256, 64, 8, torch.float32, "none"),
             (B, K, 65536, DIM, L, torch.bfloat16, None),
             (B, K, M, DIM, L, torch.float32, "ties")]
    for (b, k, m, d, l, dt, mode) in cases:
        q = randn(b, d, dtype=dt)
        if mode == "ties":
            base = randn(k, m // 8, d, dtype=dt)
            p = base.repeat_interleave(8, dim=1).contiguous()
        else:
            p = randn(k, m, d, dtype=dt)
        valid = None
        if mode == "random":
            valid = torch.rand((k, m), generator=g, device=dev) > 0.4
        elif mode == "none":
            valid = torch.zeros((k, m), dtype=torch.bool, device=dev)
        v, i = dtk.distance_topk_cuda(q, p, l, valid=valid)
        torch.cuda.synchronize()
        rv, ri = dtk.distance_topk_plain(q, p, l, valid=valid)
        full = (ref.l2_distance_ref(q, p) if valid is None
                else ref.masked_l2_distance_ref(q, p, valid))
        tol = F32_TOL if dt == torch.float32 else BF16_TOL
        err = topk_agree(v, i, rv, ri, full, tol)
        if mode == "ties":
            # equal distances must come out in ascending id order
            same = (v[..., 1:] == v[..., :-1])
            if bool((same & (i[..., 1:] < i[..., :-1])).any()):
                raise PhaseError("tie order: a larger id came first")
        if mode == "none" and not bool((i == INT32_MAX).all()):
            raise PhaseError("all-invalid shard surfaced an id")
        if valid is not None and mode == "random":
            dead = ~valid
            fin = torch.isfinite(v)
            idx = torch.where(fin, i, 0).long()
            hit = dead.unsqueeze(1).expand(k, b, m).gather(2, idx) & fin
            if bool(hit.any()):
                raise PhaseError("a masked point surfaced")
        errs["distance_topk"] = max(errs["distance_topk"], err)
        main_err.setdefault("distance_topk", err)
        log(f"  distance_topk B={b} k={k} m={m} d={d} l={l} {dt} "
            f"{mode or ''}: max abs {err:.3g}")
        del full

    # local_topk: the gather path's two shapes, l seam, ties, bf16
    for (rows, m, l, dt, mode) in [(K * B, M, L, torch.float32, None),
                                   (B, K * L, L, torch.float32, None),
                                   (5, 1000, 1, torch.float32, None),
                                   (5, 1000, 255, torch.float32, None),
                                   (5, 1000, 256, torch.float32, None),
                                   (3, 100, 128, torch.float32, None),
                                   (4, 512, 32, torch.float32, "ties"),
                                   (8, 4096, 64, torch.bfloat16, None)]:
        x = randn(rows, m)
        if mode == "ties":
            x = torch.round(x * 10) / 10
        x = x.to(dt)
        v, i = ltk.local_topk_cuda(x, l)
        torch.cuda.synchronize()
        rv, ri = ltk.local_topk_plain(x, l)
        if not (torch.equal(v, rv) and torch.equal(i, ri)):
            raise PhaseError(f"local_topk {(rows, m, l, dt, mode)}: "
                             f"differs from the plain version")
        err = float(torch.where(torch.isfinite(rv), (v - rv).abs(), 0).max())
        errs["local_topk"] = max(errs["local_topk"], err)
        main_err.setdefault("local_topk", err)
        log(f"  local_topk rows={rows} m={m} l={l} {dt} {mode or ''}: "
            f"ids equal, max abs {err:.3g}")
    results["max_abs_err"] = main_err
    results["max_abs_err_all_cases"] = errs


# ---- phase 3: the slice at full width --------------------------------------

def brute_check(points, q, l, res):
    """One answer against a plain top-l over all points on the card."""
    import torch
    from repro_torch.kernels import ref
    d = ref.l2_distance_ref(q[None], points)[0]                  # (n,)
    bv, bi = torch.topk(d, l + 1, largest=False)
    bv, bi = bv.cpu().numpy(), bi.cpu().numpy()
    got_d, got_i = res.dists, res.ids
    tol = F32_TOL["atol"] + F32_TOL["rtol"] * abs(float(bv[l - 1]))
    if len(got_d) != l or not all(abs(got_d - bv[:l]) <= tol):
        raise PhaseError(f"l={l}: distances differ from brute force")
    if bool((got_d[1:] < got_d[:-1]).any()):
        raise PhaseError("answer not ascending")
    if len(set(got_i.tolist())) != l:
        raise PhaseError("repeated id in an answer")
    true = d[torch.as_tensor(got_i.astype("int64"), device=d.device)]
    if bool((true.cpu() - torch.as_tensor(got_d)).abs().max() > tol):
        raise PhaseError("an id's distance differs from its value")
    if bv[l] - bv[l - 1] > tol:
        if set(got_i.tolist()) != set(bi[:l].tolist()):
            raise PhaseError(f"l={l}: id set differs from brute force")
    else:
        inner = set(bi[:l][bv[:l] < bv[l - 1] - tol].tolist())
        if not inner <= set(got_i.tolist()):
            raise PhaseError(f"l={l}: interior ids differ")


def phase_serve(dev, gpu, results):
    import numpy as np
    import torch
    from repro_torch.configs import CONFIG
    from repro_torch.kernels import ops as kops
    from repro_torch.runtime import KnnServer

    cfg = CONFIG
    if (cfg.n_points, cfg.dim, cfg.l_max, cfg.bucket_sizes[-1]) != (
            N_POINTS, DIM, L, B):
        raise PhaseError("KnnServiceConfig defaults moved; update the "
                         "phase-3 shapes")
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    points = torch.randn((cfg.n_points, cfg.dim), generator=g, device=dev)
    rng = np.random.default_rng(0)
    groups = [32, 5, 2, 1]                  # buckets 32, 8, 2, 1
    n_req = sum(groups)
    queries = rng.normal(size=(n_req, cfg.dim)).astype(np.float32)
    ls = rng.integers(1, cfg.l_max + 1, n_req)
    ls[0], ls[1] = 1, cfg.l_max
    # every kernel each sampler's path launches (local_topk is also
    # distance_topk's merge pass); the kernels line sums both runs
    launches = {name: 0 for name in KERNELS}
    by_sampler, serve = {}, {}
    for sampler, needs in (("selection", ["distance_topk", "local_topk"]),
                           ("gather", ["l2_distance", "local_topk"])):
        torch.cuda.reset_peak_memory_stats()
        srv = KnnServer(points, cfg=cfg.replace(sampler=sampler), shards=K,
                        device=dev, seed=0)
        srv.warmup()
        torch.cuda.synchronize()
        kops.reset_launch_counts()
        t0 = time.perf_counter()
        answers, start = [], 0
        for size in groups:
            answers += srv.query_batch(queries[start:start + size],
                                       ls[start:start + size].tolist())
            start += size
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kops.launch_counts()
        for name in needs:
            if counts[name] < 1:
                raise PhaseError(f"{sampler}: {name} was never launched")
        for name, n in counts.items():
            launches[name] += n
        by_sampler[sampler] = counts
        for q, l, r in zip(queries, ls, answers):
            brute_check(points, torch.as_tensor(q, device=dev), int(l), r)
        snap = srv.obs_snapshot()
        if snap["audit"]["contract"]["violations"]:
            raise PhaseError(f"{sampler}: contract audit violations")
        batches, seen = [], set()
        for r in answers:            # one entry per batch (bucket)
            if r.bucket not in seen:
                seen.add(r.bucket)
                batches.append(dict(bucket=r.bucket, iterations=r.iterations,
                                    rounds=r.rounds, messages=r.messages,
                                    host_syncs=r.host_syncs))
        lat = sorted(r.latency_s for r in answers)
        p50 = lat[len(lat) // 2]
        peak = torch.cuda.max_memory_allocated()
        serve[sampler] = dict(batches=batches, p50_latency_ms=p50 * 1e3,
                              wall_s=wall, requests=n_req,
                              launches=counts,
                              max_memory_allocated=peak,
                              contract=snap["audit"]["contract"]["checks"])
        log(f"  [{gpu}] sampler={sampler}: {n_req} requests, all equal "
            f"brute force; launches {counts}, per request "
            f"{ {k: n / n_req for k, n in counts.items()} }")
        for bt in batches:
            log(f"  [{gpu}] sampler={sampler} bucket={bt['bucket']}: "
                f"iterations={bt['iterations']} rounds={bt['rounds']} "
                f"messages={bt['messages']} host_syncs={bt['host_syncs']}")
        log(f"  [{gpu}] sampler={sampler}: p50 request latency "
            f"{p50 * 1e3:.3f} ms, max_memory_allocated {peak} bytes")
        del srv
    results["launches"] = launches
    results["launches_by_sampler"] = by_sampler
    results["serve"] = serve
    del points
    torch.cuda.empty_cache()


def phase_profile(dev, gpu, results):
    """Where one full bucket's time goes: torch.profiler over one
    query_batch of 32 requests per sampler, after warm-up, beside the
    batch's wall time measured without the profiler."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import CONFIG
    from repro_torch.runtime import KnnServer

    g = torch.Generator(device=dev)
    g.manual_seed(0)
    points = torch.randn((N_POINTS, DIM), generator=g, device=dev)
    rng = np.random.default_rng(1)
    qs = rng.normal(size=(B, DIM)).astype(np.float32)
    ls = rng.integers(1, L + 1, B).tolist()
    out = {}
    for sampler in ("selection", "gather"):
        srv = KnnServer(points, cfg=CONFIG.replace(sampler=sampler),
                        shards=K, device=dev, seed=0)
        srv.warmup()
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            srv.query_batch(qs, ls)
            walls.append(time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = srv.query_batch(qs, ls)
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0
        rows = []
        for e in prof.key_averages():
            # device-side events only (kernels, copies); the aten:: rows
            # repeat their kernels' time
            if e.key.startswith("aten::"):
                continue
            dev_us = getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0))
            if dev_us > 0:
                rows.append((dev_us, e.key, e.count))
        rows.sort(reverse=True)
        device_ms = sum(r[0] for r in rows) / 1e3
        walls.sort()
        out[sampler] = dict(
            batch_wall_ms_p50=walls[len(walls) // 2] * 1e3,
            profiled_wall_ms=prof_wall * 1e3, device_ms=device_ms,
            device_busy_share=device_ms / (prof_wall * 1e3),
            iterations=res[0].iterations, host_syncs=res[0].host_syncs,
            top=[dict(name=k, count=c, device_ms=us / 1e3)
                 for us, k, c in rows[:15]])
        log(f"  [{gpu}] sampler={sampler}: batch of {B} wall p50 "
            f"{out[sampler]['batch_wall_ms_p50']:.3f} ms; profiled "
            f"{prof_wall * 1e3:.3f} ms, device busy {device_ms:.3f} ms "
            f"({100 * device_ms / (prof_wall * 1e3):.1f}%), iterations "
            f"{res[0].iterations}")
        for us, k, c in rows[:15]:
            log(f"    {us / 1e3:9.3f} ms  x{c:<5d} {k[:90]}")
        del srv
    results["profile"] = out
    del points
    torch.cuda.empty_cache()


# ---- phase 4: timing ---------------------------------------------------------

def time_ms(fn, iters):
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes, flops):
    t_b, t_f = nbytes / PEAK_BYTES_S, flops / PEAK_F32_S
    return (max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations")


def phase_timing(dev, results):
    import torch
    from repro_torch.kernels import distance_topk as dtk
    from repro_torch.kernels import l2_distance as l2
    from repro_torch.kernels import local_topk as ltk

    g = torch.Generator(device=dev)
    g.manual_seed(7)
    q = torch.randn((B, DIM), generator=g, device=dev)
    p = torch.randn((K, M, DIM), generator=g, device=dev)
    dmat = l2.l2_distance_cuda(q, p)
    qk = q.expand(K, B, DIM)
    n = K * M
    dist_flops = 2 * B * n * DIM + 3 * B * n
    timing = {}
    runs = {
        "l2_distance": (
            lambda: l2.l2_distance_cuda(q, p),
            lambda: l2.l2_distance_plain(q, p),
            lambda: torch.cdist(qk, p).square(),
            4 * (B * DIM + n * DIM) + 4 * B * n, dist_flops),
        "distance_topk": (
            lambda: dtk.distance_topk_cuda(q, p, L),
            lambda: dtk.distance_topk_plain(q, p, L),
            lambda: torch.topk(torch.cdist(qk, p).square(), L,
                               largest=False),
            4 * (B * DIM + n * DIM) + 8 * K * B * L, dist_flops),
        "local_topk": (
            lambda: ltk.local_topk_cuda(dmat, L),
            lambda: ltk.local_topk_plain(dmat, L),
            lambda: torch.topk(dmat, L, largest=False),
            4 * B * n + 8 * K * B * L, B * n),
    }
    for name, (kern, plain, lib, nbytes, ops) in runs.items():
        ms = time_ms(kern, 20)
        plain_ms = time_ms(plain, 5)
        lib_ms = time_ms(lib, 5)
        b_ms, by = bound(nbytes, ops)
        timing[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                            bound_ms=b_ms, bound_by=by, bytes=nbytes,
                            operations=ops)
        log(f"  {name}: {ms:.4f} ms (plain {plain_ms:.4f}, library "
            f"{lib_ms:.4f}, bound {b_ms:.4f} by {by})")
    results["timing"] = timing


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the run's details here as JSON")
    ap.add_argument("--profile", action="store_true",
                    help="also profile one full bucket per sampler")
    args = ap.parse_args(argv)

    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch is not beside this script",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gpu = gpu_line()
    log(gpu)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    results = {"gpu": gpu, "device": torch.cuda.get_device_name(0)}
    phases = [("build", None), ("kernels", phase_kernels),
              ("serve", phase_serve), ("timing", phase_timing)]
    if args.profile:
        phases.append(("profile", phase_profile))
    for name, fn in phases:
        t0 = time.perf_counter()
        log(f"== phase {name}")
        try:
            if name == "build":
                from repro_torch.kernels import _build
                path = _build.build()
                _build.library()
                for line in _build.build_log.splitlines():
                    if any(w in line for w in ("registers", "spill",
                                               "smem", "Compiling", "==")):
                        log("  " + line.strip())
                results["library"] = str(path.relative_to(ROOT))
            elif name in ("serve", "profile"):
                fn(dev, gpu, results)
            else:
                fn(dev, results)
            torch.cuda.synchronize()
        except Exception:
            traceback.print_exc()
            log(f"== phase {name} FAILED")
            return 1
        results.setdefault("phase_s", {})[name] = time.perf_counter() - t0
        log(f"== phase {name} ok ({time.perf_counter() - t0:.1f} s)")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(results, indent=1))
    kernels = []
    for name, meta in KERNELS.items():
        t = results["timing"][name]
        kernels.append(dict(
            name=name, route="cuda", source=meta["source"],
            replaces=meta["replaces"], status="ported",
            launches=results["launches"][name],
            launches_by_sampler={smp: c[name] for smp, c in
                                 results["launches_by_sampler"].items()},
            max_abs_err=results["max_abs_err"][name], ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=t["library_ms"]))
    log(json.dumps({"kernels": kernels, "not_ported": NOT_PORTED,
                    "gpu": gpu}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
