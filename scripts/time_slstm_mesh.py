#!/usr/bin/env python3
"""Time xlstm-125m's sLSTM loop on one NVIDIA GPU: unsharded, on a 1 x 1
NCCL mesh as the port runs it (each rank steps its own rows as plain
tensors), and on the same mesh with every op of the loop dispatched
through DTensor (log-sigmoid on each rank's block, as ``layers`` runs
it, since DTensor has no rule for it).

    python3 scripts/time_slstm_mesh.py [--reps N] [--batch B] [--seq S]

One sLSTM block of xlstm-125m at full width (d_model 768, 4 heads, f32,
seeded), ``B x S`` tokens (8 x 128 by default, a training microbatch of
chip_smoke.py's phase serve_families is 4 x 128), forward and backward
of the block's sum: the wall of each, host clock around the call and a
synchronise, median and quartiles in ms over ``--reps`` calls after 2
warm-up calls.  The three give the same loss (checked bit for bit).
Prints one JSON line with the card and its power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    import torch.distributed as dist
    if not torch.cuda.is_available():
        print("time_slstm_mesh: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch.configs as configs
    from repro_torch.launch.mesh import init_distributed, make_debug_mesh
    from repro_torch.models import build_model, creator, xlstm
    from repro_torch.models import sharding as shd

    dev = torch.device("cuda", 0)
    cfg = configs.get("xlstm-125m")
    blk = next(b for b in build_model(cfg).init_params(
        0, device=dev, train=True).blocks if b.mixer == "slstm")
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    x0 = torch.randn(args.batch, args.seq, cfg.d_model, generator=g,
                     device=dev)

    def scan_dispatched(p, x, n_heads):
        # the loop of xlstm._slstm_scan with every op on DTensors
        B, S, D = x.shape
        xw = x @ p.w_gates
        state = xlstm.SLstmCache(*(shd.distribute(t, shd.spec(
            "batch", "heads", None), mesh) for t in xlstm.init_slstm_state(
                B, D, n_heads, device=dev)))
        hs = []
        for t in range(S):
            state = xlstm._slstm_step(p, xw[:, t], state, n_heads)
            hs.append(state.h.reshape(B, D))
        return torch.stack(hs, 1)

    def run(fn, x):
        x = x.detach().requires_grad_(True)
        loss = shd.gathered(fn(x).sum())
        loss.backward()
        torch.cuda.synchronize()
        return float(loss.detach())

    def timed(fn, x):
        losses, walls = [], []
        for i in range(args.reps + 2):
            t0 = time.perf_counter()
            losses.append(run(fn, x))
            if i >= 2:
                walls.append((time.perf_counter() - t0) * 1e3)
        q = np.percentile(walls, [25, 50, 75])
        return losses[0], dict(p25_ms=q[0], p50_ms=q[1], p75_ms=q[2])

    out = {}
    h = cfg.n_heads
    loss, out["unsharded"] = timed(
        lambda x: xlstm.slstm_block(blk.slstm, x, n_heads=h), x0)
    made = init_distributed("cuda", 1)[1]
    try:
        mesh = make_debug_mesh(1, 1, "cuda")
        with shd.set_mesh(mesh):
            creator.shard_model(blk, mesh)
            xm = shd.distribute(x0, shd.spec("batch", None, None), mesh)
            lr, out["mesh_rows"] = timed(
                lambda x: xlstm.slstm_block(blk.slstm, x, n_heads=h), xm)
            ld, out["mesh_dispatched"] = timed(
                lambda x: xlstm._slstm_out(blk.slstm, scan_dispatched(
                    blk.slstm, x, h)), xm)
    finally:
        if made:
            dist.destroy_process_group()
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps(dict(gpu=gpu, torch=torch.__version__,
                          batch=args.batch, seq=args.seq,
                          losses_equal=loss == lr == ld, **out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
