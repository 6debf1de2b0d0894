"""Training driver.

Port of ``repro.launch.train``: ``--device`` is the card unless ``cpu``
is given.  ``--mesh DxM`` trains the dense family on a (data, model)
mesh of D*M ranks started by ``torchrun`` (NCCL, one card a rank; gloo
on the CPU with ``--device cpu``): the parameters and moments are
DTensors laid out by the sharding rules (``models/creator.py``), the
batch is split over ``data``, and the losses are the unsharded model's.

  # qwen2-0.5b reduced, on the CPU (any --arch of the registry; vlm and
  # audio get the reference's random stubs, prefix_embeds or frames):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --reduced --steps 200 --batch 8 --seq 64 --device cpu

  # at full width on the card, with checkpoints:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --steps 30 --batch 8 --seq 128 --grad-accum 2 --ckpt-dir /tmp/ckpt

  # on a 4 x 2 mesh of gloo ranks, and on the card's 1 x 1 mesh (dense
  # family):
  PYTHONPATH=src torchrun --nproc_per_node=8 -m repro_torch.launch.train \\
      --mesh 4x2 --device cpu --reduced --steps 3 --batch 8 --seq 32
  PYTHONPATH=src torchrun --nproc_per_node=1 -m repro_torch.launch.train \\
      --mesh 1x1 --steps 5 --batch 8 --seq 128 --grad-accum 2

Wires together: config registry -> ModelApi -> seeded trainable model on
the device (sharded on the mesh) -> synthetic Markov data -> microbatched
train_step -> fault-tolerant loop with async checkpoints (resuming from
the latest one in ``--ckpt-dir``).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch.distributed as dist

import repro_torch.configs as configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import MarkovTokens
from repro_torch.launch.mesh import debug_mesh
from repro_torch.launch.serve import stub_inputs
from repro_torch.models import build_model, creator
from repro_torch.optim import AdamW
from repro_torch.runtime import (MetricLogger, TrainConfig, init_opt_state,
                                 train_loop)
from repro_torch.runtime.trainer import restore_into


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true",
                    help="family-preserving tiny config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="torch device; the card when omitted")
    ap.add_argument("--mesh", default=None,
                    help="'DxM': train on a data x model mesh of D*M ranks "
                         "(torchrun --nproc_per_node=D*M)")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def main(argv=None):
    """Train; returns ``(steps done, [losses logged])``."""
    args = parse_args(argv)
    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    api = build_model(cfg)
    if args.mesh and cfg.family != "dense":
        raise ValueError(f"--mesh trains the dense family; {args.arch} is "
                         f"{cfg.family}")
    with debug_mesh(args.mesh, args.device) as (dev, mesh):
        return _train(args, cfg, api, dev, mesh)


def _train(args, cfg, api, dev, mesh):
    tcfg = TrainConfig(grad_accum=args.grad_accum, peak_lr=args.lr,
                       warmup_steps=max(args.steps // 20, 5),
                       total_steps=args.steps,
                       compress_grads=args.compress_grads)
    optimizer = AdamW()
    data = MarkovTokens(cfg.vocab, seed=args.seed, branch=2, n_contexts=13)

    def make_batch(step):
        t, l = data.batch(step, args.batch, args.seq)
        # the family's stub, seeded by step, so a replayed step after a
        # restart gets the same batch
        rng = np.random.default_rng([args.seed, step])
        return {"tokens": t, "labels": l,
                **stub_inputs(cfg, rng, args.batch)}

    def build_state():
        params = api.init_params(args.seed, device=dev, train=True)
        if mesh is not None:
            creator.shard_model(params, mesh)
        return params

    lead = not dist.is_initialized() or dist.get_rank() == 0
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    logger = MetricLogger(quiet=not lead)
    params = build_state()
    opt_state = init_opt_state(api, tcfg, optimizer, params)
    start = 0
    if mgr is not None and mgr.latest_step() is not None:
        start = mgr.latest_step()
        restore_into(mgr, start, params, opt_state)
        logger.log(start, event="resumed from checkpoint")
    params, opt_state, step = train_loop(
        api=api, tcfg=tcfg, optimizer=optimizer, params=params,
        opt_state=opt_state, make_batch=make_batch, num_steps=args.steps,
        ckpt_manager=mgr, ckpt_every=args.ckpt_every, start_step=start,
        logger=logger, device=dev)
    losses = [r["loss"] for r in logger.history if "loss" in r]
    if lead:
        print(f"done: steps={step} first_loss={losses[0]:.4f} "
              f"last_loss={losses[-1]:.4f}")
    return step, losses


if __name__ == "__main__":
    main()
