"""End-to-end training driver: a ~100M-parameter qwen2-family model for a
few hundred steps on synthetic data, with checkpointing and restart.

Port of the repository's ``examples/train_100m.py``; ``--device`` is
the card unless ``cpu`` is given.

  PYTHONPATH=src python -m repro_torch.examples.train_100m --steps 200
  PYTHONPATH=src python -m repro_torch.examples.train_100m --tiny \\
      --steps 4 --device cpu

The model is qwen2-0.5b narrowed to ~100M params (12 layers, d=512,
vocab 32768): GQA + QKV bias + tied embeddings.
"""

import argparse
import dataclasses
import tempfile

import repro_torch.configs as configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import MarkovTokens
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.optim import AdamW
from repro_torch.runtime import (MetricLogger, TrainConfig, init_opt_state,
                                 train_loop)


def main(argv=None):
    """Train; returns the losses logged."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--tiny", action="store_true",
                    help="reduced config for smoke runs")
    ap.add_argument("--device", default=None,
                    help="torch device; the card when omitted")
    args = ap.parse_args(argv)

    cfg = configs.get("qwen2-0.5b")
    if args.tiny:
        cfg = cfg.reduced()
    else:
        cfg = dataclasses.replace(
            cfg, n_layers=12, d_model=512, n_heads=8, n_kv_heads=2,
            head_dim=64, d_ff=2048, vocab=32768)
    api = build_model(cfg)
    n = cfg.param_count()
    print(f"{cfg.name} variant: {n/1e6:.0f}M params")

    dev = resolve_device(args.device)
    params = api.init_params(0, device=dev, train=True)
    tcfg = TrainConfig(grad_accum=2, peak_lr=1e-3,
                       warmup_steps=max(args.steps // 20, 5),
                       total_steps=args.steps)
    optimizer = AdamW()
    opt_state = init_opt_state(api, tcfg, optimizer, params)
    data = MarkovTokens(cfg.vocab, seed=0, branch=4, n_contexts=257)

    def make_batch(step):
        t, l = data.batch(step, args.batch, args.seq)
        return {"tokens": t, "labels": l}

    with tempfile.TemporaryDirectory() as ckpt_dir:
        mgr = CheckpointManager(ckpt_dir, keep=2)
        logger = MetricLogger(quiet=True)
        params, opt_state, step = train_loop(
            api=api, tcfg=tcfg, optimizer=optimizer, params=params,
            opt_state=opt_state, make_batch=make_batch,
            num_steps=args.steps, ckpt_manager=mgr, ckpt_every=50,
            logger=logger, device=dev)
        losses = [r["loss"] for r in logger.history if "loss" in r]
        print(f"steps={step} loss {losses[0]:.3f} -> {losses[-1]:.3f} "
              f"(entropy floor ~{data.entropy_floor:.3f})")
        print(f"checkpoints kept: {mgr.all_steps()}")
        if not losses[-1] < losses[0]:
            raise RuntimeError("training did not reduce loss")
    return losses


if __name__ == "__main__":
    main()
