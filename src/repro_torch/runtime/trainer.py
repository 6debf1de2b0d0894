"""Training runtime: microbatched step builder + fault-tolerant loop.

Port of ``repro.runtime.trainer``.  The parameters are the model
module itself; the optimizer state is ``(AdamWState, residual | None,
step)``, the step a 0-dim int32 host tensor.

Step construction (``make_train_step``):
  * the global batch is split into ``grad_accum`` microbatches (rows
    ``[i*b, (i+1)*b)``), bounding the live activations and vocabulary
    logits; each microbatch's gradient is added as ``(acc.f32 + g.f32 /
    n).to(accum_dtype)`` into a buffer of ``accum_dtype``, the
    reference's order (``(loss / n).backward()`` would round otherwise
    when the buffer is bf16);
  * optional bf16 compression with error feedback (optim/compress.py),
    the warmup-cosine learning rate, then AdamW in place.

Under a mesh (the parameters DTensors, ``creator.shard_model``) each
microbatch is split on its batch axes, and each gradient, which comes
back ``Partial`` over the batch axes, is redistributed to its
parameter's placements before it is accumulated: the reduce-scatter
that GSPMD inserts for the reference.  The loss and ce are read whole
on every rank, so every rank runs the same collectives.

Loop (``train_loop``):
  * auto-restart: on a step failure the loop loads the latest checkpoint
    into the live parameters and optimizer tensors and replays from
    there; the synthetic data is seeded by step, so replayed batches are
    bit-identical;
  * a step-time watchdog flags outliers (the straggler telemetry).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from repro_torch.checkpoint.serialization import tree_map
from repro_torch.device import resolve_device
from repro_torch.models.sharding import is_dtensor
from repro_torch.optim import AdamW, compress as compress_mod, warmup_cosine
from repro_torch.optim.adamw import foreach_copy_
from repro_torch.runtime import metrics as metrics_mod


@dataclasses.dataclass
class TrainConfig:
    grad_accum: int = 1
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    compress_grads: bool = False
    remat: bool = True
    aux_weight: float = 0.01
    # bf16 gradient accumulation buffer: per-microbatch grads are f32
    # before the add, so the accumulation loses <1 ulp per microbatch
    accum_dtype: torch.dtype = torch.float32


def make_train_step(api, tcfg: TrainConfig, optimizer: AdamW):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; ``batch`` holds numpy arrays or tensors, ``metrics`` the
    ``loss`` and ``ce`` (0-dim tensors on the model's device) and the
    ``lr`` (0-dim f32, host)."""

    def train_step(params, opt_state, batch):
        adam_state, residual, step = opt_state
        n = tcfg.grad_accum
        named = dict(params.named_parameters())
        leaves = list(named.values())
        sharded = is_dtensor(leaves[0])
        b = len(batch["tokens"]) // n
        acc = [torch.zeros_like(p, dtype=tcfg.accum_dtype) for p in leaves]
        loss, ce = 0.0, []
        for i in range(n):
            mb = {k: v[i * b:(i + 1) * b] for k, v in batch.items()}
            l, aux = api.loss_fn(params, mb, remat=tcfg.remat)
            g = [x.float() for x in torch.autograd.grad(l, leaves)]
            if sharded:
                g = [x.redistribute(p.device_mesh, p.placements)
                     for x, p in zip(g, leaves)]
                l, aux = l.full_tensor(), {"ce": aux["ce"].full_tensor()}
            with torch.no_grad():
                torch._foreach_div_(g, n)
                if tcfg.accum_dtype == torch.float32:
                    torch._foreach_add_(acc, g)
                else:
                    torch._foreach_add_(g, [a.float() for a in acc])
                    foreach_copy_(acc, g)
            del g
            loss = loss + l.detach() / n
            ce.append(aux["ce"].detach() / n)
        grads = dict(zip(named, acc))
        if tcfg.compress_grads:
            grads, residual = compress_mod.compress(grads, residual)
        lr = warmup_cosine(step, peak_lr=tcfg.peak_lr,
                           warmup_steps=tcfg.warmup_steps,
                           total_steps=tcfg.total_steps)
        _, new_adam = optimizer.update(grads, adam_state, named, lr)
        m = {"loss": loss, "ce": torch.stack(ce).sum(), "lr": lr}
        return params, (new_adam, residual, step + 1), m

    return train_step


def init_opt_state(api, tcfg: TrainConfig, optimizer: AdamW, params):
    named = dict(params.named_parameters())
    residual = (compress_mod.init_residual(named)
                if tcfg.compress_grads else None)
    return (optimizer.init(named), residual,
            torch.zeros((), dtype=torch.int32))


def checkpoint_tree(params, opt_state) -> dict:
    """What a checkpoint holds: ``{"params": the named parameters, "opt":
    opt_state}``, the live tensors themselves."""
    return {"params": dict(params.named_parameters()), "opt": opt_state}


@torch.no_grad()
def restore_into(ckpt_manager, step: int, params, opt_state):
    """Load checkpoint ``step`` into the live parameters and optimizer
    tensors (``copy_``, staged on the host), so every holder of them
    sees the restored values; a DTensor gets its own block."""
    live = checkpoint_tree(params, opt_state)
    tree_map(lambda dst, src: dst.copy_(_like(src, dst)), live,
             ckpt_manager.restore(step, live, device="cpu"))


def _like(src: torch.Tensor, dst):
    """The whole host tensor ``src`` laid out as ``dst`` is (a DTensor's
    own block on its device), ready for ``dst.copy_``."""
    if not is_dtensor(dst):
        return src
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(src.to(dst.device), dst.device_mesh,
                             dst.placements, src_data_rank=None)


def train_loop(
    *,
    api,
    tcfg: TrainConfig,
    optimizer: AdamW,
    params,
    opt_state,
    make_batch: Callable[[int], dict],
    num_steps: int,
    ckpt_manager=None,
    ckpt_every: int = 50,
    start_step: int = 0,
    fail_at: Optional[Callable[[int], None]] = None,
    max_restarts: int = 3,
    logger: Optional[metrics_mod.MetricLogger] = None,
    device=None,
):
    """Fault-tolerant synchronous loop.  Returns ``(params, opt_state,
    step)``.

    ``device``: where the model must live, the card when None (a model
    elsewhere is an error, not a quiet move).  ``fail_at(step)`` is the
    failure-injection hook (raises to simulate a node loss); on failure
    the loop restores the latest checkpoint and continues.  A step's
    ``step_time`` ends when its loss has been read back.
    """
    dev = resolve_device(device)
    have = params.embed.table.device
    if have.type != dev.type or dev.index not in (None, have.index):
        raise ValueError(f"the model is on {have}, the loop runs on {dev}")
    train_step = make_train_step(api, tcfg, optimizer)
    watchdog = metrics_mod.StepWatchdog()
    logger = logger or metrics_mod.MetricLogger()
    restarts = 0
    step = start_step

    while step < num_steps:
        try:
            t0 = time.perf_counter()
            if fail_at is not None:
                fail_at(step)
            batch = make_batch(step)
            params, opt_state, m = train_step(params, opt_state, batch)
            loss = float(m["loss"])
            dt = time.perf_counter() - t0
            slow = watchdog.observe(dt)
            logger.log(step, loss=loss, lr=float(m["lr"]), step_time=dt,
                       straggler=slow)
            if ckpt_manager is not None and (step + 1) % ckpt_every == 0:
                ckpt_manager.save(step + 1, checkpoint_tree(params,
                                                            opt_state))
            step += 1
        except _RESTARTABLE as e:
            restarts += 1
            if restarts > max_restarts or ckpt_manager is None:
                raise
            logger.log(step, event=f"restart after {type(e).__name__}: {e}")
            ckpt_manager.wait()
            latest = ckpt_manager.latest_step()
            if latest is None:
                step = start_step
                continue
            restore_into(ckpt_manager, latest, params, opt_state)
            step = latest
    if ckpt_manager is not None:
        ckpt_manager.wait()
    return params, opt_state, step


class SimulatedNodeFailure(RuntimeError):
    pass


_RESTARTABLE = (SimulatedNodeFailure,)
