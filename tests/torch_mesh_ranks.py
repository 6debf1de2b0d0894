"""Rank programs of ``tests/test_torch_mesh.py``: each runs in one of 8
gloo processes on the CPU (a (4, 2) data x model mesh) and imports only
torch and the port, so that the spawned processes start quickly.

:func:`spawn` starts the ranks and enforces a deadline: a hang fails the
test instead of running into the suite's time limit.  A rank's failed
check raises, which fails the test with the rank's traceback; rank 0
writes what the parent compares to ``<dir>/out.json``.
"""

from __future__ import annotations

import json
import logging
import os
import time
import warnings

import numpy as np
import torch
import torch.distributed as dist

WORLD = 8


def spawn(fn, tmp_path, *args, deadline: float = 240.0):
    """Run ``fn(rank, tmp_path, *args)`` on ``WORLD`` gloo ranks joined
    through a file under ``tmp_path``; returns rank 0's ``out.json``."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(_entry, args=(fn, str(tmp_path), args),
                             nprocs=WORLD, join=False,
                             start_method="spawn")
    t0 = time.monotonic()
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() - t0 > deadline:
                raise TimeoutError(f"{fn.__name__}: the ranks did not end "
                                   f"within {deadline} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    with open(os.path.join(tmp_path, "out.json")) as f:
        return json.load(f)


def _entry(rank, fn, tmp, args):
    torch.set_num_threads(1)
    warnings.filterwarnings("ignore")
    logging.getLogger("torch.distributed").setLevel(logging.ERROR)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/init",
                            rank=rank, world_size=WORLD)
    try:
        fn(rank, tmp, *args)
    finally:
        dist.destroy_process_group()


def _write(rank, tmp, out):
    if rank == 0:
        with open(os.path.join(tmp, "out.json"), "w") as f:
            json.dump(out, f)


def _cfg():
    import repro_torch.configs as configs
    return configs.get("qwen2-0.5b").reduced()


def train_rank(rank, tmp, steps, tcfg_kw):
    """Three train steps of the reduced qwen2-0.5b on the (4, 2) mesh from
    ``params.pt`` over ``batches.npz``; the local shards' shapes against
    the rules; the collectives of a fourth step against ``cost.py``'s
    plan; a checkpoint saved on (4, 2) restored onto (2, 4) and onto no
    mesh; then ``launch.train --mesh 4x2``."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.serialization import flatten
    from repro_torch.launch import cost
    from repro_torch.launch import train as tlaunch
    from repro_torch.models import build_model, creator
    from repro_torch.models import sharding as shd
    from repro_torch.models.transformer import Transformer
    from repro_torch.optim import AdamW
    from repro_torch.runtime import (TrainConfig, init_opt_state,
                                     make_train_step)
    from repro_torch.runtime.trainer import checkpoint_tree

    cfg = _cfg()
    api = build_model(cfg)
    batches = np.load(os.path.join(tmp, "batches.npz"))
    model = Transformer(cfg)
    model.load_state_dict(torch.load(os.path.join(tmp, "params.pt")))
    model.requires_grad_(True).train(True)
    mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
    tcfg = TrainConfig(**tcfg_kw)
    opt = AdamW()
    out = {}
    with shd.set_mesh(mesh):
        creator.shard_model(model, mesh)
        # every local block has the shape the rules give
        want = creator.param_shapes(model, mesh, dtype=torch.float32)
        for n, p in model.named_parameters():
            assert tuple(p.to_local().shape) == want[n].local, n
            assert list(p.placements) == shd.placements(want[n].spec, mesh)
        state = init_opt_state(api, tcfg, opt, model)
        step = make_train_step(api, tcfg, opt)
        losses = []
        for s in range(steps):
            b = {k: batches[f"{k}{s}"] for k in ("tokens", "labels")}
            model, state, m = step(model, state, b)
            losses.append(float(m["loss"]))
        out["losses"] = losses
        for n, m_ in state[0].m.items():
            assert m_.placements == dict(model.named_parameters())[
                n].placements, n

        # the checkpoint: saved on 4 x 2 by every rank, written by rank 0
        live = checkpoint_tree(model, state)
        whole = {k: shd.gathered(v.detach()) if isinstance(
            v, torch.Tensor) else v for k, v in flatten(live).items()}
        mgr = CheckpointManager(os.path.join(tmp, "ckpt"))
        mgr.save(steps, live, blocking=True)
        mesh24 = init_device_mesh("cpu", (2, 4),
                                  mesh_dim_names=("data", "model"))
        with shd.set_mesh(mesh24):
            pspecs = build_model(cfg).param_specs()
            specs = {"params": pspecs,
                     "opt": (opt.state_specs(pspecs), None, shd.P())}
            back = flatten(mgr.restore(steps, live, device="cpu",
                                       mesh=mesh24, specs=specs))
        for k, v in back.items():
            if v.dim() == 0:
                assert not shd.is_dtensor(v) and torch.equal(v, whole[k]), k
                continue
            name = k.split("/")[-1]
            assert v.device_mesh is mesh24, k
            assert list(v.placements) == shd.placements(shd.divisible(
                specs["params"][name], v.shape, mesh24), mesh24), k
            assert torch.equal(v.full_tensor(), whole[k]), k
        plain = flatten(mgr.restore(steps, live, device="cpu"))
        assert all(torch.equal(plain[k], whole[k]) for k in whole)
        out["restored_leaves"] = len(back)

        # the collectives of one more step: the gradients' reduction
        # against cost.redistribute_plan, and every collective DTensor
        # issued as CommDebugMode counts it
        b = {k: batches[f"{k}0"][:4] for k in ("tokens", "labels")}
        leaves = list(model.parameters())
        with CommDebugMode() as cdm, cost.CollectiveCounter() as cc:
            loss, _ = api.loss_fn(model, b)
            g = torch.autograd.grad(loss, leaves)
        out["fwd_bwd_counts"] = cc.stats.counts
        assert cdm.get_total_counts() == sum(cc.stats.counts.values())
        plan = cost.CollectiveStats()
        for x, p in zip(g, leaves):
            for op in cost.redistribute_plan(
                    x.placements, p.placements, tuple(x.to_local().shape),
                    x.element_size(), tuple(mesh.shape)).ops:
                plan.add(*op)
        with CommDebugMode() as cdm, cost.CollectiveCounter() as cc:
            for x, p in zip(g, leaves):
                x.redistribute(p.device_mesh, p.placements)
        assert sorted(cc.stats.ops) == sorted(plan.ops)
        assert cdm.get_total_counts() == sum(plan.counts.values())
        by_kind = {str(k).split(".")[-1]: v
                   for k, v in cdm.get_comm_counts().items() if v}
        out["sync_counts"] = by_kind
        out["sync_plan"] = plan.counts
        out["sync_wire_bytes"] = [cc.stats.wire_bytes, plan.wire_bytes]

    _, out["launch_losses"] = tlaunch.main(
        ["--mesh", "4x2", "--device", "cpu", "--reduced", "--steps", "3",
         "--batch", "8", "--seq", "16", "--grad-accum", "2"])
    _write(rank, tmp, out)


def serve_rank(rank, tmp):
    """``launch.serve --mesh 4x2`` of the reduced qwen2-0.5b under both
    samplers."""
    from repro_torch.launch import serve as tserve
    out = {}
    for sampler in ("selection", "gather"):
        gen, _ = tserve.main(["--arch", "qwen2-0.5b", "--reduced",
                              "--tokens", "5", "--batch", "4", "--prompt",
                              "8", "--top-k", "16", "--sampler", sampler,
                              "--mesh", "4x2", "--device", "cpu"])
        out[sampler] = np.asarray(gen).tolist()
    _write(rank, tmp, out)


def families_rank(rank, tmp, runs, serve_argv):
    """Every family of ``runs`` (``[(arch, launch.train arguments)]``) on
    the (4, 2) mesh: each parameter's
    local block against the rules (the experts on ``model``), then
    ``launch.train --mesh 4x2`` and ``launch.serve --mesh 4x2`` under
    both samplers, one rank program for all of them so that process
    start and DTensor's sharding caches are paid once.  A family whose
    ``<arch>.pt`` is in ``tmp`` trains from those weights (the JAX
    package's init) instead of the seeded one."""
    from torch.distributed.device_mesh import init_device_mesh

    import repro_torch.configs as configs
    from repro_torch.launch import serve as tserve
    from repro_torch.launch import train as tlaunch
    from repro_torch.models import build_model, creator
    from repro_torch.models import model as model_mod
    from repro_torch.models import sharding as shd

    mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
    seeded = model_mod.ModelApi.init_params
    out = {}
    for arch, train_argv in runs:
        cfg = configs.get(arch).reduced()
        model = build_model(cfg).init_params(0, device="cpu")
        with shd.set_mesh(mesh):
            creator.shard_model(model, mesh)
            want = creator.param_shapes(model, mesh, dtype=torch.float32)
        experts = []
        for n, p in model.named_parameters():
            assert tuple(p.to_local().shape) == want[n].local, n
            assert list(p.placements) == shd.placements(want[n].spec, mesh)
            if ".moe.w_" in n:
                experts.append(p.placements[1].is_shard(0))
        del model
        # every cache leaf (KV, Mamba, mLSTM, sLSTM, enc_out) laid out
        # by its spec on the live mesh
        api = build_model(cfg)
        cache = api.init_cache(4, 16, device="cpu", mesh=mesh)
        with shd.set_mesh(mesh):
            shapes = api.cache_shapes(4, 16, mesh, dtype=torch.float32)
        leaves = []
        creator._cache_map(cache, lambda axes, x: leaves.append(x))
        creator._cache_map(shapes, lambda axes, x: leaves.append(x))
        half = len(leaves) // 2
        for x, sh in zip(leaves[:half], leaves[half:]):
            if isinstance(x, torch.Tensor):
                assert tuple(x.to_local().shape) == sh.local, (arch, sh)
                assert list(x.placements) == shd.placements(sh.spec, mesh)

        init = os.path.join(tmp, f"{arch}.pt")
        if os.path.exists(init):
            def from_file(self, seed=0, device=None, train=False):
                m = seeded(self, seed, device=device, train=train)
                with torch.no_grad():
                    m.load_state_dict(torch.load(init))
                return m
            model_mod.ModelApi.init_params = from_file
        try:
            _, losses = tlaunch.main(["--arch", arch, "--mesh", "4x2",
                                      *train_argv])
        finally:
            model_mod.ModelApi.init_params = seeded
        res = {"losses": losses, "experts": experts}
        for sampler in ("selection", "gather"):
            gen, _ = tserve.main(["--arch", arch, "--sampler", sampler,
                                  "--mesh", "4x2", *serve_argv])
            res[sampler] = np.asarray(gen).tolist()
        # one answer on every rank: the losses (the MoE aux loss comes
        # out of a Partial sum) and the tokens
        every = [None] * WORLD
        dist.all_gather_object(every, res)
        assert all(r == res for r in every), arch
        out[arch] = res
    _write(rank, tmp, out)
