"""The port's mesh path: every family, reduced, on 8 gloo ranks forming
a (4, 2) data x model mesh on the CPU (rank programs in
``tests/torch_mesh_ranks.py``; every spawning test is in this file, so
that ``--dist loadfile`` keeps them on one worker and never runs two
8-rank spawns at once).

  * Training: three train steps (2 microbatches, remat, AdamW) on the
    mesh from the JAX package's weights (``convert.params_from_jax``)
    give the losses of the JAX package's own run on its ``mesh42`` and
    of the unsharded port, within 1e-5 relative; every parameter's and
    moment's local block has the placements and shape the rules give.
  * Elastic restore: the checkpoint saved on (4, 2) restores bit for bit
    onto (2, 4), laid out by the rules there, and onto no mesh.
  * Collectives: the gradients' reduction issues exactly the collectives
    ``cost.redistribute_plan`` lists (kinds, sizes, wire bytes), and
    ``CommDebugMode`` counts the same collectives as ``cost``'s counter.
  * ``launch.train --mesh 4x2`` gives the unsharded launcher's losses
    within 1e-5 relative; ``launch.serve --mesh 4x2`` the unsharded
    port's tokens (``--shards 2``) under both samplers.
  * The other six families, three spawns of two (one rank program runs
    both families' training and serving, so process start and DTensor's
    sharding caches are paid once a spawn; the references run in this
    process meanwhile): three ``launch.train --mesh 4x2`` steps each,
    granite's at 8 x 32 tokens, which the mesh cuts into 4 MoE dispatch
    groups, from the JAX package's init against the JAX package's own
    steps on mesh42, the rest at 8 x 16 (one group) against the
    unsharded launcher, within 1e-5 relative; ``launch.serve --mesh
    4x2`` tokens equal to the unsharded port's under both samplers; on
    the ranks, every parameter's and cache leaf's local block as the
    rules give it (the experts on ``model``), and the losses and tokens
    the same on every rank.
"""

from concurrent import futures

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

import repro.configs as jconfigs
from repro.data import MarkovTokens as JMarkov
from repro.models import build_model as jbuild
from repro.models import sharding as jshd
from repro.optim import AdamW as JAdamW
from repro.parallel.compat import set_mesh as jset_mesh
from repro.runtime import TrainConfig as JTrainConfig
from repro.runtime import init_opt_state as jinit_opt_state
from repro.runtime import make_train_step as jmake_train_step
import repro_torch.configs as tconfigs
from repro_torch import convert
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.models import build_model
from repro_torch.models.transformer import Transformer
from repro_torch.optim import AdamW
from repro_torch.runtime import TrainConfig, init_opt_state, make_train_step

import torch_mesh_ranks as ranks

torch.set_num_threads(1)

ARCH = "qwen2-0.5b"
STEPS = 3
B, S = 8, 32
TCFG = dict(grad_accum=2, peak_lr=1e-3, warmup_steps=5, total_steps=10)
REL = 1e-5


def _rel(a, b):
    return abs(a - b) / abs(b)


def test_train_restore_and_collectives_on_a_4x2_mesh(tmp_path, mesh42):
    jcfg = jconfigs.get(ARCH).reduced()
    api = jbuild(jcfg)
    params = api.init_params(jax.random.PRNGKey(0))
    data = JMarkov(jcfg.vocab, seed=3, branch=2, n_contexts=13)
    batches = [dict(zip(("tokens", "labels"), data.batch(s, B, S)))
               for s in range(STEPS)]
    np.savez(tmp_path / "batches.npz", **{
        f"{k}{s}": v for s, b in enumerate(batches) for k, v in b.items()})
    cfg = tconfigs.get(ARCH).reduced()
    state = convert.params_from_jax(jax.tree.map(np.asarray, params), cfg)
    torch.save(state, tmp_path / "params.pt")

    # the JAX package on its (4, 2) mesh
    jt = JTrainConfig(**TCFG)
    with jset_mesh(mesh42):
        specs = api.param_specs()
        placed = jax.tree.map(
            lambda x, s: jax.device_put(x, NamedSharding(
                mesh42, jshd.divisible(s, x.shape, mesh42))), params, specs)
        jopt = JAdamW()
        jstep = jax.jit(jmake_train_step(api, jt, jopt))
        jp, js = placed, jinit_opt_state(api, jt, jopt, placed)
        want = []
        for b in batches:
            jp, js, m = jstep(jp, js, b)
            want.append(float(m["loss"]))

    # the unsharded port
    model = Transformer(cfg)
    model.load_state_dict(state)
    model.requires_grad_(True)
    tapi = build_model(cfg)
    tt, opt = TrainConfig(**TCFG), AdamW()
    st = init_opt_state(tapi, tt, opt, model)
    step = make_train_step(tapi, tt, opt)
    plain = []
    for b in batches:
        model, st, m = step(model, st, b)
        plain.append(float(m["loss"]))

    out = ranks.spawn(ranks.train_rank, tmp_path, STEPS, TCFG)
    for got, w, p in zip(out["losses"], want, plain):
        assert _rel(got, w) <= REL and _rel(got, p) <= REL, (out, want,
                                                             plain)
    assert out["restored_leaves"] > 0
    assert out["sync_counts"] == {k.replace("-", "_") + (
        "" if k == "all-reduce" else "_tensor" if k == "reduce-scatter"
        else "_into_tensor"): v for k, v in out["sync_plan"].items()}
    assert out["sync_plan"]["reduce-scatter"] > 0
    w_got, w_plan = out["sync_wire_bytes"]
    assert w_got == w_plan > 0
    assert out["fwd_bwd_counts"].get("all-gather", 0) > 0

    # the launcher, unsharded, on the same arguments
    _, launch_plain = tlaunch.main(
        ["--device", "cpu", "--reduced", "--steps", "3", "--batch", "8",
         "--seq", "16", "--grad-accum", "2"])
    assert len(out["launch_losses"]) == len(launch_plain) == 3
    for got, w in zip(out["launch_losses"], launch_plain):
        assert _rel(got, w) <= REL


def test_serve_on_a_4x2_mesh_gives_the_unsharded_tokens(tmp_path):
    out = ranks.spawn(ranks.serve_rank, tmp_path)
    for sampler in ("selection", "gather"):
        want, _ = tserve.main(["--arch", ARCH, "--reduced", "--tokens", "5",
                               "--batch", "4", "--prompt", "8", "--top-k",
                               "16", "--sampler", sampler, "--shards", "2",
                               "--device", "cpu"])
        np.testing.assert_array_equal(np.asarray(out[sampler]), want)


def test_serve_refuses_shards_with_a_mesh(capsys):
    """A mesh samples over its model axis, so ``--shards`` and ``--mesh``
    are one choice: giving both is an error, not a silent override."""
    with pytest.raises(SystemExit):
        tserve.main(["--arch", ARCH, "--reduced", "--mesh", "1x1",
                     "--shards", "2", "--device", "cpu"])
    assert "not allowed with argument" in capsys.readouterr().err


# ---- the other families -------------------------------------------------

FAMILIES = {   # one spawn each; the first family warms DTensor's caches
    "moe": ["granite-moe-3b-a800m", "phi3.5-moe-42b-a6.6b"],
    "recurrent": ["jamba-1.5-large-398b", "xlstm-125m"],
    "io": ["pixtral-12b", "seamless-m4t-large-v2"],
}
GROUP = {a: g for g, archs in FAMILIES.items() for a in archs}
GRANITE = "granite-moe-3b-a800m"
FAM_TRAIN = ["--device", "cpu", "--reduced", "--steps", "3", "--batch", "8"]
# granite trains 8 x 32 = 256 tokens, which the mesh cuts into G = 4
# dispatch groups of 64 (against the JAX package on mesh42); the rest
# 8 x 16, where G = 1 (against the unsharded port)
FAM_SEQ = {GRANITE: 32}
FAM_SERVE = ["--reduced", "--tokens", "3", "--batch", "4", "--prompt", "8",
             "--top-k", "16", "--device", "cpu"]
_RUNS = {}


def _train_argv(arch):
    return FAM_TRAIN + ["--seq", str(FAM_SEQ.get(arch, 16))]


def _granite_init(tmp):
    """The JAX package's init of the reduced granite (seed 0, as its
    launcher makes it), saved to ``<tmp>/<arch>.pt`` for the port's
    launcher."""
    api = jbuild(jconfigs.get(GRANITE).reduced())
    params = api.init_params(jax.random.PRNGKey(0))
    torch.save(convert.params_from_jax(jax.tree.map(np.asarray, params),
                                       tconfigs.get(GRANITE).reduced()),
               tmp / f"{GRANITE}.pt")
    return api, params


def _granite_on_mesh42(api, params, mesh42):
    """The JAX package's three steps of the reduced granite on mesh42 as
    its launcher sets them up (MarkovTokens(vocab, 0, branch 2, 13
    contexts), lr 1e-3, 5 warmup steps)."""
    data = JMarkov(api.cfg.vocab, seed=0, branch=2, n_contexts=13)
    jt = JTrainConfig(grad_accum=1, peak_lr=1e-3, warmup_steps=5,
                      total_steps=STEPS)
    with jset_mesh(mesh42):
        specs = api.param_specs()
        jp = jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(
            mesh42, jshd.divisible(s, x.shape, mesh42))), params, specs)
        jopt = JAdamW()
        jstep = jax.jit(jmake_train_step(api, jt, jopt))
        js = jinit_opt_state(api, jt, jopt, jp)
        losses = []
        for s in range(STEPS):
            t, l = data.batch(s, B, FAM_SEQ[GRANITE])
            jp, js, m = jstep(jp, js, {"tokens": t, "labels": l})
            losses.append(float(m["loss"]))
    return losses


def _family_runs(group, tmp_path_factory, mesh42):
    """``(rank 0's results, the references)`` of one spawn, run once per
    group; the references (the unsharded port's launchers, granite's JAX
    steps) are computed while the ranks run."""
    if group not in _RUNS:
        tmp = tmp_path_factory.mktemp(group)
        archs = FAMILIES[group]
        refs = {a: {} for a in archs}
        granite = _granite_init(tmp) if GRANITE in archs else None
        runs = [(a, _train_argv(a)) for a in archs]
        with futures.ThreadPoolExecutor(1) as ex:
            ranks_out = ex.submit(ranks.spawn, ranks.families_rank, tmp,
                                  runs, FAM_SERVE)
            for a in archs:
                refs[a]["losses"] = (
                    _granite_on_mesh42(*granite, mesh42) if a == GRANITE
                    else tlaunch.main(["--arch", a, *_train_argv(a)])[1])
                for sampler in ("selection", "gather"):
                    refs[a][sampler] = tserve.main(
                        ["--arch", a, "--sampler", sampler, "--shards", "2",
                         *FAM_SERVE])[0]
            _RUNS[group] = ranks_out.result(), refs
    return _RUNS[group]


@pytest.mark.parametrize("arch", list(GROUP))
def test_family_trains_on_a_4x2_mesh(arch, tmp_path_factory, mesh42):
    """Three launch.train --mesh 4x2 steps: granite at G = 4 against the
    JAX package's mesh42 losses, the rest against the unsharded port's,
    within 1e-5 relative; every parameter's local block is the rules'
    (asserted on the ranks), the MoE experts split on ``model``."""
    out, refs = _family_runs(GROUP[arch], tmp_path_factory, mesh42)
    got, want = out[arch]["losses"], refs[arch]["losses"]
    assert len(got) == len(want) == STEPS
    for g, w in zip(got, want):
        assert _rel(g, w) <= REL, (got, want)
    cfg = tconfigs.get(arch).reduced()
    n_moe = sum(cfg.n_experts > 0 and cfg.is_moe_layer(i)
                for i in range(cfg.n_layers))
    assert out[arch]["experts"] == [True] * 3 * n_moe


@pytest.mark.parametrize("arch", list(GROUP))
def test_family_serves_on_a_4x2_mesh(arch, tmp_path_factory, mesh42):
    """launch.serve --mesh 4x2 gives the unsharded port's tokens
    (--shards 2) under both samplers."""
    out, refs = _family_runs(GROUP[arch], tmp_path_factory, mesh42)
    for sampler in ("selection", "gather"):
        np.testing.assert_array_equal(np.asarray(out[arch][sampler]),
                                      refs[arch][sampler])
