"""The port's mesh path: qwen2-0.5b, reduced, on 8 gloo ranks forming a
(4, 2) data x model mesh on the CPU (rank programs in
``tests/torch_mesh_ranks.py``; every spawning test is in this file, so
that ``--dist loadfile`` keeps them on one worker).

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
"""

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


@pytest.mark.parametrize("main", [tserve.main, tlaunch.main],
                         ids=["serve", "train"])
def test_mesh_refuses_non_dense_families(main):
    with pytest.raises(ValueError, match="dense family"):
        main(["--arch", "granite-moe-3b-a800m", "--reduced", "--mesh",
              "1x1", "--device", "cpu"])


def test_serve_refuses_shards_with_a_mesh(capsys):
    """A mesh samples over its model axis, so ``--shards`` and ``--mesh``
    are one choice: giving both is an error, not a silent override."""
    with pytest.raises(SystemExit):
        tserve.main(["--arch", ARCH, "--reduced", "--mesh", "1x1",
                     "--shards", "2", "--device", "cpu"])
    assert "not allowed with argument" in capsys.readouterr().err
