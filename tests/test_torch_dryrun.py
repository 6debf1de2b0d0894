"""The port's dry-run (``repro_torch.launch.dryrun``) on a (4, 2) abstract
mesh with every reduced config (the hybrid cut to two periods of 2
layers).

  * every arch x shape cell is OK, and long_500k is SKIP exactly for the
    full-attention archs (``shapes_for``, as the reference's);
  * a cell's parameter and optimizer-state bytes per device equal the
    sums over the reference's ``param_shapes(mesh42)`` and
    ``AdamW.state_shapes`` shards (bf16 parameters, f32 moments), for the
    archs the reference does not pad;
  * the record holds the H100's roofline constants, and the reference's
    rules for the shape (``rules_for_shape``, ``grad_accum_for``,
    ``model_flops``) give the same values as the reference's.

The counts run on the meta device, as the dry-run's own.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import pytest
import torch

import repro.configs as jconfigs
from repro.launch import dryrun as jdryrun
from repro.models import build_model as jbuild
from repro.optim import AdamW as JAdamW
from repro.parallel.compat import set_mesh as jset_mesh
import repro_torch.configs as tconfigs
from repro_torch.launch import cost, dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import ALL_SHAPES, build_model, shapes_for
from repro_torch.models import sharding as shd
from repro_torch.models.sharding import AbstractMesh

torch.set_num_threads(1)

MESH42 = AbstractMesh((4, 2), ("data", "model"))


def test_archs_equal_reference():
    assert dryrun.ARCHS == jdryrun.ARCHS


# the hybrid cut to two periods of 2 layers (Mamba + MoE, attention +
# SwiGLU), so that its Python chunk loop counts in seconds
CUTS = {"jamba-1.5-large-398b": dict(attn_period=2, n_layers=4)}


@pytest.mark.parametrize("arch", dryrun.ARCHS)
def test_every_reduced_cell_runs(arch):
    cfg = dataclasses.replace(tconfigs.get(arch).reduced(),
                              **CUTS.get(arch, {}))
    points = {}
    for shape in ALL_SHAPES:
        rec = dryrun.run_cell(arch, shape, False, cfg=cfg, mesh=MESH42,
                              quiet=True, points=points)
        if shape not in shapes_for(cfg):
            assert shape.name == "long_500k" and not cfg.sub_quadratic
            assert rec["status"] == "SKIP", rec
            continue
        assert rec["status"] == "OK", rec.get("trace", rec)
        assert rec["chips"] == 8
        mem, roof = rec["memory"], rec["roofline"]
        assert mem["fits"] and mem["total"] == sum(
            v for k, v in mem.items() if k not in ("total", "hbm_bytes",
                                                   "fits"))
        assert roof["flops"] > 0 and roof["hbm_bytes"] > 0
        assert roof["dominant"] in ("compute", "memory", "collective")
        assert roof["peak_flops"] == cost.H100_BF16_FLOPS
        assert roof["link_bw"] == cost.NVLINK_BW      # 8 devices: one node
        if shape.kind == "decode":
            assert rec["counting"]["sampler"]


def _local_bytes(shape_struct):
    return math.prod(shape_struct.sharding.shard_shape(shape_struct.shape)
                     ) * shape_struct.dtype.itemsize


@pytest.mark.parametrize("arch", [a for a in dryrun.ARCHS if not (
    jconfigs.get(a).head_pad_to or jconfigs.get(a).kv_head_pad_to
    or jconfigs.get(a).expert_pad_to)])
def test_param_and_state_bytes_equal_reference(arch, mesh42):
    jcfg, tcfg = jconfigs.get(arch).reduced(), tconfigs.get(arch).reduced()
    shape = ALL_SHAPES[0]                                   # train_4k
    with jset_mesh(mesh42):
        ps = jbuild(jcfg).param_shapes(mesh42, dtype=jnp.bfloat16)
        st = JAdamW().state_shapes(ps)
    want_p = sum(_local_bytes(x) for x in jax.tree.leaves(ps))
    want_s = sum(_local_bytes(x) for x in jax.tree.leaves((st.m, st.v)))
    with shd.set_mesh(MESH42):
        mem, _, ga, rows = dryrun.resident_bytes(build_model(tcfg), shape,
                                                 MESH42)
    assert mem["params"] == want_p
    # the moments (the port's count is a host tensor)
    assert mem["opt_state"] == want_s
    assert (ga, rows) == (8, 256 // 4 // 8)


@pytest.mark.parametrize("arch", dryrun.ARCHS)
def test_shape_rules_equal_reference(arch):
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    for js, ts in zip(jdryrun.ALL_SHAPES, ALL_SHAPES):
        for mw in (2, 16):
            a = jdryrun.rules_for_shape(js, jcfg, model_ways=mw)
            b = dryrun.rules_for_shape(ts, tcfg, model_ways=mw)
            assert {f: getattr(a, f) for f in a.__dataclass_fields__} == {
                f: getattr(b, f) for f in b.__dataclass_fields__}
        assert jdryrun.model_flops(jcfg, js) == dryrun.model_flops(tcfg, ts)
        for multi in (False, True):
            mesh = make_production_mesh(multi_pod=multi)

            class Shape:        # the reference reads mesh.shape
                shape = mesh.shape
            assert jdryrun.grad_accum_for(jcfg, js, Shape) == \
                dryrun.grad_accum_for(tcfg, ts, mesh)


def test_big_configs_keep_bf16_moments():
    for arch in dryrun.ARCHS:
        big = tconfigs.get(arch).param_count() > 100e9
        assert dryrun.is_big(tconfigs.get(arch)) == big
    assert dryrun.is_big(tconfigs.get("jamba-1.5-large-398b"))


def test_main_writes_a_record_a_cell(tmp_path):
    out = dryrun.main(["--arch", "xlstm-125m", "--shape", "decode_32k",
                       "--shape", "long_500k", "--mesh", "both",
                       "--results-dir", str(tmp_path)])
    assert [r["status"] for r in out] == ["OK"] * 4
    assert len(list(tmp_path.iterdir())) == 4
    assert {r["chips"] for r in out} == {256, 512}
