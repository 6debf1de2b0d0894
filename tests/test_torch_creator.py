"""The port's parameter, cache, input, optimizer-state and batch layouts
against the reference's, for all ten configs, reduced.

The reference's specs come from its creators (``ModelApi.param_specs``,
``cache_specs``, ``param_shapes(mesh)``, ``cache_shapes(mesh)``,
``input_specs(shape, mesh)``, ``AdamW.state_specs``,
``data.pipeline.lm_batch_specs``); each stacked leaf is unstacked onto
the port's per-layer names (layer ``sb * p + j`` is ``blocks/sub{j}[sb]``,
as ``convert.params_from_jax`` maps it) and its leading ``stack`` entry
dropped.  Specs are compared axis for axis (as tuples padded with None to
the rank), with no mesh and under a (4, 2) mesh (the reference's real
``mesh42``, the port's abstract one).  Per-device shard shapes are
compared on (4, 2) and on the (16, 16) and (2, 16, 16) production meshes
wherever neither side pads (the reference pads heads and experts to tile
its mesh; the port holds the real ones), for the reduced and the full
configs.
"""

import dataclasses
import math

import jax
import pytest
import torch

import repro.configs as jconfigs
from repro.data import pipeline as jpipeline
from repro.models import build_model as jbuild
from repro.models import sharding as jshd
from repro.models.config import ALL_SHAPES as JSHAPES
from repro.models.transformer import superblock_size
from repro.optim import AdamW as JAdamW
from repro.parallel.compat import set_mesh as jset_mesh
import repro_torch.configs as tconfigs
from repro_torch.data import pipeline as tpipeline
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import ALL_SHAPES, build_model, creator
from repro_torch.models import sharding as shd
from repro_torch.models.sharding import AbstractMesh
from repro_torch.optim import AdamW

ARCHS = ["qwen2.5-14b", "qwen1.5-4b", "qwen2-0.5b", "yi-6b",
         "phi3.5-moe-42b-a6.6b", "granite-moe-3b-a800m",
         "jamba-1.5-large-398b", "pixtral-12b", "seamless-m4t-large-v2",
         "xlstm-125m"]
MESH42 = AbstractMesh((4, 2), ("data", "model"))


def _pad(p, rank):
    t = tuple(p)
    return t + (None,) * (rank - len(t))


def ref_named(tree, cfg, unstack):
    """The reference's parameter tree as ``{port name: leaf}``; each
    stacked leaf through ``unstack`` (drop the stack entry or dim)."""
    out = {"embed.table": tree["embed"]["table"],
           "final_ln.scale": tree["final_ln"]["scale"]}
    if "lm_head" in tree:
        out["lm_head.table"] = tree["lm_head"]["table"]

    def layer(prefix, sub):
        for mod, leaves in sub.items():
            name = {"self": "self_attn"}.get(mod, mod)
            for leaf, x in leaves.items():
                out[f"{prefix}{name}.{leaf}"] = unstack(x)

    if cfg.is_encdec:
        out["enc_ln.scale"] = tree["enc_ln"]["scale"]
        for i in range(cfg.n_enc_layers):
            layer(f"enc_blocks.{i}.", tree["enc_blocks"])
        for i in range(cfg.n_layers):
            layer(f"dec_blocks.{i}.", tree["dec_blocks"])
        return out
    p = superblock_size(cfg)
    for i in range(cfg.n_layers):
        layer(f"blocks.{i}.", tree["blocks"][f"sub{i % p}"])
    return out


def drop_stack(p):
    assert p[0] is None          # the stack rule
    return jax.sharding.PartitionSpec(*tuple(p)[1:])


def cfgs(arch):
    return jconfigs.get(arch).reduced(), tconfigs.get(arch).reduced()


def port_model(cfg):
    return build_model(cfg).init_params(device="meta")


# ---- parameters ----------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_every_parameter_has_axes(arch):
    for cfg in (tconfigs.get(arch), tconfigs.get(arch).reduced()):
        model = port_model(cfg)
        specs = creator.param_specs(model)
        assert sorted(specs) == sorted(n for n, _ in model.named_parameters())
        for n, p in model.named_parameters():
            assert len(creator.param_axes(n)) == p.dim(), n


def test_a_parameter_without_axes_raises():
    model = port_model(tconfigs.get("qwen2-0.5b").reduced())
    model.blocks[0].attn.extra = torch.nn.Parameter(
        torch.empty(3, device="meta"))
    with pytest.raises(KeyError, match="extra"):
        creator.param_specs(model)


@pytest.mark.parametrize("mesh_name", [None, "mesh42"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference(arch, mesh_name, request):
    jcfg, tcfg = cfgs(arch)
    if mesh_name is None:
        want = ref_named(jbuild(jcfg).param_specs(), jcfg, drop_stack)
        got = build_model(tcfg).param_specs()
    else:
        with jset_mesh(request.getfixturevalue(mesh_name)):
            want = ref_named(jbuild(jcfg).param_specs(), jcfg, drop_stack)
        with shd.set_mesh(MESH42):
            got = build_model(tcfg).param_specs()
    assert sorted(got) == sorted(want)
    model = port_model(tcfg)
    for n, p in model.named_parameters():
        assert _pad(got[n], p.dim()) == _pad(want[n], p.dim()), n


def _fake(mesh):
    class Sizes:
        axis_names = mesh.axis_names
        axis_sizes = mesh.axis_sizes
    return Sizes


def _ref_shard(spec, shape, mesh):
    """The reference's per-device block of a ``shape`` leaf under its
    ``divisible`` spec on ``mesh`` (an abstract stand-in)."""
    p = jshd.divisible(spec, shape, _fake(mesh))
    sizes = dict(zip(mesh.axis_names, mesh.axis_sizes))
    out = []
    for dim, e in zip(shape, _pad(p, len(shape))):
        axes = () if e is None else (e if isinstance(e, tuple) else (e,))
        out.append(dim // math.prod(sizes.get(a, 1) for a in axes))
    return tuple(out)


@pytest.mark.parametrize("mesh", [MESH42, make_production_mesh(),
                                  make_production_mesh(multi_pod=True)],
                         ids=["4x2", "16x16", "2x16x16"])
@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_shard_shapes_equal_reference(arch, full, mesh):
    jcfg, tcfg = (jconfigs.get(arch), tconfigs.get(arch)) if full else (
        cfgs(arch))
    japi = jbuild(jcfg)
    specs = ref_named(japi.param_specs(), jcfg, drop_stack)
    shapes = ref_named(japi.param_shapes(), jcfg,
                       lambda s: tuple(s.shape)[1:])
    shapes = {n: tuple(getattr(s, "shape", s)) for n, s in shapes.items()}
    dtypes = {n: getattr(d, "dtype", d) for n, d in ref_named(
        japi.param_shapes(), jcfg, lambda s: s.dtype).items()}
    with shd.set_mesh(mesh):
        got = build_model(tcfg).param_shapes(mesh)
    compared = 0
    for n, s in got.items():
        if s.shape != shapes[n]:
            # a padded leaf: heads or experts the reference adds
            assert jcfg.head_pad_to or jcfg.kv_head_pad_to or (
                jcfg.expert_pad_to), n
            continue
        assert s.local == _ref_shard(specs[n], shapes[n], mesh), n
        assert str(s.dtype).split(".")[-1] == str(dtypes[n]), n
        compared += 1
    padded = jcfg.head_pad_to or jcfg.kv_head_pad_to or jcfg.expert_pad_to
    assert compared == len(got) if not padded else compared > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_on_mesh42_equal_reference(arch, mesh42):
    jcfg, tcfg = cfgs(arch)
    with jset_mesh(mesh42):
        ref = ref_named(jbuild(jcfg).param_shapes(mesh42), jcfg, lambda s: s)
    with shd.set_mesh(MESH42):
        got = build_model(tcfg).param_shapes(MESH42)
    for n, s in got.items():
        r = ref[n]
        shape = tuple(r.shape)[1:] if len(r.shape) == len(s.shape) + 1 else (
            tuple(r.shape))
        spec = tuple(r.sharding.spec)[len(r.shape) - len(s.shape):]
        assert _pad(s.spec, len(s.shape)) == _pad(spec, len(s.shape)), n
        if shape == s.shape:
            local = tuple(r.sharding.shard_shape(r.shape))[
                len(r.shape) - len(s.shape):]
            assert s.local == local, n


# ---- caches, inputs, optimizer state, batches -----------------------------

def _ref_cache_layers(tree, cfg):
    """The reference's cache as ``(per-layer NamedTuples, enc_out)``."""
    if cfg.is_encdec:
        return [tree["self"]] * cfg.n_layers, tree["enc_out"]
    p = superblock_size(cfg)
    return [tree[f"sub{i % p}"] for i in range(cfg.n_layers)], None


@pytest.mark.parametrize("mesh_name", [None, "mesh42"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_reference(arch, mesh_name, request):
    jcfg, tcfg = cfgs(arch)
    if mesh_name is None:
        ref = jbuild(jcfg).cache_specs(2, 16)
        got = build_model(tcfg).cache_specs(2, 16)
    else:
        with jset_mesh(request.getfixturevalue(mesh_name)):
            ref = jbuild(jcfg).cache_specs(2, 16)
        with shd.set_mesh(MESH42):
            got = build_model(tcfg).cache_specs(2, 16)
    layers, enc_out = _ref_cache_layers(ref, jcfg)
    if tcfg.is_encdec:
        assert tuple(got["enc_out"]) == tuple(enc_out)
        got = got["self"]
    assert len(got) == len(layers) == tcfg.n_layers
    for g, r in zip(got, layers):
        assert type(g).__name__ == type(r).__name__
        assert g._fields == r._fields
        for f in g._fields:
            want = tuple(drop_stack(getattr(r, f)))
            assert _pad(getattr(g, f), len(want)) == want, (f, g, r)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_shapes_on_mesh42_equal_reference(arch, mesh42):
    jcfg, tcfg = cfgs(arch)
    with jset_mesh(mesh42):
        ref = jbuild(jcfg).cache_shapes(8, 16, mesh=mesh42,
                                        dtype=jax.numpy.float32)
    with shd.set_mesh(MESH42):
        got = build_model(tcfg).cache_shapes(8, 16, MESH42,
                                             dtype=torch.float32)
    layers, enc_out = _ref_cache_layers(ref, jcfg)
    if tcfg.is_encdec:
        assert got["enc_out"].shape == tuple(enc_out.shape)
        assert got["enc_out"].local == tuple(
            enc_out.sharding.shard_shape(enc_out.shape))
        got = got["self"]
    for g, r in zip(got, layers):
        for f in g._fields:
            gs, rs = getattr(g, f), getattr(r, f)
            if not isinstance(gs, shd.Shape):    # the host length
                continue
            shape = tuple(rs.shape)[1:]
            spec = tuple(rs.sharding.spec)[1:]
            assert _pad(gs.spec, len(shape)) == _pad(spec, len(shape))
            if gs.shape == shape:        # the reference pads KV heads
                assert gs.local == tuple(rs.sharding.shard_shape(
                    rs.shape))[1:], (arch, f)
            else:
                assert jcfg.kv_head_pad_to, (arch, f)


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_reference(arch, mesh42):
    jcfg, tcfg = cfgs(arch)
    for js, ts in zip(JSHAPES, ALL_SHAPES):
        assert (js.name, js.seq_len, js.global_batch, js.kind) == (
            ts.name, ts.seq_len, ts.global_batch, ts.kind)
        with jset_mesh(mesh42):
            ref = jbuild(jcfg).input_specs(js, mesh42)
        with shd.set_mesh(MESH42):
            got = build_model(tcfg).input_specs(ts, MESH42)
        assert sorted(got) == sorted(ref)
        for k, r in ref.items():
            g = got[k]
            assert g.shape == tuple(r.shape), k
            assert str(g.dtype).split(".")[-1] == str(r.dtype), k
            assert _pad(g.spec, len(g.shape)) == _pad(
                r.sharding.spec, len(g.shape)), k
            assert g.local == tuple(r.sharding.shard_shape(r.shape)), k


def test_shapes_for_equal_reference():
    from repro.models import shapes_for as jshapes_for
    from repro_torch.models import shapes_for, skipped_shapes_for
    for arch in ARCHS:
        want = [s.name for s in jshapes_for(jconfigs.get(arch))]
        assert [s.name for s in shapes_for(tconfigs.get(arch))] == want
        assert [s.name for s in skipped_shapes_for(tconfigs.get(arch))] == [
            s.name for s in JSHAPES if s.name not in want]


@pytest.mark.parametrize("mesh_name", [None, "mesh42"])
@pytest.mark.parametrize("arch", ARCHS)
def test_state_specs_equal_reference(arch, mesh_name, request):
    jcfg, tcfg = cfgs(arch)
    ctx = (jset_mesh(request.getfixturevalue(mesh_name)) if mesh_name
           else _null())
    with ctx:
        jst = JAdamW().state_specs(jbuild(jcfg).param_specs())
    with (shd.set_mesh(MESH42) if mesh_name else _null()):
        st = AdamW().state_specs(build_model(tcfg).param_specs())
    assert tuple(st.count) == tuple(jst.count) == ()
    for mine, ref in ((st.m, jst.m), (st.v, jst.v)):
        want = ref_named(ref, jcfg, drop_stack)
        assert sorted(mine) == sorted(want)
        for n in mine:
            r = len(want[n])
            assert _pad(mine[n], max(r, len(mine[n]))) == _pad(
                want[n], max(r, len(mine[n]))), n


@pytest.mark.parametrize("moment_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "phi3.5-moe-42b-a6.6b",
                                  "jamba-1.5-large-398b"])
def test_state_shapes_shard_like_parameters(arch, moment_dtype):
    tcfg = tconfigs.get(arch).reduced()
    mesh = make_production_mesh()
    with shd.set_mesh(mesh):
        ps = build_model(tcfg).param_shapes(mesh)
    st = AdamW(moment_dtype=moment_dtype).state_shapes(ps)
    assert st.count.shape == () and st.count.dtype == torch.int32
    for tree in (st.m, st.v):
        assert sorted(tree) == sorted(ps)
        for n, s in tree.items():
            assert (s.shape, s.spec, s.local) == (ps[n].shape, ps[n].spec,
                                                  ps[n].local)
            assert s.dtype == moment_dtype


@pytest.mark.parametrize("mesh_name", [None, "mesh42"])
def test_lm_batch_specs_equal_reference(mesh_name, request):
    if mesh_name is None:
        got, want = tpipeline.lm_batch_specs(), jpipeline.lm_batch_specs()
    else:
        with jset_mesh(request.getfixturevalue(mesh_name)):
            want = jpipeline.lm_batch_specs()
        with shd.set_mesh(MESH42):
            got = tpipeline.lm_batch_specs()
    assert sorted(got) == sorted(want)
    for k in got:
        assert tuple(got[k]) == tuple(want[k])


def test_specs_follow_rules():
    tcfg = tconfigs.get("qwen2-0.5b").reduced()
    with shd.use_rules(shd.Rules(kv_seq="model", heads=None)), \
            shd.set_mesh(MESH42):
        c = build_model(tcfg).cache_specs(2, 16)[0]
    assert tuple(c.k) == ("data", "model", None, None)


class _null:
    def __enter__(self):
        return None

    def __exit__(self, *a):
        return False


def test_model_and_cache_shapes_allocate_nothing():
    tcfg = dataclasses.replace(tconfigs.get("jamba-1.5-large-398b"))
    api = build_model(tcfg)
    mesh = make_production_mesh(multi_pod=True)
    with shd.set_mesh(mesh):
        ps = api.param_shapes(mesh)
        cs = api.cache_shapes(128, 32768, mesh)
    n = sum(math.prod(s.shape) for s in ps.values())
    assert abs(n - tcfg.param_count()) / tcfg.param_count() < 0.01
    assert all(s.local_nbytes <= s.nbytes for s in ps.values())
    assert len(cs) == tcfg.n_layers
