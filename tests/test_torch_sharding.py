"""The port's logical-axis sharding rules against the reference's.

``repro_torch.models.sharding`` (``spec``, ``use_rules``, ``divisible``,
``batch_shards``) on the cases of ``tests/test_sharding_rules.py`` and on
the same meshes: the reference under ``set_mesh(mesh42)`` (a real (4, 2)
JAX mesh), the port under its own ``set_mesh`` of an abstract (4, 2)
mesh.  A reference ``PartitionSpec`` is compared as a tuple with the
port's ``P``.  Then ``placements`` on (4, 2) and (2, 16, 16), and
``constrain`` without a mesh.
"""

import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.models import sharding as jshd
from repro.parallel.compat import set_mesh as jset_mesh
from repro_torch.launch.mesh import make_production_mesh, parse_mesh
from repro_torch.models import sharding as shd
from repro_torch.models.sharding import AbstractMesh, P

MESH42 = AbstractMesh((4, 2), ("data", "model"))

LOGICAL = [("batch", None, "mlp"), ("batch", "vocab"), ("embed", "qkv"),
           ("batch", "kv_seq", "heads", None), ("experts", "embed", None),
           ("stack", "mlp", "embed"), ()]
RULES = [shd.Rules(), shd.Rules(batch=None, kv_seq="data"),
         shd.Rules(kv_seq="model", heads=None)]


def _t(p):
    return tuple(p)


def _jrules(r: shd.Rules):
    return jshd.Rules(**{f: getattr(r, f) for f in r.__dataclass_fields__})


def test_spec_resolution_default():
    s = shd.spec("batch", None, "mlp")
    assert s == P(("pod", "data"), None, "model")
    assert _t(s) == _t(jshd.spec("batch", None, "mlp"))


def test_spec_rule_override():
    with shd.use_rules(shd.Rules(batch=None, kv_seq="data")):
        assert shd.spec("batch", "kv_seq") == P(None, "data")
    assert shd.spec("kv_seq") == P(None)  # default restored


def test_spec_filters_missing_mesh_axes(mesh42):
    with shd.set_mesh(MESH42):
        s = shd.spec("batch", "vocab")
    assert s == P("data", "model")
    with jset_mesh(mesh42):
        assert _t(jshd.spec("batch", "vocab")) == _t(s)


@pytest.mark.parametrize("mesh_name", [None, "mesh42"])
@pytest.mark.parametrize("rules", RULES, ids=["default", "long", "flash"])
@pytest.mark.parametrize("axes", LOGICAL, ids=str)
def test_spec_equals_reference(request, mesh_name, rules, axes):
    if mesh_name is None:
        with shd.use_rules(rules), jshd.use_rules(_jrules(rules)):
            assert _t(shd.spec(*axes)) == _t(jshd.spec(*axes))
        return
    mesh = request.getfixturevalue(mesh_name)
    with shd.use_rules(rules), jshd.use_rules(_jrules(rules)), \
            shd.set_mesh(MESH42), jset_mesh(mesh):
        assert _t(shd.spec(*axes)) == _t(jshd.spec(*axes))


def test_divisible_drops_nondividing_axes(mesh42):
    cases = [(P("data", "model"), (40, 30)), (P("data"), (2,)),
             (P(("data", "model")), (4,)), (P(("data", "model")), (1,)),
             (P(("data", "model"), None), (8, 3)), (P(None, "model"), (6, 5))]
    assert shd.divisible(P("data", "model"), (40, 30), MESH42) \
        == P("data", "model")
    assert shd.divisible(P("data"), (2,), MESH42) == P(None)
    assert shd.divisible(P(("data", "model")), (4,), MESH42) == P("data")
    assert shd.divisible(P(("data", "model")), (1,), MESH42) == P(None)
    for p, shape in cases:
        want = jshd.divisible(JP(*p), shape, mesh42)
        assert _t(shd.divisible(p, shape, MESH42)) == _t(want), (p, shape)


@pytest.mark.parametrize("multi", [False, True])
def test_divisible_on_production_mesh_equals_reference(multi):
    mesh = make_production_mesh(multi_pod=multi)

    class Sizes:          # the reference reads axis_names / axis_sizes
        axis_names = mesh.axis_names
        axis_sizes = mesh.axis_sizes

    for p, shape in [(P(("pod", "data"), None), (256, 4096)),
                     (P(("pod", "data")), (16,)), (P("model", "data"),
                                                   (40, 5120)),
                     (P("data", "model"), (896, 151936)),
                     (P(None, ("data", "model")), (3, 512))]:
        want = jshd.divisible(JP(*p), shape, Sizes)
        assert _t(shd.divisible(p, shape, mesh)) == _t(want), (p, shape)


@pytest.mark.parametrize("mesh,rule,want", [
    (None, shd.Rules(), 1),
    (MESH42, shd.Rules(), 4),
    (AbstractMesh((2, 16, 16), ("pod", "data", "model")), shd.Rules(), 32),
    (AbstractMesh((2, 16, 16), ("pod", "data", "model")),
     shd.Rules(batch="data"), 16),
    (MESH42, shd.Rules(batch=None), 1),
])
def test_batch_shards(mesh, rule, want):
    with shd.use_rules(rule):
        if mesh is None:
            assert shd.batch_shards() == want
        else:
            with shd.set_mesh(mesh):
                assert shd.batch_shards() == want


def test_batch_shards_equals_reference(mesh42):
    with shd.set_mesh(MESH42), jset_mesh(mesh42):
        assert shd.batch_shards() == jshd.batch_shards() == 4


def test_placements_on_4x2():
    from torch.distributed.tensor import Replicate, Shard
    assert shd.placements(P("data", "model"), MESH42) == [Shard(0),
                                                           Shard(1)]
    assert shd.placements(P("model", "data"), MESH42) == [Shard(1),
                                                           Shard(0)]
    assert shd.placements(P(None, "model"), MESH42) == [Replicate(),
                                                         Shard(1)]
    assert shd.placements(P(("pod", "data"), None), MESH42) == [
        Shard(0), Replicate()]
    assert shd.placements(P(), MESH42) == [Replicate(), Replicate()]
    with pytest.raises(ValueError):
        shd.placements(P("data", "data"), MESH42)


def test_placements_on_2x16x16():
    from torch.distributed.tensor import Replicate, Shard
    mesh = make_production_mesh(multi_pod=True)
    assert mesh.axis_names == ("pod", "data", "model")
    assert shd.placements(P(("pod", "data"), None, "model"), mesh) == [
        Shard(0), Shard(0), Shard(2)]
    assert shd.placements(P("data"), mesh) == [Replicate(), Shard(0),
                                               Replicate()]
    assert shd.placements(P(None, ("data", "model")), mesh) == [
        Replicate(), Shard(1), Shard(1)]


def test_shard_shape():
    mesh = make_production_mesh()
    assert shd.shard_shape(P("data", "model"), (896, 4864), mesh) == (56,
                                                                      304)
    assert shd.shard_shape(P(None, "model"), (3, 32), MESH42) == (3, 16)
    with pytest.raises(ValueError):
        shd.shard_shape(P("model"), (3,), MESH42)


def test_constrain_noop_without_mesh():
    x = torch.ones(4, 4)
    assert shd.constrain(x, "batch", None) is x
    with shd.set_mesh(MESH42):       # an abstract mesh places nothing
        assert shd.constrain(x, "batch", None) is x


def test_mesh_helpers():
    assert parse_mesh("4x2") == (4, 2) and parse_mesh("1X1") == (1, 1)
    single = make_production_mesh()
    assert single.shape == {"data": 16, "model": 16} and single.size == 256
    assert make_production_mesh(multi_pod=True).size == 512


def test_placements_replicate_on_size_one_axes():
    from torch.distributed.tensor import Replicate, Shard
    one = AbstractMesh((1, 1), ("data", "model"))
    assert shd.placements(P("data", "model"), one) == [Replicate()] * 2
    assert shd.divisible(P("data", "model"), (3, 5), one) == P("data",
                                                               "model")
    tall = AbstractMesh((4, 1), ("data", "model"))
    assert shd.placements(P("data", "model"), tall) == [Shard(0),
                                                         Replicate()]
