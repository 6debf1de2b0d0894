"""Logical-axis sharding: one rule table maps every tensor dim to mesh axes.

Port of ``repro.models.sharding``.  Model code names the *logical* axes
of a tensor; the rule table (swappable per experiment: the long-context
cells override ``kv_seq``) resolves them to mesh axes.

Mesh axes (``launch/mesh.py``):
  pod   — data parallelism across pods (multi-pod mesh only)
  data  — FSDP: batch AND parameter/optimizer sharding (ZeRO-3 style)
  model — tensor/expert parallelism: heads, d_ff, vocab, experts

The reference's ``PartitionSpec`` is :class:`P` here, a tuple of mesh-axis
entries (a name, a tuple of names, or None) that compares like the
reference's.  On a live ``DeviceMesh`` a ``P`` becomes DTensor placements
(:func:`placements`): a dim sharded over ``("pod", "data")`` is
``Shard(d)`` on both mesh dims, and an entry the mesh lacks is
``Replicate()``.  :func:`divisible` keeps the reference's rule for
placed tensors: an axis that does not tile its dim is dropped, so no
tensor is ever sharded unevenly.

The ambient mesh is set by :func:`set_mesh`, a real
``torch.distributed.device_mesh.DeviceMesh`` or an :class:`AbstractMesh`
(only a shape and axis names: the dry-run's 256- and 512-device meshes).
Under a real mesh the model's plain tensors (positions, masks) take part
in DTensor ops as replicated values (``implicit_replication``), and
:func:`constrain` redistributes an activation to the rules' placements,
at the points where the reference calls ``with_sharding_constraint``.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import NamedTuple, Optional

import torch


class P(tuple):
    """A partition spec: one entry a tensor dim (a mesh-axis name, a
    tuple of names, or None)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class Rules:
    batch: tuple | str | None = ("pod", "data")
    seq: Optional[str] = None            # activation sequence axis
    kv_seq: Optional[str] = None         # KV-cache sequence axis ("data" for
                                         # the long-context cells: SP decode)
    embed: Optional[str] = "data"        # parameter d_model axis (FSDP)
    heads: Optional[str] = "model"
    qkv: Optional[str] = "model"         # fused (head, head_dim) param axis
    mlp: Optional[str] = "model"         # d_ff
    vocab: Optional[str] = "model"
    experts: Optional[str] = "model"
    expert_cap: Optional[str] = None
    stack: Optional[str] = None          # stacked-layer leading axis (the
                                         # reference's; the port unstacks)
    none: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh that is only a shape and axis names (no devices, no
    process group): what the dry-run lays its tensors out on."""
    axis_sizes: tuple
    axis_names: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


_RULES: contextvars.ContextVar = contextvars.ContextVar("rules",
                                                        default=Rules())
_MESH: contextvars.ContextVar = contextvars.ContextVar("mesh", default=None)


def current_rules() -> Rules:
    return _RULES.get()


@contextlib.contextmanager
def use_rules(rules: Rules):
    tok = _RULES.set(rules)
    try:
        yield
    finally:
        _RULES.reset(tok)


def current_mesh():
    """The ambient mesh (a ``DeviceMesh`` or an :class:`AbstractMesh`),
    or None."""
    return _MESH.get()


def is_dtensor(x) -> bool:
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def gathered(x):
    """A DTensor's whole value on every rank (a collective every rank
    must run); anything else as it is."""
    return x.full_tensor() if is_dtensor(x) else x


def is_live(mesh) -> bool:
    return mesh is not None and not isinstance(mesh, AbstractMesh)


@contextlib.contextmanager
def set_mesh(mesh):
    """Make ``mesh`` ambient; under a live mesh, plain tensors meeting
    DTensors count as replicated."""
    outer = _MESH.get()
    tok = _MESH.set(mesh)
    try:
        # implicit_replication does not nest: its exit turns it off
        if is_live(mesh) and not is_live(outer):
            from torch.distributed.tensor.experimental import (
                implicit_replication)
            with implicit_replication():
                yield mesh
        else:
            yield mesh
    finally:
        _MESH.reset(tok)


def mesh_axes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` or an
    :class:`AbstractMesh`."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _mesh_axis_names():
    mesh = _MESH.get()
    return None if mesh is None else tuple(mesh_axes(mesh))


def spec(*logical_axes: Optional[str]) -> P:
    """Resolve logical axis names to a :class:`P` under the current rules.

    Mesh axes the rules name but the ambient mesh lacks are dropped
    ("pod" on the single-pod mesh), so one rule table serves every mesh
    shape; a tuple left with one axis becomes the bare name.
    """
    r = _RULES.get()
    names = _mesh_axis_names()
    out = []
    for ax in logical_axes:
        resolved = None if ax is None else getattr(r, ax)
        if names is not None and resolved is not None:
            if isinstance(resolved, tuple):
                resolved = tuple(a for a in resolved if a in names) or None
                if resolved is not None and len(resolved) == 1:
                    resolved = resolved[0]
            elif resolved not in names:
                resolved = None
        out.append(resolved)
    return P(*out)


def divisible(pspec: P, shape, mesh) -> P:
    """Drop mesh axes that do not evenly divide their dimension (40 heads
    over 16, batch 1): the tensor is replicated on those axes instead.
    Of a tuple entry, each axis is kept while the product of the kept
    sizes divides the dim."""
    sizes = mesh_axes(mesh)
    out = []
    entries = list(pspec) + [None] * (len(shape) - len(pspec))
    for dim, entry in zip(shape, entries):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        kept = []
        prod = 1
        for a in axes:
            n = sizes.get(a, 1)
            if dim % (prod * n) == 0:
                kept.append(a)
                prod *= n
        out.append(tuple(kept) if len(kept) > 1 else
                   (kept[0] if kept else None))
    return P(*out)


def shard_shape(pspec: P, shape, mesh) -> tuple:
    """Each device's block of a ``shape`` tensor laid out by ``pspec``
    (which must tile it: a :func:`divisible` spec)."""
    sizes = mesh_axes(mesh)
    out = []
    entries = list(pspec) + [None] * (len(shape) - len(pspec))
    for dim, entry in zip(shape, entries):
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        ways = math.prod(sizes.get(a, 1) for a in axes)
        if dim % ways:
            raise ValueError(f"{pspec} does not tile {tuple(shape)}")
        out.append(dim // ways)
    return tuple(out)


def batch_shards() -> int:
    """Number of mesh shards the batch ("data"/"pod") axes span under the
    ambient mesh: the MoE dispatch group count."""
    mesh = _MESH.get()
    if mesh is None:
        return 1
    sizes = mesh_axes(mesh)
    rule = _RULES.get().batch
    axes = rule if isinstance(rule, tuple) else (rule,)
    out = 1
    for a in axes:
        out *= sizes.get(a, 1)
    return max(out, 1)


def placements(pspec: P, mesh) -> list:
    """DTensor placements of ``pspec`` on a ``DeviceMesh``, one a mesh
    dim: ``Shard(d)`` on every mesh axis that tensor dim d is split
    over, ``Replicate()`` on the rest.  A mesh axis of size 1 holds the
    whole tensor either way and is ``Replicate()``, which DTensor
    carries through every view (some releases refuse to flatten a dim
    sharded even one way)."""
    from torch.distributed.tensor import Replicate, Shard
    sizes = mesh_axes(mesh)
    names = list(sizes)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(pspec):
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a not in names or sizes[a] == 1:
                continue
            i = names.index(a)
            if not isinstance(out[i], Replicate):
                raise ValueError(f"{pspec}: mesh axis {a!r} splits two dims")
            out[i] = Shard(d)
    return out


def distribute(x: torch.Tensor, pspec: P, mesh):
    """``x`` (the whole tensor, the same on every rank) as a DTensor laid
    out by ``divisible(pspec)`` on ``mesh``: each rank keeps its block,
    with no communication."""
    from torch.distributed.tensor import distribute_tensor
    p = placements(divisible(pspec, x.shape, mesh), mesh)
    return distribute_tensor(x, mesh, p, src_data_rank=None)


def constrain(x, *logical_axes: Optional[str]):
    """Redistribute a DTensor to the rules' placements under a live
    mesh (the reference's ``with_sharding_constraint``); a no-op
    otherwise, so the same model code runs without a mesh."""
    mesh = _MESH.get()
    if not is_live(mesh) or not is_dtensor(x):
        return x
    want = placements(divisible(spec(*logical_axes), x.shape, mesh), mesh)
    if tuple(want) == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


class Shape(NamedTuple):
    """The port's ``ShapeDtypeStruct``: a tensor's shape and dtype, its
    spec on the mesh (already :func:`sharding.divisible`; None without a
    mesh) and each device's block."""
    shape: tuple
    dtype: torch.dtype
    spec: Optional[P]
    local: tuple

    @property
    def nbytes(self) -> int:
        return _numel(self.shape) * _itemsize(self.dtype)

    @property
    def local_nbytes(self) -> int:
        return _numel(self.local) * _itemsize(self.dtype)


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def make_shape(shape, dtype, axes, mesh=None) -> Shape:
    """The :class:`Shape` of a tensor whose dims carry ``axes``: its
    ``divisible`` spec and block on ``mesh`` (the whole without one)."""
    shape = tuple(int(d) for d in shape)
    if mesh is None:
        return Shape(shape, dtype, None, shape)
    ps = divisible(spec(*axes), shape, mesh)
    return Shape(shape, dtype, ps, shard_shape(ps, shape, mesh))
