"""Parameter, cache and input layouts: specs and shapes without allocation.

Port of ``repro.models.creator``.  The reference runs one module
definition through three creators (init, ``PartitionSpec``,
``ShapeDtypeStruct``) so that the three cannot drift apart.  The port's
modules are ``nn.Module``s, so the logical axes of each parameter are
stated once, in :data:`PARAM_AXES`, keyed by the module kind and the
parameter's name, and read for every parameter of a model built on the
meta device:

  * :func:`param_specs` — ``{name: P}`` under the current rules (the
    reference's ``SpecCreator``); a parameter the table lacks raises;
  * :func:`param_shapes` — ``{name: Shape}`` with each device's block
    under :func:`sharding.divisible` (the reference's ``ShapeCreator``);
  * :func:`shard_model` — a model's parameters replaced in place by
    DTensors laid out by their specs on a live mesh.

Caches and inputs get the same pair (:func:`cache_specs`,
:func:`cache_shapes`, :func:`input_shapes`).  The reference's leading
super-block ``stack`` axis does not exist here (the port unstacks), and
its rule is None, so the specs agree once it is dropped.  The port holds
only the real heads and experts (``convert.params_from_jax``), so its
shapes equal the reference's wherever the reference does not pad.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import sharding as shd
from repro_torch.models.sharding import P, Shape, make_shape

_ATTN = {"wq": ("embed", "qkv"), "wk": ("embed", "qkv"),
         "wv": ("embed", "qkv"), "wo": ("qkv", "embed"),
         "bq": ("qkv",), "bk": ("qkv",), "bv": ("qkv",)}

# module kind -> parameter name -> logical axes (the reference's create()
# calls: attention.py:54-62, mlp.py:13-15, moe.py:44-50, mamba.py:40-53,
# xlstm.py:54-62,187-193, layers.py:14,29)
PARAM_AXES = {
    "attn": _ATTN,
    "ffn": {"w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"),
            "w_down": ("mlp", "embed")},
    "moe": {"router": ("embed", None),
            "w_gate": ("experts", "embed", None),
            "w_up": ("experts", "embed", None),
            "w_down": ("experts", None, "embed")},
    "mamba": {"in_proj": ("embed", "mlp"), "conv_w": (None, "mlp"),
              "conv_b": ("mlp",), "x_proj": ("mlp", None),
              "dt_proj": (None, "mlp"), "dt_bias": ("mlp",),
              "a_log": ("mlp", None), "d_skip": ("mlp",),
              "out_proj": ("mlp", "embed")},
    "mlstm": {"up": ("embed", "mlp"), "wq": ("mlp", None),
              "wk": ("mlp", None), "wv": ("mlp", None),
              "w_i": ("mlp", None), "b_i": (None,), "w_f": ("mlp", None),
              "b_f": (None,), "down": ("mlp", "embed")},
    "slstm": {"w_gates": ("embed", "mlp"), "r_gates": ("embed", "mlp"),
              "b_gates": ("mlp",), "up": ("embed", "mlp"),
              "down": ("mlp", "embed")},
    "norm": {"scale": (None,)},
    "table": {"table": ("vocab", "embed")},
}

# the module names of the port's models -> their kind
_KIND = {"attn": "attn", "self_attn": "attn", "cross": "attn",
         "ffn": "ffn", "moe": "moe", "mamba": "mamba", "mlstm": "mlstm",
         "slstm": "slstm", "embed": "table", "lm_head": "table",
         "ln": "norm", "ln1": "norm", "ln2": "norm", "lnx": "norm",
         "final_ln": "norm", "enc_ln": "norm"}

# cache NamedTuple -> field -> logical axes (attention.py:216-222,
# mamba.py:154-157, xlstm.py:152-156,243); a host int has spec P()
_CACHE_AXES = {
    "KVCache": {"k": ("batch", "kv_seq", "heads", None),
                "v": ("batch", "kv_seq", "heads", None), "length": ()},
    "MambaCache": {"conv": ("batch", None, "mlp"),
                   "ssm": ("batch", "mlp", None)},
    "MLstmCache": {"c": ("batch", "heads", None, None),
                   "n": ("batch", "heads", None)},
    "SLstmCache": {f: ("batch", "heads", None) for f in "cnhm"},
}


def param_axes(name: str) -> tuple:
    """The logical axes of the parameter ``name`` (a ``named_parameters``
    key); raises ``KeyError`` for a parameter the table lacks."""
    parts = name.split(".")
    if len(parts) < 2 or parts[-2] not in _KIND:
        raise KeyError(f"no logical axes for parameter {name!r}")
    table = PARAM_AXES[_KIND[parts[-2]]]
    if parts[-1] not in table:
        raise KeyError(f"no logical axes for parameter {name!r}")
    return table[parts[-1]]


def _checked_axes(name: str, p) -> tuple:
    axes = param_axes(name)
    if len(axes) != p.dim():
        raise ValueError(f"{name}: {tuple(p.shape)} against axes {axes}")
    return axes


def param_specs(model: nn.Module) -> dict:
    """``{name: P}`` for every parameter of ``model`` under the current
    rules and ambient mesh."""
    return {n: shd.spec(*_checked_axes(n, p))
            for n, p in model.named_parameters()}


# parameters the reference keeps in f32 whatever the model's dtype
# (layers.py:14, mamba.py:48-51)
_F32 = {("norm", "scale"), ("mamba", "a_log"), ("mamba", "d_skip")}


def _param_dtype(name: str, dtype: torch.dtype) -> torch.dtype:
    parts = name.split(".")
    return torch.float32 if (_KIND.get(parts[-2]), parts[-1]) in _F32 else (
        dtype)


def param_shapes(model: nn.Module, mesh=None,
                 dtype=torch.bfloat16) -> dict:
    """``{name: Shape}`` of every parameter of ``model`` (a module on the
    meta device costs nothing) in ``dtype`` (the norms' scales and
    Mamba's ``a_log`` and ``d_skip`` in f32, as the reference keeps
    them), laid out on ``mesh``."""
    return {n: make_shape(p.shape, _param_dtype(n, dtype),
                          _checked_axes(n, p), mesh)
            for n, p in model.named_parameters()}


def _cache_map(cache, fn):
    """Apply ``fn(axes, leaf)`` to each leaf of a port cache: a list of
    per-layer NamedTuples, or the audio family's ``{"self", "enc_out"}``."""
    if isinstance(cache, dict):
        return {"self": _cache_map(cache["self"], fn),
                "enc_out": fn(("batch", None, None), cache["enc_out"])}
    out = []
    for c in cache:
        axes = _CACHE_AXES[type(c).__name__]
        out.append(type(c)(*(fn(axes[f], getattr(c, f))
                             for f in c._fields)))
    return out


def cache_specs(cache) -> list | dict:
    """The cache's structure with a ``P`` at every leaf."""
    return _cache_map(cache, lambda axes, x: shd.spec(*axes))


def cache_shapes(cache, mesh=None) -> list | dict:
    """The cache's structure with a :class:`Shape` at every tensor leaf
    (a host int length stays an int)."""
    return _cache_map(cache, lambda axes, x: x if not isinstance(
        x, torch.Tensor) else make_shape(x.shape, x.dtype, axes, mesh))


def distribute_cache(cache, mesh):
    """The cache with every tensor a DTensor laid out by its spec on the
    live ``mesh`` (a host int length stays an int)."""
    return _cache_map(cache, lambda axes, x: x if not isinstance(
        x, torch.Tensor) else shd.distribute(x, shd.spec(*axes), mesh))


@torch.no_grad()
def shard_model(model: nn.Module, mesh) -> nn.Module:
    """Replace every parameter of ``model`` in place by a DTensor laid out
    by ``divisible(spec)`` on the live ``mesh`` (every rank holds the
    same whole model before the call); ``requires_grad`` is kept."""
    specs = param_specs(model)
    for mod_name, mod in model.named_modules():
        for pn, p in list(mod.named_parameters(recurse=False)):
            name = f"{mod_name}.{pn}" if mod_name else pn
            dt = shd.distribute(p.detach(), specs[name], mesh)
            setattr(mod, pn, nn.Parameter(dt, requires_grad=p.requires_grad))
    return model
