"""Unified model API: one object per architecture.

Port of ``repro.models.model``.  ``serve_step`` is where the paper's
technique is first-class in the LM stack: with ``shards=k`` the decode
logits are held as k vocabulary shards (``core.topk.shard_vocab``, -inf
padding up to a multiple of k) and the next token comes from
``core.topk.topk_sample``, the distributed-selection sampler (or its
gather baseline); with ``shards=None`` it is plain top-k sampling over
the whole row, the reference's no-mesh path.

The parameters are a module: a
:class:`~repro_torch.models.transformer.Transformer` for the
decoder-only families (dense, moe, hybrid, vlm, ssm), an
:class:`~repro_torch.models.encdec.EncDec` for the audio family; its
device is where every step runs.  A batch may carry the modality stubs,
``prefix_embeds`` (vlm) and ``frames`` (audio), as the reference's does.
The serving entry points run without autograd; ``loss_fn`` is the
training step's, on a module made with ``init_params(train=True)``.

Under a mesh the parameters are DTensors (``creator.shard_model``) and
every entry point runs under their mesh (``sharding.set_mesh``): the
batch is split on its batch axes, the activations follow the rules'
``constrain`` points, and ``prefill`` / ``decode_step`` gather the
vocabulary-sharded logits once a step, so the sampler sees whole rows.
The layouts of parameters, caches and inputs come without allocation
from ``param_specs`` / ``param_shapes``, ``cache_specs`` /
``cache_shapes`` and ``input_specs`` (``models/creator.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import topk as topk_mod
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models import creator, encdec, transformer
from repro_torch.models import sharding as shd
from repro_torch.models.config import InputShape, ModelConfig


def mesh_of(params):
    """The live mesh the model's parameters are DTensors on, or None."""
    t = params.embed.table
    return t.device_mesh if shd.is_dtensor(t) else None


def _mesh_scope(params):
    """Make a sharded model's mesh ambient (if it is not already)."""
    mesh = mesh_of(params)
    if mesh is None or shd.current_mesh() is mesh:
        return contextlib.nullcontext()
    return shd.set_mesh(mesh)


def _tokens(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(x), dtype=torch.int64, device=device)


def _inputs(params, batch: dict) -> dict:
    """``batch``'s tokens (int64), labels and modality stubs (the model's
    dtype) and mask as tensors on the model's device; for a sharded
    model, DTensors split on their batch axes (every rank holds the same
    whole batch, and keeps its block)."""
    table = params.embed.table
    out = {}
    for k in ("tokens", "labels"):
        if k in batch:
            out[k] = _tokens(batch[k], table.device)
    for k in ("prefix_embeds", "frames"):
        if batch.get(k) is not None:
            out[k] = torch.as_tensor(batch[k], device=table.device).to(
                table.dtype)
    if batch.get("mask") is not None:
        out["mask"] = torch.as_tensor(batch["mask"], device=table.device)
    mesh = mesh_of(params)
    if mesh is not None:
        out = {k: shd.distribute(v, shd.spec("batch", *[None] * (
            v.dim() - 1)), mesh) for k, v in out.items()}
    return out


@dataclasses.dataclass(frozen=True)
class ModelApi:
    cfg: ModelConfig

    # ---- parameters -------------------------------------------------------
    def init_params(self, seed: int = 0, device=None, train: bool = False):
        """A seeded random f32 model on ``device`` (the card when None):
        for serving, no autograd; with ``train``, trainable parameters.
        On the meta device the module is built and left unfilled."""
        dev = resolve_device(device)
        cls = encdec.EncDec if self.cfg.is_encdec else transformer.Transformer
        model = cls(self.cfg, device=dev)
        if dev.type != "meta":
            g = torch.Generator(device=dev)
            g.manual_seed(int(seed))
            transformer.init_params(model, g)
        return model.requires_grad_(train).train(train)

    # ---- steps ------------------------------------------------------------
    def loss_fn(self, params, batch, remat: bool = True):
        """``(loss, {"ce", "aux"})`` of ``batch`` (``tokens``, ``labels``,
        optional ``mask``, the family's stub; numpy or tensors) under the
        model ``params``."""
        with _mesh_scope(params):
            b = _inputs(params, batch)
            if self.cfg.is_encdec:
                return encdec.loss_fn(params, b, remat=remat)
            return transformer.loss_fn(params, b, remat=remat)

    def forward(self, params, batch):
        """``(logits (B, S, V), aux_loss)`` over ``batch["tokens"]`` (and
        the vlm prefix, whose positions the logits include)."""
        with _mesh_scope(params):
            b = _inputs(params, batch)
            if self.cfg.is_encdec:
                return encdec.forward(params, b["tokens"], b["frames"])
            return transformer.forward(params, b["tokens"],
                                       b.get("prefix_embeds"))

    @torch.no_grad()
    def prefill(self, params, batch, cache):
        """``(last-position logits (B, V), cache)``; the logits whole on
        every rank under a mesh."""
        with _mesh_scope(params):
            b = _inputs(params, batch)
            if self.cfg.is_encdec:
                out = encdec.prefill(params, b["tokens"], b["frames"], cache)
            else:
                out = transformer.prefill(params, b["tokens"], cache,
                                          b.get("prefix_embeds"))
            return shd.gathered(out[0]), out[1]

    @torch.no_grad()
    def decode_step(self, params, token, cache):
        """``(logits (B, V), cache)``; the logits whole on every rank under
        a mesh (the one gather of a step)."""
        with _mesh_scope(params):
            tok = _inputs(params, {"tokens": token})["tokens"]
            if self.cfg.is_encdec:
                out = encdec.decode_step(params, tok, cache)
            else:
                out = transformer.decode_step(params, tok, cache)
            return shd.gathered(out[0]), out[1]

    @torch.no_grad()
    def serve_step(self, params, token, cache, key: int, *, shards=None,
                   top_k: int = 50, temperature: float = 0.8,
                   sampler: str = "selection", num_pivots: int = 1,
                   observe=None):
        """decode_step + the paper's distributed top-k sampler ->
        ``(next tokens (B,) int32, cache)``.

        ``shards=k``: the sampler runs over k vocabulary shards (module
        docstring); ``None``: plain top-k sampling over the row.  For a
        sharded model the shards are its ``model`` axis (``None`` or that
        axis's size; another count raises).
        ``key``: the step's int seed.  ``observe`` (optional) is called
        with the step's ``(logits (B, V), core.topk.TopKResult)``.
        """
        mesh = mesh_of(params)
        if mesh is not None:
            axis = shd.mesh_axes(mesh).get("model", 1)
            if shards not in (None, axis):
                raise ValueError(f"shards={shards} on a mesh whose model "
                                 f"axis is {axis}")
            shards = axis
        logits, new_cache = self.decode_step(params, token, cache)
        look = None if observe is None else (lambda r: observe(logits, r))
        if shards is None:
            v, idx = kops.local_topk((-logits.float()).contiguous(), top_k)
            res = topk_mod.TopKResult(values=-v, indices=idx, iterations=0)
            if look is not None:
                look(res)
            choice = topk_mod.categorical(
                topk_mod.generator(key, logits.device),
                res.values / max(temperature, 1e-6))
            nxt = res.indices.gather(-1, choice[:, None])[:, 0]
            return nxt.to(torch.int32), new_cache
        sampled = topk_mod.topk_sample(
            topk_mod.shard_vocab(logits, shards), top_k, temperature, key,
            method=sampler, num_pivots=num_pivots, observe=look)
        return sampled.to(torch.int32), new_cache

    # ---- caches -----------------------------------------------------------
    def init_cache(self, batch: int, s_max: int, dtype=torch.float32,
                   device=None, mesh=None):
        """The decoder's cache: a list of per-layer caches, or for the
        audio family ``{"self": [...], "enc_out"}``; on a live ``mesh``
        every buffer a DTensor laid out by its cache spec."""
        mod = encdec if self.cfg.is_encdec else transformer
        cache = mod.init_cache(self.cfg, batch, s_max, dtype=dtype,
                               device=resolve_device(device))
        if mesh is None:
            return cache
        with shd.set_mesh(mesh):
            return creator.distribute_cache(cache, mesh)

    # ---- layouts (no allocation) -------------------------------------------
    def param_specs(self) -> dict:
        """``{parameter name: P}`` under the current rules and mesh."""
        return creator.param_specs(self.init_params(device="meta"))

    def param_shapes(self, mesh=None, dtype=torch.bfloat16) -> dict:
        """``{parameter name: sharding.Shape}`` in ``dtype`` on ``mesh``."""
        return creator.param_shapes(self.init_params(device="meta"), mesh,
                                    dtype)

    def cache_specs(self, batch: int, s_max: int):
        return creator.cache_specs(self.init_cache(batch, s_max,
                                                   device="meta"))

    def cache_shapes(self, batch: int, s_max: int, mesh=None,
                     dtype=torch.bfloat16):
        return creator.cache_shapes(self.init_cache(
            batch, s_max, dtype=dtype, device="meta"), mesh)

    def input_specs(self, shape: InputShape, mesh=None,
                    dtype=torch.bfloat16) -> dict[str, Any]:
        """:class:`sharding.Shape` stand-ins for every model input of the
        (arch x shape) cell: the decode token, or the tokens (and labels
        for training) with the family's stub, ``prefix_embeds`` (vlm) or
        ``frames`` (audio), in ``dtype``."""
        cfg = self.cfg
        gb, S = shape.global_batch, shape.seq_len

        def arr(shp, dt, *axes):
            return shd.make_shape(shp, dt, axes, mesh)

        if shape.kind == "decode":
            return {"token": arr((gb,), torch.int32, "batch")}
        specs: dict[str, Any] = {}
        s_text = S
        if cfg.family == "vlm":
            s_text = S - cfg.num_prefix_embeds
            specs["prefix_embeds"] = arr(
                (gb, cfg.num_prefix_embeds, cfg.d_model), dtype,
                "batch", None, None)
        if cfg.is_encdec:
            specs["frames"] = arr((gb, cfg.frontend_frames, cfg.d_model),
                                  dtype, "batch", None, None)
        specs["tokens"] = arr((gb, s_text), torch.int32, "batch", None)
        if shape.kind == "train":
            specs["labels"] = arr((gb, s_text), torch.int32, "batch", None)
        return specs


def build_model(cfg: ModelConfig) -> ModelApi:
    return ModelApi(cfg=cfg)
