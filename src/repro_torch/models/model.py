"""Unified model API: one object per architecture.

Port of ``repro.models.model``.  ``serve_step`` is where the paper's
technique is first-class in the LM stack: with ``shards=k`` the decode
logits are held as k vocabulary shards (``core.topk.shard_vocab``, -inf
padding up to a multiple of k) and the next token comes from
``core.topk.topk_sample``, the distributed-selection sampler (or its
gather baseline); with ``shards=None`` it is plain top-k sampling over
the whole row, the reference's no-mesh path.

The parameters are a :class:`~repro_torch.models.transformer.Transformer`
module; its device is where every step runs.  The serving entry points
run without autograd; ``loss_fn`` is the training step's, on a module
made with ``init_params(train=True)``.  Families other than dense raise
``NotImplementedError`` in :func:`build_model`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import topk as topk_mod
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig

# where the port's queue of work takes up each family it does not run yet
_LATER = {
    "moe": "ROADMAP.md queue 1, item 8b (moe: granite, phi3.5)",
    "vlm": "ROADMAP.md queue 1, item 8b (vlm: pixtral)",
    "hybrid": "ROADMAP.md queue 1, item 8b (hybrid: jamba, with mamba.py)",
    "ssm": "ROADMAP.md queue 1, item 8b (ssm: xlstm)",
    "audio": "ROADMAP.md queue 1, item 8b (audio: seamless)",
}


def _tokens(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(x), dtype=torch.int64, device=device)


@dataclasses.dataclass(frozen=True)
class ModelApi:
    cfg: ModelConfig

    # ---- parameters -------------------------------------------------------
    def init_params(self, seed: int = 0, device=None,
                    train: bool = False) -> transformer.Transformer:
        """A seeded random f32 model on ``device`` (the card when None):
        for serving, no autograd; with ``train``, trainable parameters."""
        dev = resolve_device(device)
        model = transformer.Transformer(self.cfg, device=dev)
        g = torch.Generator(device=dev)
        g.manual_seed(int(seed))
        transformer.init_params(model, g)
        return model.requires_grad_(train).train(train)

    # ---- steps ------------------------------------------------------------
    def loss_fn(self, params, batch, remat: bool = True):
        """``(loss, {"ce", "aux"})`` of ``batch`` (``tokens``, ``labels``,
        optional ``mask``; numpy or tensors) under the model ``params``."""
        dev = params.embed.table.device
        b = {"tokens": _tokens(batch["tokens"], dev),
             "labels": _tokens(batch["labels"], dev)}
        if batch.get("mask") is not None:
            b["mask"] = torch.as_tensor(batch["mask"], device=dev)
        return transformer.loss_fn(params, b, remat=remat)

    def forward(self, params, batch):
        """``(logits (B, S, V), aux_loss)`` over ``batch["tokens"]``."""
        return transformer.forward(params, _tokens(
            batch["tokens"], params.embed.table.device))

    @torch.no_grad()
    def prefill(self, params, batch, cache):
        return transformer.prefill(params, _tokens(
            batch["tokens"], params.embed.table.device), cache)

    @torch.no_grad()
    def decode_step(self, params, token, cache):
        return transformer.decode_step(params, _tokens(
            token, params.embed.table.device), cache)

    @torch.no_grad()
    def serve_step(self, params, token, cache, key: int, *, shards=None,
                   top_k: int = 50, temperature: float = 0.8,
                   sampler: str = "selection", num_pivots: int = 1,
                   observe=None):
        """decode_step + the paper's distributed top-k sampler ->
        ``(next tokens (B,) int32, cache)``.

        ``shards=k``: the sampler runs over k vocabulary shards (module
        docstring); ``None``: plain top-k sampling over the row.
        ``key``: the step's int seed.  ``observe`` (optional) is called
        with the step's ``(logits (B, V), core.topk.TopKResult)``.
        """
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
                   device=None) -> list:
        return transformer.init_cache(self.cfg, batch, s_max, dtype=dtype,
                                      device=resolve_device(device))


def build_model(cfg: ModelConfig) -> ModelApi:
    """The dense family's API; other families raise, naming the queue
    item that ports them."""
    family = "audio" if cfg.is_encdec else cfg.family
    if family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the port does not run family {family!r} yet; "
            f"{_LATER.get(family, 'ROADMAP.md queue 1, item 8b')} ports it")
    return ModelApi(cfg=cfg)
