"""Serving engine: batched prefill, then decode with the distributed
sampler.

Port of ``repro.runtime.server``.  The first token is the argmax of the
prefill logits; every later one goes through ``ModelApi.serve_step``,
i.e. the paper's distributed top-k over the vocabulary shards
(``shards=k``; the gather baseline with ``sampler="gather"``) or plain
top-k sampling (``shards=None``).  Host<->device traffic is one int32
token per sequence per step.  Step i draws with the seed
``core.topk.fold_in(key, i)``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core.topk import fold_in
from repro_torch.models.model import mesh_of


@dataclasses.dataclass
class ServeConfig:
    max_seq: int = 2048
    top_k: int = 50
    temperature: float = 0.8
    sampler: str = "selection"     # "selection" (paper) | "gather" (baseline)
    num_pivots: int = 1


class Server:
    """``api``: a ``models.ModelApi``; ``params``: its model, whose device
    the server runs on; ``shards``: vocabulary shards of the sampler
    (None: plain top-k; a model sharded on a mesh, whose cache is laid
    out by its specs, samples over its ``model`` axis, and another count
    raises).  ``observe`` (optional) is handed to every
    ``serve_step`` (``(logits, TopKResult)`` per decode step).  The
    decoder's cache is f32 and holds ``scfg.max_seq`` positions, the vlm
    prefix's among them."""

    def __init__(self, api, params, scfg: ServeConfig, *,
                 shards: Optional[int] = None, observe=None):
        if scfg.sampler not in ("selection", "gather"):
            raise ValueError(f"unknown sampler {scfg.sampler!r}")
        self.api = api
        self.params = params
        self.scfg = scfg
        self.shards = shards
        self.observe = observe
        self.device = params.embed.table.device

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def generate(self, batch: dict, max_new_tokens: int,
                 key: Optional[int] = None):
        """``batch``: ``{"tokens": (B, S) int}``, with the family's stub
        (``prefix_embeds`` or ``frames``), all handed to the prefill.
        Returns ``(generated (B, max_new_tokens) int32 numpy, stats)``;
        stats as the reference's: ``prefill_s``, ``decode_s``,
        ``tok_per_s``."""
        key = 0 if key is None else int(key)
        scfg = self.scfg
        B = batch["tokens"].shape[0]
        cache = self.api.init_cache(B, scfg.max_seq, device=self.device,
                                    mesh=mesh_of(self.params))
        self._sync()
        t0 = time.perf_counter()
        logits, cache = self.api.prefill(self.params, batch, cache)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out = [tok.cpu().numpy()]
        prefill_s = time.perf_counter() - t0

        t1 = time.perf_counter()
        for i in range(max_new_tokens - 1):
            tok, cache = self.api.serve_step(
                self.params, tok, cache, fold_in(key, i), shards=self.shards,
                top_k=scfg.top_k, temperature=scfg.temperature,
                sampler=scfg.sampler, num_pivots=scfg.num_pivots,
                observe=self.observe)
            out.append(tok.cpu().numpy())
        decode_s = time.perf_counter() - t1
        gen = np.stack(out, axis=1).astype(np.int32)
        return gen, {"prefill_s": prefill_s, "decode_s": decode_s,
                     "tok_per_s": B * max(max_new_tokens - 1, 1)
                     / max(decode_s, 1e-9)}
