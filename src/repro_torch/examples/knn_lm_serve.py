"""kNN-LM serving through the micro-batched query service.

Port of the repository's ``examples/knn_lm_serve.py``.  A seeded LM
decodes while a ``KnnServer`` fronts the sharded (hidden-state key,
next-token value) datastore.  Each decode step:

  1. ``decode_step`` gives the LM's ``(B, V)`` logits;
  2. the B query states are *submitted* to the service, whose
     micro-batcher coalesces them into one device batch and runs
     Algorithm 2 (or the simple method, with its ``sampler="gather"``);
  3. the winners come back as (token value, distance) per request, the
     values looked up host-side from the global ids;
  4. the sparse kNN mass is scattered into the vocabulary-sharded logits
     (``core.datastore.interp_logits``) and the token is drawn by the
     distributed-selection top-k sampler (``core.topk.topk_sample``).

The query is the current token's embedding, a stand-in for the hidden
state that a deployment would tap before the unembedding, as in the
reference.  The LM and the datastore are independent services, coupled
only by (query vector in, l winners out).

  PYTHONPATH=src python -m repro_torch.examples.knn_lm_serve            # card
  PYTHONPATH=src python -m repro_torch.examples.knn_lm_serve --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

import repro_torch.configs as configs
from repro_torch.configs.knn_service import CONFIG as KNN_CONFIG
from repro_torch.core import datastore, topk
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.models.layers import embed
from repro_torch.runtime import KnnServer

L = 8              # neighbours per step
LAM = 0.35         # kNN interpolation weight
TEMP = 10.0        # kNN softmax temperature
STEPS = 12
B = 4              # decode batch = requests per service flush
TOP_K = 16         # the sampler's k
SAMPLE_TEMP = 0.8  # the sampler's temperature
VOCAB_SHARDS = 2   # the reference's model axis (its 4x2 mesh)
STORE_SHARDS = 8   # the datastore service's shards
N_KEYS = 2 * 4096  # datastore size


def datastore_server(keys, values, *, l_max: int = L, batch: int = B,
                     sampler: str = "selection", device=None) -> KnnServer:
    """A static ``KnnServer`` over ``(N, d)`` keys with their ``(N,)``
    token values, k = ``STORE_SHARDS``, route exact, buckets ``(1, 2,
    batch)``."""
    cfg = KNN_CONFIG.replace(dim=int(keys.shape[1]), l=min(L, l_max),
                             l_max=l_max, sampler=sampler,
                             bucket_sizes=tuple(sorted({1, 2, batch})))
    return KnnServer(keys, values, cfg=cfg, shards=STORE_SHARDS,
                     device=device)


def knn_lm_decode(api, params, server: KnnServer, prompt, steps: int, *,
                  l: int = L, shards: int = VOCAB_SHARDS, observe=None):
    """Prefill ``prompt`` ``(B, S)``, then ``steps`` kNN-LM steps through
    ``server`` (which must be serving: ``with server.serving()``), l
    neighbours a step, the LM's vocabulary over ``shards``.

    Returns ``(generated (B, steps + 1) int32, last retrieval's selection
    iterations)``.  ``observe`` (optional) is called after each step
    with ``(i, dict)``: the step's ``lm_logits`` (B, V), ``queries``
    (B, d), the service ``results``, the ``retrieval``
    (``datastore.RetrievalResult`` on the device), ``mixed`` (the
    sharded log-mixture) and the drawn ``token``.
    """
    dev = params.embed.table.device
    nb, s = prompt.shape
    cache = api.init_cache(nb, s + steps + 8, device=dev)
    logits, cache = api.prefill(params, {"tokens": prompt}, cache)
    tok = torch.argmax(logits, -1).to(torch.int32)
    out = [tok.cpu().numpy()]
    iters = 0
    for i in range(steps):
        lm_logits, cache = api.decode_step(params, tok, cache)
        h = embed(params.embed.table, tok).cpu().numpy()
        # one service request per sequence; the micro-batcher coalesces
        # all of them into one bucketed device batch
        futs = [server.submit(h[b], l) for b in range(nb)]
        res = [f.result(timeout=600) for f in futs]
        iters = res[0].iterations
        toks = np.stack([np.where(r.values < 0, 0, r.values)
                         for r in res]).astype(np.int32)
        dists = np.stack([r.dists for r in res])
        logit = np.where(np.isfinite(dists), -dists / TEMP,
                         -np.inf).astype(np.float32)
        ret = datastore.RetrievalResult(
            tokens=torch.from_numpy(toks).to(dev),
            weights=torch.softmax(torch.from_numpy(logit).to(dev), -1),
            dists=torch.from_numpy(dists).to(dev), iterations=iters)
        mixed = datastore.interp_logits(
            topk.shard_vocab(lm_logits, shards), ret, LAM)
        tok = topk.topk_sample(mixed, TOP_K, SAMPLE_TEMP,
                               100 + i).to(torch.int32)
        if observe is not None:
            observe(i, dict(lm_logits=lm_logits, queries=h, results=res,
                            retrieval=ret, mixed=mixed, token=tok))
        out.append(tok.cpu().numpy())
    return np.stack(out, 1), iters


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device; the card when omitted")
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--sampler", default="selection",
                    choices=["selection", "gather"],
                    help="the datastore service's sampler")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = configs.get("qwen2-0.5b").reduced()
    api = build_model(cfg)
    rng = np.random.default_rng(0)

    # synthetic datastore: (hidden-state key, next-token value) pairs
    keys = rng.normal(size=(N_KEYS, cfg.d_model)).astype(np.float32)
    values = rng.integers(0, cfg.vocab, size=(N_KEYS,)).astype(np.int32)
    server = datastore_server(keys, values, sampler=args.sampler,
                              device=dev)
    server.warmup()
    params = api.init_params(0, device=dev)
    prompt = rng.integers(0, cfg.vocab, (B, 8)).astype(np.int32)
    with server.serving():
        gen, iters = knn_lm_decode(api, params, server, prompt, args.steps)
    print(f"kNN-LM decode with lam={LAM}, l={L} over a {N_KEYS}-key datastore "
          f"served by the micro-batched query service "
          f"({server.stats.batches} batches for "
          f"{server.stats.queries} retrievals; last retrieval took "
          f"{iters} selection rounds)")
    print("generated token ids:")
    print(gen)
    return gen


if __name__ == "__main__":
    main()
