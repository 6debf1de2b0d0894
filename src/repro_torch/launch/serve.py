"""Serving driver: LM generation with the distributed-selection sampler,
or the paper's standalone distributed l-NN service.

Port of ``repro.launch.serve``; ``--shards K`` runs the LM sampler over
K vocabulary shards on one device (and the l-NN service over K point
shards), and ``--device`` is the card unless ``cpu`` is given.
``--mesh DxM`` serves the LM (any family) on a (data, model) mesh of
D*M ranks started by ``torchrun`` (NCCL, one card a rank; gloo with
``--device cpu``): the parameters and every layer's cache (KV, Mamba,
mLSTM, sLSTM, the encoder's states) are DTensors laid out by the
sharding rules, each step's logits are gathered once to every rank, and
the sampler runs over M vocabulary shards, so the tokens are those of
``--shards M`` on one device.

  # LM decode, qwen2-0.5b at full width, 8 vocabulary shards:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
      --shards 8

  # reduced, on the CPU (any --arch of repro_torch.configs.registry()):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
      --reduced --tokens 4 --batch 2 --shards 2 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch pixtral-12b \
      --reduced --tokens 4 --batch 2 --shards 2 --device cpu

  # on a 4 x 2 mesh of gloo ranks, and on the card's 1 x 1 mesh:
  PYTHONPATH=src torchrun --nproc_per_node=8 -m repro_torch.launch.serve \
      --arch qwen2-0.5b --reduced --tokens 4 --batch 4 --mesh 4x2 \
      --device cpu
  PYTHONPATH=src torchrun --nproc_per_node=1 -m repro_torch.launch.serve \
      --arch qwen2-0.5b --mesh 1x1
  PYTHONPATH=src torchrun --nproc_per_node=1 -m repro_torch.launch.serve \
      --arch granite-moe-3b-a800m --mesh 1x1 --batch 8 --prompt 128 \
      --tokens 8

  # the paper's artifact: distributed l-NN queries over a sharded corpus
  PYTHONPATH=src python -m repro_torch.launch.serve --arch knn-service \
      --knn-k 8
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.distributed as dist

import repro_torch.configs as configs
from repro_torch import convert
from repro_torch.core import knn as knn_mod
from repro_torch.core.topk import generator
from repro_torch.data import gaussian_clusters
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import debug_mesh
from repro_torch.models import build_model, creator
from repro_torch.runtime import ServeConfig, Server


def stub_inputs(cfg, rng, batch: int) -> dict:
    """The modality stubs of the reference's launcher: random
    ``prefix_embeds`` (vlm) or ``frames`` (audio) for ``batch`` rows."""
    out = {}
    if cfg.family == "vlm":
        out["prefix_embeds"] = rng.normal(
            size=(batch, cfg.num_prefix_embeds, cfg.d_model)).astype(
                np.float32)
    if cfg.is_encdec:
        out["frames"] = rng.normal(
            size=(batch, cfg.frontend_frames, cfg.d_model)).astype(
                np.float32)
    return out


def serve_lm(args):
    """Seeded random model, random prompts (with the family's stub),
    ``Server.generate``; returns ``(generated tokens, stats)``.  The
    cache holds the vlm prefix too (the reference's launcher leaves it
    out of ``max_seq``).  Under ``--mesh`` every rank returns the same
    tokens and rank 0 prints them."""
    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    api = build_model(cfg)
    with debug_mesh(args.mesh, args.device) as (dev, mesh):
        return _serve_lm(args, cfg, api, dev, mesh)


def _serve_lm(args, cfg, api, dev, mesh):
    rng = np.random.default_rng(args.seed)
    batch = {"tokens": rng.integers(0, cfg.vocab,
                                    (args.batch, args.prompt)).astype(
                                        np.int32)}
    batch.update(stub_inputs(cfg, rng, args.batch))
    prefix = cfg.num_prefix_embeds if cfg.family == "vlm" else 0
    scfg = ServeConfig(max_seq=prefix + args.prompt + args.tokens + 8,
                       top_k=args.top_k, sampler=args.sampler,
                       num_pivots=args.num_pivots)
    params = api.init_params(args.seed, device=dev)
    if mesh is not None:
        creator.shard_model(params, mesh)
    server = Server(api, params, scfg, shards=args.shards)
    gen, stats = server.generate(batch, args.tokens, key=args.seed + 1)
    if not dist.is_initialized() or dist.get_rank() == 0:
        print("generated tokens:\n", gen)
        print({k: round(v, 4) for k, v in stats.items()})
    return gen, stats


def serve_knn(args):
    """The paper's own service: l-NN queries against a sharded point set,
    classified by a vote of the winners' labels; returns ``(predicted
    classes, (B, l) distances, (B, l) ids)``."""
    kcfg = configs.get("knn-service")
    dev = resolve_device(args.device)
    k = args.shards or 8
    n = min(kcfg.n_points, args.knn_points)
    n -= n % k
    pts, labels = gaussian_clusters(n, kcfg.dim, kcfg.num_classes,
                                    seed=args.seed)
    points, ids, _, lab = convert.shards_from_numpy(pts, k, labels=labels,
                                                    device=dev)
    l = args.knn_k
    rng = np.random.default_rng(args.seed + 7)
    qs = rng.normal(scale=8.0, size=(kcfg.query_batch, kcfg.dim)).astype(
        np.float32)
    q = torch.from_numpy(qs).to(dev)
    t0 = time.perf_counter()
    res = knn_mod.knn_query(points, ids, q, l, generator(3, dev),
                            num_pivots=args.num_pivots, gather_results=True,
                            point_labels=lab)
    pred, _ = knn_mod.knn_classify(res.mask, res.local_labels.long(),
                                   kcfg.num_classes)
    pred = pred.cpu().numpy()
    dt = time.perf_counter() - t0
    print(f"l-NN over {n} points sharded {k} ways: l={l} "
          f"iterations={res.selection.iterations} wall={dt*1e3:.1f}ms")
    print("predicted classes:", pred)
    d = res.dists.cpu().numpy()
    print("nearest distances (q0):", np.sort(d[0])[:5])
    return pred, d, res.ids.cpu().numpy()


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--top-k", type=int, default=50)
    ap.add_argument("--sampler", default="selection",
                    choices=["selection", "gather"])
    ap.add_argument("--num-pivots", type=int, default=1)
    # a mesh samples over its model axis: the two options are one choice
    shards_or_mesh = ap.add_mutually_exclusive_group()
    shards_or_mesh.add_argument(
        "--shards", type=int, default=None,
        help="vocabulary shards of the LM sampler (none: plain top-k), or "
             "point shards of the l-NN service (default 8)")
    shards_or_mesh.add_argument(
        "--mesh", default=None,
        help="'DxM': serve the LM on a data x model mesh of D*M ranks "
             "(torchrun --nproc_per_node=D*M), sampling over M vocabulary "
             "shards")
    ap.add_argument("--device", default=None,
                    help="torch device; the card when omitted")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--knn-k", type=int, default=8)
    ap.add_argument("--knn-points", type=int, default=1 << 16)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.arch in ("knn-service", "knn_service"):
        return serve_knn(args)
    return serve_lm(args)


if __name__ == "__main__":
    main()
