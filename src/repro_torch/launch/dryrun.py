"""Multi-pod dry-run: every (arch x shape x mesh) cell laid out and costed
on the meta device, with no allocation.

Port of ``repro.launch.dryrun``.  The reference lowers and compiles each
cell on 256 or 512 placeholder devices and reads XLA's memory and cost
analyses.  The port has no compiler to ask, so for each architecture and
each of its input shapes, on the (16, 16) single-pod and (2, 16, 16)
multi-pod meshes (``launch/mesh.py``, abstract meshes), it

  1. lays out the parameters, optimizer state, gradient-accumulation
     buffer, caches and inputs by the sharding rules
     (``models/creator.py``; ``rules_for_shape`` and ``grad_accum_for``
     as the reference's) and sums each device's bytes; the parameters
     are bf16, the moments and accumulation buffer f32, or bf16 above
     100 B parameters, as in the reference;
  2. counts the cell's step on the meta device with ``launch/cost.py``:
     the train step (microbatched, remat, AdamW), the prefill, or one
     decode step.  The step is counted at batch 1 on models of one and
     two layer-pattern periods (for the encoder-decoder, one and two
     layers of each stack), at three sequence lengths, and carried
     to the full depth (costs are linear in the depth), the full length
     (``cost.extrapolate``) and the batch (linear); the activations a
     training device keeps are what autograd saves outside the
     rematerialised layers plus each layer's checkpointed input, and a
     serving step's are its largest live set (one layer's, taken on a
     line in S from the two longest counts);
  3. records per-device FLOPs and HBM bytes (the counted step over the
     devices), the collective wire bytes of the sharding plan, the
     roofline on an H100 (``cost.Roofline``), the 6ND model FLOPs, and
     ``fits``: the device's bytes against the card's 80 GB.

The decode step's sampler runs a data-dependent selection loop, which
the meta device cannot drive; its body is counted once, as one read of
the step's logits, as the reference's counter counts a while loop's
body once.  Per-device activations are counted with the model axis
unsplit (an upper bound).  The port holds only the real heads and
experts, so for an arch the reference pads the record gives the port's
bytes and names the reference's padded layout beside them.  A failing
cell is recorded as FAIL with its error.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
      --results-dir results/dryrun_torch
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch

import repro_torch.configs as configs
from repro_torch.launch import cost
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model, creator, shapes_for
from repro_torch.models import sharding as shd
from repro_torch.models.config import ALL_SHAPES
from repro_torch.models.sharding import Rules, use_rules
from repro_torch.models.transformer import superblock_size
from repro_torch.optim import AdamW
from repro_torch.runtime import TrainConfig, make_train_step

ARCHS = [
    "qwen2.5-14b", "qwen1.5-4b", "qwen2-0.5b", "yi-6b",
    "phi3.5-moe-42b-a6.6b", "granite-moe-3b-a800m", "jamba-1.5-large-398b",
    "pixtral-12b", "seamless-m4t-large-v2", "xlstm-125m",
]

PARAM_DTYPE = torch.bfloat16
# sequence lengths the step is counted at: multiples of the attention's
# query chunk (512), of the Mamba chunk (16) and of the mLSTM chunk (64),
# each at least two chunks long (one chunk skips the join of the chunks'
# outputs), where FLOPs and bytes are quadratics in S; shorter ones for
# the attention-free family
LENGTHS = (1024, 1536, 2048)
SSM_LENGTHS = (128, 192, 256)


def rules_for_shape(shape, cfg=None, model_ways: int = 16):
    """Per-shape sharding-rule overrides (the reference's)."""
    if shape.name == "long_500k":
        # batch 1 is unshardable: shard the KV/state sequence axis instead
        return Rules(batch=None, kv_seq="data")
    if shape.kind == "decode" and cfg is not None:
        # flash decode: where the KV heads cannot tile the model axis,
        # shard the cache's sequence over model instead (not the hybrid)
        flash = (cfg.n_kv_phys % model_ways != 0
                 and cfg.family != "hybrid")
        if flash:
            return Rules(kv_seq="model", heads=None)
    return Rules()


def data_ways(mesh) -> int:
    sizes = shd.mesh_axes(mesh)
    return sizes.get("pod", 1) * sizes.get("data", 1)


def grad_accum_for(cfg, shape, mesh) -> int:
    """Microbatch count: bounded per-microbatch tokens, at least one
    sequence a data shard (the reference's rule)."""
    max_accum = max(1, shape.global_batch // data_ways(mesh))
    target = 8 if cfg.d_model <= 6000 else 16
    return min(target, max_accum)


def model_flops(cfg, shape) -> float:
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch


def is_big(cfg) -> bool:
    """Above 100 B parameters the reference keeps bf16 moments and a bf16
    accumulation buffer."""
    return cfg.param_count() > 100e9


# ---- counting on the meta device -------------------------------------------

def _periods(cfg) -> int:
    return cfg.n_layers // superblock_size(cfg)


def _full_depth(cfg) -> tuple:
    """The depth: (encoder layers, decoder layers) for the
    encoder-decoder, else (periods of the layer pattern,)."""
    if cfg.is_encdec:
        return (cfg.n_enc_layers, cfg.n_layers)
    return (_periods(cfg),)


def _depths(cfg) -> list:
    """The depths the step is counted at: one period, then each stack one
    period deeper (a model of no layers saves one tensor less, so the
    line starts at one)."""
    if cfg.is_encdec:
        return [(1, 1), (2, 1), (1, 2)]
    return [(1,), (2,)]


def _at_depth(cfg, depth: tuple):
    """``cfg`` cut to ``depth`` (see :func:`_full_depth`)."""
    if cfg.is_encdec:
        return dataclasses.replace(cfg, n_enc_layers=depth[0],
                                   n_layers=depth[1])
    return dataclasses.replace(cfg, n_layers=depth[0] * superblock_size(cfg))


def _stub_shapes(cfg, batch: int) -> dict:
    out = {}
    if cfg.family == "vlm":
        out["prefix_embeds"] = (batch, cfg.num_prefix_embeds, cfg.d_model)
    if cfg.is_encdec:
        out["frames"] = (batch, cfg.frontend_frames, cfg.d_model)
    return out


def _meta_batch(cfg, batch: int, seq: int, labels: bool,
                dtype=PARAM_DTYPE) -> dict:
    """A batch of ``seq`` positions on the meta device; for the vlm the
    prefix counts against ``seq``, as in ``input_specs``."""
    s_text = seq - (cfg.num_prefix_embeds if cfg.family == "vlm" else 0)
    b = {"tokens": torch.zeros(batch, s_text, dtype=torch.int64,
                               device="meta")}
    if labels:
        b["labels"] = torch.zeros(batch, s_text, dtype=torch.int64,
                                  device="meta")
    for k, shp in _stub_shapes(cfg, batch).items():
        b[k] = torch.zeros(shp, dtype=dtype, device="meta")
    return b


def count_step(cfg, kind: str, batch: int, seq: int, *, grad_accum: int = 1,
               dtype=PARAM_DTYPE, moment_dtype=torch.float32,
               accum_dtype=torch.float32):
    """``(Cost, saved bytes, resident bytes)`` of one step of ``kind``
    (train, prefill or decode) counted on the meta device: a train step
    is ``runtime.make_train_step``'s (``grad_accum`` microbatches, remat,
    AdamW); the resident bytes are the parameters and moments (train) or
    the parameters and cache."""
    api = build_model(cfg)
    params = api.init_params(device="meta", train=kind == "train").to(dtype)
    pbytes = sum(p.numel() * p.element_size() for p in params.parameters())
    n = sum(p.numel() for p in params.parameters())
    if kind == "train":
        opt = AdamW(moment_dtype=moment_dtype)
        tcfg = TrainConfig(grad_accum=grad_accum, total_steps=10000,
                           accum_dtype=accum_dtype)
        named = dict(params.named_parameters())
        state = (opt.init(named), None, torch.zeros((), dtype=torch.int32))
        step = make_train_step(api, tcfg, opt)
        batch_ = _meta_batch(cfg, batch, seq, True, dtype)
        resident = pbytes + n * (2 * torch.empty((), dtype=moment_dtype
                                                 ).element_size())
        with cost.CostMode() as m:
            step(params, state, batch_)
        return cost.Cost(m.flops, m.bytes, m.peak_bytes, m.ops), m.saved, (
            resident)
    cache = api.init_cache(batch, seq + (1 if kind == "decode" else 0),
                           dtype=dtype, device="meta")
    resident = pbytes + _tree_bytes(cache)
    if kind == "prefill":
        with cost.CostMode() as m:
            api.prefill(params, _meta_batch(cfg, batch, seq, False, dtype),
                        cache)
    else:
        cache = _filled(cache, seq)
        token = torch.zeros(batch, dtype=torch.int64, device="meta")
        with cost.CostMode() as m:
            logits, _ = api.decode_step(params, token, cache)
        # the sampler's body once: one read of the logits
        m.bytes += logits.numel() * 4
    return cost.Cost(m.flops, m.bytes, m.peak_bytes, m.ops), 0, resident


def _filled(cache, length: int):
    """A decode cache whose attention layers hold ``length`` tokens."""
    from repro_torch.models.attention import KVCache
    if isinstance(cache, dict):
        return {"self": _filled(cache["self"], length),
                "enc_out": cache["enc_out"]}
    return [c._replace(length=length) if isinstance(c, KVCache) else c
            for c in cache]


def _tree_bytes(tree) -> int:
    from repro_torch.checkpoint.serialization import flatten
    return sum(x.numel() * x.element_size() for x in flatten(tree).values()
               if isinstance(x, torch.Tensor))


def _lengths(cfg) -> tuple:
    return SSM_LENGTHS if cfg.family == "ssm" else LENGTHS


def count_point(cfg, kind: str, length: int, depth: tuple,
                kw: tuple = ()) -> dict:
    """One batch-1 count at ``length`` on ``cfg`` cut to ``depth``: the
    :class:`cost.Cost` fields and the saved bytes."""
    cst, saved, _ = count_step(_at_depth(cfg, depth), kind, 1, length,
                               **dict(kw))
    return dict(cst.as_dict(), saved=saved)


def points_needed(cfg, kind: str, kw: tuple = ()) -> list:
    """The ``count_point`` arguments :func:`full_cost` needs."""
    return [(cfg, kind, L, k, kw) for L in _lengths(cfg)
            for k in _depths(cfg)]


def full_cost(cfg, kind: str, seq: int, kw: tuple = (), points=None):
    """``(Cost, saved bytes)`` of one batch-1 step at the full depth and
    length ``seq``, from counts at two depths and three lengths (module
    docstring); ``points`` holds counts made already, keyed like
    :func:`points_needed`'s entries without the config, and takes the
    ones made here."""
    points = {} if points is None else points
    fields = ("flops", "bytes", "peak_bytes", "ops", "saved")
    base, *deeper = _depths(cfg)
    full = _full_depth(cfg)
    at_len = {}
    for L in _lengths(cfg):
        for k in [base] + deeper:
            if (kind, L, k, kw) not in points:
                points[(kind, L, k, kw)] = count_point(cfg, kind, L, k, kw)
        c = {k: points[(kind, L, k, kw)] for k in [base] + deeper}
        at_len[L] = {f: c[base][f] + sum(
            (n - 1) * (c[k][f] - c[base][f]) for n, k in zip(full, deeper))
            for f in fields}
        # the live set's peak is one layer's transient, not a sum
        at_len[L]["peak_bytes"] = max(c[k]["peak_bytes"] for k in c)
    out = {f: cost.extrapolate({L: v[f] for L, v in at_len.items()}, seq)
           for f in fields}
    # a live set grows linearly in S past one query chunk (at the first
    # length the score block is S x S): the peak from the last two
    # lengths, on a line
    last = sorted(at_len)[-2:]
    out["peak_bytes"] = cost.extrapolate(
        {L: at_len[L]["peak_bytes"] for L in last}, seq)
    saved = out.pop("saved")
    return cost.Cost(**out), saved


# ---- the collective plan ----------------------------------------------------

def wire_plan(cfg, shape, mesh, param_shapes, grad_accum: int,
              act_tokens: int) -> cost.CollectiveStats:
    """The collectives the sharding rules imply for one step on each
    device (ring wire bytes, ``cost.collective_wire_bytes``): each
    parameter's blocks all-gathered over the batch axes where it is split
    there (FSDP) for every use (forward, remat recompute and backward in
    training, once otherwise) and its gradient reduce-scattered once a
    microbatch; two all-reduces of a layer's (tokens, d_model) output
    over ``model`` a use (attention and FFN outputs); the decode step's
    logits gathered once.  An estimate of what GSPMD or DTensor insert,
    not a trace."""
    sizes = shd.mesh_axes(mesh)
    stats = cost.CollectiveStats()
    uses = 3 if shape.kind == "train" else 1
    micro = grad_accum if shape.kind == "train" else 1
    for s in param_shapes.values():
        axes = [a for e in s.spec if e is not None
                for a in (e if isinstance(e, tuple) else (e,))]
        dn = math.prod(sizes[a] for a in axes if a in ("pod", "data"))
        if dn <= 1:
            continue
        for _ in range(uses * micro):
            stats.add("all-gather", s.local_nbytes * dn, dn)
        if shape.kind == "train":
            for _ in range(micro):
                stats.add("reduce-scatter", s.local_nbytes, dn)
    mdl = sizes.get("model", 1)
    itemsize = torch.empty((), dtype=PARAM_DTYPE).element_size()
    out_bytes = act_tokens * cfg.d_model * itemsize
    layers = cfg.n_layers + cfg.n_enc_layers
    for _ in range(2 * layers * uses * micro):
        stats.add("all-reduce", out_bytes, mdl)
    if shape.kind == "decode":
        stats.add("all-gather", shape.global_batch * cfg.vocab * 4, mdl)
    return stats


# ---- one cell ---------------------------------------------------------------

def _step_kw(cfg, kind: str) -> tuple:
    if kind != "train":
        return ()
    mdt = torch.bfloat16 if is_big(cfg) else torch.float32
    return (("accum_dtype", mdt), ("moment_dtype", mdt))


def _sum_local(tree) -> int:
    """Each device's bytes of a tree of :class:`sharding.Shape`."""
    if isinstance(tree, shd.Shape):
        return tree.local_nbytes
    if isinstance(tree, dict):
        return sum(_sum_local(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_sum_local(v) for v in tree)
    return 0


def resident_bytes(api, shape, mesh, grad_accum=None):
    """Each device's bytes of what a cell holds besides its activations,
    under the ambient mesh and rules: ``({"params", "inputs", and
    "opt_state", "accum", "grads" (train) or "cache"}, parameter shapes,
    microbatches, the device's microbatch rows)``.  The optimizer's count
    is a host tensor, so the state's device bytes are the moments'."""
    cfg = api.cfg
    pshapes = api.param_shapes(mesh, dtype=PARAM_DTYPE)
    inputs = api.input_specs(shape, mesh, dtype=PARAM_DTYPE)
    mem = {"params": _sum_local(pshapes), "inputs": _sum_local(inputs)}
    gb, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        mdt = dict(_step_kw(cfg, "train"))["moment_dtype"]
        ga = grad_accum or grad_accum_for(cfg, shape, mesh)
        st = AdamW(moment_dtype=mdt).state_shapes(pshapes)
        mem["opt_state"] = _sum_local((st.m, st.v))
        n_local = sum(math.prod(s.local) for s in pshapes.values())
        mem["accum"] = n_local * torch.empty((), dtype=mdt).element_size()
        mem["grads"] = n_local * 4
        return mem, pshapes, ga, max(1, gb // data_ways(mesh) // ga)
    cache = api.cache_shapes(gb, S + (1 if shape.kind == "decode" else 0),
                             mesh, dtype=PARAM_DTYPE)
    mem["cache"] = _sum_local(cache)
    return mem, pshapes, 1, max(1, gb // data_ways(mesh))


def run_cell(arch: str, shape, multi_pod: bool, *, grad_accum=None,
             results_dir=None, quiet: bool = False, cfg=None, mesh=None,
             points=None) -> dict:
    """One cell's record.  ``cfg`` and ``mesh`` replace the arch's config
    and the production mesh (the tests' reduced configs on a (4, 2)
    mesh); ``points`` holds batch-1 counts made already (``main``'s
    worker processes)."""
    mesh_name = "multi" if multi_pod else "single"
    cell_id = f"{arch}|{shape.name}|{mesh_name}"
    cfg = cfg or configs.get(arch)
    api = build_model(cfg)

    if shape not in shapes_for(cfg):
        rec = {"cell": cell_id, "status": "SKIP",
               "reason": "full-attention arch: long_500k requires a "
                         "sub-quadratic backbone"}
        _save(rec, results_dir, cell_id, quiet)
        return rec

    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size
    t0 = time.perf_counter()
    try:
        model_ways = shd.mesh_axes(mesh).get("model", 1)
        rec = {"cell": cell_id, "status": "OK", "chips": chips,
               "device": "NVIDIA H100 SXM5 80 GB (data sheet)"}
        with shd.set_mesh(mesh), use_rules(
                rules_for_shape(shape, cfg, model_ways=model_ways)):
            rec["rules"] = dataclasses.asdict(shd.current_rules())
            mem, pshapes, ga, b_dev = resident_bytes(api, shape, mesh,
                                                     grad_accum)
            gb, S = shape.global_batch, shape.seq_len
            if shape.kind == "train":
                step, saved = full_cost(cfg, "train", S,
                                        _step_kw(cfg, "train"), points)
                itemsize = torch.empty((), dtype=PARAM_DTYPE).element_size()
                layer_inputs = (cfg.n_layers + cfg.n_enc_layers) * S * (
                    cfg.d_model * itemsize)
                mem["activations"] = b_dev * (saved + layer_inputs)
                rec["grad_accum"] = ga
                rec["moment_dtype"] = str(dict(_step_kw(cfg, "train"))[
                    "moment_dtype"])
                act_tokens = b_dev * S
            else:
                step, _ = full_cost(cfg, shape.kind, S, (), points)
                mem["activations"] = b_dev * step.peak_bytes
                act_tokens = b_dev * (S if shape.kind == "prefill" else 1)
            mem["total"] = sum(mem.values())
            mem["hbm_bytes"] = cost.H100_HBM_BYTES
            mem["fits"] = bool(mem["total"] < cost.H100_HBM_BYTES)
            wires = wire_plan(cfg, shape, mesh, pshapes, ga, act_tokens)
            roof = cost.Roofline(
                flops=step.flops * gb / chips, hbm_bytes=step.bytes * gb
                / chips, wire_bytes=wires.wire_bytes, chips=chips,
                model_flops=model_flops(cfg, shape),
                collective_counts=wires.counts)
        rec.update({
            "memory": mem, "roofline": roof.summary(),
            "step_batch1": step.as_dict(),
            "count_s": time.perf_counter() - t0,
            "counting": {
                "lengths": list(_lengths(cfg)),
                "depths": _depths(cfg), "full_depth": _full_depth(cfg),
                "sampler": ("body once: one read of the logits"
                            if shape.kind == "decode" else None)},
        })
        pad = {k: getattr(cfg, k) for k in
               ("head_pad_to", "kv_head_pad_to", "expert_pad_to")
               if getattr(cfg, k)}
        if pad:
            rec["reference_padding"] = pad
    except Exception as e:  # a failing cell is a bug: record it loudly
        rec = {"cell": cell_id, "status": "FAIL",
               "error": f"{type(e).__name__}: {e}",
               "trace": traceback.format_exc()[-2000:]}
    _save(rec, results_dir, cell_id, quiet)
    return rec


def _save(rec, results_dir, cell_id, quiet):
    if results_dir:
        os.makedirs(results_dir, exist_ok=True)
        safe = cell_id.replace("|", "__").replace(".", "_")
        with open(os.path.join(results_dir, f"{safe}.json"), "w") as f:
            json.dump(rec, f, indent=1, default=str)
    if not quiet:
        print(json.dumps({k: v for k, v in rec.items() if k != "trace"},
                         default=str), flush=True)


def _point(args):
    arch, kind, L, k, kw = args
    return (arch, kind, L, k, kw), count_point(configs.get(arch), kind, L, k,
                                                kw)


def count_all(archs, shapes, jobs: int) -> dict:
    """Every batch-1 count the cells of ``archs`` x ``shapes`` need, made
    in ``jobs`` worker processes: ``{arch: {(kind, L, k, kw): counts}}``."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    todo = []
    for arch in archs:
        cfg = configs.get(arch)
        kinds = {s.kind for s in shapes if s in shapes_for(cfg)}
        for kind in sorted(kinds):
            todo += [(arch, kind, L, k, kw) for _, kind, L, k, kw in
                     points_needed(cfg, kind, _step_kw(cfg, kind))]
    # the longest counts first
    todo.sort(key=lambda t: -t[2] * sum(t[3]))
    out: dict = {a: {} for a in archs}
    with ProcessPoolExecutor(
            max_workers=jobs,
            mp_context=multiprocessing.get_context("spawn")) as ex:
        for (arch, kind, L, k, kw), c in ex.map(_point, todo):
            out[arch][(kind, L, k, kw)] = c
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append", default=None, choices=ARCHS)
    ap.add_argument("--shape", action="append", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--grad-accum", type=int, default=None)
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker processes for the meta-device counts")
    ap.add_argument("--results-dir", default=None)
    args = ap.parse_args(argv)

    archs = args.arch or (ARCHS if args.all else ["qwen2-0.5b"])
    shapes = [s for s in ALL_SHAPES
              if args.shape is None or s.name in args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    points = (count_all(archs, shapes, args.jobs) if args.jobs > 1
              else {a: {} for a in archs})
    out = []
    for arch in archs:
        for s in shapes:
            for mp in meshes:
                out.append(run_cell(arch, s, mp, grad_accum=args.grad_accum,
                                    results_dir=args.results_dir,
                                    points=points[arch]))
    return out


if __name__ == "__main__":
    main()
