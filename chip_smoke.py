#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase; needs one card
    python3 chip_smoke.py --out FILE      # also write the details as JSON
    python3 chip_smoke.py --profile       # also profile one full bucket

Phases:
  1. build the CUDA kernels from src/repro_torch/kernels/csrc (nvcc,
     sm_90a), print ptxas' register / shared-memory / spill lines and
     local_topk's resident blocks per SM, and fail if l2_distance,
     distance_topk or local_topk spills;
  2. hold each kernel against its plain PyTorch version on the card, at
     the main path's shapes and at the edge cases (l2_distance and
     distance_topk also under the routed phase's 1-of-8-shards mask;
     local_topk bit for bit, also on ragged, negative and signed-zero
     rows, on real distances and on the merge of a real distance_topk
     launch's partials, unmasked and under the mask; local_topk's passes
     at l = 257 and 1000 on the long row and the merge shape, with
     all-equal, signed-zero and +inf rows, and its floored pass against
     local_topk_floor_plain; the distance step at l > 256; the routing
     kernel in its three modes, bit for bit; the LM path's shapes:
     local_topk on the sampler's vocabulary rows, 64 x 18,992 at l = 50,
     with +inf tails of a padded vocabulary and bf16 logits full of ties,
     bit for bit, and l2_distance and distance_topk at d = 896);
  3. serve the static exact l-NN slice at full width (2**22 x 64 f32
     points, k = 8 shards, l <= 128, buckets <= 32) through
     KnnServer.query_batch under both samplers, check every answer
     against a brute-force top-l over all points, and check that each
     sampler's path launched its kernels;
  3b. serve_routed: the same widths on 8 Gaussian clusters, one a shard,
     with route="pruned" (device and host routing, both samplers) and
     search="approx": answers byte-identical to the exact route's and
     equal to brute force, the device router's rows equal to the host
     router's, fewer than 8 shards touched a batch, approx recall@l and
     candidate fraction checked, each path's kernels launched, one
     route_index_mask launch a routed batch;
  3c. serve_large_l: the phase-3 data at l_max = 1024 (l drawn from
     1..1024, with 257, 1000 and 1024), both samplers, exact route: every
     answer equal to brute force, local_topk's passes launched and no
     distance_topk launch;
  3d. serve_store: a MutableStore of 2^22 slots (k = 8 x 524,288, dim 64,
     affinity placement, proximity re-deal, 2 pivots, re-tightening, the
     split trigger, 8 index buckets) filled from drifting_clusters by
     insert + flush (2^20 points); eight churn rounds (8,192 inserts,
     4,096 deletes, 2,048 updates, one flush; an explicit compact()
     after round 5), after each 40 requests to five servers over the
     store (exact selection and gather; pruned device and host routing;
     pruned device routing with search="approx"): every answer equal to
     an f64 brute force over the live set of its generation, pruned
     answers byte-identical to the exact route's and touching the same
     shards under device and host routing, the generation's packed
     routing operands equal to a fresh packing and one route + index
     launch on them equal to the plain version and host route_shards
     bit for bit, approx recall@l >= 0.95, 0 contract violations, each
     path's kernels launched; then
     the store's masks on the kernels (phase 2's store cases), a flush's
     clone + scatter, the routing operands' repack, compact() split into
     its parts, and epoch swaps under load (a store with history carried
     over by convert.store_from_mirrors, served by the micro-batcher
     while an ingest thread flushes);
  3f. serve_maintained: serve_store's final state carried over
     (convert.store_from_mirrors) into a MutableStore(maintenance=
     "background", track_history=True) with the same knobs; four churn
     rounds from two writer threads while the micro-batcher serves 40
     requests a round to four servers (exact selection traced; pruned
     device routing with the bytes shadow audit on every batch; the
     same with search="approx" and the recall audit; gather with an SLO
     and the metrics endpoint on an ephemeral port), and a fifth server
     times batches of 32 throughout; then the worker is waited idle.
     Every answer equal to an f64 brute force over history() of its
     generation, pruned answers byte-identical to the exact route's at
     the same generation, approx recall@l >= 0.95, 0 contract violations
     and 0 shadow divergences, worker errors 0 with a background repack
     and a re-tightening committed (and counted by the commit clock),
     the exported span forest well formed with every maint.cycle's
     plan, prepare and commit, a repeated request's explain report
     byte-identical, /metrics parsed and stopped by close(), device
     memory within one generation of its level after round 1, each
     path's kernels launched; reported: flush walls, each cycle's plan /
     prepare / upload / commit and lock hold, the largest snapshot
     during a commit, batch walls during a repack and quiet, the upload
     with pageable and pinned staging, peak memory;
  3e. serve_predict: label prediction at the serve phases' widths on
     labeled_mixture(2^22, 64, 16 classes, separation 8): exact vote
     (exact route; pruned device routing, also with search="approx"),
     exact regress, ensemble vote (pruned host routing) and regress, 40
     requests each: exact answers equal to brute force and each label
     and confidence equal to the f64 vote or mean over the labels of the
     served ids (and of the f64 brute-force ids, near-ties at rank l
     reported), each ensemble payload equal, shard by shard, to a vote
     over an f64 top-kl of that shard, routed-away shards silent, the
     label the host aggregate of it and the bill one message a touched
     shard; ensemble-vs-exact agreement >= cfg.accuracy_floor and both
     modes' accuracy against bayes_labels; batch walls with and without
     the fold and the fold's device time; then a labeled store of 2^20
     slots (2^18 live) under exact vote, ensemble vote and exact vote at
     l_max = 512: each query's nearest neighbour deleted, labels
     rewritten, compact(), every answer's label held to an f64 vote over
     its generation, labels_for and the device labels to the host mirror;
  3g. serve_lm: qwen2-0.5b at full width (24 layers, d 896, 14 heads in
     2 KV groups, vocabulary 151,936; f32, seeded init on the card)
     serving 8 prompts of 128 tokens, 64 new tokens each, through
     Server.generate over 8 vocabulary shards of 18,992 (top_k 50,
     temperature 0.8), both samplers: each step's distributed top-k
     (values and ids, in order) equal to a stable descending sort of the
     (B, V) row, selection and gather drawing the same tokens, the
     prefill and the first 8 decode steps' logits within 1e-3 x max
     |logit| of the same model in f64, decode within 5e-3 of a
     teacher-forced forward, local_topk launched; reported: prefill ms,
     decode ms a step beside the weight-read bound, tokens/s, selection
     iterations and host syncs a step, peak memory;
  3g2. serve_families: the moe, hybrid, vlm, audio and ssm families,
     one model at a time, f32 seeded: granite-moe-3b at full width and
     depth (32 layers, d 1536, 40 experts top-8, vocabulary 49,155),
     xlstm-125m and seamless-m4t-v2 full (1,024 stub frames),
     pixtral-12b at 4 of 40 layers (256 stub patch embeds), phi3.5-moe
     at 2 of 32 layers, jamba at d_model 2048 with one 8-layer
     super-block and 16 experts; 8 prompts of 128 tokens, 32 new,
     through Server.generate over 8 vocabulary shards at top_k 50, both
     samplers: each step's top-k equal to a stable sort of its row, the
     samplers' tokens equal, local_topk launched; prefill and 4 decode
     steps within 1e-3 x max |logit| of the f64 twin, which replays the
     f32 run's MoE routing (the slots f64 would route otherwise
     reported); decode against teacher forcing for xlstm, seamless and
     pixtral; jamba's chunked Mamba state against the exact recurrence
     in f64 (reported); reported: prefill ms, decode ms a step beside
     the weight-read bound, tokens/s, one profiled step's device time,
     busy share and launches, peak memory; then three train_loop steps
     with remat of granite at 2 layers and of xlstm, finite and moving;
  3h. serve_knn_lm: the kNN-LM example (repro_torch.examples.
     knn_lm_serve) at full width: qwen2-0.5b decoding while a static
     KnnServer (k = 8, route exact) serves a datastore of 2^22 keys x 896
     f32 made on the card with token values in [0, 151,936); lambda 0.35,
     T = 10, B = 8 requests a step through submit, sampler top_k 16 at
     0.8; 16 steps at l_max = 8 under each knn sampler and 4 at l_max =
     1024: every retrieval equal to an f64 brute force over the
     datastore (near ties at rank l reported), the winners' tokens the
     datastore's values at their ids, exp(mixed) summing to 1 within
     1e-3 and equal to an f64 host mixture within 1e-5, one step's
     core.datastore.retrieve equal to the server's answer, each path's
     kernels launched;
  3i. train: qwen2-0.5b at full width (f32, seeded) trained for 30 steps
     through runtime.train_loop on MarkovTokens(vocab, 0, branch 2, 13
     contexts), batch 8 x 128 in 2 microbatches with remat, AdamW's
     defaults at lr 1e-3 after 5 warmup steps; a CheckpointManager(keep
     2) every 10 steps and one SimulatedNodeFailure at step 22, all under
     torch.use_deterministic_algorithms: the loss falls by more than 1.0,
     steps 20-21 replay bit for bit after the restore of step 20, a
     checkpoint restored equals the live parameters and moments, the
     gradients of a 2 x 64 batch within 1e-3 x max |g| of the f64 twin
     tensor by tensor, one AdamW step within 1e-6 x max |p| of f64 on the
     host, the prefetcher's copies equal their batches, no kernel
     launched; reported: step walls and tokens/s beside the products'
     and AdamW's bounds, one profiled step, peak memory, the checkpoint's
     snapshot, write and restore walls and bytes;
  3j. mesh: the mesh path.  The dry-run of all ten archs x their shapes x
     the (16, 16) and (2, 16, 16) meshes (``launch.dryrun --all --mesh
     both``, its counts in worker processes, before the phase's card
     work and beside no other phase): every cell OK or SKIP, one line a
     cell; qwen2-0.5b at full width trained 5 steps through
     ``launch.train`` unsharded and on a 1 x 1 NCCL mesh (phase train's
     knobs) under deterministic algorithms, each run counted by
     ``launch.cost``: the losses equal within 1e-6 relative, the FLOPs 5 x
     the dry-run's meta count of one step, and the card's peak memory
     within [0.67, 1.5] x the dry-run's predicted peak; qwen2-0.5b served
     on the 1 x 1 mesh (B = 8, 128-token prompts, 16 new tokens, both
     samplers): tokens equal to the unsharded port's, each top-k a stable
     sort, local_topk launched; the examples quickstart,
     distributed_topk_demo and streaming_ingest on the card with their
     own checks; past 420 s the phase dumps every thread's stack and
     exits;
  4. time each kernel, its plain version and one PyTorch yardstick call
     (where one computes the same function) with CUDA events at the
     serving shapes, beside the least time the card could take for the
     same work; l2_distance and distance_topk also alone (profiler) and
     with 1 of 8 shards valid, whose bound counts the live shard;
     local_topk's long-row time split into its first pass and its merge,
     and its merge of distance_topk's partials as a row of its own, both
     also under the 1-of-8 mask (bounds count what the run's data needs);
     the long row at l = 1024 in passes beside one pass at l = 256; the
     routing kernel's three modes at B = 32 beside a launch floor (one
     PyTorch op on a 1-element tensor) and the device-routed prologue's
     wall; the distance kernels, the long row and the merge under the
     store's real mask after the churn (bounds counting its live tiles),
     and distance_topk there with each shard's slots shuffled; the LM
     path's shapes: l2_distance and distance_topk over serve_knn_lm's
     datastore (B = 8, 2^22 x 896, l = 8), local_topk on the vocabulary
     rows beside the launch floor;
  5. print the kernels line, then the device line last.

Exits non-zero, and prints no result, without a CUDA device or without
the repository beside it.  Imports nothing of JAX or of src/repro.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

INT32_MAX = 2**31 - 1
# One H100 SXM (NVIDIA data sheet), at the full 700 W power limit.
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12          # f32 outside the tensor cores
F32_TOL = dict(rtol=1e-4, atol=1e-3)     # tests/test_kernels.py
BF16_TOL = dict(rtol=2e-2, atol=1.0)

# the phase-3 shapes: KnnServiceConfig defaults
N_POINTS, DIM, K, L, B = 1 << 22, 64, 8, 128, 32
M = N_POINTS // K

KERNELS = {
    "l2_distance": dict(
        source="src/repro_torch/kernels/csrc/l2_distance.cu",
        replaces="src/repro/kernels/l2_distance.py:67"),
    "distance_topk": dict(
        source="src/repro_torch/kernels/csrc/distance_topk.cu",
        replaces="src/repro/kernels/distance_topk.py:152"),
    "local_topk": dict(
        source="src/repro_torch/kernels/csrc/local_topk.cu",
        replaces="src/repro/kernels/local_topk.py:54"),
    # one kernel serves both routing TPU kernels; each entry counts its
    # launches in the runs whose path computes that mask
    "route_mask": dict(
        source="src/repro_torch/kernels/csrc/route_index_mask.cu",
        replaces="src/repro/kernels/routing.py:226",
        counter="route_index_mask",
        runs=("a_device_selection", "c_device_gather", "d_device_approx",
              "store_a_device_selection", "store_d_device_approx",
              "predict_exact_vote_routed", "predict_exact_vote_approx",
              "maintained_race", "maintained_device_bytes",
              "maintained_approx_recall")),
    "index_mask": dict(
        source="src/repro_torch/kernels/csrc/route_index_mask.cu",
        replaces="src/repro/kernels/routing.py:339",
        counter="route_index_mask",
        runs=("d_device_approx", "store_d_device_approx",
              "predict_exact_vote_approx", "maintained_approx_recall")),
}
# every launch counter of the port (kernels/ops.py COUNTERS)
COUNTERS = ("l2_distance", "distance_topk", "local_topk", "route_index_mask")
# phase 4's extra numbers for the two distance kernels, on the kernels line
MASKED_KEYS = ("kernel_ms", "masked_ms", "masked_kernel_ms", "masked_plain_ms",
               "masked_bound_ms", "masked_bound_by")
# phase 4's extra numbers for local_topk: the long row's two passes and the
# merge of distance_topk's partials (the selection path's shape)
LTK_KEYS = ("first_pass_ms", "merge_pass_ms", "long_row_plan", "merge_ms",
            "merge_kernel_ms", "merge_plain_ms", "merge_library_ms",
            "merge_bound_ms", "merge_bound_by", "merge_calls", "merge_plan",
            "merge_masked_ms", "merge_masked_kernel_ms",
            "merge_masked_plain_ms", "merge_masked_bound_ms",
            "merge_masked_bound_by", "merge_masked_calls")
# distance_topk's unmerged partials at the main shape, unmasked (None) and
# under the routed mask ("routed"), kept for phase 4
MERGE_INPUTS = {}
# phase 4's extra numbers for the routing kernel: its route + index mode,
# the launch floor and the device-routed prologue
ROUTE_KEYS = ("device_ms", "both_ms", "both_device_ms", "both_plain_ms",
              "both_bound_ms", "launch_floor_ms", "launch_floor_device_ms",
              "prologue_ms", "routing_readback_ms")
# phase 4's extra numbers for local_topk at l above one pass
LARGE_L_KEYS = ("large_l", "large_l_ms", "large_l_kernel_ms",
                "large_l_plain_ms", "large_l_one_pass_ms", "large_l_bound_ms",
                "large_l_library_ms")
# phase 4's numbers under the store's real mask after the churn (the
# distance kernels, local_topk's long row, and its merge of distance_topk's
# partials), each bound counting the live tiles or the pairs the data needs
STORE_KEYS = ("store_masked_ms", "store_masked_kernel_ms",
              "store_masked_plain_ms", "store_masked_bound_ms",
              "store_masked_bound_by", "store_live_tiles",
              "store_shuffled_ms", "store_shuffled_kernel_ms",
              "merge_store_ms", "merge_store_kernel_ms",
              "merge_store_plain_ms", "merge_store_bound_ms",
              "merge_store_bound_by")
# phase 4's numbers at the LM path's shapes: the distance kernels over the
# kNN-LM datastore (B = 8, 2^22 x 896, l = 8), local_topk on the sampler's
# vocabulary rows (64 x 18,992, l = 50) beside the launch floor
LM_KEYS = ("lm_shape", "lm_ms", "lm_kernel_ms", "lm_plain_ms",
           "lm_library_ms", "lm_library_device_ms", "lm_bound_ms",
           "lm_bound_by",
           "lm_launch_floor_ms", "lm_launch_floor_device_ms")
# the routed phase's B = 32 routing inputs and approx server, kept for
# phase 4's timing
ROUTED_INPUTS = {}
L_LARGE = 1024         # serve_large_l's l_max


class PhaseError(RuntimeError):
    pass


def log(*a):
    print(*a, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def spill_bytes(build_log: str) -> dict:
    """Spill stores + loads per kernel entry, from ptxas -v's lines (the
    build log is empty when the library was already built)."""
    import re
    out, fn = {}, None
    for line in build_log.splitlines():
        hit = re.search(r"(?:Compiling entry function|Function properties "
                        r"for) '?([\w$]+)", line)
        if hit:
            fn = hit.group(1)
        hit = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                        line)
        if hit and fn:
            out[fn] = out.get(fn, 0) + int(hit.group(1)) + int(hit.group(2))
    return out


# ---- phase 2: each kernel against its plain version -----------------------

ROUTED_SHARD = 3       # the one live shard of the routed phase's mask


def routed_mask(k, m, dev):
    """The (k, m) mask of a batch routed to one shard, as the pruned
    route folds it (core/knn.py): shard ROUTED_SHARD valid, the rest off."""
    import torch
    valid = torch.zeros((k, m), dtype=torch.bool, device=dev)
    valid[ROUTED_SHARD] = True
    return valid


def topk_agree(v, i, rv, ri, full, tol):
    """Kernel (v, i) vs plain (rv, ri) top-l lists, row by row.

    Values within ``tol``.  Ids: each id the kernel returns is real,
    unique in its row and its true distance (``full``, the plain
    distance matrix) matches the value beside it; where the plain
    version's l-th and (l+1)-th values are farther apart than the
    tolerance, the id sets are equal.  Returns the max abs value error.
    """
    import torch
    if not torch.allclose(v, rv, **tol):
        raise PhaseError(f"values differ: max abs {(v - rv).abs().max()}")
    fin = torch.isfinite(rv)
    if not torch.equal(fin, torch.isfinite(v)):
        raise PhaseError("+inf slots differ")
    if not bool((i[~fin] == INT32_MAX).all()):
        raise PhaseError("a +inf slot carries a real id")
    l = v.shape[-1]
    v2, i2, rv2, ri2 = (x.reshape(-1, l) for x in (v, i, rv, ri))
    full2 = full.reshape(-1, full.shape[-1])
    fin2 = torch.isfinite(rv2)
    safe = torch.where(fin2, i2, 0).long()
    true = full2.gather(1, safe)
    if not torch.allclose(torch.where(fin2, true, 0),
                          torch.where(fin2, v2, 0), **tol):
        raise PhaseError("an id's true distance differs from its value")
    if full2.shape[1] <= l:          # every point is in the answer
        if not torch.equal(i.sort(-1).values, ri.sort(-1).values):
            raise PhaseError("id sets differ")
        return float(torch.where(fin, (v - rv).abs(), 0).max())
    srt = torch.sort(full2, dim=1).values
    nxt = srt[:, l]
    gap = (nxt - srt[:, l - 1]) > (tol["atol"] + tol["rtol"] * nxt.abs())
    for r in torch.nonzero(gap & fin2.all(1)).flatten().tolist():
        if set(i2[r].tolist()) != set(ri2[r].tolist()):
            raise PhaseError(f"row {r}: id sets differ")
        if len(set(i2[r].tolist())) != l:
            raise PhaseError(f"row {r}: repeated id")
    return float(torch.where(fin, (v - rv).abs(), 0).max())


def pass_rows(g, dev, rows, m, mode):
    """(rows, m) f32 rows for local_topk's passes: N(0, 1), or tied (one
    decimal), all equal, signed zeros, or +inf rows (half the rows whole,
    one from column 40, one every third value)."""
    import torch
    x = torch.randn((rows, m), generator=g, device=dev)
    if mode == "ties":
        x = torch.round(x * 10) / 10
    elif mode == "equal":
        x = torch.full_like(x, 1.5)
    elif mode == "zeros":
        x = torch.round(x * 2) / 8
        neg = torch.rand((rows, m), generator=g, device=dev) < 0.5
        x = torch.where((x == 0) & neg, torch.full_like(x, -0.0), x)
    elif mode == "inf":
        x[: rows // 2] = float("inf")
        x[rows // 2, 40:] = float("inf")
        x[rows // 2 + 1, ::3] = float("inf")
    return x


def ltk_plan(rows, m, l, with_ids):
    """The local_topk launch's plan on this card: blocks per SM (the
    occupancy API), grid, items and waves."""
    from repro_torch.kernels import local_topk as ltk
    bps = ltk.blocks_per_sm(l, 0, with_ids)
    slots = bps * ltk.sm_count(0)
    per, nparts, grid = ltk.plan(rows, m, slots)
    items = -(-rows * m // per)
    return dict(rows=rows, m=m, blocks_per_sm=bps, grid=grid, items=items,
                per=per, nparts=nparts, waves=items / slots)


def capture_merge(fn):
    """Runs fn() and returns the partials distance_topk handed to
    local_topk's merge during it."""
    from repro_torch.kernels import local_topk as ltk
    seen, merge = [], ltk.merge_partials

    def keep(pv, pi, l):
        seen.append((pv.clone(), pi.clone()))
        return merge(pv, pi, l)
    ltk.merge_partials = keep
    try:
        out = fn()
    finally:
        ltk.merge_partials = merge
    if len(seen) != 1:
        raise PhaseError(f"distance_topk merged {len(seen)} times")
    return out, seen[0]


def phase_kernels(dev, results):
    import torch
    from repro_torch.kernels import distance_topk as dtk
    from repro_torch.kernels import l2_distance as l2
    from repro_torch.kernels import local_topk as ltk
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref

    g = torch.Generator(device=dev)
    g.manual_seed(1234)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    errs = {name: 0.0 for name in KERNELS}
    main_err = {}
    # l2_distance: main shape, ragged edges, bf16, the routed phase's mask
    # (1 of 8 shards valid) and a random one
    for (b, k, m, d, dt, mode) in [(B, K, M, DIM, torch.float32, None),
                                   (13, 1, 777, 300, torch.float32, None),
                                   (4, 3, 96, 64, torch.float32, None),
                                   (B, K, M, DIM, torch.bfloat16, None),
                                   (13, 2, 777, 300, torch.bfloat16, None),
                                   (B, K, M, DIM, torch.float32, "routed"),
                                   (B, K, M, DIM, torch.bfloat16, "routed"),
                                   (5, 3, 777, 64, torch.float32, "random")]:
        q, p = randn(b, d, dtype=dt), randn(k, m, d, dtype=dt)
        valid = None
        if mode == "routed":
            valid = routed_mask(k, m, dev)
        elif mode == "random":
            valid = torch.rand((k, m), generator=g, device=dev) > 0.4
        out = l2.l2_distance_cuda(q, p, valid=valid)
        torch.cuda.synchronize()
        want = l2.l2_distance_plain(q, p)
        if valid is not None:
            want = torch.where(valid.unsqueeze(1), want,
                               torch.full_like(want, float("inf")))
            if not torch.equal(torch.isinf(out), torch.isinf(want)):
                raise PhaseError(f"l2_distance {(b, k, m, d, dt, mode)}: "
                                 f"+inf entries differ")
        tol = F32_TOL if dt == torch.float32 else BF16_TOL
        if not torch.allclose(out, want, **tol):
            raise PhaseError(f"l2_distance {(b, k, m, d, dt, mode)}: max "
                             f"abs {(out - want).abs().max()}")
        fin = torch.isfinite(want)
        err = float(torch.where(fin, (out - want).abs(), 0).max())
        errs["l2_distance"] = max(errs["l2_distance"], err)
        main_err.setdefault("l2_distance", err)
        log(f"  l2_distance B={b} k={k} m={m} d={d} {dt} {mode or ''}: "
            f"max abs {err:.3g}")
        del out, want

    # distance_topk: main shape, l at 1/255/256, ragged, l > m, ties,
    # random valid mask, all-invalid, bf16
    cases = [(B, K, M, DIM, L, torch.float32, None),
             (13, 1, 777, 300, 1, torch.float32, None),
             (13, 1, 777, 300, 255, torch.float32, None),
             (13, 2, 777, 300, 256, torch.float32, None),
             (4, 2, 96, 64, 128, torch.float32, None),
             (5, K, 4096, 32, 16, torch.float32, "random"),
             (4, 2, 256, 64, 8, torch.float32, "none"),
             (B, K, 65536, DIM, L, torch.bfloat16, None),
             (B, K, M, DIM, L, torch.float32, "ties"),
             (B, K, M, DIM, L, torch.float32, "routed"),
             (B, K, M, DIM, L, torch.bfloat16, "routed")]
    for (b, k, m, d, l, dt, mode) in cases:
        q = randn(b, d, dtype=dt)
        if mode == "ties":
            base = randn(k, m // 8, d, dtype=dt)
            p = base.repeat_interleave(8, dim=1).contiguous()
        else:
            p = randn(k, m, d, dtype=dt)
        valid = None
        if mode == "random":
            valid = torch.rand((k, m), generator=g, device=dev) > 0.4
        elif mode == "none":
            valid = torch.zeros((k, m), dtype=torch.bool, device=dev)
        elif mode == "routed":
            valid = routed_mask(k, m, dev)
        v, i = dtk.distance_topk_cuda(q, p, l, valid=valid)
        torch.cuda.synchronize()
        rv, ri = dtk.distance_topk_plain(q, p, l, valid=valid)
        full = (ref.l2_distance_ref(q, p) if valid is None
                else ref.masked_l2_distance_ref(q, p, valid))
        tol = F32_TOL if dt == torch.float32 else BF16_TOL
        err = topk_agree(v, i, rv, ri, full, tol)
        if mode == "ties":
            # equal distances must come out in ascending id order
            same = (v[..., 1:] == v[..., :-1])
            if bool((same & (i[..., 1:] < i[..., :-1])).any()):
                raise PhaseError("tie order: a larger id came first")
        if mode == "none" and not bool((i == INT32_MAX).all()):
            raise PhaseError("all-invalid shard surfaced an id")
        if mode == "routed" and not (
                bool(torch.isinf(v[torch.arange(k, device=dev)
                                   != ROUTED_SHARD]).all())
                and bool(torch.isfinite(v[ROUTED_SHARD]).all())):
            raise PhaseError("routed mask: a dead shard surfaced a point "
                             "or the live shard lacks one")
        if valid is not None and mode == "random":
            dead = ~valid
            fin = torch.isfinite(v)
            idx = torch.where(fin, i, 0).long()
            hit = dead.unsqueeze(1).expand(k, b, m).gather(2, idx) & fin
            if bool(hit.any()):
                raise PhaseError("a masked point surfaced")
        errs["distance_topk"] = max(errs["distance_topk"], err)
        main_err.setdefault("distance_topk", err)
        log(f"  distance_topk B={b} k={k} m={m} d={d} l={l} {dt} "
            f"{mode or ''}: max abs {err:.3g}")
        del full

    # local_topk: the gather path's two shapes, l seam, ties, bf16, rows
    # no multiple of 4 (8 in bf16) long and short, negative values with
    # -0.0 / +0.0 ties (held against the plain version on the CPU, whose
    # stable sort compares values)
    for (rows, m, l, dt, mode) in [(K * B, M, L, torch.float32, None),
                                   (B, K * L, L, torch.float32, None),
                                   (5, 1000, 1, torch.float32, None),
                                   (5, 1000, 255, torch.float32, None),
                                   (5, 1000, 256, torch.float32, None),
                                   (3, 100, 128, torch.float32, None),
                                   (4, 512, 32, torch.float32, "ties"),
                                   (8, 4096, 64, torch.bfloat16, None),
                                   (7, 100003, 128, torch.float32, None),
                                   (3, 40001, 128, torch.bfloat16, None),
                                   (8, 4099, 64, torch.bfloat16, None),
                                   (6, 50003, 256, torch.float32, "zeros"),
                                   (K * B, 1001, 64, torch.float32,
                                    "zeros")]:
        x = randn(rows, m)
        if mode == "ties":
            x = torch.round(x * 10) / 10
        if mode == "zeros":
            x = torch.round(x * 2) / 8
            neg = torch.rand((rows, m), generator=g, device=dev) < 0.5
            x = torch.where((x == 0) & neg, torch.full_like(x, -0.0), x)
        x = x.to(dt)
        v, i = ltk.local_topk_cuda(x, l)
        torch.cuda.synchronize()
        if mode == "zeros":
            rv, ri = ltk.local_topk_plain(x.cpu(), l)
            v, i = v.cpu(), i.cpu()
        else:
            rv, ri = ltk.local_topk_plain(x, l)
        if not (torch.equal(v, rv) and torch.equal(i, ri)):
            raise PhaseError(f"local_topk {(rows, m, l, dt, mode)}: "
                             f"differs from the plain version")
        err = float(torch.where(torch.isfinite(rv), (v - rv).abs(), 0).max())
        errs["local_topk"] = max(errs["local_topk"], err)
        main_err.setdefault("local_topk", err)
        log(f"  local_topk rows={rows} m={m} l={l} {dt} {mode or ''}: "
            f"ids equal, max abs {err:.3g}")
    # the LM path's shapes: local_topk on the sampler's vocabulary rows
    # (negated logits over 8 shards of 18,992, l = 50; a vocabulary 8 does
    # not divide, whose -inf pads are +inf tails once negated, also where
    # the top-l reaches them; bf16 logits full of ties), bit for bit; the
    # distance kernels at the datastore's d = 896, keys at the embedding
    # table's scale
    from repro_torch.core.topk import shard_vocab
    lm_err = {name: 0.0 for name in ("l2_distance", "distance_topk",
                                     "local_topk")}
    for (bsz, V, l, dt, mode) in [(8, 151936, 50, torch.float32, None),
                                  (8, 151941, 50, torch.float32, "padded"),
                                  (3, 8 * 60 + 5, 60, torch.float32,
                                   "padded"),
                                  (8, 151936, 50, torch.bfloat16, "ties")]:
        logits = randn(bsz, V) * 3
        if mode == "ties":
            logits = torch.round(logits * 2) / 2
        x = (-shard_vocab(logits.to(dt), 8)).contiguous().reshape(8 * bsz, -1)
        v, i = ltk.local_topk_cuda(x, l)
        torch.cuda.synchronize()
        rv, ri = ltk.local_topk_plain(x, l)
        if not (torch.equal(v, rv) and torch.equal(i, ri)):
            raise PhaseError(f"local_topk vocabulary rows "
                             f"{(bsz, V, l, dt, mode)}: differs from the "
                             f"plain version")
        err = float(torch.where(torch.isfinite(rv), (v - rv).abs(), 0).max())
        lm_err["local_topk"] = max(lm_err["local_topk"], err)
        log(f"  local_topk vocabulary rows {tuple(x.shape)} (B={bsz}, V={V})"
            f" l={l} {dt} {mode or ''}: {int(torch.isinf(x).sum())} +inf "
            f"pads, values and ids equal")
    # (l = 192 is the fused kernel's largest at d = 896; above it
    # ops.distance_topk is l2_distance then local_topk, as at l > 256)
    for (b, k, m, l) in [(8, K, 65536, 8), (8, K, 65536, 192),
                         (5, 3, 777, 8)]:
        q = randn(b, 896) * 0.02
        p = randn(k, m, 896) * 0.02
        out = l2.l2_distance_cuda(q, p)
        torch.cuda.synchronize()
        full = l2.l2_distance_plain(q, p)
        if not torch.allclose(out, full, **F32_TOL):
            raise PhaseError(f"l2_distance d=896 {(b, k, m)}: max abs "
                             f"{(out - full).abs().max()}")
        lm_err["l2_distance"] = max(lm_err["l2_distance"],
                                    float((out - full).abs().max()))
        v, i = dtk.distance_topk_cuda(q, p, l)
        torch.cuda.synchronize()
        rv, ri = dtk.distance_topk_plain(q, p, l)
        lm_err["distance_topk"] = max(lm_err["distance_topk"], topk_agree(
            v, i, rv, ri, full, F32_TOL))
        if l == 192:
            before = (dtk.COUNT.n, l2.COUNT.n)
            v, i = kops.distance_topk(q, p, 256)
            torch.cuda.synchronize()
            if (dtk.COUNT.n, l2.COUNT.n) != (before[0], before[1] + 1):
                raise PhaseError("d=896 l=256: not l2_distance + local_topk")
            rv, ri = dtk.distance_topk_plain(q, p, 256)
            topk_agree(v, i, rv, ri, full, F32_TOL)
        log(f"  l2_distance and distance_topk B={b} k={k} m={m} d=896 l={l}:"
            f" max abs {lm_err['l2_distance']:.3g}, "
            f"{lm_err['distance_topk']:.3g}")
        del q, p, out, full
    for name, err in lm_err.items():
        errs[name] = max(errs[name], err)
    results["lm_max_abs_err"] = lm_err

    # local_topk's merge of a real distance_topk launch's partials at the
    # main shape, unmasked and under the routed mask: bit for bit
    q, p = randn(B, DIM), randn(K, M, DIM)
    for mode in (None, "routed"):
        valid = routed_mask(K, M, dev) if mode else None
        # the gather sampler's long rows of real distances (+inf rows
        # where the mask is off)
        x = l2.l2_distance_cuda(q, p, valid=valid).reshape(K * B, M)
        v, i = ltk.local_topk_cuda(x, L)
        rv, ri = ltk.local_topk_plain(x, L)
        if not (torch.equal(v, rv) and torch.equal(i, ri)):
            raise PhaseError(f"local_topk on distances {mode}: differs from "
                             f"the plain version")
        log(f"  local_topk rows={K * B} m={M} l={L} distances {mode or ''}: "
            f"values and ids equal")
        del x
        (v, i), (pv, pi) = capture_merge(
            lambda: dtk.distance_topk_cuda(q, p, L, valid=valid))
        torch.cuda.synchronize()
        mv, mi = ltk.merge_partials(pv, pi, L)
        rv, ri = ltk.merge_partials_plain(pv, pi, L)
        if not (torch.equal(mv, rv) and torch.equal(mi, ri)
                and torch.equal(v.reshape(-1, L), rv)
                and torch.equal(i.reshape(-1, L), ri)):
            raise PhaseError(f"local_topk merge {tuple(pv.shape)} {mode}: "
                             f"differs from the plain version")
        fin = torch.isfinite(pv)
        log(f"  local_topk merge of distance_topk partials "
            f"{tuple(pv.shape)} {mode or ''}: {int(fin.sum())} finite of "
            f"{pv.numel()}, values and ids equal")
        MERGE_INPUTS[mode] = (pv, pi)
    # the distance step above one pass (l2_distance, then local_topk's
    # passes), unmasked and under the routed mask
    for mode in (None, "routed"):
        valid = routed_mask(K, M, dev) if mode else None
        before = ltk.COUNT.n
        v, i = kops.distance_topk(q, p, L_LARGE, valid=valid)
        torch.cuda.synchronize()
        rv, ri = dtk.distance_topk_plain(q, p, L_LARGE, valid=valid)
        full = (ref.l2_distance_ref(q, p) if valid is None
                else ref.masked_l2_distance_ref(q, p, valid))
        err = topk_agree(v, i, rv, ri, full, F32_TOL)
        log(f"  ops.distance_topk B={B} k={K} m={M} l={L_LARGE} "
            f"{mode or ''}: l2_distance + {ltk.COUNT.n - before} local_topk "
            f"launches, max abs {err:.3g}")
        del v, i, rv, ri, full
    del q, p
    # local_topk above one pass: the long row and the merge shape, random,
    # tied, all-equal and +inf rows bit for bit against the plain version
    # (signed zeros against the CPU's, whose stable sort compares values)
    for (rows, m, l, mode) in [(K * B, M, 257, None),
                               (K * B, M, 1000, None),
                               (K * B, M, 1000, "equal"),
                               (K * B, 65536, 1000, None),
                               (K * B, 65536, 257, "inf"),
                               (K * B, 65536, 1000, "ties"),
                               (6, 50003, 1000, "zeros"),
                               (K * B, 1001, 1000, "zeros")]:
        x = pass_rows(g, dev, rows, m, mode)
        before = ltk.COUNT.n
        v, i = ltk.local_topk_cuda(x, l)
        torch.cuda.synchronize()
        launches = ltk.COUNT.n - before
        if mode == "zeros":
            x, v, i = x.cpu(), v.cpu(), i.cpu()
        rv, ri = ltk.local_topk_plain(x, l)
        if not (torch.equal(v, rv) and torch.equal(i, ri)):
            raise PhaseError(f"local_topk passes {(rows, m, l, mode)}: "
                             f"differ from the plain version")
        log(f"  local_topk rows={rows} m={m} l={l} {mode or ''}: "
            f"{launches} launches ({-(-min(l, m) // 256)} passes), values "
            f"and ids equal")
        del x, v, i, rv, ri
    # one floored pass against local_topk_floor_plain: floors from a first
    # pass, on values of the rows (ids on both sides of equal values) and
    # below every value
    x = pass_rows(g, dev, K * B, M, "ties")
    fv1, fi1 = (t[:, -1].contiguous() for t in ltk.local_topk_cuda(x, 256))
    pick = torch.randint(0, M, (K * B,), generator=g, device=dev)
    fv2 = x.gather(1, pick[:, None])[:, 0].contiguous()
    fi2 = torch.randint(0, M, (K * B,), generator=g, device=dev,
                        dtype=torch.int32)
    fv2[0], fi2[0] = -float("inf"), -1
    for name, floor in (("a first pass", (fv1, fi1)),
                        ("values of the rows", (fv2, fi2))):
        pv, pi = ltk.launch(x, None, 256, floor=floor)
        v, i = ltk.merge_partials(pv, pi, 256)
        rv, ri = ltk.local_topk_floor_plain(x, 256, floor)
        if not (torch.equal(v, rv) and torch.equal(i, ri)):
            raise PhaseError(f"local_topk floored pass ({name}): differs "
                             f"from local_topk_floor_plain")
        log(f"  local_topk floored pass rows={K * B} m={M} l=256, floors "
            f"from {name}: values and ids equal")
    del x, pv, pi
    # the routing kernel in its three modes (route, route + index, index
    # on given rows): 1, 2 and 4 pivots, l mixing 0 with 1..128, one empty
    # shard, ragged B and B above 32 warps; rows and unions must be equal
    import numpy as np
    from repro_torch.data import sharded_clusters
    from repro_torch.kernels import routing as rt
    from repro_torch.store import IndexMaintainer, build_summaries
    per = 4096
    pts, centers = sharded_clusters(K, per, DIM, seed=5, device=dev)
    valid = np.ones(K * per, bool)
    valid[2 * per:3 * per] = False
    rng = np.random.default_rng(5)
    idx = IndexMaintainer(K, per, DIM, 8)
    idx.rebuild(pts, valid)
    iops = rt.pack_index(idx.freeze(0))
    only_index = rt.PackedRouting(index=iops, device=dev, k=K)
    for pivots in (1, 2, 4):
        sops = rt.pack_summaries(build_summaries(pts, K, valid=valid,
                                                 num_pivots=pivots))
        route = rt.PackedRouting(sops, device=dev)
        both = rt.PackedRouting(sops, iops, device=dev)
        for b in (B, 5, 1, 70):
            q = torch.as_tensor(centers[rng.integers(0, K, b)]
                                + rng.normal(size=(b, DIM)),
                                dtype=torch.float32, device=dev)
            ls = torch.as_tensor(rng.integers(0, L + 1, b),
                                 dtype=torch.int32, device=dev)
            ls[0] = 0
            rows, _, u = rt.route_index_cuda(q, ls, route)
            torch.cuda.synchronize()
            if not (torch.equal(rows, rt.route_mask_plain(
                    q, ls, route.route_ops()))
                    and torch.equal(u, rows.any(0))):
                raise PhaseError(f"route_index_mask route pivots={pivots} "
                                 f"B={b}: differs from the plain version")
            if bool(rows[0].any()) or bool(rows[:, 2].any()):
                raise PhaseError("route_index_mask kept an l=0 row or an "
                                 "empty shard")
            got = rt.route_index_cuda(q, ls, both)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(
                    got, rt.route_index_plain(q, ls, both))):
                raise PhaseError(f"route_index_mask route+index "
                                 f"pivots={pivots} B={b}: differs from the "
                                 f"plain versions")
            gate = rows.clone()
            gate[:, 5] = 0                       # the gate drops shard 5
            _, keep, u = rt.route_index_cuda(q, ls, only_index, gate)
            torch.cuda.synchronize()
            if not (torch.equal(keep, rt.index_mask_plain(
                    q, ls, gate, only_index.index_ops()))
                    and torch.equal(u, torch.cat([gate.any(0),
                                                  keep.any(0)]))):
                raise PhaseError(f"route_index_mask index B={b}: differs "
                                 f"from the plain version")
            if bool(keep[:, 40:48].any()):
                raise PhaseError("route_index_mask kept a gated-out bucket")
            log(f"  route_index_mask pivots={pivots} B={b}: route "
                f"{int(rows.sum())} of {rows.numel()} kept, route+index "
                f"{int(got[1].sum())} of {got[1].numel()}, index "
                f"{int(keep.sum())} of {keep.numel()}; rows and unions "
                f"equal to plain")
    for name in ("route_mask", "index_mask"):
        errs[name] = main_err[name] = 0.0        # masks compared equal
    results["max_abs_err"] = main_err
    results["max_abs_err_all_cases"] = errs


# ---- phase 3: the slice at full width --------------------------------------

def brute_check(points, q, l, res):
    """One answer against a plain top-l over all points on the card."""
    import torch
    from repro_torch.kernels import ref
    d = ref.l2_distance_ref(q[None], points)[0]                  # (n,)
    bv, bi = torch.topk(d, l + 1, largest=False)
    bv, bi = bv.cpu().numpy(), bi.cpu().numpy()
    got_d, got_i = res.dists, res.ids
    tol = F32_TOL["atol"] + F32_TOL["rtol"] * abs(float(bv[l - 1]))
    if len(got_d) != l or not all(abs(got_d - bv[:l]) <= tol):
        raise PhaseError(f"l={l}: distances differ from brute force")
    if bool((got_d[1:] < got_d[:-1]).any()):
        raise PhaseError("answer not ascending")
    if len(set(got_i.tolist())) != l:
        raise PhaseError("repeated id in an answer")
    true = d[torch.as_tensor(got_i.astype("int64"), device=d.device)]
    if bool((true.cpu() - torch.as_tensor(got_d)).abs().max() > tol):
        raise PhaseError("an id's distance differs from its value")
    if bv[l] - bv[l - 1] > tol:
        if set(got_i.tolist()) != set(bi[:l].tolist()):
            raise PhaseError(f"l={l}: id set differs from brute force")
    else:
        inner = set(bi[:l][bv[:l] < bv[l - 1] - tol].tolist())
        if not inner <= set(got_i.tolist()):
            raise PhaseError(f"l={l}: interior ids differ")


def phase_serve(dev, gpu, results):
    import numpy as np
    import torch
    from repro_torch.configs import CONFIG
    from repro_torch.kernels import ops as kops
    from repro_torch.runtime import KnnServer

    cfg = CONFIG
    if (cfg.n_points, cfg.dim, cfg.l_max, cfg.bucket_sizes[-1]) != (
            N_POINTS, DIM, L, B):
        raise PhaseError("KnnServiceConfig defaults moved; update the "
                         "phase-3 shapes")
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    points = torch.randn((cfg.n_points, cfg.dim), generator=g, device=dev)
    rng = np.random.default_rng(0)
    groups = [32, 5, 2, 1]                  # buckets 32, 8, 2, 1
    n_req = sum(groups)
    queries = rng.normal(size=(n_req, cfg.dim)).astype(np.float32)
    ls = rng.integers(1, cfg.l_max + 1, n_req)
    ls[0], ls[1] = 1, cfg.l_max
    # every kernel each sampler's path launches (local_topk is also
    # distance_topk's merge pass); the kernels line sums both runs
    launches = {name: 0 for name in COUNTERS}
    by_sampler, serve = {}, {}
    for sampler, needs in (("selection", ["distance_topk", "local_topk"]),
                           ("gather", ["l2_distance", "local_topk"])):
        torch.cuda.reset_peak_memory_stats()
        srv = KnnServer(points, cfg=cfg.replace(sampler=sampler), shards=K,
                        device=dev, seed=0)
        srv.warmup()
        torch.cuda.synchronize()
        kops.reset_launch_counts()
        t0 = time.perf_counter()
        answers, start = [], 0
        for size in groups:
            answers += srv.query_batch(queries[start:start + size],
                                       ls[start:start + size].tolist())
            start += size
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kops.launch_counts()
        for name in needs:
            if counts[name] < 1:
                raise PhaseError(f"{sampler}: {name} was never launched")
        for name, n in counts.items():
            launches[name] += n
        by_sampler[sampler] = counts
        for q, l, r in zip(queries, ls, answers):
            brute_check(points, torch.as_tensor(q, device=dev), int(l), r)
        snap = srv.obs_snapshot()
        if snap["audit"]["contract"]["violations"]:
            raise PhaseError(f"{sampler}: contract audit violations")
        batches, seen = [], set()
        for r in answers:            # one entry per batch (bucket)
            if r.bucket not in seen:
                seen.add(r.bucket)
                batches.append(dict(bucket=r.bucket, iterations=r.iterations,
                                    rounds=r.rounds, messages=r.messages,
                                    host_syncs=r.host_syncs))
        lat = sorted(r.latency_s for r in answers)
        p50 = lat[len(lat) // 2]
        peak = torch.cuda.max_memory_allocated()
        serve[sampler] = dict(batches=batches, p50_latency_ms=p50 * 1e3,
                              wall_s=wall, requests=n_req,
                              launches=counts,
                              max_memory_allocated=peak,
                              contract=snap["audit"]["contract"]["checks"])
        log(f"  [{gpu}] sampler={sampler}: {n_req} requests, all equal "
            f"brute force; launches {counts}, per request "
            f"{ {k: n / n_req for k, n in counts.items()} }")
        for bt in batches:
            log(f"  [{gpu}] sampler={sampler} bucket={bt['bucket']}: "
                f"iterations={bt['iterations']} rounds={bt['rounds']} "
                f"messages={bt['messages']} host_syncs={bt['host_syncs']}")
        log(f"  [{gpu}] sampler={sampler}: p50 request latency "
            f"{p50 * 1e3:.3f} ms, max_memory_allocated {peak} bytes")
        del srv
    results["launches"] = launches
    results["launches_by_sampler"] = by_sampler
    results["serve"] = serve
    del points
    torch.cuda.empty_cache()


def phase_serve_routed(dev, gpu, results):
    """Pruned routing and the approx tier at full width, on clusters."""
    import numpy as np
    import torch
    from repro_torch.configs import CONFIG
    from repro_torch.data import sharded_clusters
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    from repro_torch.kernels import routing as rt
    from repro_torch.runtime import KnnServer
    from repro_torch.store import route_shards

    cfg = CONFIG
    points, centers = sharded_clusters(K, M, DIM, scale=8.0, seed=43,
                                       device=dev)
    rng = np.random.default_rng(43)
    groups = [32, 5, 2, 1]                  # buckets 32, 8, 2, 1
    qs_g, ls_g = [], []
    for size in groups:                     # a burst: one center + N(0, 1)
        c = centers[int(rng.integers(0, K))]
        qs_g.append((c + rng.normal(size=(size, DIM))).astype(np.float32))
        ls_g.append(rng.integers(1, L + 1, size))
    ls_g[0][0], ls_g[0][1] = 1, L
    n_req = sum(groups)
    queries = np.concatenate(qs_g)
    ls_all = np.concatenate(ls_g)
    # brute force over all points, for every request
    truth = []
    for q, l in zip(queries, ls_all):
        d = ref.l2_distance_ref(torch.as_tensor(q, device=dev)[None],
                                points)[0]
        truth.append(set(torch.topk(d, int(l), largest=False).indices
                         .cpu().numpy().tolist()))

    pruned = cfg.replace(route="pruned", route_compute="device")
    runs = [  # name, config, exact twin, kernels the path must launch
        ("exact_selection", cfg, None, ["distance_topk", "local_topk"]),
        ("exact_gather", cfg.replace(sampler="gather"), None,
         ["l2_distance", "local_topk"]),
        ("a_device_selection", pruned, "exact_selection",
         ["route_index_mask", "distance_topk", "local_topk"]),
        ("b_host_selection", pruned.replace(route_compute="host"),
         "exact_selection", ["distance_topk", "local_topk"]),
        ("c_device_gather", pruned.replace(sampler="gather"),
         "exact_gather", ["route_index_mask", "l2_distance", "local_topk"]),
        ("d_device_approx", pruned.replace(search="approx"), None,
         ["route_index_mask", "distance_topk", "local_topk"]),
    ]
    answers, out = {}, {}
    launches = {name: 0 for name in COUNTERS}
    for name, rcfg, twin, needs in runs:
        t0 = time.perf_counter()
        srv = KnnServer(points, cfg=rcfg, shards=K, device=dev, seed=0)
        build_s = time.perf_counter() - t0
        srv.warmup()
        torch.cuda.synchronize()
        kops.reset_launch_counts()
        res, walls = [], []
        for qg, lg in zip(qs_g, ls_g):
            t0 = time.perf_counter()
            res += srv.query_batch(qg, lg.tolist())
            walls.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        counts = kops.launch_counts()
        for kname in needs:
            if counts[kname] < 1:
                raise PhaseError(f"{name}: {kname} was never launched")
        # one routing launch a batch where the device routes, none else
        want = len(groups) if rcfg.route_compute == "device" and (
            rcfg.route == "pruned") else 0
        if counts["route_index_mask"] != want:
            raise PhaseError(f"{name}: {counts['route_index_mask']} routing "
                             f"launches for {len(groups)} batches, want "
                             f"{want}")
        if name.startswith(("a_", "b_", "c_", "d_")):
            for kname, n in counts.items():
                launches[kname] += n
        answers[name] = res
        steady = []
        for _ in range(5):
            t0 = time.perf_counter()
            srv.query_batch(qs_g[0], ls_g[0].tolist())
            steady.append(time.perf_counter() - t0)
        steady.sort()

        if twin is not None:
            for r, w, q, l in zip(res, answers[twin], queries, ls_all):
                if (r.dists.tobytes() != w.dists.tobytes()
                        or not np.array_equal(r.ids, w.ids)):
                    raise PhaseError(f"{name}: an answer differs from the "
                                     f"exact route's")
                brute_check(points, torch.as_tensor(q, device=dev), int(l),
                            r)
        if rcfg.route == "pruned":
            if any(r.shards_touched >= K for r in res):
                raise PhaseError(f"{name}: a batch touched all {K} shards")
        if name == "a_device_selection":
            # the device router's rows equal the host router's, per batch
            packed = rt.on_device(rt.pack_summaries(srv._summaries), dev)
            for qg, lg in zip(qs_g, ls_g):
                b = srv._bucket_for(len(qg))
                qp = np.zeros((b, DIM), np.float32)
                lp = np.zeros(b, np.int32)
                qp[:len(qg)], lp[:len(qg)] = qg, lg
                dev_rows = kops.route_mask(torch.as_tensor(qp, device=dev),
                                           torch.as_tensor(lp, device=dev),
                                           packed, slack=rcfg.route_slack)
                host_rows = route_shards(srv._summaries, qp, lp,
                                         slack=rcfg.route_slack)
                if not np.array_equal(dev_rows.cpu().numpy(), host_rows):
                    raise PhaseError("device routing rows differ from the "
                                     "host router's")
        snap = srv.obs_snapshot()
        if snap["audit"]["contract"]["violations"]:
            raise PhaseError(f"{name}: contract audit violations")
        entry = dict(
            build_s=build_s, requests=n_req, launches=counts,
            launches_per_request={k: n / n_req for k, n in counts.items()},
            batches=[dict(bucket=r.bucket, shards_touched=r.shards_touched,
                          rounds=r.rounds, messages=r.messages,
                          host_syncs=r.host_syncs, wall_ms=w * 1e3)
                     for r, w in zip([res[i] for i in (0, 32, 37, 39)],
                                     walls)],
            batch32_wall_ms_p50=steady[len(steady) // 2] * 1e3,
            batch32_wall_ms=[x * 1e3 for x in steady],
            prune_rate=srv.placement_stats()["prune_rate"])
        if name == "d_device_approx":
            cf = snap["metrics"]["serve.candidate_fraction"]
            recalls = [len(t & set(r.ids.tolist())) / r.l
                       for t, r in zip(truth, res)]
            entry.update(candidate_fraction=cf, recall_min=min(recalls),
                         recall_mean=float(np.mean(recalls)))
            if min(recalls) < 0.95:
                raise PhaseError(f"approx recall@l min {min(recalls)} "
                                 f"< 0.95")
            if cf["max"] > 1 / 3:
                raise PhaseError(f"approx candidate fraction {cf['max']} "
                                 f"> 1/3 on a batch")
            if any(r.recall_mode != "approx" for r in res):
                raise PhaseError("approx answers not tagged approx")
            # phase 4 times the routing kernel and this server's prologue
            # on this batch's inputs
            q32 = torch.as_tensor(qs_g[0], device=dev)
            l32 = torch.as_tensor(ls_g[0].astype(np.int32), device=dev)
            sops = rt.pack_summaries(srv._summaries)
            iops = rt.pack_index(srv._index)
            route = rt.PackedRouting(sops, device=dev, slack=rcfg.route_slack)
            ROUTED_INPUTS.update(
                q=q32, ls=l32, route=route,
                both=srv._operands(srv._summaries, srv._index)[0],
                index=rt.PackedRouting(index=iops, device=dev, k=K,
                                       oversample=rcfg.index_oversample),
                rows=rt.route_index_cuda(q32, l32, route)[0],
                server=srv, q_np=qs_g[0],
                ls_np=ls_g[0].astype(np.int32))
        out[name] = entry
        log(f"  [{gpu}] {name}: built in {build_s:.2f} s; {n_req} requests"
            f"{' equal to the exact route and brute force' if twin else ''}"
            f"; touched {[bt['shards_touched'] for bt in entry['batches']]}"
            f" a batch, prune rate {entry['prune_rate']:.4f}; launches "
            f"{counts}; batch of 32 wall p50 "
            f"{entry['batch32_wall_ms_p50']:.3f} ms")
        if name == "d_device_approx":
            log(f"  [{gpu}] {name}: recall@l min {entry['recall_min']:.4f}"
                f" mean {entry['recall_mean']:.4f}; candidate fraction "
                f"mean {cf['mean']:.4f} max {cf['max']:.4f}")
        del srv
    results["launches_routed"] = launches
    results["serve_routed"] = out
    del points
    torch.cuda.empty_cache()


def phase_serve_large_l(dev, gpu, results):
    """l above one top-l pass at full width: the phase-3 points at l_max =
    L_LARGE, both samplers, exact route; every answer equal to brute
    force, through l2_distance and local_topk's passes."""
    import numpy as np
    import torch
    from repro_torch.configs import CONFIG
    from repro_torch.kernels import ops as kops
    from repro_torch.runtime import KnnServer

    cfg = CONFIG.replace(l_max=L_LARGE)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    points = torch.randn((cfg.n_points, cfg.dim), generator=g, device=dev)
    rng = np.random.default_rng(16)
    groups = [32, 5, 2, 1]                  # buckets 32, 8, 2, 1
    n_req = sum(groups)
    queries = rng.normal(size=(n_req, cfg.dim)).astype(np.float32)
    ls = rng.integers(1, L_LARGE + 1, n_req)
    ls[:3] = (257, 1000, L_LARGE)
    passes = -(-L_LARGE // 256)
    out = {}
    for sampler in ("selection", "gather"):
        torch.cuda.reset_peak_memory_stats()
        srv = KnnServer(points, cfg=cfg.replace(sampler=sampler), shards=K,
                        device=dev, seed=0)
        env = srv.envelopes[-1]
        if env["dtk_path"] != "l2+local_topk" or env["ltk_passes"] != passes:
            raise PhaseError(f"envelope {env}: not the multi-pass path")
        srv.warmup()
        torch.cuda.synchronize()
        kops.reset_launch_counts()
        t0 = time.perf_counter()
        answers, start = [], 0
        for size in groups:
            answers += srv.query_batch(queries[start:start + size],
                                       ls[start:start + size].tolist())
            start += size
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kops.launch_counts()
        if counts["distance_topk"] or counts["route_index_mask"]:
            raise PhaseError(f"large l {sampler}: launches {counts}, want "
                             f"no distance_topk or routing launch")
        if (counts["l2_distance"] < len(groups)
                or counts["local_topk"] < passes * len(groups)):
            raise PhaseError(f"large l {sampler}: launches {counts}, want "
                             f"l2_distance and {passes} local_topk passes a "
                             f"batch")
        for q, l, r in zip(queries, ls, answers):
            brute_check(points, torch.as_tensor(q, device=dev), int(l), r)
        snap = srv.obs_snapshot()
        if snap["audit"]["contract"]["violations"]:
            raise PhaseError(f"large l {sampler}: contract audit violations")
        first = {r.bucket: r for r in reversed(answers)}
        lat = sorted(r.latency_s for r in answers)
        out[f"large_{sampler}"] = dict(
            l_max=L_LARGE, requests=n_req, launches=counts, wall_s=wall,
            p50_latency_ms=lat[len(lat) // 2] * 1e3,
            max_memory_allocated=torch.cuda.max_memory_allocated(),
            batches=[dict(bucket=b, iterations=r.iterations, rounds=r.rounds,
                          messages=r.messages, host_syncs=r.host_syncs)
                     for b, r in sorted(first.items(), reverse=True)])
        log(f"  [{gpu}] l_max={L_LARGE} sampler={sampler}: {n_req} requests "
            f"(l = 257, 1000, {L_LARGE} among them), all equal brute force; "
            f"launches {counts}; wall {wall * 1e3:.1f} ms; batches "
            f"{out[f'large_{sampler}']['batches']}")
        del srv
    results["serve_large_l"] = out
    del points
    torch.cuda.empty_cache()


# ---- phase 3d: the mutable store at full width ---------------------------------

STORE_CAP = M                 # 2^19 slots a shard, 2^22 in all
STORE_STEP = 1 << 16          # points a prefill flush (8 clusters x 8192)
CHURN = dict(rounds=8, inserts=8192, deletes=4096, updates=2048)
STORE_COMPACT_ROUND = 5       # the explicit compact(), after this round
PREFILL = 1 << 20              # live points the prefill reaches
LOAD_CYCLES = 6               # the ingest thread's insert/flush/delete/flush
# the store servers: name, config changes, exact twin, kernels the path
# must launch
STORE_RUNS = (
    ("store_exact_selection", {}, None, ["distance_topk", "local_topk"]),
    ("store_exact_gather", dict(sampler="gather"), None,
     ["l2_distance", "local_topk"]),
    ("store_a_device_selection",
     dict(route="pruned", route_compute="device"), "store_exact_selection",
     ["route_index_mask", "distance_topk", "local_topk"]),
    ("store_b_host_selection", dict(route="pruned", route_compute="host"),
     "store_exact_selection", ["distance_topk", "local_topk"]),
    ("store_d_device_approx",
     dict(route="pruned", route_compute="device", search="approx"), None,
     ["route_index_mask", "distance_topk", "local_topk"]),
)
# the store's real mask, points and queries after the churn, kept for
# phase 4's timing; and the kernels' errors under the store's masks
STORE_INPUTS = {}


def store_config():
    """The store phase's service config: the serve phases' shapes and the
    store knobs of the adaptive A/B (benchmarks/bench_serve.py); the
    tombstone trigger is set once the prefill's size is known."""
    from repro_torch.configs import CONFIG
    return CONFIG.replace(
        placement="affinity", redeal="proximity", summary_pivots=2,
        retighten_every=4096, split_radius_factor=1.0, index_buckets=8,
        store_capacity_per_shard=STORE_CAP, store_staging_size=1 << 30)


def interleaved(pts):
    """A drifting_clusters batch (cluster-major rows) in the order eight
    concurrent writers, one a cluster, would send it: cluster 0, 1, ...,
    7, 0, 1, ..."""
    return pts.reshape(K, -1, DIM).transpose(1, 0, 2).reshape(-1, DIM).copy()


def truth_on_card(lid, lp, q, l):
    """The brute-force top-(l+1) over the live set (ids ``lid`` numpy,
    points ``lp`` on the card), in f64 by direct differences:
    (distances, ids, |q|^2 + max |p|^2) as numpy and a float."""
    import torch
    q64 = q.double()
    d = ((lp.double() - q64) ** 2).sum(-1)
    bv, bi = torch.topk(d, min(l + 1, d.numel()), largest=False)
    mag = float((q64 * q64).sum() + (lp.double() ** 2).sum(-1).max())
    return bv.cpu().numpy(), lid[bi.cpu().numpy()], mag


def store_check(res, truth, l, generation, what=""):
    """One store answer against the f64 brute-force truth of its
    generation: distances within ``F32_TOL`` plus the f32 rounding of the
    expanded distance ``|q|^2 - 2 q.p + |p|^2`` the kernels compute,
    ``32 * 2^-23 * (|q|^2 + max |p|^2)`` (the store's clusters lie far
    from the origin); ids equal, or the strict interior where the l-th
    and (l+1)-th distances lie within that tolerance; sentinels past the
    live count."""
    import numpy as np
    bv, bid, mag = truth
    if res.generation != generation:
        raise PhaseError(f"{what}: answer of generation {res.generation}, "
                         f"want {generation}")
    n = min(l, len(bv))
    if len(res.dists) != l or not np.all(np.isinf(res.dists[n:])) or not (
            np.all(res.ids[n:] == INT32_MAX)):
        raise PhaseError(f"{what}: sentinel slots differ")
    got_d, got_i = res.dists[:n], res.ids[:n]
    tol = (F32_TOL["atol"] + F32_TOL["rtol"] * abs(float(bv[n - 1]))
           + 32 * 2.0 ** -23 * mag)
    err = float(np.abs(got_d - bv[:n]).max())
    if err > tol:
        raise PhaseError(f"{what} l={l}: distances differ from brute force "
                         f"by {err:.4g} > {tol:.4g}")
    if len(set(got_i.tolist())) != n:
        raise PhaseError(f"{what}: repeated id in an answer")
    if len(bv) == n or bv[n] - bv[n - 1] > tol:
        if set(got_i.tolist()) != set(bid[:n].tolist()):
            raise PhaseError(f"{what} l={l}: id set differs from brute force")
    elif not set(bid[:n][bv[:n] < bv[n - 1] - tol].tolist()) <= set(
            got_i.tolist()):
        raise PhaseError(f"{what} l={l}: interior ids differ")
    return err


def store_masks(valid_real, dev):
    """The three store masks of the kernel checks, (k, m) bool on the
    card: the store's real mask after the churn; that mask with shard 2
    cut to 0 < live < l (l // 3 live points, scattered) and shard 5
    emptied; and scattered tombstones, 30% of every shard's live slots."""
    import torch
    g = torch.Generator(device=dev)
    g.manual_seed(17)
    few = valid_real.clone()
    few[2] = False
    few[2, torch.randperm(M, generator=g, device=dev)[:L // 3]] = True
    few[5] = False
    tomb = valid_real & (torch.rand(valid_real.shape, generator=g,
                                    device=dev) > 0.3)
    return {"real": valid_real, "few": few, "tombstones": tomb}


def store_mask_kernels(dev, q, p, valid_real):
    """distance_topk, l2_distance and local_topk's merge of
    distance_topk's partials held against their plain versions under the
    three store masks, at full width.  Returns the max abs errors."""
    import torch
    from repro_torch.kernels import distance_topk as dtk
    from repro_torch.kernels import l2_distance as l2
    from repro_torch.kernels import local_topk as ltk
    from repro_torch.kernels import ref
    errs = {"l2_distance": 0.0, "distance_topk": 0.0, "local_topk": 0.0}
    for mode, valid in store_masks(valid_real, dev).items():
        out = l2.l2_distance_cuda(q, p, valid=valid)
        want = ref.masked_l2_distance_ref(q, p, valid)
        if not torch.equal(torch.isinf(out), torch.isinf(want)):
            raise PhaseError(f"l2_distance store mask {mode}: +inf entries "
                             f"differ")
        if not torch.allclose(out, want, **F32_TOL):
            raise PhaseError(f"l2_distance store mask {mode}: max abs "
                             f"{(out - want).abs().max()}")
        fin = torch.isfinite(want)
        errs["l2_distance"] = max(errs["l2_distance"], float(
            torch.where(fin, (out - want).abs(), 0).max()))
        del out
        (v, i), (pv, pi) = capture_merge(
            lambda: dtk.distance_topk_cuda(q, p, L, valid=valid))
        torch.cuda.synchronize()
        rv, ri = dtk.distance_topk_plain(q, p, L, valid=valid)
        err = topk_agree(v, i, rv, ri, want, F32_TOL)
        errs["distance_topk"] = max(errs["distance_topk"], err)
        fin = torch.isfinite(v)
        dead = (~valid).unsqueeze(1).expand(K, q.shape[0], M)
        if bool((dead.gather(2, torch.where(fin, i, 0).long()) & fin).any()):
            raise PhaseError(f"distance_topk store mask {mode}: a dead slot "
                             f"surfaced")
        live = valid.sum(1)
        short = int((fin.sum(-1) != torch.clamp(live, max=L)[:, None]).sum())
        if short:
            raise PhaseError(f"distance_topk store mask {mode}: {short} rows "
                             f"with another count of finite slots than "
                             f"min(live, l)")
        mv, mi = ltk.merge_partials(pv, pi, L)
        rmv, rmi = ltk.merge_partials_plain(pv, pi, L)
        if not (torch.equal(mv, rmv) and torch.equal(mi, rmi)):
            raise PhaseError(f"local_topk merge store mask {mode}: differs "
                             f"from the plain version")
        if mode == "real":
            STORE_INPUTS["merge"] = (pv, pi)
        log(f"  store mask {mode}: live per shard {live.tolist()}; "
            f"l2_distance, distance_topk (max abs {err:.3g}) and the merge of "
            f"its partials {tuple(pv.shape)} ({int(torch.isfinite(pv).sum())} "
            f"finite) equal to plain")
        del want
    return errs


def store_routing_check(srv, st, q, ls, dev):
    """The device router on the store's current generation: the operands
    ``srv`` packed for it when it served are a packing from scratch of the
    generation's summaries and index, and one route + index launch on
    them equals the plain version, and its rows host ``route_shards``,
    bit for bit."""
    import numpy as np
    import torch
    from repro_torch.kernels import routing as rt
    from repro_torch.store import route_shards
    _, summ, idx = st.serving_snapshot()
    ops = srv._gen_ops
    if ops is None or ops[0] is not summ or ops[1] is not idx:
        raise PhaseError(f"store routing: the server's operands are not "
                         f"generation {st.generation}'s")
    packed = ops[2]
    fresh = rt.PackedRouting(rt.pack_summaries(summ), rt.pack_index(idx),
                             device=dev)
    if not torch.equal(packed.buf, fresh.buf):
        raise PhaseError(f"store routing: generation {st.generation}'s "
                         f"packed operands differ from a fresh packing")
    qt = torch.as_tensor(q, device=dev)
    lt = torch.as_tensor(ls.astype(np.int32), device=dev)
    got = rt.route_index_cuda(qt, lt, packed)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(
            got, rt.route_index_plain(qt, lt, packed))):
        raise PhaseError(f"store routing: route_index_mask on generation "
                         f"{st.generation} differs from the plain version")
    host = route_shards(summ, q, ls, slack=srv.cfg.route_slack)
    if not np.array_equal(got[0].cpu().numpy() != 0, host):
        raise PhaseError(f"store routing: generation {st.generation}'s "
                         f"device rows differ from host route_shards")


def phase_serve_store(dev, gpu, results):
    """The mutable store at full width (module docstring, phase 3d)."""
    import threading
    import numpy as np
    import torch
    from repro_torch import convert
    from repro_torch.data import drifting_clusters
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import routing as rt
    from repro_torch.runtime import KnnServer
    from repro_torch.store import MutableStore, scatter_operands
    from repro_torch.store.mutable import scatter_apply

    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    cfg = store_config()
    out = {"capacity_slots": K * STORE_CAP}
    stream = drifting_clusters(K, STORE_STEP // K, DIM, steps=1 << 10,
                               drift=4.0, scale=12.0, seed=17)
    # the store keeps the bucket index the approx server reads
    store_kw = cfg.replace(search="approx").store_kwargs()
    st = MutableStore(DIM, device=dev, **store_kw)

    # prefill: insert + flush a step at a time up to 2^20 live points
    t0 = time.perf_counter()
    pts, centers = next(stream)
    st.insert(interleaved(pts))
    st.flush()
    rate = STORE_STEP / (time.perf_counter() - t0)
    log(f"  [{gpu}] prefill: {rate:.0f} points/s of insert + flush on the "
        f"first {STORE_STEP} points; {PREFILL} to go")
    flush_walls = []
    while st.live_count < PREFILL:
        pts, centers = next(stream)
        st.insert(interleaved(pts))
        t1 = time.perf_counter()
        st.flush()
        flush_walls.append(time.perf_counter() - t1)
    prefill_s = time.perf_counter() - t0
    # the tombstone trigger at one and a half rounds of deletes over the
    # live count, so the churn's deletes fire it within two rounds,
    # before a split's repack clears them
    st.compact_tombstone_frac = 1.5 * CHURN["deletes"] / st.live_count
    out.update(prefill_points=st.live_count,
               compact_tombstone_frac=st.compact_tombstone_frac,
               prefill_rate_first_step=rate,
               prefill_rate=st.live_count / prefill_s, prefill_s=prefill_s,
               prefill_flush_s=flush_walls, prefill_stats=dict(
                   vars(st.stats)))
    log(f"  [{gpu}] prefill: {st.live_count} live in {prefill_s:.1f} s "
        f"({st.live_count / prefill_s:.0f} points/s), generation "
        f"{st.generation}, live per shard {st.live_per_shard.tolist()}, "
        f"stats {vars(st.stats)}; tombstone trigger "
        f"{st.compact_tombstone_frac:.5f}")

    servers = {}
    for name, kw, twin, needs in STORE_RUNS:
        srv = KnnServer(store=st, cfg=cfg.replace(**kw), device=dev, seed=0)
        srv.warmup()
        servers[name] = srv
    torch.cuda.synchronize()
    launches = {name: {c: 0 for c in COUNTERS} for name, *_ in STORE_RUNS}
    rng = np.random.default_rng(171)
    groups = [32, 5, 2, 1]                  # buckets 32, 8, 2, 1
    rounds = []
    recalls, errs = [], []
    for rnd in range(1, CHURN["rounds"] + 1):
        pts, centers = next(stream)
        prev = st.serving_snapshot()[1:]
        live_ids, live_pts = st.live_arrays()
        gone = rng.choice(live_ids, CHURN["deletes"], replace=False)
        keep = np.setdiff1d(live_ids, gone)
        moved = rng.choice(keep, CHURN["updates"], replace=False)
        # an update moves a point a little: N(0, 0.25) a coordinate
        old = live_pts[np.searchsorted(live_ids, moved)]
        st.insert(interleaved(pts)[:CHURN["inserts"]])
        st.delete(gone)
        st.update(moved, old + rng.normal(scale=0.5, size=old.shape).astype(
            np.float32))
        t1 = time.perf_counter()
        before = st.stats.compactions
        gen = st.flush()
        flush_s = time.perf_counter() - t1
        auto = (st.stats.last_compact_reason
                if st.stats.compactions > before else None)
        compact_s = None
        if rnd == STORE_COMPACT_ROUND:
            t2 = time.perf_counter()
            gen = st.compact()
            compact_s = time.perf_counter() - t2
        lid, lpts = st.live_arrays()
        lp = torch.as_tensor(lpts, device=dev)
        queries, ls = [], []
        for size in groups:
            c = centers[int(rng.integers(0, K))]
            queries.append((c + rng.normal(size=(size, DIM))).astype(
                np.float32))
            ls.append(rng.integers(1, L + 1, size))
        ls[0][0], ls[0][1] = 1, L
        truth = [truth_on_card(lid, lp, torch.as_tensor(q, device=dev),
                               int(l))
                 for qg, lg in zip(queries, ls) for q, l in zip(qg, lg)]
        answers = {}
        for name, kw, twin, needs in STORE_RUNS:
            srv = servers[name]
            torch.cuda.synchronize()
            kops.reset_launch_counts()
            res = []
            for qg, lg in zip(queries, ls):
                res += srv.query_batch(qg, lg.tolist())
            torch.cuda.synchronize()
            counts = kops.launch_counts()
            for c, n in counts.items():
                launches[name][c] += n
            for kname in needs:
                if counts[kname] < 1:
                    raise PhaseError(f"{name}: {kname} was never launched")
            want = (len(groups) if kw.get("route_compute") == "device"
                    else 0)
            if counts["route_index_mask"] != want:
                raise PhaseError(f"{name}: {counts['route_index_mask']} "
                                 f"routing launches for {len(groups)} "
                                 f"batches, want {want}")
            answers[name] = res
            all_l = [int(x) for lg in ls for x in lg]
            if kw.get("search") == "approx":
                for r, (bv, bid, _), l in zip(res, truth, all_l):
                    if r.generation != gen or r.recall_mode != "approx":
                        raise PhaseError(f"{name}: generation or mode")
                    n = min(l, len(bv))
                    recalls.append(len(set(bid[:n].tolist())
                                       & set(r.ids.tolist())) / n)
            else:
                for r, t, l in zip(res, truth, all_l):
                    errs.append(store_check(r, t, l, gen, name))
            if twin is not None:
                for r, w in zip(res, answers[twin]):
                    if (r.dists.tobytes() != w.dists.tobytes()
                            or not np.array_equal(r.ids, w.ids)):
                        raise PhaseError(f"{name}: an answer differs from "
                                         f"the exact route's")
        for ra, rb in zip(answers["store_a_device_selection"],
                          answers["store_b_host_selection"]):
            if ra.shards_touched != rb.shards_touched:
                raise PhaseError("store routing: the device router touched "
                                 "other shards than the host router")
        store_routing_check(servers["store_d_device_approx"], st,
                            np.concatenate(queries), np.concatenate(ls), dev)
        entry = dict(round=rnd, generation=gen, live=st.live_count,
                     flush_s=flush_s, compact_s=compact_s,
                     flush_compacted=auto,
                     last_compact_reason=st.stats.last_compact_reason,
                     touched=[r.shards_touched for r in
                              answers["store_a_device_selection"][::10]],
                     live_per_shard=st.live_per_shard.tolist())
        rounds.append(entry)
        log(f"  [{gpu}] round {rnd}: generation {gen}, {st.live_count} live, "
            f"flush {flush_s:.2f} s"
            + (f", compact() {compact_s:.2f} s" if compact_s else "")
            + f"; {len(truth)} requests to each of {len(STORE_RUNS)} servers "
            f"equal brute force (the approx server's recall is checked "
            f"after the churn); stats {vars(st.stats)}")
    if min(recalls) < 0.95:
        raise PhaseError(f"store approx recall@l min {min(recalls)} < 0.95")
    auto = [(e["round"], e["flush_compacted"]) for e in rounds
            if e["flush_compacted"]]
    if not any(r.startswith("tombstone_density") for _, r in auto):
        raise PhaseError("the churn's tombstones fired no auto-compaction")
    log(f"  [{gpu}] churn: stats.last_compact_reason "
        f"{st.stats.last_compact_reason!r}; flushes that repacked (round, "
        f"reason): {auto}; approx recall@l min {min(recalls):.4f} mean "
        f"{float(np.mean(recalls)):.4f}")
    for name, srv in servers.items():
        snap = srv.obs_snapshot()
        if snap["audit"]["contract"]["violations"]:
            raise PhaseError(f"{name}: contract audit violations")
    log(f"  [{gpu}] largest distance error against the f64 brute force: "
        f"{max(errs):.4g}")
    out.update(rounds=rounds, launches=launches, max_dist_err=max(errs),
               approx_recall_min=min(recalls),
               approx_recall_mean=float(np.mean(recalls)),
               stats=dict(vars(st.stats)),
               audit={n: s.obs_snapshot()["audit"]["contract"]["checks"]
                      for n, s in servers.items()})

    # each server's batch of 32 on the churned store, and the store's
    # metrics as its servers recorded them
    q32, l32 = queries[0], ls[0].tolist()
    walls = {}
    for name, srv in servers.items():
        w = []
        for _ in range(5):
            t1 = time.perf_counter()
            srv.query_batch(q32, l32)
            w.append(time.perf_counter() - t1)
        w.sort()
        walls[name] = dict(p50_ms=w[2] * 1e3, all_ms=[x * 1e3 for x in w])
    out["batch32_wall"] = walls
    # the store records into the registry of the server built last
    reg = servers[STORE_RUNS[-1][0]].metrics.snapshot()
    out["store_metrics"] = {k: v for k, v in reg.items()
                            if k.startswith("store.")}
    log(f"  [{gpu}] batch of 32 wall p50 (ms): "
        f"{ {n: round(w['p50_ms'], 3) for n, w in walls.items()} }; "
        f"store metrics {out['store_metrics']}")

    # the device time of one flush's clone + scatter, at a churn round's
    # touched-slot count; the route_index_mask launch on this generation
    # and the repack of its operands and slot decode per generation
    snap = st.snapshot()
    n_touch = CHURN["inserts"] + CHURN["deletes"] + CHURN["updates"]
    slots = sorted(rng.choice(K * STORE_CAP, n_touch, replace=False).tolist())
    idx, up, ui, uv = scatter_operands(slots, st._pts, st._ids, st._valid,
                                       st.total, DIM, id_sentinel=INT32_MAX)
    sl = torch.as_tensor(idx[:n_touch].astype(np.int64), device=dev)
    up, ui, uv = (torch.as_tensor(x[:n_touch], device=dev)
                  for x in (up, ui, uv))
    scatter = lambda: scatter_apply(snap.points, snap.ids, snap.valid, sl,  # noqa: E731
                                    up, ui, uv)
    out["flush_device_ms"] = time_ms(scatter, 10)
    out["flush_device_bound_ms"] = bound(
        2 * (snap.points.numel() * 4 + snap.ids.numel() * 4
             + snap.valid.numel()), 0)[0]
    dsrv = servers["store_d_device_approx"]
    _, summ, sidx = st.serving_snapshot()
    packed = dsrv._operands(summ, sidx)[0]
    qt = torch.as_tensor(q32, device=dev)
    lt = torch.as_tensor(np.asarray(l32, np.int32), device=dev)
    route = lambda: rt.route_index_cuda(qt, lt, packed,  # noqa: E731
                                        with_rows=False)
    out["route_index_ms"] = time_ms(route, 200)
    out["route_index_device_ms"] = device_ms(route, "route_index_kernel")
    repacks = []
    for i in range(10):
        pair = (summ, sidx) if i % 2 else prev
        t1 = time.perf_counter()
        dsrv._operands(*pair)
        torch.cuda.synchronize()
        repacks.append(time.perf_counter() - t1)
    repacks.sort()
    out["operands_repack_ms_p50"] = repacks[5] * 1e3
    log(f"  [{gpu}] one flush's clone + scatter ({n_touch} slots): "
        f"{out['flush_device_ms']:.4f} ms of device time (bound "
        f"{out['flush_device_bound_ms']:.4f}); route_index_mask on this "
        f"generation {out['route_index_ms']:.4f} ms (device "
        f"{out['route_index_device_ms']} ms); operands + slot decode "
        f"repacked a generation in {out['operands_repack_ms_p50']:.3f} ms p50")

    # phase 2's store cases, on the churned store's real mask and points
    valid_real = snap.valid.view(K, STORE_CAP)
    pts3 = snap.points.view(K, STORE_CAP, DIM)
    q = torch.as_tensor(q32, device=dev)
    STORE_INPUTS.update(q=q, points=pts3, valid=valid_real)
    out["kernel_max_abs_err"] = store_mask_kernels(dev, q, pts3, valid_real)
    # every churn round held the routing kernel bit for bit
    # (store_routing_check), else the phase failed there
    out["kernel_max_abs_err"].update(route_mask=0.0, index_mask=0.0)

    # an explicit compact() at full width, split: the host repack, the
    # summaries and index rebuild, the upload
    parts = {}

    def timed(name, fn):
        def run(*a, **kw):
            t1 = time.perf_counter()
            r = fn(*a, **kw)
            parts[name] = parts.get(name, 0.0) + time.perf_counter() - t1
            return r
        return run
    st._summ.rebuild = timed("summaries_rebuild_s", st._summ.rebuild)
    st._index.rebuild = timed("index_rebuild_s", st._index.rebuild)
    st._upload_snapshot_locked = timed("upload_s",
                                       st._upload_snapshot_locked)
    t1 = time.perf_counter()
    st.compact()
    parts["compact_s"] = time.perf_counter() - t1
    del st._summ.rebuild, st._index.rebuild, st._upload_snapshot_locked
    parts["repack_s"] = (parts["compact_s"] - parts["summaries_rebuild_s"]
                         - parts["index_rebuild_s"] - parts["upload_s"])
    out["compact"] = parts
    log(f"  [{gpu}] compact() at {st.live_count} live: "
        f"{ {k: round(v, 3) for k, v in parts.items()} } s (repack_s is the "
        f"rest: the re-deal, the slot map, freezing and bookkeeping)")

    # epoch swaps under load: a store with history, continued from this
    # one's mirrors, served by the micro-batcher while an ingest thread
    # runs insert/flush/delete/flush cycles
    del servers
    live = st.live_count
    st2 = convert.store_from_mirrors(
        st._pts, st._ids, st._valid, cap=STORE_CAP, shards=K,
        generation=st.generation, device=dev, used=st._used,
        next_id=st._next_id, used_ids=st._used_ids, track_history=True, **{
            k: v for k, v in store_kw.items() if k != "capacity_per_shard"})
    del st
    srv = KnnServer(store=st2, cfg=cfg.replace(max_wait_ms=5.0), device=dev,
                    seed=0)
    srv.warmup()
    stop = threading.Event()
    cycles = []

    def mutate():
        r = np.random.default_rng(5)
        while not stop.is_set() and len(cycles) < LOAD_CYCLES:
            c = centers[int(r.integers(0, K))]
            ids = st2.insert((c + r.normal(size=(256, DIM))).astype(
                np.float32))
            st2.flush()
            st2.delete(ids)
            st2.flush()
            cycles.append(st2.generation)

    t = threading.Thread(target=mutate, daemon=True)
    lrng = np.random.default_rng(6)
    load_q = [(centers[int(lrng.integers(0, K))]
               + lrng.normal(size=DIM)).astype(np.float32)
              for _ in range(24)]
    with srv.serving():
        t.start()
        futs = [srv.submit(q, L) for q in load_q[:12]]
        res = [f.result(timeout=300) for f in futs]
        st2.insert(load_q[0][None] + 0.01)
        forced = st2.flush()
        futs = [srv.submit(q, L) for q in load_q[12:]]
        res += [f.result(timeout=300) for f in futs]
        stop.set()
        t.join(timeout=300)
    if t.is_alive():
        raise PhaseError("the ingest thread did not stop")
    gens = [r.generation for r in res]
    if not min(gens[12:]) >= forced > max(gens[:12]):
        raise PhaseError(f"answers crossed the epoch swap the wrong way: "
                         f"{gens}, forced {forced}")
    for q, r in zip(load_q, res):
        hid, hpts = st2.history(r.generation)
        store_check(r, truth_on_card(hid, torch.as_tensor(hpts, device=dev),
                                     torch.as_tensor(q, device=dev), L),
                    L, r.generation, "load")
    if srv.obs_snapshot()["audit"]["contract"]["violations"]:
        raise PhaseError("load: contract audit violations")
    out["load"] = dict(requests=len(res), generations=sorted(set(gens)),
                       swaps=len(cycles) * 2 + 1,
                       history=len(st2._history), live_before=live)
    log(f"  [{gpu}] epoch swaps under load: {len(res)} requests answered "
        f"across generations {sorted(set(gens))} while {len(cycles)} "
        f"insert/flush/delete/flush cycles ran; every answer equal to brute "
        f"force over its generation's history ({len(st2._history)} "
        f"generations kept)")
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  [{gpu}] max_memory_allocated {out['max_memory_allocated']} bytes")
    results["serve_store"] = out
    # phase serve_maintained carries this state over
    MAINTAINED.update(
        points=st2._pts, ids=st2._ids, valid=st2._valid,
        used=st2._used.copy(), next_id=st2._next_id,
        used_ids=set(st2._used_ids), generation=st2.generation,
        centers=centers,
        tombstone_frac=1.5 * CHURN["deletes"] / st2.live_count)
    del srv, st2
    torch.cuda.empty_cache()


# ---- phase 3f: background maintenance and the operator plane ----------------

MAINT_ROUNDS = 4
MAINT_REQUESTS = 40           # a round, to each of the four servers
# The reference's plan puts compaction debt before a due re-tightening,
# and the 1.5-round tombstone trigger arms before a shard has absorbed
# retighten_every ops, so mixed rounds end on a repack.  An update-only
# tail (points moved within their cluster: no tombstones) follows until
# a re-tightening commits, at most MAINT_TAIL_MAX flushes.
MAINT_TAIL_UPDATES = 8192
MAINT_TAIL_MAX = 8
# the servers over the background store: name, config changes, kernels
# the path must launch.  The traced server is the store's obs plane: its
# ring holds the maintenance cycles beside its own requests
MAINT_RUNS = (
    ("maintained_device_bytes",
     dict(route="pruned", route_compute="device", obs_audit_every=1),
     ["route_index_mask", "distance_topk", "local_topk"]),
    ("maintained_approx_recall",
     dict(route="pruned", route_compute="device", search="approx",
          obs_audit_every=1),
     ["route_index_mask", "distance_topk", "local_topk"]),
    ("maintained_gather_slo",
     dict(sampler="gather", slo_latency_p99_s=0.5,
          slo_contract_violations=True, obs_http_port=-1),
     ["l2_distance", "local_topk"]),
    ("maintained_exact_traced", dict(obs_trace=True,
                                     obs_trace_capacity=1 << 16),
     ["distance_topk", "local_topk"]),
)
# serve_store's final state (mirrors, counts, the last centres)
MAINTAINED = {}


def maintained_state():
    """serve_store's final state, which this phase carries over."""
    if not MAINTAINED:
        raise PhaseError("serve_store left no state to carry over")
    return MAINTAINED


def quantile_ms(walls, q):
    """Nearest-rank q-quantile of ``walls`` (s) in ms, None when empty."""
    import math
    if not walls:
        return None
    w = sorted(walls)
    return w[min(max(math.ceil(q * len(w)), 1), len(w)) - 1] * 1e3


def maint_cycles(recs):
    """Each maintenance cycle of a span export: its kind and its plan,
    prepare, upload and commit times (plan and commit include the wait
    for the store lock), the plan's and the commit's lock holds and the
    ops it replayed; fails unless every cycle has its plan, prepare and
    commit (or discard) children."""
    kids = {}
    for r in recs:
        if r["parent"] is not None:
            kids.setdefault(r["parent"], []).append(r)
    cycles = []
    for c in (r for r in recs if r["name"] == "maint.cycle"):
        by = {k["name"]: k for k in kids.get(c["span"], [])}
        end = by.get("maint.commit") or by.get("maint.discard")
        if "maint.plan" not in by or "maint.prepare" not in by or not end:
            raise PhaseError(f"maint.cycle {c['attrs']} lacks its plan, "
                             f"prepare or commit: {sorted(by)}")
        up = [k for k in kids.get(by["maint.prepare"]["span"], [])
              if k["name"] == "maint.upload"]
        span = lambda r: r["t1"] - r["t0"]  # noqa: E731
        cycles.append(dict(
            kind=c["attrs"]["kind"], t0=c["t0"],
            committed=end["name"] == "maint.commit",
            plan_s=span(by["maint.plan"]),
            plan_held_s=by["maint.plan"]["attrs"]["held_s"],
            prepare_s=span(by["maint.prepare"]),
            upload_s=span(up[0]) if up else None,
            upload_bytes=up[0]["attrs"]["bytes"] if up else None,
            commit_s=span(end), commit_t=(end["t0"], end["t1"]),
            held_s=end.get("attrs", {}).get("held_s"),
            replayed=end.get("attrs", {}).get("replayed")))
    return cycles


def phase_serve_maintained(dev, gpu, results):
    """Background maintenance and the operator plane at full width
    (module docstring, phase 3f)."""
    import contextlib
    import io
    import threading
    import urllib.request
    import numpy as np
    import torch
    from repro_torch import convert
    from repro_torch.data import drifting_clusters
    from repro_torch.kernels import ops as kops
    from repro_torch.obs import build_trees
    from repro_torch.obs.explain import deterministic_json
    from repro_torch.obs.export import parse_prometheus_text
    from repro_torch.runtime import KnnServer
    from repro_torch.store import maintenance

    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    state = maintained_state()
    cfg = store_config()
    store_kw = {k: v for k, v in cfg.replace(search="approx")
                .store_kwargs().items() if k != "capacity_per_shard"}
    store_kw.update(maintenance="background",
                    compact_tombstone_frac=state["tombstone_frac"])
    t1 = time.perf_counter()
    st = convert.store_from_mirrors(
        state["points"], state["ids"], state["valid"], cap=STORE_CAP,
        shards=K, generation=state["generation"], device=dev,
        used=state["used"], next_id=state["next_id"],
        used_ids=state["used_ids"], track_history=True, **store_kw)
    centers = state["centers"]
    MAINTAINED.clear()
    worker = st._worker
    out = {"carry_s": time.perf_counter() - t1, "live": st.live_count,
           "generation": st.generation,
           "compact_tombstone_frac": st.compact_tombstone_frac}
    gen_bytes = K * STORE_CAP * (DIM * 4 + 4 + 1)
    servers = {}
    for name, kw, _ in MAINT_RUNS:
        srv = KnnServer(store=st, cfg=cfg.replace(max_wait_ms=5.0, **kw),
                        device=dev, seed=0)
        srv.warmup()
        servers[name] = srv
    traced = servers["maintained_exact_traced"]
    # batch-of-32 walls on a server of its own, beside the race, traced
    # so its snapshot stages can be set against the commits
    walls_srv = KnnServer(store=st, cfg=cfg.replace(
        obs_trace=True, obs_trace_capacity=1 << 18), device=dev, seed=1)
    walls_srv.warmup()
    st.attach_obs(traced.obs)
    log(f"  [{gpu}] carried {st.live_count} live (generation "
        f"{st.generation}) into a background store in {out['carry_s']:.1f} "
        f"s; tombstone trigger {st.compact_tombstone_frac:.5f}")

    stream = drifting_clusters(K, STORE_STEP // K, DIM, steps=1 << 10,
                               drift=4.0, scale=12.0, seed=29)
    rng = np.random.default_rng(191)
    q32 = (centers[int(rng.integers(0, K))]
           + rng.normal(size=(32, DIM))).astype(np.float32)
    l32 = rng.integers(1, L + 1, 32).tolist()
    flushes, errors, walls = [], [], []
    writing = threading.Event()
    stop_walls = threading.Event()

    def sample_walls():
        while not stop_walls.is_set():
            k0, w0 = worker.current, writing.is_set()
            t = time.perf_counter()
            walls_srv.query_batch(q32, l32)
            walls.append((time.perf_counter() - t, k0, worker.current,
                          w0 or writing.is_set(), t))

    def writer(w, rnd, ins, gone, moved, new):
        try:
            st.insert(ins)
            st.delete(gone)
            st.update(moved, new)
            t = time.perf_counter()
            gen = st.flush()
            flushes.append(dict(round=rnd, writer=w, generation=gen,
                                flush_s=time.perf_counter() - t))
        except Exception:
            errors.append(traceback.format_exc())

    torch.cuda.synchronize()
    kops.reset_launch_counts()
    pending = {name: [] for name in servers}
    sampler = threading.Thread(target=sample_walls, daemon=True)
    with contextlib.ExitStack() as serving:
        for srv in servers.values():
            serving.enter_context(srv.serving())
        sampler.start()
        for rnd in range(1, MAINT_ROUNDS + 1):
            pts, centers = next(stream)
            live_ids, live_pts = st.live_arrays()
            gone = rng.choice(live_ids, CHURN["deletes"], replace=False)
            moved = rng.choice(np.setdiff1d(live_ids, gone),
                               CHURN["updates"], replace=False)
            new = (live_pts[np.searchsorted(live_ids, moved)]
                   + rng.normal(scale=0.5, size=(len(moved), DIM))
                   ).astype(np.float32)
            ins = interleaved(pts)[:CHURN["inserts"]]
            qs = (centers[rng.integers(0, K, MAINT_REQUESTS)]
                  + rng.normal(size=(MAINT_REQUESTS, DIM))).astype(np.float32)
            ls = rng.integers(1, L + 1, MAINT_REQUESTS)
            ls[0], ls[1] = 1, L
            writing.set()
            threads = [threading.Thread(target=writer, args=(
                w, rnd, ins[w::2], gone[w::2], moved[w::2], new[w::2]))
                for w in (0, 1)]
            for t in threads:
                t.start()
            for name, srv in servers.items():
                pending[name] += [(rnd, j, q, int(l), srv.submit(q, int(l)))
                                  for j, (q, l) in enumerate(zip(qs, ls))]
            for t in threads:
                t.join()
            writing.clear()
            for name in servers:
                for *_, f in pending[name]:
                    f.result(timeout=600)
            if rnd == 1:
                torch.cuda.synchronize()
                mem_round1 = torch.cuda.memory_allocated()
            log(f"  [{gpu}] round {rnd}: generation {st.generation}, "
                f"{st.live_count} live, flushes "
                f"{[round(f['flush_s'], 3) for f in flushes[-2:]]} s; worker "
                f"{ {k: v for k, v in worker.stats_dict().items() if v} }")
        if errors:
            raise PhaseError(f"a writer failed: {errors[0]}")
        t1 = time.perf_counter()
        if not worker.wait_idle(timeout=400):
            raise PhaseError("the worker did not go idle in 400 s")
        out["idle_wait_s"] = time.perf_counter() - t1
        tail = []
        while not worker.stats.retightens:
            if len(tail) == MAINT_TAIL_MAX:
                raise PhaseError(f"no re-tightening after {len(tail)} "
                                 f"update-only flushes: {worker.stats}")
            live_ids, live_pts = st.live_arrays()
            moved = rng.choice(live_ids, MAINT_TAIL_UPDATES, replace=False)
            st.update(moved, (live_pts[np.searchsorted(live_ids, moved)]
                              + rng.normal(scale=0.5, size=(
                                  len(moved), DIM))).astype(np.float32))
            t1 = time.perf_counter()
            writing.set()
            gen = st.flush()
            writing.clear()
            tail.append(dict(generation=gen,
                             flush_s=time.perf_counter() - t1))
            if not worker.wait_idle(timeout=400):
                raise PhaseError("the worker did not go idle in 400 s")
        out["tail_flushes"] = tail
        log(f"  [{gpu}] worker idle {out['idle_wait_s']:.1f} s after the "
            f"last round; {len(tail)} update-only flushes of "
            f"{MAINT_TAIL_UPDATES} to a re-tightening")
        stop_walls.set()
        sampler.join()
    torch.cuda.synchronize()
    race_counts = kops.launch_counts()
    quiet = []
    for _ in range(10):
        t = time.perf_counter()
        walls_srv.query_batch(q32, l32)
        quiet.append(time.perf_counter() - t)
    ws = worker.stats_dict()
    clock = st.maint_commit_clock()
    log(f"  [{gpu}] worker stats {ws}; clock {clock}")
    if ws["errors"]:
        raise PhaseError(f"maintenance worker errors: {ws['error']}")
    if clock[0] != ws["commits"]:
        raise PhaseError(f"commit clock {clock[0]} != {ws['commits']} "
                         f"commits")

    # the trace: a well-formed forest, every cycle complete
    buf = io.StringIO()
    traced.export_trace_jsonl(buf)
    recs = [json.loads(x) for x in buf.getvalue().splitlines()]
    build_trees(recs)
    cycles = maint_cycles(recs)
    for c in cycles:
        log(f"  [{gpu}] cycle " + json.dumps(
            {k: v for k, v in c.items() if k not in ("t0", "commit_t")}))
    kinds = [c["kind"] for c in cycles if c["committed"]]
    if not any(k in ("repack", "split") for k in kinds) or (
            "retighten" not in kinds):
        raise PhaseError(f"want a background repack and a re-tightening "
                         f"commit, got {kinds}")
    if len(kinds) != ws["commits"]:
        raise PhaseError(f"{len(kinds)} commit spans, {ws['commits']} "
                         f"commits")
    commits = [c["commit_t"] for c in cycles if c["committed"]]
    snaps = [(r["t0"], r["t1"]) for r in recs + walls_srv.obs.tracer.spans()
             if r["name"] == "snapshot"]
    raced = [b - a for a, b in snaps
             if any(a < c1 and b > c0 for c0, c1 in commits)]
    # a dispatch also reads the store lock after its kernel (the commit
    # clock), where a commit's wait usually lands: the batch walls that
    # overlap a commit
    raced_walls = [w for w, *_, t in walls
                   if any(t < c1 and t + w > c0 for c0, c1 in commits)]

    # every answer against an f64 brute force over its generation
    answers = {name: {(rnd, j): (q, l, f.result()) for rnd, j, q, l, f in p}
               for name, p in pending.items()}
    by_gen = {}
    for name, ans in answers.items():
        for key, (q, l, r) in ans.items():
            by_gen.setdefault(r.generation, []).append((name, key, q, l, r))
    errs, recalls = [], []
    for g, items in sorted(by_gen.items()):
        hid, hpts = st.history(g)
        lp = torch.as_tensor(hpts, device=dev)
        for name, key, q, l, r in items:
            truth = truth_on_card(hid, lp, torch.as_tensor(q, device=dev), l)
            if name == "maintained_approx_recall":
                bv, bid, _ = truth
                n = min(l, len(bv))
                recalls.append(len(set(bid[:n].tolist())
                                   & set(r.ids.tolist())) / n)
            else:
                errs.append(store_check(r, truth, l, g, f"{name} {key}"))
        del lp
    if min(recalls) < 0.95:
        raise PhaseError(f"approx recall@l min {min(recalls)} < 0.95")
    same_gen = 0
    for key, (_, _, r) in answers["maintained_device_bytes"].items():
        w = answers["maintained_exact_traced"][key][2]
        if r.generation == w.generation:
            same_gen += 1
            if (r.dists.tobytes() != w.dists.tobytes()
                    or not np.array_equal(r.ids, w.ids)):
                raise PhaseError(f"pruned answer {key} differs from the "
                                 f"exact route's at generation "
                                 f"{r.generation}")
    audits = {}
    audited = {n for n, kw, _ in MAINT_RUNS if kw.get("obs_audit_every")}
    for name, srv in servers.items():
        snap = srv.obs_snapshot()
        sh = snap["audit"]["shadow"]
        audits[name] = dict(contract=snap["audit"]["contract"]["checks"],
                            shadow_checks=sh["checks"],
                            shadow_divergences=sh["divergences"])
        if snap["audit"]["contract"]["violations"]:
            raise PhaseError(f"{name}: contract audit violations")
        if sh["divergences"]:
            raise PhaseError(f"{name}: shadow divergences {sh['details']}")
        if name in audited and not sh["checks"]:
            raise PhaseError(f"{name}: the shadow audit never ran")
    shadow_launches = {}
    for name in ("maintained_device_bytes", "maintained_approx_recall"):
        for k, v in servers[name].metrics.snapshot().items():
            if k.startswith("audit.shadow.launches."):
                c = k.rsplit(".", 1)[1]
                shadow_launches[c] = shadow_launches.get(c, 0) + v
    log(f"  [{gpu}] {sum(len(a) for a in answers.values())} answers over "
        f"{len(by_gen)} generations equal brute force (largest distance "
        f"error {max(errs):.4g}); approx recall@l min {min(recalls):.4f}; "
        f"{same_gen} pruned answers byte-identical to the exact route's at "
        f"the same generation; audits {audits}")

    # explain: a repeated request gives the same stable report
    rep = [deterministic_json(r.explain()) for r in
           servers["maintained_approx_recall"].query_batch(q32[:4], l32[:4])]
    again = [deterministic_json(r.explain()) for r in
             servers["maintained_approx_recall"].query_batch(q32[:4],
                                                             l32[:4])]
    if rep != again:
        raise PhaseError("explain: a repeated request's stable report "
                         "differs")
    # the metrics endpoint, then close() stops it
    gsrv = servers["maintained_gather_slo"]
    url = f"http://127.0.0.1:{gsrv._http.port}/metrics"
    with urllib.request.urlopen(url, timeout=30) as resp:
        prom = parse_prometheus_text(resp.read().decode())
    if prom["knn_serve_latency_s"]["count"] < MAINT_ROUNDS * MAINT_REQUESTS:
        raise PhaseError(f"/metrics: {prom['knn_serve_latency_s']}")
    slo = gsrv.obs_snapshot()["slo"]
    gsrv.close()
    if gsrv._http._thread.is_alive():
        raise PhaseError("close() left the metrics endpoint running")

    # each path's kernels, counts at 0 before and read after its pass
    launches = {"maintained_race": race_counts}
    for name, _, needs in MAINT_RUNS:
        _, counts = run_and_count(servers[name], [q32], [l32], needs, name)
        launches[name] = counts
    launches["maintained_shadow"] = {c: shadow_launches.get(c, 0)
                                     for c in COUNTERS}

    # the memory check: the explain rings and the allocator pin nothing
    for srv in servers.values():
        srv.close()
    torch.cuda.synchronize()
    mem_end = torch.cuda.memory_allocated()
    if mem_end > mem_round1 + gen_bytes:
        raise PhaseError(f"device memory {mem_end} after the rounds > "
                         f"{mem_round1} after round 1 + one generation "
                         f"{gen_bytes}")

    # the upload alone: pageable against pinned staging, same buffers
    host = [st._pts, st._ids, st._valid]
    side = torch.cuda.Stream(dev)
    upload_s = {}
    for pinned in (False, True, False, True):
        t = time.perf_counter()
        src = ([torch.from_numpy(a).pin_memory().numpy() for a in host]
               if pinned else host)
        bufs = maintenance.upload(src, dev, stream=side)
        upload_s.setdefault("pinned" if pinned else "pageable", []).append(
            time.perf_counter() - t)
        del bufs
    st.close()

    def wall_stats(sel):
        w = [x[0] for x in walls if sel(x)]
        return dict(n=len(w), p50_ms=quantile_ms(w, 0.5),
                    p99_ms=quantile_ms(w, 0.99))
    repack = ("repack", "split")
    out.update(
        rounds=MAINT_ROUNDS, flushes=flushes,
        cycles=[{k: v for k, v in c.items() if k not in ("t0", "commit_t")}
                for c in cycles],
        max_snapshot_s_during_commit=max(raced) if raced else None,
        snapshots_during_commit=len(raced),
        max_batch32_wall_during_commit_s=(max(raced_walls) if raced_walls
                                          else None),
        batch32_during_commit=len(raced_walls),
        batch32_wall=dict(
            repack_quiet_writers=wall_stats(lambda x: not x[3] and (
                x[1] in repack or x[2] in repack)),
            repack_with_writers=wall_stats(lambda x: x[3] and (
                x[1] in repack or x[2] in repack)),
            retighten=wall_stats(lambda x: "retighten" in (x[1], x[2])),
            writers_no_cycle=wall_stats(lambda x: x[3] and x[1] is None
                                        and x[2] is None),
            quiet=dict(n=len(quiet), p50_ms=quantile_ms(quiet, 0.5),
                       p99_ms=quantile_ms(quiet, 0.99))),
        worker=ws, clock=clock[0], audits=audits, launches=launches,
        shadow_launches=shadow_launches, max_dist_err=max(errs),
        approx_recall_min=min(recalls), pruned_same_generation=same_gen,
        generations_served=len(by_gen), slo=slo,
        memory=dict(round1=mem_round1, end=mem_end, generation=gen_bytes),
        upload_probe_s=upload_s,
        max_memory_allocated=torch.cuda.max_memory_allocated())
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  [{gpu}] flushes (s): "
        f"{[round(f['flush_s'], 3) for f in flushes]}")
    log(f"  [{gpu}] largest serve.snapshot_s during a commit: "
        f"{out['max_snapshot_s_during_commit']} ({len(raced)} snapshots "
        f"raced a commit); largest batch-of-32 wall overlapping a commit "
        f"{out['max_batch32_wall_during_commit_s']} ({len(raced_walls)} "
        f"batches); batch-of-32 walls {out['batch32_wall']}")
    log(f"  [{gpu}] memory {out['memory']}, peak "
        f"{out['max_memory_allocated']} bytes; upload probe (s) "
        f"{ {k: [round(x, 3) for x in v] for k, v in upload_s.items()} }; "
        f"slo firing {slo['firing']} fired {slo['alerts_fired']}; "
        f"phase_s {out['phase_s']:.1f}")
    results["serve_maintained"] = out
    del servers, walls_srv, traced, gsrv, st
    torch.cuda.empty_cache()


# ---- phase 3e: label prediction ---------------------------------------------

# the labeled workload: tests/test_predict.py's family at the serve phases'
# widths (racing-ingest case: separation 8.0, seed 11)
PREDICT_SEED, PREDICT_SEPARATION, NUM_CLASSES = 11, 8.0, 16
# the static prediction servers: name, config changes, kernels the path
# must launch
PREDICT_RUNS = (
    ("predict_exact_vote", dict(predict="vote"),
     ["distance_topk", "local_topk"]),
    ("predict_exact_vote_routed",
     dict(predict="vote", route="pruned", route_compute="device"),
     ["route_index_mask", "distance_topk", "local_topk"]),
    ("predict_exact_vote_approx",
     dict(predict="vote", route="pruned", route_compute="device",
          search="approx"),
     ["route_index_mask", "distance_topk", "local_topk"]),
    ("predict_exact_regress", dict(predict="regress"),
     ["distance_topk", "local_topk"]),
    ("predict_ensemble_vote",
     dict(predict="vote", predict_mode="ensemble", route="pruned",
          route_compute="host"), ["distance_topk", "local_topk"]),
    ("predict_ensemble_regress",
     dict(predict="regress", predict_mode="ensemble"),
     ["distance_topk", "local_topk"]),
)
# the labeled store: 2^20 slots, 2^18 live after the prefill
PREDICT_STORE_CAP = 1 << 17
PREDICT_STORE_LIVE = 1 << 18
PREDICT_STORE_L_MAX = 512      # the third store server: local_topk's passes


def f64_dists(points, q):
    """(B, n) f64 squared distances of the numpy queries ``q`` to
    ``points`` (n, dim) on the card; dead slots are masked by the caller."""
    import torch
    p = points.double()
    qq = torch.as_tensor(q, device=points.device).double()
    return (p * p).sum(-1)[None] - 2.0 * qq @ p.T + (qq * qq).sum(-1)[:, None]


def host_vote(lab, l=None):
    """The f64 host fold over the labels ``lab`` of the winners: vote
    ``(label, confidence)`` as f32, ties to the lowest class; or, with the
    request's ``l``, regress ``(f64 mean, f32 count / l)``."""
    import numpy as np
    if l is None:
        hist = np.bincount(lab.astype(np.int64), minlength=NUM_CLASSES)
        total = int(hist.sum())
        return (np.float32(hist.argmax() if total else -1),
                np.float32(hist.max()) / np.float32(max(total, 1)))
    den = len(lab)
    return (float(lab.astype(np.float64).sum()) / max(den, 1),
            np.float32(den) / np.float32(l))


def label_check(r, lab, mode):
    """One exact answer's label and confidence against the f64 host fold
    over the labels ``lab`` of its served ids: bit for bit (vote), the
    mean within 1e-6 relative and the confidence exactly (regress).
    Returns the number of mismatches (0 or 1)."""
    import numpy as np
    want, conf = host_vote(lab, None if mode == "vote" else r.l)
    if mode == "vote":
        return int(np.float32(r.label).tobytes() != want.tobytes()
                   or np.float32(r.confidence).tobytes() != conf.tobytes())
    return int(abs(r.label - want) > 1e-6 * abs(want)
               or np.float32(r.confidence).tobytes() != conf.tobytes())


def brute_vote_check(r, dq, id_of, lab_of, mode):
    """The label against the vote over the f64 brute-force ids (``dq``:
    one query's f64 distances on the card over a point set whose row i
    holds id ``id_of(i)``; ``lab_of``: ids -> labels) where the served and
    brute-force id sets are equal; ``(mismatch, near_tie)``, a near-tie
    being a row whose sets differ within the f32 tolerance at rank l."""
    import numpy as np
    import torch
    n = int(np.isfinite(r.dists).sum())
    bv, bi = torch.topk(dq, min(n + 1, dq.numel()), largest=False)
    bv, bid = bv.cpu().numpy(), id_of(bi.cpu().numpy())
    if set(bid[:n].tolist()) != set(r.ids[:n].tolist()):
        tol = F32_TOL["atol"] + F32_TOL["rtol"] * abs(float(bv[n - 1]))
        if len(bv) > n and bv[n] - bv[n - 1] <= tol:
            return 0, 1
        raise PhaseError("served ids differ from brute force away from a "
                         "near-tie")
    return label_check(r, lab_of(bid[:n]), mode), 0


def capture_ensemble(srv):
    """Wrap ``srv``'s ensemble pass: each batch's (payload, routed-shard
    flags, l, touched) is kept."""
    seen = []
    run = srv._ensemble_run

    def keep(points, ids, valid, labels, active, act, qt, l_arr, touched,
             syncs):
        out = run(points, ids, valid, labels, active, act, qt, l_arr,
                  touched, syncs)
        seen.append((out.payload, act, l_arr.copy(), touched))
        return out
    srv._ensemble_run = keep
    return seen


def ensemble_check(cfg, seen, answers, D, lab_t, k, m, what):
    """Each ensemble batch's (k, B, C) payload against a vote (or [sum,
    count]) over an f64 brute-force top-kl of each shard's points
    (``D``: (requests, k*m) f64 with dead slots +inf; ``lab_t``: (k*m,)
    labels on the card); routed-away shards and padding rows all zero;
    each label the host aggregate of the served payload; one round and
    one message a touched shard.  Returns (mismatches, near-ties)."""
    import numpy as np
    import torch
    from repro_torch import predict as pm
    bad = ties = row0 = 0
    vote = cfg.predict == "vote"
    for payload, act, l_arr, touched in seen:
        act = np.ones(k, bool) if act is None else act
        kl = pm.local_k_for(l_arr, touched, cfg.local_k, cfg.l_max)
        n = int((l_arr > 0).sum())
        got = (pm.aggregate_vote(payload, act) if vote
               else pm.aggregate_regress(payload, act))
        for row in range(len(l_arr)):
            if row >= n or not kl[row]:
                bad += int(np.any(payload[:, row] != 0))
                continue
            r = answers[row0 + row]
            if r.messages != r.shards_touched or r.rounds != 1 or (
                    r.shards_touched != touched):
                raise PhaseError(f"{what}: bill {r.rounds} rounds, "
                                 f"{r.messages} messages for {touched} "
                                 f"touched shards")
            if np.float32(r.label).tobytes() != got[0][row].tobytes() or (
                    np.float32(r.confidence).tobytes()
                    != got[1][row].tobytes()):
                bad += 1
            d = D[row0 + row].view(k, m)
            bv, bi = torch.topk(d, int(kl[row]) + 1, dim=-1, largest=False)
            lab = lab_t.view(k, m).gather(1, bi).cpu().numpy()
            bv = bv.cpu().numpy()
            for j in range(k):
                if not act[j]:
                    bad += int(np.any(payload[j, row] != 0))
                    continue
                c = int(kl[row])
                fin = np.isfinite(bv[j, :c])
                tol = F32_TOL["atol"] + F32_TOL["rtol"] * abs(
                    float(bv[j, c - 1]))
                if fin.all() and bv[j, c] - bv[j, c - 1] <= tol:
                    ties += 1
                    continue
                lj = lab[j, :c][fin]
                if vote:
                    want = np.bincount(lj.astype(np.int64),
                                       minlength=NUM_CLASSES)
                    bad += int(not np.array_equal(payload[j, row], want))
                else:
                    s, cnt = payload[j, row]
                    bad += int(cnt != len(lj) or abs(
                        s - lj.astype(np.float64).sum()) > 1e-5 * max(
                            1.0, abs(s)))
        row0 += n
    return bad, ties


def run_and_count(srv, groups_q, groups_l, needs, name):
    """Serve the groups with each launch counter at 0 before and read
    after; fail if a kernel the path needs was never launched."""
    import torch
    from repro_torch.kernels import ops as kops
    torch.cuda.synchronize()
    kops.reset_launch_counts()
    res = []
    for qg, lg in zip(groups_q, groups_l):
        res += srv.query_batch(qg, [int(x) for x in lg])
    torch.cuda.synchronize()
    counts = kops.launch_counts()
    for kname in needs:
        if counts[kname] < 1:
            raise PhaseError(f"{name}: {kname} was never launched")
    return res, counts


def device_total_ms(fn, iters=20):
    """Mean device time of every kernel one call of ``fn`` launches, from
    torch.profiler (the aten:: rows repeat their kernels and are left
    out)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "self_device_time_total",
                        getattr(e, "self_cuda_time_total", 0))
                for e in prof.key_averages() if not e.key.startswith("aten::"))
    return total / iters / 1e3


def wall_p50_ms(fn, reps=5):
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        walls.append(time.perf_counter() - t0)
    walls.sort()
    return walls[len(walls) // 2] * 1e3, [w * 1e3 for w in walls]


def phase_serve_predict(dev, gpu, results):
    """Label prediction: the static labeled mixture at full width, then a
    labeled store at a smaller depth (module docstring, phase 3e)."""
    import numpy as np
    import torch
    from repro_torch import predict as pm
    from repro_torch.configs import CONFIG
    from repro_torch.core import knn as knn_mod
    from repro_torch.data import bayes_labels, labeled_mixture
    from repro_torch.runtime import KnnServer
    from repro_torch.store import MutableStore

    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    out = {"seed": PREDICT_SEED, "separation": PREDICT_SEPARATION,
           "num_classes": NUM_CLASSES}
    pts_np, cls, centers = labeled_mixture(
        N_POINTS, DIM, NUM_CLASSES, separation=PREDICT_SEPARATION,
        seed=PREDICT_SEED)
    rng = np.random.default_rng(PREDICT_SEED + 1)
    labels = cls.astype(np.float32)
    # regression targets: the class id plus U(0, 1), so sums round
    targets = (labels + rng.random(N_POINTS)).astype(np.float32)
    points = torch.as_tensor(pts_np, device=dev)
    del pts_np
    groups = [32, 5, 2, 1]                  # buckets 32, 8, 2, 1
    n_req = sum(groups)
    qcls = rng.integers(0, NUM_CLASSES, n_req)
    queries = (centers[qcls] + rng.normal(size=(n_req, DIM))).astype(
        np.float32)
    ls = rng.integers(1, L + 1, n_req)
    ls[0], ls[1] = 1, L
    cuts = np.cumsum([0] + groups)
    gq = [queries[a:b] for a, b in zip(cuts[:-1], cuts[1:])]
    gl = [ls[a:b] for a, b in zip(cuts[:-1], cuts[1:])]
    out["data_s"] = time.perf_counter() - t_phase
    D = f64_dists(points, queries)                      # (40, n) f64
    lab_t = {"vote": torch.as_tensor(labels, device=dev),
             "regress": torch.as_tensor(targets, device=dev)}
    bayes = bayes_labels(queries, centers)

    launches, answers, servers, checks = {}, {}, {}, {}
    for name, kw, needs in PREDICT_RUNS:
        cfg = CONFIG.replace(num_classes=NUM_CLASSES, **kw)
        mode = cfg.predict
        srv = KnnServer(points, labels=labels if mode == "vote" else targets,
                        cfg=cfg, shards=K, device=dev, seed=0)
        srv.warmup()
        seen = capture_ensemble(srv) if cfg.predict_mode == "ensemble" else None
        res, counts = run_and_count(srv, gq, gl, needs, name)
        want = (len(groups) if cfg.route == "pruned"
                and cfg.route_compute == "device" else 0)
        if counts["route_index_mask"] != want:
            raise PhaseError(f"{name}: {counts['route_index_mask']} routing "
                             f"launches for {len(groups)} batches, want "
                             f"{want}")
        launches[name], answers[name], servers[name] = counts, res, srv
        host = labels if mode == "vote" else targets
        bad = ties = 0
        if cfg.predict_mode == "exact":
            for q, l, r, row in zip(queries, ls, res, range(n_req)):
                if r.predict_mode != "exact":
                    raise PhaseError(f"{name}: predict_mode {r.predict_mode}")
                if cfg.search == "exact":
                    brute_check(points, torch.as_tensor(q, device=dev),
                                int(l), r)
                n = int(np.isfinite(r.dists).sum())
                bad += label_check(r, host[r.ids[:n]], mode)
                if cfg.search == "exact":
                    b, t = brute_vote_check(r, D[row], lambda i: i,
                                            lambda i: host[i], mode)
                    bad, ties = bad + b, ties + t
            if cfg.search == "approx":
                rec = [len(set(r.ids.tolist()) & set(torch.topk(
                    D[row], int(l), largest=False)[1].cpu().numpy().tolist()))
                    / int(l) for row, (l, r) in enumerate(zip(ls, res))]
                checks.setdefault("approx_recall", {})[name] = dict(
                    min=min(rec), mean=float(np.mean(rec)))
        else:
            bad, ties = ensemble_check(cfg, seen, res, D, lab_t[mode], K, M,
                                       name)
            if any(not (np.isinf(r.dists).all()
                        and (r.ids == INT32_MAX).all()) for r in res):
                raise PhaseError(f"{name}: an ensemble answer carries ids")
        if bad:
            raise PhaseError(f"{name}: {bad} label mismatches")
        if srv.obs_snapshot()["audit"]["contract"]["violations"]:
            raise PhaseError(f"{name}: contract audit violations")
        checks[name] = dict(mismatches=bad, near_ties=ties,
                            touched=sorted({r.shards_touched for r in res}),
                            rounds=sorted({r.rounds for r in res}),
                            messages=sorted({r.messages for r in res}))
        log(f"  [{gpu}] {name}: {n_req} requests, 0 label mismatches "
            f"({ties} near-ties reported), touched "
            f"{checks[name]['touched']}, rounds {checks[name]['rounds']}, "
            f"messages {checks[name]['messages']}; launches {counts}")
    exact = np.array([r.label for r in answers["predict_exact_vote"]])
    ens = np.array([r.label for r in answers["predict_ensemble_vote"]])
    agreement = float((exact == ens).mean())
    floor = CONFIG.accuracy_floor
    acc = {name: float((np.array([r.label for r in answers[name]])
                        == bayes).mean())
           for name in ("predict_exact_vote", "predict_ensemble_vote")}
    out.update(launches=launches, checks=checks, agreement=agreement,
               accuracy_floor=floor, bayes_accuracy=acc)
    log(f"  [{gpu}] ensemble-vs-exact label agreement {agreement:.4f} "
        f"(floor {floor}); accuracy against bayes_labels: {acc}")
    if agreement < floor:
        raise PhaseError(f"ensemble agreement {agreement} < {floor}")

    # timing: the batch of 32 with and without the fold, the fold's device
    # time (label gather + histogram), the ensemble's batch
    q32, l32 = gq[0], [int(x) for x in gl[0]]
    nopred = KnnServer(points, cfg=CONFIG, shards=K, device=dev, seed=0)
    nopred.warmup()
    tim = {}
    for name, srv in (("predict_none", nopred),
                      ("exact_vote", servers["predict_exact_vote"]),
                      ("ensemble_vote", servers["predict_ensemble_vote"])):
        tim[name + "_wall_ms"] = wall_p50_ms(lambda: srv.query_batch(q32,
                                                                    l32))
    kept = []
    real = knn_mod.knn_query_batched

    def keep(*a, **kw):
        kept.append(real(*a, **kw))
        return kept[-1]
    knn_mod.knn_query_batched = keep
    try:
        servers["predict_exact_vote"].query_batch(q32, l32)
    finally:
        knn_mod.knn_query_batched = real
    res = kept[-1]
    lt = torch.as_tensor(np.asarray(l32, np.int32), device=dev)
    base = (torch.arange(K, device=dev) * M).view(K, 1, 1).int()
    slots = torch.where(res.local_ids == INT32_MAX, INT32_MAX,
                        res.local_ids - base)
    lab_km = lab_t["vote"].view(K, M)
    tim["fold_device_ms"] = device_total_ms(lambda: pm.exact_predict(
        res, lt, predict="vote", num_classes=NUM_CLASSES))
    tim["label_gather_device_ms"] = device_total_ms(
        lambda: knn_mod._gather_at(lab_km, slots, 0.0))
    out["timing"] = tim
    log(f"  [{gpu}] batch of {B} wall p50 (ms): predict='none' "
        f"{tim['predict_none_wall_ms'][0]:.3f}, exact vote "
        f"{tim['exact_vote_wall_ms'][0]:.3f}, ensemble vote "
        f"{tim['ensemble_vote_wall_ms'][0]:.3f}; device time of the fold "
        f"(vote + histogram) {tim['fold_device_ms']:.4f} ms and of the "
        f"label gather {tim['label_gather_device_ms']:.4f} ms")
    del servers, nopred, srv, res, kept, D, points, lab_t, lab_km
    torch.cuda.empty_cache()

    # the labeled store, at 2^20 slots
    t_store = time.perf_counter()
    scfg = CONFIG.replace(predict="vote", num_classes=NUM_CLASSES,
                          store_capacity_per_shard=PREDICT_STORE_CAP,
                          store_staging_size=1 << 30)
    spts, scls, scent = labeled_mixture(
        PREDICT_STORE_LIVE + 8192, DIM, NUM_CLASSES,
        separation=PREDICT_SEPARATION, seed=PREDICT_SEED + 2)
    slab = scls.astype(np.float32)
    st = MutableStore(DIM, device=dev, track_history=True,
                      **scfg.store_kwargs())
    step = 1 << 16
    for a in range(0, PREDICT_STORE_LIVE, step):
        b = min(a + step, PREDICT_STORE_LIVE)
        st.insert(spts[a:b], labels=slab[a:b])
        st.flush()
    prefill_s = time.perf_counter() - t_store
    srng = np.random.default_rng(PREDICT_SEED + 3)
    sq = (scent[srng.integers(0, NUM_CLASSES, n_req)]
          + srng.normal(size=(n_req, DIM))).astype(np.float32)
    sl = srng.integers(1, L + 1, n_req)
    sl[0], sl[1] = 1, L
    sl_big = srng.integers(1, PREDICT_STORE_L_MAX + 1, n_req)
    sl_big[:3] = 1, 257, PREDICT_STORE_L_MAX
    sgq = [sq[a:b] for a, b in zip(cuts[:-1], cuts[1:])]
    store_runs = (
        ("store_exact_vote", scfg, sl, ["distance_topk", "local_topk"]),
        ("store_ensemble_vote", scfg.replace(predict_mode="ensemble"), sl,
         ["distance_topk", "local_topk"]),
        ("store_exact_vote_large_l",
         scfg.replace(l_max=PREDICT_STORE_L_MAX), sl_big,
         ["l2_distance", "local_topk"]))
    sservers = {name: KnnServer(store=st, cfg=c, device=dev, seed=0)
                for name, c, _, _ in store_runs}
    seen = capture_ensemble(sservers["store_ensemble_vote"])
    for srv in sservers.values():
        srv.warmup()
    expect = dict(zip(range(len(slab)), slab.tolist()))  # id -> label
    stages, prev = [], None
    slaunch = {name: {c: 0 for c in COUNTERS} for name, *_ in store_runs}

    def serve_stage(stage):
        gen = st.generation
        lid, lpts = st.history(gen)             # the generation's live set
        snap = st.snapshot()
        lp = torch.as_tensor(lpts, device=dev)
        Dl = f64_dists(lp, sq)
        Ds = f64_dists(snap.points, sq)
        Ds = torch.where(snap.valid[None], Ds, float("inf"))
        slab_t = torch.as_tensor(st._labels, device=dev)
        entry = dict(stage=stage, generation=gen, live=st.live_count)
        for name, c, lss, needs in store_runs:
            seen.clear()
            res, counts = run_and_count(
                sservers[name], sgq,
                [lss[a:b] for a, b in zip(cuts[:-1], cuts[1:])], needs, name)
            for cname, v in counts.items():
                slaunch[name][cname] += v
            if name.endswith("large_l") and counts["distance_topk"]:
                raise PhaseError(f"{name}: distance_topk launched above "
                                 f"one pass")
            bad = ties = 0
            if c.predict_mode == "ensemble":
                bad, ties = ensemble_check(c, seen, res, Ds, slab_t, K,
                                           PREDICT_STORE_CAP, name)
            else:
                for row, (q, l, r) in enumerate(zip(sq, lss, res)):
                    store_check(r, truth_on_card(
                        lid, lp, torch.as_tensor(q, device=dev), int(l)),
                        int(l), gen, name)
                    n = int(np.isfinite(r.dists).sum())
                    bad += label_check(r, st.labels_for(r.ids[:n]), "vote")
                    b, t = brute_vote_check(r, Dl[row], lambda i: lid[i],
                                            st.labels_for, "vote")
                    bad, ties = bad + b, ties + t
            if bad:
                raise PhaseError(f"{name} at {stage}: {bad} label "
                                 f"mismatches")
            entry[name] = dict(near_ties=ties, labels=[r.label for r in res])
        return entry

    stages.append(serve_stage("prefill"))

    def nearest():
        """Each query's nearest live neighbour's id, in f64."""
        snap = st.snapshot()
        d = torch.where(snap.valid[None], f64_dists(snap.points, sq),
                        float("inf"))
        return np.unique(snap.ids[d.argmin(-1)].cpu().numpy())

    def changed(a, b):
        return sum(x != y for x, y in zip(
            stages[a]["store_exact_vote"]["labels"],
            stages[b]["store_exact_vote"]["labels"]))
    # give each query's nearest neighbour another label (points kept), so
    # the votes at small l move; then delete those neighbours
    near = nearest()
    lid_all, lpts = st.live_arrays()
    new = (st.labels_for(near) + 1) % NUM_CLASSES
    st.update(near, lpts[np.searchsorted(lid_all, near)], labels=new)
    st.flush()
    expect.update(zip(near.tolist(), new.tolist()))
    stages.append(serve_stage("relabelled_nearest"))
    st.delete(near)
    st.flush()
    stages.append(serve_stage("deleted_nearest"))
    moved = (changed(0, 1), changed(1, 2))
    # more labeled points, then an explicit compact()
    a = PREDICT_STORE_LIVE
    st.insert(spts[a:], labels=slab[a:])
    st.flush()
    t1 = time.perf_counter()
    st.compact()
    compact_s = time.perf_counter() - t1
    stages.append(serve_stage("compacted"))
    # labels_for against the phase's own id -> label map and the host
    # mirror; the device labels against the mirror
    ids_all = np.arange(len(slab))
    want = np.array([expect[i] for i in ids_all], np.float32)
    if not np.array_equal(st.labels_for(ids_all), want):
        raise PhaseError("labels_for differs from the labels written")
    lid, llab = st.live_labels()
    if not np.array_equal(llab, want[lid]) or not np.array_equal(
            st.snapshot().labels.cpu().numpy(), st._labels):
        raise PhaseError("the live labels or the device labels differ from "
                         "the host mirror")
    for name, srv in sservers.items():
        if srv.obs_snapshot()["audit"]["contract"]["violations"]:
            raise PhaseError(f"{name}: contract audit violations")
    out["store"] = dict(
        capacity_slots=K * PREDICT_STORE_CAP, prefill_s=prefill_s,
        prefill_rate=PREDICT_STORE_LIVE / prefill_s, compact_s=compact_s,
        relabelled_then_deleted=int(len(near)),
        exact_labels_changed=dict(relabel=int(moved[0]),
                                  delete=int(moved[1])), launches=slaunch,
        stages=[{k: (v if k in ("stage", "generation", "live") else
                     {"near_ties": v["near_ties"]})
                 for k, v in e.items()} for e in stages],
        s=time.perf_counter() - t_store)
    log(f"  [{gpu}] labeled store ({K * PREDICT_STORE_CAP} slots): prefill "
        f"{PREDICT_STORE_LIVE} in {prefill_s:.1f} s; stages "
        f"{[(e['stage'], e['generation'], e['live']) for e in stages]}, "
        f"every answer's label equal to the f64 vote over its generation "
        f"(exact, ensemble, l_max={PREDICT_STORE_L_MAX}); relabelling the "
        f"{len(near)} queries' nearest neighbours changed {moved[0]} exact "
        f"labels, deleting them {moved[1]}; compact() "
        f"{compact_s:.2f} s; labels_for and the device labels equal the "
        f"host mirror; launches {slaunch}")
    launches.update(slaunch)
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  [{gpu}] serve_predict phase_s {out['phase_s']:.1f}, "
        f"max_memory_allocated {out['max_memory_allocated']} bytes")
    results["serve_predict"] = out
    del sservers, st
    torch.cuda.empty_cache()


# ---- phases 3g-3h: LM serving at full width ---------------------------------

LM_ARCH = "qwen2-0.5b"
LM_SHARDS = 8                 # vocabulary shards: 151,936 = 8 x 18,992
LM_BATCH, LM_PROMPT, LM_NEW = 8, 128, 64
LM_TOP_K, LM_TEMP = 50, 0.8
LM_F64_STEPS = 8              # decode steps held against the f64 model
LM_F64_REL = 1e-3             # ... within this times max |logit|
DECODE_TOL = 5e-3             # tests/test_decode_consistency.py:58-59
PREFILL_TOL = 5e-4
KNN_LM_KEYS = 1 << 22         # datastore keys, d = 896 (15.03 GB in f32)
KNN_LM_SCALE = 0.02           # keys at the embedding table's scale
KNN_LM_STEPS = 16             # at the example's L = 8, each knn sampler
KNN_LM_LARGE_STEPS = 4        # at l_max = L_LARGE
MIX_TOL = 1e-5                # mixed probability vs the f64 host mixture
# the datastore and queries of serve_knn_lm, kept for phase 4's timing
LM_INPUTS = {}


def lm_server_run(api, params, batch, sampler, observe, key):
    from repro_torch.runtime import ServeConfig, Server
    srv = Server(api, params, ServeConfig(
        max_seq=LM_PROMPT + LM_NEW + 8, top_k=LM_TOP_K,
        temperature=LM_TEMP, sampler=sampler), shards=LM_SHARDS,
        observe=observe)
    return srv.generate(batch, LM_NEW, key=key)


def phase_serve_lm(dev, gpu, results):
    """qwen2-0.5b at full width (f32, seeded init) through Server.generate
    over 8 vocabulary shards, both samplers: checked runs (each step's
    distributed top-k against a stable descending sort of the row on the
    card; prefill and the first decode steps against the same model in
    f64; decode against a teacher-forced forward), then timed runs and
    one profiled step of each."""
    import copy
    import numpy as np
    import torch
    import repro_torch.configs as configs
    from repro_torch.kernels import ops as kops
    from repro_torch.models import build_model

    cfg = configs.get(LM_ARCH)
    if cfg.vocab // LM_SHARDS != 18992 or cfg.vocab % LM_SHARDS:
        raise PhaseError("qwen2-0.5b's vocabulary moved; update the shards")
    api = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = api.init_params(0, device=dev)
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in params.parameters())
    rng = np.random.default_rng(20)
    prompt = rng.integers(0, cfg.vocab, (LM_BATCH, LM_PROMPT)).astype(
        np.int32)
    batch = {"tokens": prompt}
    out, gens, launches, logged = {}, {}, {}, {}
    for sampler in ("selection", "gather"):
        steps, bad = [], []

        def observe(logits, res):
            srt = torch.sort(logits, dim=-1, descending=True, stable=True)
            if not (torch.equal(res.indices.long(),
                                srt.indices[:, :LM_TOP_K])
                    and torch.equal(res.values, srt.values[:, :LM_TOP_K])):
                bad.append(len(steps))
            steps.append(logits.clone())
        torch.cuda.synchronize()
        kops.reset_launch_counts()
        gen, _ = lm_server_run(api, params, batch, sampler, observe, key=1)
        torch.cuda.synchronize()
        counts = kops.launch_counts()
        if counts["local_topk"] < 1:
            raise PhaseError(f"serve_lm {sampler}: local_topk never "
                             f"launched")
        if bad:
            raise PhaseError(f"serve_lm {sampler}: the top-k of steps {bad} "
                             f"differs from a stable sort of the row")
        launches[f"lm_{sampler}"] = counts
        gens[sampler], logged[sampler] = gen, steps
        log(f"  [{gpu}] serve_lm {sampler}: {len(steps)} decode steps, each "
            f"top-{LM_TOP_K} (values and ids in order) equal to a stable "
            f"sort of the (B, V) row; launches {counts}")
    if not np.array_equal(gens["selection"], gens["gather"]):
        raise PhaseError("serve_lm: selection and gather drew other tokens")
    gen, steps = gens["selection"], logged["selection"]
    del logged

    # the prefill and the first decode steps against the model in f64
    p64 = copy.deepcopy(params).double()
    c32 = api.init_cache(LM_BATCH, LM_PROMPT + 8, device=dev)
    c64 = api.init_cache(LM_BATCH, LM_PROMPT + 8, dtype=torch.float64,
                         device=dev)
    pre32, _ = api.prefill(params, batch, c32)
    pre64, c64 = api.prefill(p64, batch, c64)

    def rel(got, want):
        return float((got.double() - want).abs().max() / want.abs().max())
    f64_err = [rel(pre32, pre64)]
    for i in range(LM_F64_STEPS):
        want, c64 = api.decode_step(p64, torch.as_tensor(gen[:, i],
                                                         device=dev), c64)
        f64_err.append(rel(steps[i], want))
    del p64, c64, c32
    if max(f64_err) > LM_F64_REL:
        raise PhaseError(f"serve_lm: logits vs f64 {f64_err} above "
                         f"{LM_F64_REL} x max |logit|")
    # decode against the teacher-forced forward over the generated tokens
    ext = np.concatenate([prompt, gen[:, :-1]], 1)
    with torch.no_grad():
        full, _ = api.forward(params, {"tokens": ext})
    pre_err = float((pre32 - full[:, LM_PROMPT - 1]).abs().max())
    dec_err = max(float((s - full[:, LM_PROMPT + i]).abs().max())
                  for i, s in enumerate(steps))
    max_logit = float(full.abs().max())
    del full, steps, pre32, pre64
    if pre_err > PREFILL_TOL or dec_err > DECODE_TOL:
        raise PhaseError(f"serve_lm: vs teacher forcing prefill {pre_err}, "
                         f"decode {dec_err}")
    log(f"  [{gpu}] serve_lm: selection and gather drew the same "
        f"{gen.shape} tokens; prefill + {LM_F64_STEPS} decode steps vs f64: "
        f"max rel {max(f64_err):.3g} (max |logit| {max_logit:.3f}); vs "
        f"teacher forcing prefill {pre_err:.3g}, decode {dec_err:.3g}")

    # timed runs: no comparisons in the loop
    bound_ms = weight_bytes / PEAK_BYTES_S * 1e3
    for sampler in ("selection", "gather"):
        sel = []
        torch.cuda.synchronize()
        again, stats = lm_server_run(
            api, params, batch, sampler,
            lambda lg, r: sel.append((r.iterations, r.host_syncs)), key=1)
        if not np.array_equal(again, gen):
            raise PhaseError(f"serve_lm {sampler}: the timed run drew "
                             f"other tokens")
        its = [a for a, _ in sel]
        syncs = [b for _, b in sel]
        decode_ms = stats["decode_s"] / (LM_NEW - 1) * 1e3
        out[sampler] = dict(
            prefill_ms=stats["prefill_s"] * 1e3, decode_ms_per_step=decode_ms,
            tok_per_s=stats["tok_per_s"], weight_read_bound_ms=bound_ms,
            iterations_per_step=dict(mean=float(np.mean(its)),
                                     min=min(its), max=max(its)),
            host_syncs_per_step=dict(mean=float(np.mean(syncs)),
                                     min=min(syncs), max=max(syncs)))
        log(f"  [{gpu}] serve_lm {sampler}: prefill {LM_BATCH}x{LM_PROMPT} "
            f"{stats['prefill_s'] * 1e3:.3f} ms; decode "
            f"{decode_ms:.3f} ms a step (weight-read bound {bound_ms:.3f} "
            f"ms for {weight_bytes} bytes); {stats['tok_per_s']:.1f} "
            f"tokens/s; selection iterations a step "
            f"{out[sampler]['iterations_per_step']}, host syncs "
            f"{out[sampler]['host_syncs_per_step']}")
    # where a decode step goes: one serve_step of each sampler under
    # torch.profiler (device time, kernel launches, the top device items)
    from torch.profiler import ProfilerActivity, profile
    for sampler in ("selection", "gather"):
        cache = api.init_cache(LM_BATCH, LM_PROMPT + 8, device=dev)
        lg, cache = api.prefill(params, batch, cache)
        tok = torch.argmax(lg, -1).to(torch.int32)
        step = lambda: api.serve_step(                     # noqa: E731
            params, tok, cache, 7, shards=LM_SHARDS, top_k=LM_TOP_K,
            temperature=LM_TEMP, sampler=sampler)[0].cpu()
        step()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step()
            prof_wall = time.perf_counter() - t0
        ka = prof.key_averages()
        # device-side events only; the aten:: rows repeat their kernels'
        dev_us = {e.key: getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0))
                  for e in ka if not e.key.startswith("aten::")}
        top = sorted(((us, k) for k, us in dev_us.items() if us),
                     reverse=True)[:5]
        dev_ms = sum(dev_us.values()) / 1e3
        out[sampler].update(
            profiled_device_ms=dev_ms, profiled_wall_ms=prof_wall * 1e3,
            device_busy_share=dev_ms / (prof_wall * 1e3),
            launches_per_step=sum(e.count for e in ka
                                  if e.key == "cudaLaunchKernel"),
            top_device_ms={k[:60]: us / 1e3 for us, k in top})
        log(f"  [{gpu}] serve_lm {sampler}: one profiled step "
            f"{dev_ms:.3f} ms of device time in {prof_wall * 1e3:.3f} ms "
            f"({100 * out[sampler]['device_busy_share']:.1f}% busy), "
            f"{out[sampler]['launches_per_step']} kernel launches (wall "
            f"unprofiled {out[sampler]['decode_ms_per_step']:.3f} ms); top "
            f"{out[sampler]['top_device_ms']}")
        del cache, lg
    peak = torch.cuda.max_memory_allocated()
    log(f"  [{gpu}] serve_lm: max_memory_allocated {peak} bytes")
    results["serve_lm"] = dict(
        runs=out, launches=launches, f64_max_rel_err=f64_err,
        prefill_err=pre_err, decode_err=dec_err, max_abs_logit=max_logit,
        weight_bytes=weight_bytes, max_memory_allocated=peak,
        shape=dict(batch=LM_BATCH, prompt=LM_PROMPT, new=LM_NEW,
                   shards=LM_SHARDS, top_k=LM_TOP_K, temperature=LM_TEMP))
    del params
    torch.cuda.empty_cache()


# phase serve_families: each arch with its cut, in the order run; the
# sizes fit f32 weights and the f64 twin on one 80 GB card
FAM_RUNS = (
    ("granite-moe-3b-a800m", {}),
    ("xlstm-125m", {}),
    ("seamless-m4t-large-v2", {}),
    ("pixtral-12b", dict(n_layers=4)),
    ("phi3.5-moe-42b-a6.6b", dict(n_layers=2)),
    # one MoE layer of the full width is 38.7 GB: d_model 8192 -> 2048
    ("jamba-1.5-large-398b", dict(d_model=2048, n_heads=16, n_kv_heads=2,
                                  head_dim=128, d_ff=6144, n_layers=8,
                                  n_experts=16, moe_top_k=2)),
)
FAM_CONTINUOUS = ("xlstm-125m", "seamless-m4t-large-v2", "pixtral-12b")
FAM_BATCH, FAM_PROMPT, FAM_NEW = 8, 128, 32
FAM_F64_STEPS = 4             # decode steps held against the f64 twin
FAM_TRAIN = (("granite-moe-3b-a800m", dict(n_layers=2)), ("xlstm-125m", {}))
FAM_TRAIN_STEPS = 3


def family_config(arch, cut):
    import dataclasses
    import repro_torch.configs as configs
    return dataclasses.replace(configs.get(arch), **cut)


class RouteLog:
    """Wraps ``repro_torch.models.moe.route``: in ``record`` mode it keeps
    each call's expert ids; in ``replay`` mode it hands them back in the
    same order, the gates computed from the call's own probabilities, and
    counts the (token, k) slots where the call's own routing differs."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.orig = moe, moe.route
        self.ids, self.mode, self.at, self.flips = [], None, 0, 0

    def __call__(self, probs, top_k):
        gate, idx = self.orig(probs, top_k)
        if self.mode == "record":
            self.ids.append(idx.clone())
        elif self.mode == "replay":
            want = self.ids[self.at]
            self.at += 1
            self.flips += int((idx != want).sum())
            gate = probs.gather(-1, want)
            gate, idx = gate / gate.sum(-1, keepdim=True), want
        return gate, idx

    def __enter__(self):
        self.moe.route = self
        return self

    def __exit__(self, *exc):
        self.moe.route = self.orig


def mamba_clip_gap(p64, batch, api, dev):
    """The f64 prefill's chunked (clipped) final SSM state of each Mamba
    layer against the exact recurrence over the same layer input, token
    by token: ``[max |chunked - exact| / max |exact|]`` a layer."""
    import torch
    from repro_torch.models import mamba
    inputs, orig = [], mamba.mamba_prefill

    def keep(p, x, cache, **kw):
        inputs.append((p, x.clone()))
        return orig(p, x, cache, **kw)
    cfg = api.cfg
    mamba.mamba_prefill = keep
    try:
        api.prefill(p64, batch, api.init_cache(
            FAM_BATCH, FAM_PROMPT + 8, dtype=torch.float64, device=dev))
    finally:
        mamba.mamba_prefill = orig
    gaps = []
    with torch.no_grad():
        for p, x in inputs:
            kw = dict(expand=cfg.mamba_expand, d_state=cfg.mamba_d_state,
                      d_conv=cfg.mamba_d_conv, dtype=x.dtype, device=dev)
            chunked = mamba.init_mamba_cache(x.shape[0], cfg.d_model, **kw)
            mamba.mamba_prefill(p, x, chunked, d_state=cfg.mamba_d_state)
            exact = mamba.init_mamba_cache(x.shape[0], cfg.d_model, **kw)
            for t in range(x.shape[1]):
                mamba.mamba_decode_step(p, x[:, t:t + 1], exact,
                                        d_state=cfg.mamba_d_state)
            gaps.append(float((chunked.ssm - exact.ssm).abs().max()
                              / exact.ssm.abs().max()))
    return gaps


def family_run(dev, gpu, arch, cut, launches):
    """serve_families for one arch: checked runs under both samplers,
    the f64 twin, teacher forcing or the Mamba clip, a timed run and a
    profiled step.  Returns its record."""
    import copy
    import numpy as np
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.serve import stub_inputs
    from repro_torch.models import build_model
    from repro_torch.runtime import ServeConfig, Server

    cfg = family_config(arch, cut)
    api = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = api.init_params(0, device=dev)
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in params.parameters())
    rng = np.random.default_rng(22)
    prompt = rng.integers(0, cfg.vocab, (FAM_BATCH, FAM_PROMPT)).astype(
        np.int32)
    batch = {"tokens": prompt, **stub_inputs(cfg, rng, FAM_BATCH)}
    P = cfg.num_prefix_embeds if cfg.family == "vlm" else 0
    max_seq = P + FAM_PROMPT + FAM_NEW + 8

    def server(sampler, observe=None):
        return Server(api, params, ServeConfig(
            max_seq=max_seq, top_k=LM_TOP_K, temperature=LM_TEMP,
            sampler=sampler), shards=LM_SHARDS, observe=observe)

    gens, logged = {}, {}
    for sampler in ("selection", "gather"):
        steps, bad = [], []

        def observe(logits, res):
            srt = torch.sort(logits, dim=-1, descending=True, stable=True)
            if not (torch.equal(res.indices.long(),
                                srt.indices[:, :LM_TOP_K])
                    and torch.equal(res.values, srt.values[:, :LM_TOP_K])):
                bad.append(len(steps))
            steps.append(logits.clone())
        torch.cuda.synchronize()
        kops.reset_launch_counts()
        gen, _ = server(sampler, observe).generate(batch, FAM_NEW, key=1)
        torch.cuda.synchronize()
        counts = kops.launch_counts()
        if counts["local_topk"] < 1:
            raise PhaseError(f"serve_families {arch} {sampler}: local_topk "
                             f"never launched")
        if bad:
            raise PhaseError(f"serve_families {arch} {sampler}: the top-k of "
                             f"steps {bad} differs from a stable sort")
        launches[f"fam_{arch}_{sampler}"] = counts
        gens[sampler], logged[sampler] = gen, steps
    if not np.array_equal(gens["selection"], gens["gather"]):
        raise PhaseError(f"serve_families {arch}: the samplers drew other "
                         f"tokens")
    gen, steps = gens["selection"], logged.pop("selection")
    del logged

    # prefill and the first decode steps against the f64 twin, which
    # replays the f32 run's routing
    def check_run(model, dtype, routes, mode):
        routes.mode = mode
        cache = api.init_cache(FAM_BATCH, max_seq, dtype=dtype, device=dev)
        out = [api.prefill(model, batch, cache)[0]]
        for i in range(FAM_F64_STEPS):
            lg, cache = api.decode_step(model, torch.as_tensor(
                gen[:, i], device=dev), cache)
            out.append(lg)
        routes.mode = None
        return out
    with RouteLog() as routes:
        got = check_run(params, torch.float32, routes, "record")
        p64 = copy.deepcopy(params).double()
        want = check_run(p64, torch.float64, routes, "replay")
    f64_err = [float((g.double() - w).abs().max() / w.abs().max())
               for g, w in zip(got, want)]
    if max(f64_err) > LM_F64_REL:
        raise PhaseError(f"serve_families {arch}: logits vs f64 {f64_err} "
                         f"above {LM_F64_REL} x max |logit|")
    rec = dict(cut=cut, weight_bytes=weight_bytes, f64_max_rel_err=f64_err,
               route_calls=len(routes.ids), f64_route_flips=routes.flips,
               max_abs_logit=float(want[0].abs().max()))
    pre32 = got[0]
    del got, want
    msg = (f"prefill + {FAM_F64_STEPS} decode steps vs f64 max rel "
           f"{max(f64_err):.3g}")
    if cfg.n_experts:
        msg += (f" (routing of {len(routes.ids)} calls replayed; f64 would "
                f"have routed {routes.flips} slots otherwise)")
    if cfg.family == "hybrid":
        rec["mamba_clip_gap"] = gaps = mamba_clip_gap(p64, batch, api, dev)
        msg += f"; Mamba chunked vs exact final state, rel {max(gaps):.3g}"
    del p64
    torch.cuda.empty_cache()
    if arch in FAM_CONTINUOUS:
        ext = dict(batch, tokens=np.concatenate([prompt, gen[:, :-1]], 1))
        with torch.no_grad():
            full, _ = api.forward(params, ext)
        pre_err = float((pre32 - full[:, P + FAM_PROMPT - 1]).abs().max())
        dec_err = max(float((s - full[:, P + FAM_PROMPT + i]).abs().max())
                      for i, s in enumerate(steps))
        del full
        if pre_err > PREFILL_TOL or dec_err > DECODE_TOL:
            raise PhaseError(f"serve_families {arch}: vs teacher forcing "
                             f"prefill {pre_err}, decode {dec_err}")
        rec.update(prefill_err=pre_err, decode_err=dec_err)
        msg += f"; vs teacher forcing prefill {pre_err:.3g}, decode " \
               f"{dec_err:.3g}"
    del steps
    log(f"  [{gpu}] serve_families {arch}: {FAM_NEW - 1} decode steps a "
        f"sampler, each top-{LM_TOP_K} equal to a stable sort, the samplers' "
        f"tokens equal; {msg}")

    # a timed run (no comparisons), then one profiled serve_step
    again, stats = server("selection").generate(batch, FAM_NEW, key=1)
    if not np.array_equal(again, gen):
        raise PhaseError(f"serve_families {arch}: the timed run drew other "
                         f"tokens")
    cache = api.init_cache(FAM_BATCH, max_seq, device=dev)
    lg, cache = api.prefill(params, batch, cache)
    tok = torch.argmax(lg, -1).to(torch.int32)
    wall, dev_ms, nlaunch, by_kernel = profiled_step(
        lambda: api.serve_step(params, tok, cache, 7, shards=LM_SHARDS,
                               top_k=LM_TOP_K, temperature=LM_TEMP))
    top = dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:4])
    rec.update(
        prefill_ms=stats["prefill_s"] * 1e3,
        decode_ms_per_step=stats["decode_s"] / (FAM_NEW - 1) * 1e3,
        tok_per_s=stats["tok_per_s"],
        weight_read_bound_ms=weight_bytes / PEAK_BYTES_S * 1e3,
        profiled_wall_ms=wall, profiled_device_ms=dev_ms,
        device_busy_share=dev_ms / wall, launches_per_step=nlaunch,
        top_device_ms={k[:60]: v for k, v in top.items()},
        max_memory_allocated=torch.cuda.max_memory_allocated())
    log(f"  [{gpu}] serve_families {arch}: prefill {FAM_BATCH}x"
        f"{P + FAM_PROMPT} {rec['prefill_ms']:.3f} ms; decode "
        f"{rec['decode_ms_per_step']:.3f} ms a step (weight-read bound "
        f"{rec['weight_read_bound_ms']:.3f} ms for {weight_bytes} bytes); "
        f"{stats['tok_per_s']:.1f} tokens/s; one profiled step {dev_ms:.3f} "
        f"ms of device time in {wall:.3f} ms ({100 * dev_ms / wall:.1f}% "
        f"busy), {nlaunch} launches; peak memory "
        f"{rec['max_memory_allocated']} bytes")
    return rec


def family_train(dev, gpu, arch, cut):
    """Three ``train_loop`` steps with remat: the loss finite, every
    parameter tensor moved."""
    import math
    import torch
    from repro_torch.data import MarkovTokens
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW
    from repro_torch.runtime import (MetricLogger, TrainConfig,
                                     init_opt_state, train_loop)
    cfg = family_config(arch, cut)
    api = build_model(cfg)
    params = api.init_params(0, device=dev, train=True)
    start = {n: p.detach().clone() for n, p in params.named_parameters()}
    tcfg = TrainConfig(grad_accum=2, peak_lr=1e-3, warmup_steps=1,
                       total_steps=FAM_TRAIN_STEPS, remat=True)
    opt = AdamW()
    data = MarkovTokens(cfg.vocab, seed=0, branch=2, n_contexts=13)

    def make_batch(step):
        t, l = data.batch(step, FAM_BATCH, FAM_PROMPT)
        return {"tokens": t, "labels": l}
    logger = MetricLogger()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, _, step = train_loop(
        api=api, tcfg=tcfg, optimizer=opt, params=params,
        opt_state=init_opt_state(api, tcfg, opt, params),
        make_batch=make_batch, num_steps=FAM_TRAIN_STEPS, logger=logger,
        device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = [r["loss"] for r in logger.history if "loss" in r]
    still = [n for n, p in params.named_parameters()
             if torch.equal(p.detach(), start[n])]
    if step != FAM_TRAIN_STEPS or not all(map(math.isfinite, losses)):
        raise PhaseError(f"serve_families train {arch}: steps {step}, "
                         f"losses {losses}")
    if still:
        raise PhaseError(f"serve_families train {arch}: {still[:4]} did not "
                         f"move")
    log(f"  [{gpu}] serve_families train {arch} {cut}: {step} steps of "
        f"{FAM_BATCH}x{FAM_PROMPT} with remat, losses {losses}, every "
        f"parameter moved, {wall:.3f} s")
    return dict(cut=cut, losses=losses, wall_s=wall)


def phase_serve_families(dev, gpu, results):
    """The moe, hybrid, vlm, audio and ssm families (FAM_RUNS: granite-
    moe-3b at full width and depth, the others at the cuts listed),
    f32 seeded, B = 8 prompts of 128 tokens (the vlm's after 256 stub
    patch embeds, the audio's over 1,024 stub frames), 32 new tokens
    through Server.generate over 8 vocabulary shards at top_k 50, both
    samplers: each step's top-k equal to a stable sort of its row, the
    samplers' tokens equal, local_topk launched; prefill and 4 decode
    steps within 1e-3 x max |logit| of the f64 twin (which replays the
    f32 run's MoE routing); decode against teacher forcing for the
    continuous families; jamba's chunked Mamba state against the exact
    recurrence in f64 (reported); timings and one profiled step; then
    three train_loop steps of granite at 2 layers and xlstm.  One model
    at a time, freed before the next."""
    import gc
    import torch
    launches, out = {}, {}
    for arch, cut in FAM_RUNS:
        out[arch] = family_run(dev, gpu, arch, cut, launches)
        gc.collect()
        torch.cuda.empty_cache()
    train = {arch: family_train(dev, gpu, arch, cut)
             for arch, cut in FAM_TRAIN}
    gc.collect()
    torch.cuda.empty_cache()
    results["serve_families"] = dict(
        runs=out, train=train, launches=launches,
        shape=dict(batch=FAM_BATCH, prompt=FAM_PROMPT, new=FAM_NEW,
                   shards=LM_SHARDS, top_k=LM_TOP_K, temperature=LM_TEMP))


def brute_f64(keys, q, l, chunk=1 << 18):
    """The l + 1 nearest keys of each query ``q`` (B, d), in f64 over all
    of ``keys`` (n, d) on the card, chunk by chunk: ``((B, l+1) f64
    distances ascending, (B, l+1) int64 ids)``."""
    import torch
    q64 = q.double()
    q2 = (q64 * q64).sum(-1, keepdim=True)
    best_d = best_i = None
    for s in range(0, keys.shape[0], chunk):
        kc = keys[s:s + chunk].double()
        d = q2 - 2.0 * q64 @ kc.t() + (kc * kc).sum(-1)[None]
        del kc
        v, i = torch.topk(d, min(l + 1, d.shape[1]), largest=False)
        i = i + s
        if best_d is not None:
            v, j = torch.topk(torch.cat([best_d, v], 1), l + 1,
                              largest=False)
            i = torch.cat([best_i, i], 1).gather(1, j)
        best_d, best_i = v, i
    return best_d, best_i


def retrieval_check(keys, values, q_np, res, l, what, mag_p):
    """Each served answer against an f64 brute force over the datastore:
    distances within 1e-5 relative plus the f32 rounding of the expanded
    distance, ``32 * 2^-23 * (|q|^2 + max |p|^2)`` (``mag_p`` the last
    term); the id set equal where rank l and l + 1 lie farther apart than
    that, else the ids below the tie; the tokens the datastore's values
    at the ids.  Returns (near ties, max abs distance error)."""
    import numpy as np
    import torch
    bd, bi = brute_f64(keys, torch.as_tensor(q_np, device=keys.device), l)
    bd, bi = bd.cpu().numpy(), bi.cpu().numpy()
    q2 = (q_np.astype(np.float64) ** 2).sum(-1)
    ties, err = 0, 0.0
    for b, r in enumerate(res):
        tol = 1e-5 * abs(bd[b, l - 1]) + 32 * 2.0 ** -23 * (q2[b] + mag_p)
        if len(r.dists) != l or not np.all(np.abs(r.dists - bd[b, :l])
                                           <= tol):
            raise PhaseError(f"{what} row {b}: distances differ from the "
                             f"f64 brute force")
        err = max(err, float(np.abs(r.dists - bd[b, :l]).max()))
        if len(set(r.ids.tolist())) != l:
            raise PhaseError(f"{what} row {b}: repeated id")
        if not np.array_equal(r.values, values[r.ids]):
            raise PhaseError(f"{what} row {b}: tokens are not the "
                             f"datastore's values at the ids")
        if bd[b, l] - bd[b, l - 1] > tol:
            if set(r.ids.tolist()) != set(bi[b, :l].tolist()):
                raise PhaseError(f"{what} row {b}: id set differs from the "
                                 f"f64 brute force")
        else:
            ties += 1
            inner = set(bi[b, :l][bd[b, :l] < bd[b, l - 1] - tol].tolist())
            if not inner <= set(r.ids.tolist()):
                raise PhaseError(f"{what} row {b}: interior ids differ")
    return ties, err


def host_mixture(lm_logits, res, lam, temp):
    """The f64 host kNN-LM mixture (probabilities, (B, V)) from the LM
    logits and the served (dists, values): softmax over the row, the kNN
    weights softmax(-d / T) added at their tokens (duplicates add)."""
    import numpy as np
    lm = lm_logits.astype(np.float64)
    p_lm = np.exp(lm - lm.max(-1, keepdims=True))
    p_lm /= p_lm.sum(-1, keepdims=True)
    p_knn = np.zeros_like(p_lm)
    for b, r in enumerate(res):
        d = r.dists.astype(np.float64)
        fin = np.isfinite(d)
        w = np.exp(-(d[fin] - d[fin].min()) / temp)
        np.add.at(p_knn[b], np.maximum(r.values[fin], 0), w / w.sum())
    return (1 - lam) * p_lm + lam * p_knn


def phase_serve_knn_lm(dev, gpu, results):
    """The kNN-LM example at full width: qwen2-0.5b (seeded, f32) decodes
    while a static KnnServer (k = 8, route exact) serves a datastore of
    2^22 keys x 896 made on the card, through
    repro_torch.examples.knn_lm_serve.knn_lm_decode with the example's
    knobs; 16 steps at l_max = 8 under each knn sampler, 4 at l_max =
    1024.  Every retrieval against an f64 brute force, the mixture
    against an f64 host mixture, one step's core.datastore.retrieve
    against the server's answer."""
    import numpy as np
    import torch
    import repro_torch.configs as configs
    from repro_torch.core import datastore, topk
    from repro_torch.examples import knn_lm_serve as ex
    from repro_torch.kernels import ops as kops
    from repro_torch.models import build_model

    cfg = configs.get(LM_ARCH)
    api = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = api.init_params(0, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(21)
    keys = torch.randn((KNN_LM_KEYS, cfg.d_model), generator=g, device=dev)
    keys.mul_(KNN_LM_SCALE)
    mag_p = float(max((keys[s:s + (1 << 18)].double() ** 2).sum(-1).max()
                      for s in range(0, KNN_LM_KEYS, 1 << 18)))
    values = np.random.default_rng(21).integers(
        0, cfg.vocab, KNN_LM_KEYS).astype(np.int32)
    rng = np.random.default_rng(22)
    prompt = rng.integers(0, cfg.vocab, (LM_BATCH, LM_PROMPT)).astype(
        np.int32)
    runs = (("knn_lm_selection", "selection", ex.L, KNN_LM_STEPS,
             ["distance_topk", "local_topk"]),
            ("knn_lm_gather", "gather", ex.L, KNN_LM_STEPS,
             ["l2_distance", "local_topk"]),
            ("knn_lm_large", "selection", L_LARGE, KNN_LM_LARGE_STEPS,
             ["l2_distance", "local_topk"]))
    out, launches, gens = {}, {}, {}
    for run, sampler, l, n_steps, needs in runs:
        srv = ex.datastore_server(keys, values, l_max=l, batch=LM_BATCH,
                                  sampler=sampler, device=dev)
        srv.warmup()
        seen = []

        def observe(i, s):
            seen.append(dict(q=s["queries"], res=s["results"],
                             lm=s["lm_logits"].cpu().numpy(),
                             mixed=s["mixed"].transpose(0, 1).reshape(
                                 LM_BATCH, -1).cpu().numpy()))
        torch.cuda.synchronize()
        kops.reset_launch_counts()
        t0 = time.perf_counter()
        with srv.serving():
            gen, _ = ex.knn_lm_decode(api, params, srv, prompt, n_steps,
                                      l=l, shards=LM_SHARDS, observe=observe)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kops.launch_counts()
        for name in needs:
            if counts[name] < 1:
                raise PhaseError(f"{run}: {name} was never launched")
        launches[run] = counts
        ties = 0
        dist_err = mix_err = sum_err = 0.0
        for i, st in enumerate(seen):
            t, e = retrieval_check(keys, values, st["q"], st["res"], l,
                                   f"{run} step {i}", mag_p)
            ties, dist_err = ties + t, max(dist_err, e)
            p = np.exp(st["mixed"].astype(np.float64))[:, :cfg.vocab]
            sum_err = max(sum_err, float(np.abs(p.sum(-1) - 1).max()))
            want = host_mixture(st["lm"], st["res"], ex.LAM, ex.TEMP)
            mix_err = max(mix_err, float(np.abs(p - want).max()))
        if sum_err > 1e-3:
            raise PhaseError(f"{run}: exp(mixed) sums off 1 by {sum_err}")
        if mix_err > MIX_TOL:
            raise PhaseError(f"{run}: mixture vs the f64 host mixture "
                             f"{mix_err} > {MIX_TOL}")
        if run == "knn_lm_selection":
            # core.datastore.retrieve on the same shards, step 0's queries
            m = KNN_LM_KEYS // K
            store = datastore.build_local(
                keys.view(K, m, cfg.d_model),
                torch.as_tensor(values, device=dev).view(K, m))
            q0 = torch.as_tensor(seen[0]["q"], device=dev)
            with kops.counted_apart():
                ret = datastore.retrieve(store, q0, l,
                                         topk.generator(5, dev),
                                         temperature=ex.TEMP)
            r0 = seen[0]["res"]
            want_t = np.stack([r.values for r in r0])
            want_d = np.stack([r.dists for r in r0])
            # the pack is in shard order; the server's answer ascending
            order = torch.argsort(ret.dists, dim=-1, stable=True)
            got_t = ret.tokens.gather(-1, order).cpu().numpy()
            got_d = ret.dists.gather(-1, order).cpu().numpy()
            if not np.array_equal(got_t, want_t):
                raise PhaseError("core.datastore.retrieve's tokens differ "
                                 "from the server's")
            if not np.allclose(got_d, want_d, **F32_TOL):
                raise PhaseError("core.datastore.retrieve's distances "
                                 "differ from the server's")
            log(f"  [{gpu}] {run} step 0: core.datastore.retrieve over the "
                f"same shards equals the server's answer")
            del store, ret
        lat = sorted(r.latency_s for st in seen for r in st["res"])
        gens[run] = gen
        out[run] = dict(sampler=sampler, l=l, steps=n_steps, wall_s=wall,
                        near_ties=ties, max_abs_dist_err=dist_err,
                        mix_max_abs_err=mix_err, sum_max_abs_err=sum_err,
                        retrieval_p50_ms=lat[len(lat) // 2] * 1e3,
                        iterations=[st["res"][0].iterations for st in seen],
                        launches=counts)
        log(f"  [{gpu}] {run}: {n_steps} steps x {LM_BATCH} retrievals of "
            f"l={l} over {KNN_LM_KEYS} keys, all equal the f64 brute force "
            f"({ties} near ties at rank l, max abs {dist_err:.3g}); mixture "
            f"vs f64 host {mix_err:.3g}, sums within {sum_err:.3g}; "
            f"retrieval p50 {out[run]['retrieval_p50_ms']:.3f} ms; loop "
            f"wall {wall:.2f} s with the checks; launches {counts}")
        srv.close()
        del srv, seen
    # the two knn samplers' answers are equal; their distances come from
    # two kernels, so the draws may part where the mixture nearly ties
    same = int((gens["knn_lm_selection"] == gens["knn_lm_gather"]).sum())
    peak = torch.cuda.max_memory_allocated()
    log(f"  [{gpu}] serve_knn_lm: the knn samplers drew the same token at "
        f"{same} of {gens['knn_lm_gather'].size} places; "
        f"max_memory_allocated {peak} bytes")
    results["serve_knn_lm"] = dict(runs=out, launches=launches,
                                   keys=KNN_LM_KEYS, dim=cfg.d_model,
                                   same_tokens=same,
                                   max_memory_allocated=peak)
    # phase 4 times the distance kernels on this datastore, with the
    # prompts' last token embeddings as queries
    last = torch.as_tensor(prompt[:, -1], device=dev).long()
    LM_INPUTS.update(keys=keys, q=params.embed.table[last].contiguous())
    del params
    torch.cuda.empty_cache()


# ---- phase 3i: training at full width ------------------------------------

TRAIN_BATCH, TRAIN_SEQ, TRAIN_ACCUM = 8, 128, 2
TRAIN_STEPS, TRAIN_WARMUP, TRAIN_LR = 30, 5, 1e-3
TRAIN_CKPT_EVERY, TRAIN_KEEP, TRAIN_FAIL_AT = 10, 2, 22
TRAIN_TIMED = 2               # steps timed after the loop, in each mode
TRAIN_GRAD_BATCH = (2, 64)    # the batch held against the f64 twin
GRAD_F64_REL = 1e-3           # max |g32 - g64| <= this x max |g64|, a tensor
ADAMW_F64_REL = 1e-6          # one AdamW step vs f64: this x max |p|


def profiled_step(fn):
    """``fn()`` once under torch.profiler: ``(wall ms, device ms, kernel
    launches, {kernel: device ms})``, the device time summed over the
    events that ran on the card."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    us = {e.key: getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
          for e in ka if getattr(e, "device_type", None) == DeviceType.CUDA}
    launches = sum(e.count for e in ka if e.key.startswith(
        ("cudaLaunchKernel", "cuLaunchKernel")))
    return (wall * 1e3, sum(us.values()) / 1e3, launches,
            {k: v / 1e3 for k, v in us.items() if v})


def phase_train(dev, gpu, results):
    """qwen2-0.5b at full width (f32, seeded) trained through
    ``runtime.train_loop`` on MarkovTokens(vocab, 0, branch 2, 13
    contexts), batch 8 x 128 in 2 microbatches, AdamW's defaults, lr
    1e-3 after 5 warmup steps, 30 steps; checkpoints every 10 (keep 2)
    and one injected node failure at step 22.  Checks: the loss falls by
    more than 1.0; the restart from step 20 replays steps 20-21 bit for
    bit (under ``torch.use_deterministic_algorithms``); a checkpoint
    restored equals the live parameters and moments; the gradients of a
    2 x 64 batch within 1e-3 x max |g| of the model's f64 twin, tensor by
    tensor; one AdamW step on the card within 1e-6 x max |p| of the same
    step in f64 on the host; the prefetcher's copies to the card equal
    their batches; no kernel of repro_torch.kernels launched.  Reported:
    step walls, tokens/s, one profiled step, peak memory, the
    checkpoint's snapshot, write and restore walls and its bytes."""
    import shutil
    import tempfile
    import torch
    import repro_torch.configs as configs
    from repro_torch.kernels import ops as kops
    from repro_torch.models import build_model

    cfg = configs.get(LM_ARCH)
    api = build_model(cfg)
    n_params = cfg.param_count() + cfg.d_model
    ckpt_est = 3 * 4 * n_params          # parameters, m and v in f32
    (ROOT / "build").mkdir(exist_ok=True)
    free = shutil.disk_usage(ROOT / "build").free
    if free < 3 * ckpt_est:
        raise PhaseError(f"train: {free} bytes free under build/, less "
                         f"than 3 checkpoints of ~{ckpt_est}")
    ckpt_dir = tempfile.mkdtemp(prefix="train_ckpt_", dir=ROOT / "build")
    torch.cuda.synchronize()
    kops.reset_launch_counts()
    torch.cuda.empty_cache()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    # deterministic kernels (the embedding's backward sorts instead of
    # adding with atomics), without the NaN fill of fresh memory, which
    # no kernel here reads and which would add a launch to every
    # allocation
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.utils.deterministic.fill_uninitialized_memory = False
    torch.use_deterministic_algorithms(True)
    try:
        out = train_run(dev, gpu, api, cfg, ckpt_dir, n_params, base_mem)
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = fill
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    if any(kops.launch_counts().values()):
        raise PhaseError(f"train: kernels launched during the phase: "
                         f"{kops.launch_counts()}")
    results["train"] = out
    torch.cuda.empty_cache()


def train_run(dev, gpu, api, cfg, ckpt_dir, n_params, base_mem):
    """phase_train's run, checks and measurements; returns its record."""
    import copy
    import math
    import numpy as np
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint import serialization as ckpt_serialization
    from repro_torch.checkpoint.serialization import flatten
    from repro_torch.data import MarkovTokens, Prefetcher
    from repro_torch.kernels import ops as kops
    from repro_torch.optim import AdamW
    from repro_torch.runtime import (MetricLogger, SimulatedNodeFailure,
                                     TrainConfig, init_opt_state,
                                     make_train_step, train_loop)
    from repro_torch.runtime.trainer import checkpoint_tree

    params = api.init_params(0, device=dev, train=True)
    tcfg = TrainConfig(grad_accum=TRAIN_ACCUM, peak_lr=TRAIN_LR,
                       warmup_steps=TRAIN_WARMUP, total_steps=TRAIN_STEPS)
    opt = AdamW()
    opt_state = init_opt_state(api, tcfg, opt, params)
    data = MarkovTokens(cfg.vocab, seed=0, branch=2, n_contexts=13)

    def make_batch(step):
        t, l = data.batch(step, TRAIN_BATCH, TRAIN_SEQ)
        return {"tokens": t, "labels": l}

    # the prefetcher's consumer-side copy from pinned host memory
    pf = Prefetcher(make_batch, prefetch=2, device=dev)
    try:
        for _ in range(3):
            s, b = next(pf)
            want = make_batch(s)
            for k, v in b.items():
                if v.device.type != dev.type or not np.array_equal(
                        v.cpu().numpy(), want[k]):
                    raise PhaseError(f"train: the prefetcher's {k} of "
                                     f"step {s} differs from its batch")
    finally:
        pf.close()

    mgr = CheckpointManager(ckpt_dir, keep=TRAIN_KEEP)
    # each save's synchronous snapshot, and the writer thread's serialize
    # (timed around serialization.save_pytree for the loop)
    snap_s, write_s = [], []
    save, write = mgr.save, ckpt_serialization.save_pytree

    def timed_save(*a, **kw):
        mgr.wait()
        t0 = time.perf_counter()
        save(*a, **kw)
        snap_s.append(time.perf_counter() - t0)

    def timed_write(*a, **kw):
        t0 = time.perf_counter()
        write(*a, **kw)
        write_s.append(time.perf_counter() - t0)
    mgr.save = timed_save
    crashed = []

    def fail_at(step):
        if step == TRAIN_FAIL_AT and not crashed:
            crashed.append(step)
            raise SimulatedNodeFailure("injected node loss")

    logger = MetricLogger(quiet=True)
    torch.cuda.synchronize()
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    ckpt_serialization.save_pytree = timed_write
    try:
        params, opt_state, step = train_loop(
            api=api, tcfg=tcfg, optimizer=opt, params=params,
            opt_state=opt_state, make_batch=make_batch,
            num_steps=TRAIN_STEPS, ckpt_manager=mgr,
            ckpt_every=TRAIN_CKPT_EVERY, fail_at=fail_at, logger=logger,
            device=dev)
    finally:
        ckpt_serialization.save_pytree = write
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    launches = kops.launch_counts()
    loop_peak = torch.cuda.max_memory_allocated() - base_mem
    if any(launches.values()):
        raise PhaseError(f"train: the loop launched kernels {launches}")

    recs = [r for r in logger.history if "loss" in r]
    events = [r for r in logger.history if "event" in r]
    steps = [r["step"] for r in recs]
    replayed = list(range(TRAIN_FAIL_AT)) + list(range(
        TRAIN_FAIL_AT - TRAIN_FAIL_AT % TRAIN_CKPT_EVERY, TRAIN_STEPS))
    if step != TRAIN_STEPS or steps != replayed or len(events) != 1:
        raise PhaseError(f"train: steps {steps}, events {events}")
    losses = [r["loss"] for r in recs]
    if not all(math.isfinite(x) for x in losses):
        raise PhaseError(f"train: a loss is not finite: {losses}")
    if not losses[-1] < losses[0] - 1.0:
        raise PhaseError(f"train: the loss fell from {losses[0]} to "
                         f"{losses[-1]}, not by more than 1.0")
    twice = {s: [r["loss"] for r in recs if r["step"] == s]
             for s in set(steps) if steps.count(s) == 2}
    replay_diff = max(abs(a - b) for a, b in twice.values())
    if sorted(twice) != [20, 21] or replay_diff != 0.0:
        raise PhaseError(f"train: replayed losses {twice}")
    if mgr.all_steps() != [20, 30]:
        raise PhaseError(f"train: checkpoints kept {mgr.all_steps()}")
    walls = [r["step_time"] for r in recs]
    p50 = float(np.median(walls[3:]))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flop_bound_ms = 6 * n_params * tokens / PEAK_F32_S * 1e3
    adamw_bound_ms = 7 * 4 * n_params / PEAK_BYTES_S * 1e3
    log(f"  [{gpu}] train: {TRAIN_STEPS} steps of qwen2-0.5b at full width "
        f"({n_params} parameters, f32), batch {TRAIN_BATCH}x{TRAIN_SEQ} in "
        f"{TRAIN_ACCUM} microbatches, remat; loss {losses[0]:.4f} (ln V "
        f"{math.log(cfg.vocab):.4f}) -> {losses[-1]:.4f}; restart at step "
        f"{TRAIN_FAIL_AT} from step 20, steps 20-21 replayed bit for bit; "
        f"launches {launches}")
    log(f"  [{gpu}] train: step wall p50 {p50 * 1e3:.3f} ms over steps "
        f"3-30 ({tokens / p50:.1f} tokens/s), first step "
        f"{walls[0] * 1e3:.3f} ms; the loop {loop_s:.3f} s with its "
        f"checkpoints and restart; bounds: the step's products "
        f"{flop_bound_ms:.3f} ms (6 x {n_params} x {tokens} f32 flops at "
        f"67 TFLOP/s), AdamW {adamw_bound_ms:.3f} ms (7 x 4 B x {n_params} "
        f"at 3.35 TB/s); peak memory of the loop {loop_peak} bytes")

    # the last checkpoint restored to the card and compared with the
    # live state it was taken from
    tree = checkpoint_tree(params, opt_state)
    ckpt_bytes = sum(f.stat().st_size for f in
                     (Path(ckpt_dir) / f"step_{TRAIN_STEPS}").iterdir())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored = mgr.restore(TRAIN_STEPS, tree, device=dev)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    live, back = flatten(tree), flatten(restored)
    if list(live) != list(back):
        raise PhaseError("train: the restored tree's leaves differ")
    bad = [k for k in live if not torch.equal(
        live[k], back[k].to(live[k].device))]
    del restored, back
    if bad:
        raise PhaseError(f"train: restored leaves differ: {bad[:5]}")
    log(f"  [{gpu}] train: checkpoints of {len(live)} leaves, {ckpt_bytes} "
        f"bytes: snapshots {[round(x * 1e3, 3) for x in snap_s]} ms, "
        f"writes {[round(x, 3) for x in write_s]} s (steps 10, 20, 30); "
        f"step {TRAIN_STEPS} restored to the card in {restore_s:.3f} s, "
        f"equal to the live state bit for bit")

    # steps timed as the loop runs them, then with deterministic
    # algorithms off (what the replay's bit-equality costs), one step of
    # each mode under the profiler
    split = {"loop": loop_s, "restore": restore_s}
    t_part = time.perf_counter()
    train_step = make_train_step(api, tcfg, opt)
    prof, next_step = {}, [TRAIN_STEPS]

    def one():
        nonlocal params, opt_state
        params, opt_state, m = train_step(params, opt_state,
                                          make_batch(next_step[0]))
        float(m["loss"])
        next_step[0] += 1

    for mode in ("deterministic", "nondeterministic"):
        torch.use_deterministic_algorithms(mode == "deterministic")
        walls_m = []
        for _ in range(TRAIN_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            one()
            walls_m.append((time.perf_counter() - t0) * 1e3)
        wall, dev_ms, n_launch, by_kernel = profiled_step(one)
        share = lambda words: sum(  # noqa: E731
            v for k, v in by_kernel.items()
            if any(w in k.lower() for w in words))
        prof[mode] = dict(
            step_ms=walls_m, profiled_wall_ms=wall, device_ms=dev_ms,
            busy_share=dev_ms / wall, launches=n_launch,
            gemm_ms=share(("gemm", "xmma", "cutlass", "sm90_")),
            foreach_ms=share(("multi_tensor",)),
            top_device_ms=dict(sorted(by_kernel.items(),
                                      key=lambda kv: -kv[1])[:8]))
        top = prof[mode]["top_device_ms"]
        log(f"  [{gpu}] train, {mode}: step walls "
            f"{[round(w, 3) for w in walls_m]} ms; one profiled step "
            f"{dev_ms:.3f} ms of device time in {wall:.3f} ms "
            f"({100 * dev_ms / wall:.1f}% busy), {n_launch} kernel "
            f"launches; GEMMs {prof[mode]['gemm_ms']:.3f} ms, foreach "
            f"(accumulation + AdamW) {prof[mode]['foreach_ms']:.3f} ms; top "
            f"{ {k[:60]: round(v, 3) for k, v in top.items()} }")
    torch.use_deterministic_algorithms(True)
    split["timed_steps"] = time.perf_counter() - t_part
    t_part = time.perf_counter()

    # the gradients of one batch against the model's f64 twin
    t, l = data.batch(1000, *TRAIN_GRAD_BATCH)
    gbatch = {"tokens": t, "labels": l}
    names = [n for n, _ in params.named_parameters()]
    loss32, _ = api.loss_fn(params, gbatch, remat=False)
    g32 = torch.autograd.grad(loss32, list(params.parameters()))
    twin = copy.deepcopy(params).double()
    loss64, _ = api.loss_fn(twin, gbatch, remat=False)
    g64 = torch.autograd.grad(loss64, list(twin.parameters()))
    grad_rel = {n: float((a.double() - b).abs().max() / b.abs().max())
                for n, a, b in zip(names, g32, g64)}
    loss_err = abs(float(loss32.detach()) - float(loss64.detach()))
    del twin, g64, loss64
    worst = max(grad_rel, key=grad_rel.get)
    if grad_rel[worst] > GRAD_F64_REL:
        raise PhaseError(f"train: gradient of {worst} {grad_rel[worst]} x "
                         f"max |g64| from f64")
    log(f"  [{gpu}] train: gradients of a {TRAIN_GRAD_BATCH} batch vs the "
        f"f64 twin: largest max|g32 - g64| / max|g64| {grad_rel[worst]:.3g} "
        f"({worst}; limit {GRAD_F64_REL}); loss {loss_err:.3g} apart")

    split["grad_f64"] = time.perf_counter() - t_part
    t_part = time.perf_counter()

    # one AdamW step on the card against the same step in f64 on the host
    adam = opt_state[0]
    host = {n: tuple(x.detach().to("cpu", copy=True) for x in (
        p, adam.m[n], adam.v[n], g)) for n, p, g in zip(
            names, params.parameters(), g32)}
    count = int(adam.count)
    opt.update(dict(zip(names, g32)), adam, dict(params.named_parameters()),
               TRAIN_LR)
    del g32
    gn = math.sqrt(sum(float((h[3].double() ** 2).sum())
                       for h in host.values()))
    scale = min(1.0, opt.clip_norm / (gn + 1e-9))
    b1c, b2c = 1 - opt.b1 ** (count + 1), 1 - opt.b2 ** (count + 1)
    adam_err = p_max = 0.0
    for n, p in params.named_parameters():
        p0, m0, v0, g = (x.double() for x in host.pop(n))
        g = g * scale
        m = opt.b1 * m0 + (1 - opt.b1) * g
        v = opt.b2 * v0 + (1 - opt.b2) * g * g
        want = p0 - TRAIN_LR * ((m / b1c) / (torch.sqrt(v / b2c) + opt.eps)
                                + opt.weight_decay * p0)
        adam_err = max(adam_err, float((p.detach().cpu().double()
                                        - want).abs().max()))
        p_max = max(p_max, float(want.abs().max()))
    if adam_err > ADAMW_F64_REL * p_max:
        raise PhaseError(f"train: AdamW step {adam_err} from f64 (max |p| "
                         f"{p_max})")
    split["adamw_f64"] = time.perf_counter() - t_part
    peak = torch.cuda.max_memory_allocated() - base_mem
    log(f"  [{gpu}] train: one AdamW step (count {count + 1}, lr "
        f"{TRAIN_LR}, global norm {gn:.4g}) vs f64 on the host: max |dp| "
        f"{adam_err:.3g} = {adam_err / p_max:.3g} x max |p| (limit "
        f"{ADAMW_F64_REL}); peak memory of the phase {peak} bytes; the "
        f"phase's parts {({k: round(v, 3) for k, v in split.items()})} s")
    return dict(
        launches={"train": launches}, steps=steps, losses=losses,
        first_loss=losses[0], last_loss=losses[-1],
        replayed=twice, replay_max_abs_diff=replay_diff,
        step_walls_s=walls, step_wall_p50_ms=p50 * 1e3,
        first_step_ms=walls[0] * 1e3, tokens_per_s=tokens / p50,
        loop_s=loop_s, flop_bound_ms=flop_bound_ms,
        adamw_bound_ms=adamw_bound_ms, profiled=prof,
        loop_peak_bytes=loop_peak, phase_peak_bytes=peak,
        ckpt_bytes=ckpt_bytes, ckpt_leaves=len(live),
        ckpt_snapshot_ms=[x * 1e3 for x in snap_s], ckpt_write_s=write_s,
        restore_s=restore_s, grad_f64_max_rel=grad_rel[worst],
        grad_f64_worst=worst, grad_f64_rel=grad_rel,
        adamw_f64_max_abs=adam_err, adamw_f64_rel=adam_err / p_max,
        n_params=n_params, split_s=split,
        shape=dict(batch=TRAIN_BATCH, seq=TRAIN_SEQ, grad_accum=TRAIN_ACCUM,
                   steps=TRAIN_STEPS, lr=TRAIN_LR, warmup=TRAIN_WARMUP,
                   ckpt_every=TRAIN_CKPT_EVERY, fail_at=TRAIN_FAIL_AT))


MESH_SERVE = dict(batch=8, prompt=128, tokens=16, top_k=50)
MESH_TRAIN_STEPS = 5
MESH_LOSS_REL = 1e-6          # the 1 x 1 mesh's losses vs the unsharded
MESH_PEAK_BAND = (0.67, 1.5)  # measured peak / predicted peak
MESH_DRYRUN_JOBS = min(8, os.cpu_count() or 1)
MESH_DEADLINE_S = 420         # the phase dumps every thread's stack and
                              # exits past this


def phase_mesh(dev, gpu, results):
    """The mesh path on the card.  (1) The dry-run of all ten archs x
    their shapes x the (16, 16) and (2, 16, 16) meshes (``launch.dryrun
    --all --mesh both``, its counts in worker processes on the host,
    before the card's work, so no wall of this script is taken beside
    it): every cell OK or SKIP, one line a cell.  (2) qwen2-0.5b at full
    width trained 5 steps through ``launch.train`` unsharded and on a 1 x
    1 NCCL mesh (phase train's knobs: 8 x 128 tokens in 2 microbatches,
    remat, AdamW's defaults) under deterministic algorithms, each run
    counted by ``launch.cost``: the losses equal (within 1e-6 relative),
    the FLOPs 5 x the dry-run's meta count of one step, and the card's
    peak memory over the run within [0.67, 1.5] x the dry-run's
    predicted peak.  (3) qwen2-0.5b served on the 1 x 1 mesh (B = 8,
    128-token prompts, 16 new tokens, both samplers): the tokens equal
    the unsharded port's, each step's top-k equals a stable sort of its
    row, local_topk launched.  (4) The three examples on the card with
    their own checks."""
    import contextlib
    import faulthandler
    import io
    import numpy as np
    import torch
    import repro_torch.configs as configs
    from repro_torch.examples import (distributed_topk_demo, quickstart,
                                      streaming_ingest)
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import cost, dryrun
    from repro_torch.launch import train as tlaunch
    from repro_torch.launch.mesh import debug_mesh
    from repro_torch.models import build_model, creator
    from repro_torch.runtime import ServeConfig, Server

    out, launches = {}, {}
    # the card; the CPU only in a rehearsal of the phase
    on = None if dev.type == "cuda" else "cpu"
    devarg = [] if on is None else ["--device", on]
    t_phase = time.perf_counter()
    faulthandler.dump_traceback_later(MESH_DEADLINE_S, exit=True)
    try:
        # (1) the dry-run's cells
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            cells = dryrun.main(["--all", "--mesh", "both", "--jobs",
                                 str(MESH_DRYRUN_JOBS)])
        dry_s = time.perf_counter() - t0
        status = {}
        for c in cells:
            status[c["status"]] = status.get(c["status"], 0) + 1
            if c["status"] == "OK":
                m, r = c["memory"], c["roofline"]
                log(f"  [{gpu}] dryrun {c['cell']}: OK fits={m['fits']} "
                    f"device bytes {m['total']} (params {m['params']}, "
                    f"activations {m['activations']}) compute "
                    f"{r['compute_s']:.4g} s memory {r['memory_s']:.4g} s "
                    f"collective {r['collective_s']:.4g} s "
                    f"({r['dominant']})")
            else:
                log(f"  [{gpu}] dryrun {c['cell']}: {c['status']} "
                    f"{c.get('reason') or c.get('error')}")
        want_cells = 10 * 4 * 2
        if len(cells) != want_cells or status.get("FAIL"):
            raise PhaseError(f"mesh: dry-run cells {status}, {len(cells)} "
                             f"of {want_cells}")
        out["dryrun"] = dict(status=status, wall_s=dry_s,
                             jobs=MESH_DRYRUN_JOBS,
                             cells={c["cell"]: c for c in cells})
        log(f"  [{gpu}] mesh dry-run: {status} over {len(cells)} cells in "
            f"{dry_s:.1f} s ({MESH_DRYRUN_JOBS} worker processes)")

        # (2) training, unsharded and on the 1 x 1 mesh, each run counted
        cfg = configs.get(LM_ARCH)
        pred, _, resident = dryrun.count_step(
            cfg, "train", TRAIN_BATCH, TRAIN_SEQ, grad_accum=TRAIN_ACCUM,
            dtype=torch.float32)
        predicted_peak = resident + pred.peak_bytes
        args = ["--steps", str(MESH_TRAIN_STEPS), "--batch",
                str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--grad-accum",
                str(TRAIN_ACCUM), "--lr", str(TRAIN_LR)] + devarg
        walls, losses, counted = {}, {}, {}
        fill = torch.utils.deterministic.fill_uninitialized_memory
        torch.utils.deterministic.fill_uninitialized_memory = False
        torch.use_deterministic_algorithms(True)
        try:
            for name, extra in (("plain", []), ("mesh", ["--mesh", "1x1"])):
                # what earlier phases still hold is not this run's
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                with contextlib.redirect_stderr(io.StringIO()), \
                        cost.CostMode() as m:
                    _, losses[name] = tlaunch.main(args + extra)
                torch.cuda.synchronize()
                walls[name] = time.perf_counter() - t0
                counted[name] = dict(
                    flops=m.flops, bytes=m.bytes, ops=m.ops, base=base,
                    max_memory_allocated=torch.cuda.max_memory_allocated()
                    - base)
                torch.cuda.empty_cache()
        finally:
            torch.use_deterministic_algorithms(False)
            torch.utils.deterministic.fill_uninitialized_memory = fill
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses["mesh"],
                                                      losses["plain"]))
        if len(losses["mesh"]) != MESH_TRAIN_STEPS or rel > MESH_LOSS_REL:
            raise PhaseError(f"mesh: the 1x1 mesh's losses {losses['mesh']}"
                             f" against the unsharded {losses['plain']}")
        ratio = {}
        for name, c in counted.items():
            if c["flops"] != MESH_TRAIN_STEPS * pred.flops:
                raise PhaseError(f"mesh: the {name} run's FLOPs "
                                 f"{c['flops']} on the card against "
                                 f"{MESH_TRAIN_STEPS} x the dry-run's "
                                 f"{pred.flops}")
            ratio[name] = c["max_memory_allocated"] / predicted_peak
            if not MESH_PEAK_BAND[0] <= ratio[name] <= MESH_PEAK_BAND[1]:
                raise PhaseError(f"mesh: the {name} run's peak memory {c} "
                                 f"against the predicted {predicted_peak} "
                                 f"({ratio[name]:.3f})")
        log(f"  [{gpu}] mesh train: {MESH_TRAIN_STEPS} steps of qwen2-0.5b "
            f"at full width, 8x128 in 2 microbatches, on the 1x1 NCCL mesh "
            f"and unsharded: losses {losses['mesh']} (largest relative gap "
            f"{rel:.3g}); launcher walls {walls} s, counted")
        log(f"  [{gpu}] mesh train step: FLOPs {pred.flops} on the meta "
            f"device; on the card {MESH_TRAIN_STEPS} x that, unsharded and "
            f"on the mesh; predicted peak {predicted_peak} bytes (resident "
            f"{resident} + transient {pred.peak_bytes}), measured "
            f"{counted['plain']['max_memory_allocated']} unsharded, "
            f"{counted['mesh']['max_memory_allocated']} on the mesh "
            f"(ratios {ratio})")
        out["train"] = dict(losses=losses, max_rel=rel, launcher_s=walls,
                            counted=counted, predicted=pred.as_dict(),
                            predicted_peak=predicted_peak,
                            resident=resident, peak_ratio=ratio)

        # (3) serving on the 1 x 1 mesh against the unsharded port
        api = build_model(cfg)
        rng = np.random.default_rng(22)
        sb = {"tokens": rng.integers(0, cfg.vocab, (
            MESH_SERVE["batch"], MESH_SERVE["prompt"])).astype(np.int32)}
        scfg_kw = dict(max_seq=MESH_SERVE["prompt"] + MESH_SERVE["tokens"]
                       + 8, top_k=MESH_SERVE["top_k"])
        gens, serve_s = {}, {}
        for sampler in ("selection", "gather"):
            for name, spec in (("plain", None), ("mesh", "1x1")):
                bad, nsteps = [], [0]

                def observe(logits, res):
                    srt = torch.sort(logits, dim=-1, descending=True,
                                     stable=True)
                    k = MESH_SERVE["top_k"]
                    if not (torch.equal(res.indices.long(), srt.indices[:, :k])
                            and torch.equal(res.values, srt.values[:, :k])):
                        bad.append(nsteps[0])
                    nsteps[0] += 1
                with debug_mesh(spec, on) as (mdev, mesh):
                    params = api.init_params(0, device=mdev)
                    if mesh is not None:
                        creator.shard_model(params, mesh)
                    srv = Server(api, params, ServeConfig(
                        sampler=sampler, **scfg_kw),
                        shards=None if mesh is not None else 1,
                        observe=observe)
                    torch.cuda.synchronize()
                    kops.reset_launch_counts()
                    t0 = time.perf_counter()
                    gens[(sampler, name)], _ = srv.generate(
                        sb, MESH_SERVE["tokens"], key=1)
                    torch.cuda.synchronize()
                    serve_s[f"{sampler}_{name}"] = time.perf_counter() - t0
                    counts = kops.launch_counts()
                    del srv, params
                if bad or nsteps[0] != MESH_SERVE["tokens"] - 1:
                    raise PhaseError(f"mesh serve {sampler} {name}: top-k of "
                                     f"steps {bad} differs from a stable sort")
                if counts["local_topk"] < 1:
                    raise PhaseError(f"mesh serve {sampler} {name}: "
                                     f"local_topk never launched")
                if name == "mesh":
                    launches[f"mesh_serve_{sampler}"] = counts
            if not np.array_equal(gens[(sampler, "mesh")],
                                  gens[(sampler, "plain")]):
                raise PhaseError(f"mesh serve {sampler}: the 1x1 mesh's "
                                 f"tokens differ from the unsharded port's")
        if not np.array_equal(gens[("selection", "mesh")],
                              gens[("gather", "mesh")]):
            raise PhaseError("mesh serve: the samplers drew other tokens")
        log(f"  [{gpu}] mesh serve: qwen2-0.5b B={MESH_SERVE['batch']} x "
            f"{MESH_SERVE['prompt']} + {MESH_SERVE['tokens']} tokens, both "
            f"samplers on the 1x1 mesh: tokens equal to the unsharded "
            f"port's, every top-{MESH_SERVE['top_k']} equal to a stable "
            f"sort; walls { {k: round(v, 3) for k, v in serve_s.items()} } "
            f"s; launches {launches}")
        out["serve"] = dict(walls_s=serve_s, tokens=np.asarray(
            gens[("selection", "mesh")]).tolist())
        torch.cuda.empty_cache()

        # (4) the examples on the card
        ex = {}
        for name, mod in (("quickstart", quickstart),
                          ("distributed_topk_demo", distributed_topk_demo),
                          ("streaming_ingest", streaming_ingest)):
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                mod.main(devarg)
            ex[name] = time.perf_counter() - t0
            tail = buf.getvalue().strip().splitlines()[-1]
            log(f"  [{gpu}] example {name}: {ex[name]:.3f} s; {tail}")
        out["examples_s"] = ex
    finally:
        faulthandler.cancel_dump_traceback_later()
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    results["mesh"] = out

def lm_timing(timing, dev, results):
    """Phase 4 at the LM path's shapes: l2_distance and distance_topk over
    serve_knn_lm's datastore (B = 8, 2^22 x 896, l = 8), local_topk on
    the vocabulary rows (8 x 8 shards of 18,992, l = 50) beside the
    launch floor; each beside its bound and its library call, the
    library's device time too.  First the kernels are held against their
    plain versions on these inputs: l2_distance, distance_topk at l = 8,
    and local_topk's passes at l = 1024 over l2_distance's output."""
    import torch
    from repro_torch.core.topk import shard_vocab
    from repro_torch.kernels import distance_topk as dtk
    from repro_torch.kernels import l2_distance as l2
    from repro_torch.kernels import local_topk as ltk
    keys, q = LM_INPUTS["keys"], LM_INPUTS["q"]
    n, d = keys.shape
    b, l = q.shape[0], 8
    p = keys.view(K, n // K, d)
    lm_err = results["lm_max_abs_err"]
    out = l2.l2_distance_cuda(q, p)
    torch.cuda.synchronize()
    full = l2.l2_distance_plain(q, p)
    if not torch.allclose(out, full, **F32_TOL):
        raise PhaseError(f"l2_distance at {(b, n, d)}: max abs "
                         f"{(out - full).abs().max()}")
    lm_err["l2_distance"] = max(lm_err["l2_distance"],
                                float((out - full).abs().max()))
    v, i = dtk.distance_topk_cuda(q, p, l)
    torch.cuda.synchronize()
    rv, ri = dtk.distance_topk_plain(q, p, l)
    lm_err["distance_topk"] = max(lm_err["distance_topk"], topk_agree(
        v, i, rv, ri, full, F32_TOL))
    # l = 1024 as the server takes it: local_topk's passes over the
    # distances l2_distance wrote, bit for bit
    v, i = ltk.local_topk_cuda(out, L_LARGE)
    torch.cuda.synchronize()
    rv, ri = ltk.local_topk_plain(out, L_LARGE)
    if not (torch.equal(v, rv) and torch.equal(i, ri)):
        raise PhaseError(f"local_topk at {tuple(out.shape)} l={L_LARGE}: "
                         f"differs from the plain version")
    log(f"  at {(b, n, d)}: l2_distance (max abs {lm_err['l2_distance']:.3g})"
        f", distance_topk l={l} (max abs {lm_err['distance_topk']:.3g}) and "
        f"local_topk l={L_LARGE} on l2_distance's output (bit for bit) agree"
        f" with their plain versions")
    del out, full, v, i, rv, ri
    torch.cuda.empty_cache()
    qk = q.expand(K, b, d)
    flops = 2 * b * n * d + 3 * b * n
    g = torch.Generator(device=dev)
    g.manual_seed(23)
    logits = torch.randn((LM_BATCH, 151936), generator=g, device=dev)
    rows = (-shard_vocab(logits, LM_SHARDS)).contiguous().reshape(
        LM_SHARDS * LM_BATCH, -1)
    runs = {
        "l2_distance": (
            (b, n, d), lambda: l2.l2_distance_cuda(q, p),
            lambda: l2.l2_distance_plain(q, p),
            lambda: torch.cdist(qk, p).square(),
            4 * (b * d + n * d) + 4 * b * n, flops),
        "distance_topk": (
            (b, n, d, l), lambda: dtk.distance_topk_cuda(q, p, l),
            lambda: dtk.distance_topk_plain(q, p, l),
            lambda: torch.topk(torch.cdist(qk, p).square(), l,
                               largest=False),
            4 * (b * d + n * d) + 8 * K * b * l, flops),
        "local_topk": (
            tuple(rows.shape) + (LM_TOP_K,),
            lambda: ltk.local_topk_cuda(rows, LM_TOP_K),
            lambda: ltk.local_topk_plain(rows, LM_TOP_K),
            lambda: torch.topk(logits, LM_TOP_K),
            4 * rows.numel() + 8 * rows.shape[0] * LM_TOP_K, rows.numel()),
    }
    floor = timing["route_mask"]
    for name, (shape, kern, plain, lib, nbytes, ops) in runs.items():
        b_ms, by = bound(nbytes, ops)
        t = timing[name]
        t.update(lm_shape=list(shape), lm_ms=time_ms(kern, 20),
                 lm_kernel_ms=device_ms(kern, f"{name}_kernel",
                                        iters=20, per_call=True),
                 lm_plain_ms=time_ms(plain, 3), lm_library_ms=time_ms(lib, 3),
                 lm_library_device_ms=device_ms(lib, None, iters=5,
                                                per_call=True),
                 lm_bound_ms=b_ms, lm_bound_by=by)
        if name == "local_topk":
            t.update(lm_launch_floor_ms=floor["launch_floor_ms"],
                     lm_launch_floor_device_ms=floor[
                         "launch_floor_device_ms"])
        log(f"  {name} at the LM path's shape {shape}: {t['lm_ms']:.4f} ms "
            f"(kernels alone {t['lm_kernel_ms']}, plain "
            f"{t['lm_plain_ms']:.4f}, library {t['lm_library_ms']:.4f} "
            f"[device {t['lm_library_device_ms']}], "
            f"bound {b_ms:.6f} by {by})")


def phase_profile(dev, gpu, results):
    """Where one full bucket's time goes: torch.profiler over one
    query_batch of 32 requests per sampler, after warm-up, beside the
    batch's wall time measured without the profiler."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import CONFIG
    from repro_torch.runtime import KnnServer

    g = torch.Generator(device=dev)
    g.manual_seed(0)
    points = torch.randn((N_POINTS, DIM), generator=g, device=dev)
    rng = np.random.default_rng(1)
    qs = rng.normal(size=(B, DIM)).astype(np.float32)
    ls = rng.integers(1, L + 1, B).tolist()
    out = {}
    for sampler in ("selection", "gather"):
        srv = KnnServer(points, cfg=CONFIG.replace(sampler=sampler),
                        shards=K, device=dev, seed=0)
        srv.warmup()
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            srv.query_batch(qs, ls)
            walls.append(time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = srv.query_batch(qs, ls)
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0
        rows = []
        for e in prof.key_averages():
            # device-side events only (kernels, copies); the aten:: rows
            # repeat their kernels' time
            if e.key.startswith("aten::"):
                continue
            dev_us = getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0))
            if dev_us > 0:
                rows.append((dev_us, e.key, e.count))
        rows.sort(reverse=True)
        device_ms = sum(r[0] for r in rows) / 1e3
        walls.sort()
        out[sampler] = dict(
            batch_wall_ms_p50=walls[len(walls) // 2] * 1e3,
            profiled_wall_ms=prof_wall * 1e3, device_ms=device_ms,
            device_busy_share=device_ms / (prof_wall * 1e3),
            iterations=res[0].iterations, host_syncs=res[0].host_syncs,
            top=[dict(name=k, count=c, device_ms=us / 1e3)
                 for us, k, c in rows[:15]])
        log(f"  [{gpu}] sampler={sampler}: batch of {B} wall p50 "
            f"{out[sampler]['batch_wall_ms_p50']:.3f} ms; profiled "
            f"{prof_wall * 1e3:.3f} ms, device busy {device_ms:.3f} ms "
            f"({100 * device_ms / (prof_wall * 1e3):.1f}%), iterations "
            f"{res[0].iterations}")
        for us, k, c in rows[:15]:
            log(f"    {us / 1e3:9.3f} ms  x{c:<5d} {k[:90]}")
        del srv
    results["profile"] = out
    del points
    torch.cuda.empty_cache()


# ---- phase 4: timing ---------------------------------------------------------

def time_ms(fn, iters):
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, kernel_name, iters=50, per_call=False):
    """Mean device time of one launch (``per_call``: of all launches in
    one call of ``fn``) of the kernel whose name contains ``kernel_name``
    (None: of every device event, a library call's kernels and copies),
    from torch.profiler over ``iters`` calls of ``fn``: the kernel alone,
    without the host time between launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):      # a profile that caught no device event is retaken
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = count = 0
        for e in prof.key_averages():
            if (e.device_type == DeviceType.CUDA if kernel_name is None
                    else kernel_name in e.key):
                total += getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0))
                count += e.count
        if count:
            return total / (iters if per_call else count) / 1e3
    return None


def bound(nbytes, flops):
    t_b, t_f = nbytes / PEAK_BYTES_S, flops / PEAK_F32_S
    return (max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations")


def merge_bytes(pv, l):
    """Bytes the merge of ``(rows, chunks, w)`` partials must move on this
    data: every value, the id of every pair at or below its row's l-th
    value (the pairs that can be in the answer, ties included) and the
    ``(rows, l)`` output of values and ids."""
    import torch
    rows = pv.shape[0]
    flat = pv.reshape(rows, -1)
    lth = torch.topk(flat, l, dim=1, largest=False).values[:, -1:]
    return 4 * flat.numel() + 4 * int((flat <= lth).sum()) + 8 * rows * l


def store_timing(timing):
    """Phase 4 under the store's real mask after the churn (STORE_INPUTS):
    l2_distance and distance_topk, local_topk's long row of the masked
    distances, and its merge of distance_topk's partials.  The distance
    bounds count the points of the 64-point tiles with a live point (the
    tiles the kernels read), the flags and the outputs; the long row's,
    the row read and the answer written; the merge's, merge_bytes."""
    import torch
    from repro_torch.kernels import distance_topk as dtk
    from repro_torch.kernels import l2_distance as l2
    from repro_torch.kernels import local_topk as ltk
    from repro_torch.kernels import ref
    q, p, valid = (STORE_INPUTS[x] for x in ("q", "points", "valid"))
    b, n = q.shape[0], K * M
    tiles = int(valid.view(K, M // 64, 64).any(-1).sum())
    live_pts = 64 * tiles
    flops = 2 * b * live_pts * DIM + 3 * b * live_pts
    rows = l2.l2_distance_cuda(q, p, valid=valid)
    runs = {
        "l2_distance": (
            lambda: l2.l2_distance_cuda(q, p, valid=valid),
            lambda: ref.masked_l2_distance_ref(q, p, valid),
            4 * (b * DIM + live_pts * DIM) + K * M + 4 * b * n, flops),
        "distance_topk": (
            lambda: dtk.distance_topk_cuda(q, p, L, valid=valid),
            lambda: dtk.distance_topk_plain(q, p, L, valid=valid),
            4 * (b * DIM + live_pts * DIM) + K * M + 8 * K * b * L, flops),
        "local_topk": (
            lambda: ltk.local_topk_cuda(rows, L),
            lambda: ltk.local_topk_plain(rows, L),
            4 * b * n + 8 * K * b * L, b * n),
    }
    for name, (kern, plain, nbytes, ops) in runs.items():
        b_ms, by = bound(nbytes, ops)
        t = timing[name]
        t.update(store_masked_ms=time_ms(kern, 20),
                 store_masked_kernel_ms=device_ms(
                     kern, f"{name}_kernel", per_call=True),
                 store_masked_plain_ms=time_ms(plain, 3),
                 store_masked_bound_ms=b_ms, store_masked_bound_by=by,
                 store_live_tiles=tiles)
        log(f"  {name} under the store's mask ({tiles} of {n // 64} tiles "
            f"live): {t['store_masked_ms']:.4f} ms, kernels alone "
            f"{t['store_masked_kernel_ms']:.4f} (plain "
            f"{t['store_masked_plain_ms']:.4f}, bound {b_ms:.6f} by {by})")
    # distance_topk on the same points and mask with each shard's slots
    # in one fixed random order: the store's slot order follows the ids,
    # which follow the drifting stream, so does the order alone move it?
    g = torch.Generator(device=q.device)
    g.manual_seed(3)
    perm = torch.randperm(M, generator=g, device=q.device)
    ps, vs = p[:, perm].contiguous(), valid[:, perm].contiguous()
    shuffled = lambda: dtk.distance_topk_cuda(q, ps, L, valid=vs)  # noqa: E731
    t = timing["distance_topk"]
    t.update(store_shuffled_ms=time_ms(shuffled, 20),
             store_shuffled_kernel_ms=device_ms(
                 shuffled, "distance_topk_kernel", per_call=True))
    log(f"  distance_topk under the store's mask, each shard's slots "
        f"shuffled: {t['store_shuffled_ms']:.4f} ms, kernel alone "
        f"{t['store_shuffled_kernel_ms']:.4f}")
    del ps, vs
    pv, pi = STORE_INPUTS["merge"]
    mb_ms, mby = bound(merge_bytes(pv, L), pv.numel())
    merge = lambda: ltk.merge_partials(pv, pi, L)         # noqa: E731
    t = timing["local_topk"]
    t.update(merge_store_ms=time_ms(merge, 20),
             merge_store_kernel_ms=device_ms(merge, "local_topk_kernel",
                                             per_call=True),
             merge_store_plain_ms=time_ms(
                 lambda: ltk.merge_partials_plain(pv, pi, L), 3),
             merge_store_bound_ms=mb_ms, merge_store_bound_by=mby)
    log(f"  local_topk merge of distance_topk partials {tuple(pv.shape)} "
        f"under the store's mask: {t['merge_store_ms']:.4f} ms (kernel alone "
        f"{t['merge_store_kernel_ms']:.4f}, plain "
        f"{t['merge_store_plain_ms']:.4f}, bound {mb_ms:.6f} by {mby})")


def phase_timing(dev, results):
    import torch
    from repro_torch.kernels import distance_topk as dtk
    from repro_torch.kernels import l2_distance as l2
    from repro_torch.kernels import local_topk as ltk
    from repro_torch.kernels import ops as kops

    g = torch.Generator(device=dev)
    g.manual_seed(7)
    q = torch.randn((B, DIM), generator=g, device=dev)
    p = torch.randn((K, M, DIM), generator=g, device=dev)
    dmat = l2.l2_distance_cuda(q, p)
    qk = q.expand(K, B, DIM)
    n = K * M
    dist_flops = 2 * B * n * DIM + 3 * B * n
    timing = {}
    runs = {
        "l2_distance": (
            lambda: l2.l2_distance_cuda(q, p),
            lambda: l2.l2_distance_plain(q, p),
            lambda: torch.cdist(qk, p).square(),
            4 * (B * DIM + n * DIM) + 4 * B * n, dist_flops),
        "distance_topk": (
            lambda: dtk.distance_topk_cuda(q, p, L),
            lambda: dtk.distance_topk_plain(q, p, L),
            lambda: torch.topk(torch.cdist(qk, p).square(), L,
                               largest=False),
            4 * (B * DIM + n * DIM) + 8 * K * B * L, dist_flops),
        "local_topk": (
            lambda: ltk.local_topk_cuda(dmat, L),
            lambda: ltk.local_topk_plain(dmat, L),
            lambda: torch.topk(dmat, L, largest=False),
            4 * B * n + 8 * K * B * L, B * n),
    }
    # the routing kernel, on the routed phase's bucket of 32: route mode
    # (route_mask's function) and index mode on given rows (index_mask's)
    from repro_torch.kernels import routing as rt
    ri = ROUTED_INPUTS
    rq, rl, rows = ri["q"], ri["ls"], ri["rows"]
    p_route, p_index, p_both = ri["route"], ri["index"], ri["both"]
    k, m, r, kb = p_route.k, p_route.m, p_route.r, p_both.kb
    # sub/mul/add per coordinate for k + m*k distances, the r + 1 dots,
    # the bound updates, and the (k^2 + (m k)^2) counts; per bucket
    # column, its distance, bounds and kb counts
    route_ops = B * (3 * DIM * k * (1 + m) + 2 * DIM * (r + 1)
                     + k * (5 * m + 3 * r + 6) + 3 * m * k
                     + 2 * (k * k + (m * k) ** 2))
    index_ops = B * (kb * (3 * DIM + 8) + 2 * kb * kb)
    # each input read once (queries, ls, the packed operands, given rows),
    # each output written once (rows, bucket rows, one byte a union)
    route_bytes = 4 * B * (DIM + 1 + k) + 4 * p_route.buf.numel() + k
    index_bytes = (4 * B * (DIM + 1 + k + kb) + 4 * p_index.buf.numel()
                   + k + kb)
    both_bytes = (4 * B * (DIM + 1 + k + kb) + 4 * p_both.buf.numel()
                  + k + kb)
    runs["route_mask"] = (
        lambda: rt.route_index_cuda(rq, rl, p_route),
        lambda: rt.route_mask_plain(rq, rl, p_route.route_ops(),
                                    slack=p_route.slack),
        None, route_bytes, route_ops)
    runs["index_mask"] = (
        lambda: rt.route_index_cuda(rq, rl, p_index, rows),
        lambda: rt.index_mask_plain(rq, rl, rows, p_index.index_ops(),
                                    oversample=p_index.oversample),
        None, index_bytes, index_ops)
    # the routed phase's mask: 1 of 8 shards valid; the bound counts the
    # live shard's points, the uint8 flags and the outputs
    vmask = routed_mask(K, M, dev)
    live_flops = 2 * B * M * DIM + 3 * B * M
    inf = torch.full((K, B, M), float("inf"), device=dev)
    masked = {
        "l2_distance": (
            lambda: l2.l2_distance_cuda(q, p, valid=vmask),
            lambda: torch.where(vmask.unsqueeze(1), l2.l2_distance_plain(q, p),
                                inf),
            4 * (B * DIM + M * DIM) + K * M + 4 * B * n, live_flops),
        "distance_topk": (
            lambda: dtk.distance_topk_cuda(q, p, L, valid=vmask),
            lambda: dtk.distance_topk_plain(q, p, L, valid=vmask),
            4 * (B * DIM + M * DIM) + K * M + 8 * K * B * L, live_flops),
    }
    for name, (kern, plain, lib, nbytes, ops) in runs.items():
        ms = time_ms(kern, 20 if lib else 200)
        plain_ms = time_ms(plain, 5)
        lib_ms = time_ms(lib, 5) if lib else None
        b_ms, by = bound(nbytes, ops)
        timing[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                            bound_ms=b_ms, bound_by=by, bytes=nbytes,
                            operations=ops)
        if lib is None:
            # launch-bound: the event loop above times the wrapper's host
            # work between launches; the profiler gives the kernel alone
            timing[name]["device_ms"] = device_ms(kern, "route_index_kernel")
        log(f"  {name}: {ms:.4f} ms (plain {plain_ms:.4f}, library "
            f"{'none' if lib_ms is None else f'{lib_ms:.4f}'}, bound "
            f"{b_ms:.6f} by {by}"
            + (f", device {timing[name]['device_ms']} ms by the profiler)"
               if lib is None else ")"))
        if name in masked:
            # the kernel alone (the wrapper adds distance_topk's merge)
            timing[name]["kernel_ms"] = device_ms(kern, f"{name}_kernel")
            mk, mp, mb, mo = masked[name]
            m_ms, mp_ms = time_ms(mk, 20), time_ms(mp, 5)
            mb_ms, mby = bound(mb, mo)
            timing[name].update(
                masked_ms=m_ms, masked_plain_ms=mp_ms, masked_bound_ms=mb_ms,
                masked_bound_by=mby,
                masked_kernel_ms=device_ms(mk, f"{name}_kernel"))
            log(f"  {name} kernel alone {timing[name]['kernel_ms']:.4f} ms; "
                f"masked (1 of {K} shards valid): {m_ms:.4f} ms, kernel "
                f"alone {timing[name]['masked_kernel_ms']:.4f} ms (plain "
                f"{mp_ms:.4f}, bound {mb_ms:.6f} by {mby})")
    # local_topk: the long row's two passes, the long row under the routed
    # mask (the gather's +inf rows), and the merge of distance_topk's
    # partials (the selection path's shape), unmasked and masked, as a row
    # of its own; every bound counts what this data needs
    t = timing["local_topk"]
    rows_x = dmat.reshape(K * B, M)
    pv1, pi1 = ltk.launch(rows_x, None, L)
    dmask = l2.l2_distance_cuda(q, p, valid=vmask)
    t.update(first_pass_ms=time_ms(lambda: ltk.launch(rows_x, None, L), 20),
             merge_pass_ms=time_ms(lambda: ltk.merge_partials(pv1, pi1, L),
                                   20),
             long_row_plan=[ltk_plan(K * B, M, L, False),
                            ltk_plan(K * B, pv1.shape[1] * L, L, True)],
             kernel_ms=device_ms(lambda: ltk.local_topk_cuda(dmat, L),
                                 "local_topk_kernel", per_call=True),
             masked_ms=time_ms(lambda: ltk.local_topk_cuda(dmask, L), 20),
             masked_kernel_ms=device_ms(lambda: ltk.local_topk_cuda(dmask, L),
                                        "local_topk_kernel", per_call=True),
             masked_plain_ms=time_ms(lambda: ltk.local_topk_plain(dmask, L),
                                     5),
             masked_bound_ms=t["bound_ms"], masked_bound_by=t["bound_by"])
    log(f"  local_topk long row: first pass {t['first_pass_ms']:.4f} ms, "
        f"its merge {t['merge_pass_ms']:.4f} ms, kernels alone "
        f"{t['kernel_ms']:.4f} ms; masked (1 of {K} shards valid): "
        f"{t['masked_ms']:.4f} ms, kernels alone {t['masked_kernel_ms']:.4f} "
        f"ms (plain {t['masked_plain_ms']:.4f}, bound "
        f"{t['masked_bound_ms']:.6f}); plans {t['long_row_plan']}")
    del dmask
    slots = ltk.blocks_per_sm(L, 0, True) * ltk.sm_count(0)
    for mode, key in ((None, "merge"), ("routed", "merge_masked")):
        mpv, mpi = MERGE_INPUTS[mode]
        rows = mpv.shape[0]
        flat_v, flat_i = mpv.reshape(rows, -1), mpi.reshape(rows, -1)

        def library_merge():
            v, j = torch.topk(flat_v, L, largest=False)
            return v, flat_i.gather(1, j)
        mb_ms, mby = bound(merge_bytes(mpv, L), mpv.numel())
        merge = lambda: ltk.merge_partials(mpv, mpi, L)   # noqa: E731
        t.update({
            f"{key}_ms": time_ms(merge, 20),
            f"{key}_kernel_ms": device_ms(merge, "local_topk_kernel",
                                          per_call=True),
            f"{key}_plain_ms": time_ms(
                lambda: ltk.merge_partials_plain(mpv, mpi, L), 5),
            f"{key}_bound_ms": mb_ms, f"{key}_bound_by": mby,
            # every distance_topk launch merges once (merge_calls: all of
            # them); the routed runs' merges are under the 1-of-8 mask
            f"{key}_calls": results["launches_routed"]["distance_topk"]
            + (results["launches"]["distance_topk"] if mode is None else 0)})
        if mode is None:
            widths = [flat_v.shape[1]] + [n * L for _, n, _ in ltk.merge_plans(
                rows, flat_v.shape[1], L, slots)[:-1]]
            t.update(merge_library_ms=time_ms(library_merge, 5),
                     merge_plan=[ltk_plan(rows, w, L, True) for w in widths])
        log(f"  local_topk merge of distance_topk partials "
            f"{tuple(mpv.shape)} {mode or ''}: {t[key + '_ms']:.4f} ms "
            f"(kernel alone {t[key + '_kernel_ms']:.4f}, plain "
            f"{t[key + '_plain_ms']:.4f}, bound {mb_ms:.6f} by {mby}); "
            f"{t[key + '_calls']} calls on the main path")
    log(f"  local_topk merge: library {t['merge_library_ms']:.4f} ms; plans "
        f"{t['merge_plan']}")
    # the long row above one pass: L_LARGE slots in passes, beside one pass
    # of 256; the bound reads the row once and writes the answer
    lb_ms, _ = bound(4 * B * n + 8 * K * B * L_LARGE, B * n)
    big = lambda: ltk.local_topk_cuda(dmat, L_LARGE)      # noqa: E731
    t.update(large_l=L_LARGE, large_l_ms=time_ms(big, 10),
             large_l_kernel_ms=device_ms(big, "local_topk_kernel", iters=10,
                                         per_call=True),
             large_l_plain_ms=time_ms(
                 lambda: ltk.local_topk_plain(dmat, L_LARGE), 3),
             large_l_one_pass_ms=time_ms(
                 lambda: ltk.local_topk_cuda(dmat, 256), 10),
             large_l_library_ms=time_ms(
                 lambda: torch.topk(dmat, L_LARGE, largest=False), 3),
             large_l_bound_ms=lb_ms)
    log(f"  local_topk long row at l={L_LARGE}: {t['large_l_ms']:.4f} ms "
        f"(kernels alone {t['large_l_kernel_ms']:.4f}; one pass at l=256 "
        f"{t['large_l_one_pass_ms']:.4f}; plain {t['large_l_plain_ms']:.4f};"
        f" library {t['large_l_library_ms']:.4f}; bound {lb_ms:.6f})")
    store_timing(timing)
    # the routing kernel's route + index mode (the approx server's launch),
    # the launch floor of this card and stack (one PyTorch op on a
    # 1-element tensor), and the device-routed prologue of the approx
    # server at B = 32, the kernel and its readback (synchronised after,
    # so the candidate-mask launches it queues are in it too)
    rtm = timing["route_mask"]
    both = lambda: rt.route_index_cuda(rq, rl, p_both)    # noqa: E731
    one = torch.zeros(1, device=dev)
    srv, q_np, l_np = ri["server"], ri["q_np"], ri["ls_np"]
    qt, lt = torch.as_tensor(q_np, device=dev), torch.as_tensor(l_np,
                                                                device=dev)

    def prologue():
        srv._prologue(q_np, l_np, qt, lt)
        torch.cuda.synchronize()
    def routing():       # the routing step alone: its launch and readback
        kops.route_index(qt, lt, p_both, with_rows=False)[2].cpu()

    def wall_ms(fn):
        for _ in range(10):
            fn()
        walls = []
        for _ in range(200):
            t0 = time.perf_counter()
            fn()
            walls.append(time.perf_counter() - t0)
        walls.sort()
        return walls[100] * 1e3, [walls[50] * 1e3, walls[150] * 1e3]
    rtm.update(both_ms=time_ms(both, 200),
               both_device_ms=device_ms(both, "route_index_kernel"),
               both_plain_ms=time_ms(
                   lambda: rt.route_index_plain(rq, rl, p_both), 5),
               both_bound_ms=bound(both_bytes, route_ops + index_ops)[0],
               launch_floor_ms=time_ms(lambda: one.add_(1), 200),
               launch_floor_device_ms=device_ms(lambda: one.add_(1),
                                                "elementwise"),
               prologue_ms=wall_ms(prologue),
               routing_readback_ms=wall_ms(routing))
    log(f"  route_index_mask route+index: {rtm['both_ms']:.4f} ms (device "
        f"{rtm['both_device_ms']} ms, plain {rtm['both_plain_ms']:.4f}, bound"
        f" {rtm['both_bound_ms']:.7f}); launch floor {rtm['launch_floor_ms']:.4f}"
        f" ms (device {rtm['launch_floor_device_ms']} ms); device-routed "
        f"prologue at B={B}: p50 and quartiles {rtm['prologue_ms']} ms; its "
        f"launch and readback alone {rtm['routing_readback_ms']} ms")
    lm_timing(timing, dev, results)
    results["timing"] = timing


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the run's details here as JSON")
    ap.add_argument("--profile", action="store_true",
                    help="also profile one full bucket per sampler")
    args = ap.parse_args(argv)

    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch is not beside this script",
              file=sys.stderr)
        return 2
    # phase train runs under torch.use_deterministic_algorithms, which
    # needs a fixed cuBLAS workspace before the first cuBLAS call; 8 x 4 MiB
    # is PyTorch's default on Hopper
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gpu = gpu_line()
    log(gpu)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    results = {"gpu": gpu, "device": torch.cuda.get_device_name(0)}
    return run_phases(args, dev, gpu, results)


def run_phases(args, dev, gpu, results) -> int:
    """Every phase in turn, then the kernels line and the device line."""
    import torch
    phases = [("build", None), ("kernels", phase_kernels),
              ("serve", phase_serve), ("serve_routed", phase_serve_routed),
              ("serve_large_l", phase_serve_large_l),
              ("serve_store", phase_serve_store),
              ("serve_maintained", phase_serve_maintained),
              ("serve_predict", phase_serve_predict),
              ("serve_lm", phase_serve_lm),
              ("serve_families", phase_serve_families),
              ("serve_knn_lm", phase_serve_knn_lm),
              ("train", phase_train),
              ("mesh", phase_mesh),
              ("timing", phase_timing)]
    if args.profile:
        phases.append(("profile", phase_profile))
    for name, fn in phases:
        t0 = time.perf_counter()
        log(f"== phase {name}")
        try:
            if name == "build":
                from repro_torch.kernels import _build
                path = _build.build()
                _build.library()
                for line in _build.build_log.splitlines():
                    if any(w in line for w in ("registers", "spill",
                                               "smem", "Compiling", "==")):
                        log("  " + line.strip())
                results["library"] = str(path.relative_to(ROOT))
                results["spills"] = spills = spill_bytes(_build.build_log)
                bad = {f: b for f, b in spills.items() if b and any(
                    k in f for k in ("l2_distance", "distance_topk",
                                     "local_topk"))}
                if bad:
                    raise PhaseError(f"kernels spill: {bad}")
                from repro_torch.kernels import local_topk as ltk
                results["local_topk_blocks_per_sm"] = bps = {
                    name: ltk.blocks_per_sm(L, code, ids) for name, code, ids
                    in (("f32", 0, False), ("bf16", 1, False),
                        ("f32_ids", 0, True))}
                log(f"  local_topk blocks per SM at l={L}: {bps}")
            elif name in ("serve", "serve_routed", "serve_large_l",
                          "serve_store", "serve_maintained", "serve_predict",
                          "serve_lm", "serve_families", "serve_knn_lm",
                          "train", "mesh", "profile"):
                fn(dev, gpu, results)
            else:
                fn(dev, results)
            torch.cuda.synchronize()
        except Exception:
            traceback.print_exc()
            log(f"== phase {name} FAILED")
            return 1
        results.setdefault("phase_s", {})[name] = time.perf_counter() - t0
        log(f"== phase {name} ok ({time.perf_counter() - t0:.1f} s)")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(results, indent=1,
                                             default=str))
    # each main path's counts, read right after its run (the routed
    # phase's exact twins repeat phase 3 and are left out)
    counts = dict(results["launches_by_sampler"])
    counts.update({run: e["launches"] for run, e in
                   results["serve_routed"].items()
                   if run[:2] in ("a_", "b_", "c_", "d_")})
    counts.update({run: e["launches"] for run, e in
                   results["serve_large_l"].items()})
    counts.update(results["serve_store"]["launches"])
    counts.update(results["serve_predict"]["launches"])
    counts.update(results["serve_maintained"]["launches"])
    counts.update(results["serve_lm"]["launches"])
    counts.update(results["serve_families"]["launches"])
    counts.update(results["serve_knn_lm"]["launches"])
    counts.update(results["train"]["launches"])
    counts.update(results["mesh"]["launches"])
    kernels = []
    for name, meta in KERNELS.items():
        t = results["timing"][name]
        counter = meta.get("counter", name)
        by_run = {run: c[counter] for run, c in counts.items()
                  if run in meta.get("runs", counts)}
        kernels.append(dict(
            name=name, route="cuda", source=meta["source"],
            replaces=meta["replaces"], status="ported",
            store_max_abs_err=results["serve_store"][
                "kernel_max_abs_err"].get(name),
            launches=sum(by_run.values()), launches_by_run=by_run,
            max_abs_err=results["max_abs_err"][name],
            lm_max_abs_err=results["lm_max_abs_err"].get(name), ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=t["library_ms"],
            **{key: t[key] for key in MASKED_KEYS + LTK_KEYS + ROUTE_KEYS
               + LARGE_L_KEYS + STORE_KEYS + LM_KEYS if key in t}))
    log(json.dumps({"kernels": kernels, "not_ported": [], "gpu": gpu}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
