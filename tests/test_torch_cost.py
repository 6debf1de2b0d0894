"""The port's cost model (``repro_torch.launch.cost``) against the
reference's controlled programs and formulas.

  * FLOPs are exact on ``tests/test_hlo_counter.py``'s nested loops (5 x
    3 products of 128 x 128: 15 * 2 * 128^3), and loops and their unrolled
    form count the same;
  * the extrapolation over sequence length and depth (``launch.dryrun.
    full_cost``) equals a direct count of every family's reduced config
    (the hybrid cut to two periods of 2 layers) at a length and depth it
    did not count (the counterpart of ``test_scan_vs_unroll_agree``):
    FLOPs, bytes, ops and saved bytes exactly, on the meta device as the
    dry-run counts (``test_counts_on_meta_equal_counts_on_cpu`` holds
    the meta device's counts to a real run's);
  * ``collective_wire_bytes`` equals the reference's ring formulas
    (``repro.launch.hlo_analysis``) on the same collectives, written as
    HLO lines;
  * ``redistribute_plan`` against hand-worked redistributions, the
    counter's peak on a known program, and the roofline's H100 terms.
"""

import dataclasses

import pytest
import torch

from repro.launch import hlo_analysis
import repro_torch.configs as tconfigs
from repro_torch.launch import cost, dryrun

ARCHS = ["qwen2-0.5b", "granite-moe-3b-a800m", "jamba-1.5-large-398b",
         "pixtral-12b", "seamless-m4t-large-v2", "xlstm-125m"]


def count(fn, *args):
    """``(fn's result, Cost)`` of one call under ``cost.CostMode``."""
    with cost.CostMode() as m:
        out = fn(*args)
    return out, cost.Cost(m.flops, m.bytes, m.peak_bytes, m.ops)


def test_nested_loop_flops_exact():
    w = torch.empty(128, 128, device="meta")
    x = torch.empty(128, 128, device="meta")

    def f(x):
        for _ in range(5):
            for _ in range(3):
                x = torch.tanh(x @ w)
        return x

    _, c = count(f, x)
    assert c.flops == 15 * 2 * 128 ** 3
    # bytes: each product reads x and w and writes its result, each tanh
    # reads and writes one block
    blk = 128 * 128 * 4
    assert c.bytes == 15 * (3 * blk + 2 * blk)
    assert c.ops == 30


def test_loop_and_unrolled_count_the_same():
    w = torch.empty(64, 64, device="meta")

    def looped(x):
        for _ in range(8):
            x = torch.tanh(x @ w)
        return x

    def unrolled(x):
        x = torch.tanh(x @ w)
        x = torch.tanh(x @ w)
        x = torch.tanh(x @ w)
        x = torch.tanh(x @ w)
        x = torch.tanh(x @ w)
        x = torch.tanh(x @ w)
        x = torch.tanh(x @ w)
        return torch.tanh(x @ w)

    x = torch.empty(64, 64, device="meta")
    assert count(looped, x)[1] == count(unrolled, x)[1]


def test_counts_on_meta_equal_counts_on_cpu():
    w = torch.randn(32, 48)
    x = torch.randn(16, 32, requires_grad=True)

    def f(x, w):
        y = torch.softmax(x @ w, -1)
        return torch.autograd.grad(y.square().sum(), x)[0]

    _, real = count(f, x, w)
    _, meta = count(f, x.detach().to("meta").requires_grad_(),
                         w.to("meta"))
    assert (real.flops, real.bytes, real.ops) == (meta.flops, meta.bytes,
                                                  meta.ops)
    assert real.flops == 2 * (2 * 16 * 32 * 48)   # forward + grad of x


def test_peak_counts_saved_tensors_until_backward():
    a = torch.empty(1000, device="meta", requires_grad=True)

    def f(a):
        y = a.exp()          # saved for backward: 4000 bytes
        z = (y * 2).sum()
        del y
        g, = torch.autograd.grad(z, a)
        return g

    with cost.CostMode() as m:
        f(a)
    # exp, mul live together (8000) before the sum's output is made
    assert m.peak_bytes >= 8000
    assert m.saved >= 4000
    with cost.CostMode() as m2:
        b = torch.empty(256, device="meta")
        for _ in range(10):
            b = b + 1        # one block live at a time (plus the new one)
    assert m2.peak_bytes == 2 * 256 * 4


# the hybrid cut to a period of 2 (Mamba + MoE, attention + SwiGLU) and 2
# periods, so that its Python chunk loop counts in seconds
CUTS = {"jamba-1.5-large-398b": dict(attn_period=2, n_layers=4)}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_extrapolation_equals_direct_count(arch, kind):
    cfg = dataclasses.replace(tconfigs.get(arch).reduced(),
                              **CUTS.get(arch, {}))
    assert dryrun._periods(cfg) >= 2
    lengths = dryrun._lengths(cfg)
    far = lengths[-1] + (lengths[1] - lengths[0])     # the next multiple
    got, saved = dryrun.full_cost(cfg, kind, far)
    want, want_saved, _ = dryrun.count_step(cfg, kind, 1, far)
    assert (got.flops, got.bytes, got.ops) == (want.flops, want.bytes,
                                               want.ops)
    assert saved == want_saved
    if kind == "train":
        assert want.flops > 0 and saved > 0


@pytest.mark.parametrize("points,at,want", [
    ({1: 3, 2: 5, 3: 7}, 10, 21),                 # a line
    ({512: 512 ** 2, 1024: 1024 ** 2, 1536: 1536 ** 2}, 32768, 32768 ** 2),
    ({64: 7, 128: 7}, 4096, 7),
])
def test_extrapolate_is_exact(points, at, want):
    assert cost.extrapolate(points, at) == want


def _hlo(kind, n, dims="1024"):
    group = ",".join(str(i) for i in range(n))
    return (f"  %x = f32[{dims}]{{0}} {kind}(f32[{dims}]{{0}} %p), "
            f"replica_groups={{{{{group}}}}}, to_apply=%add")


@pytest.mark.parametrize("n", [2, 4, 8, 16])
@pytest.mark.parametrize("kind", ["all-reduce", "all-gather",
                                  "reduce-scatter", "all-to-all",
                                  "collective-permute"])
def test_collective_wire_bytes_equal_reference(kind, n):
    want = hlo_analysis.collective_wire_bytes(_hlo(kind, n))
    got = cost.collective_wire_bytes(kind, 1024 * 4, n)
    assert got == pytest.approx(want.wire_bytes, rel=1e-12)
    assert want.counts == {kind: 1}
    assert cost.collective_wire_bytes(kind, 4096, 1) == 0.0


def test_redistribute_plan():
    from torch.distributed.tensor import Partial, Replicate, Shard
    sizes = (4, 2)
    # a gradient Partial over data onto its parameter's Shard(0): one
    # reduce-scatter of the (64, 32) block over 4
    p = cost.redistribute_plan((Partial(), Shard(1)), (Shard(0), Shard(1)),
                               (64, 32), 4, sizes)
    assert p.ops == [("reduce-scatter", 16 * 32 * 4, 4)]
    assert p.wire_bytes == 3 * 16 * 32 * 4
    # Partial on both onto replicated: two all-reduces, data first
    p = cost.redistribute_plan((Partial(), Partial()), (Replicate(),) * 2,
                               (64,), 4, sizes)
    assert p.ops == [("all-reduce", 256, 4), ("all-reduce", 256, 2)]
    # data first: reduce-scatter over 4, then over 2 on the smaller block
    p = cost.redistribute_plan((Partial(), Partial()), (Shard(0), Shard(1)),
                               (64, 64), 4, sizes)
    assert p.ops == [("reduce-scatter", 16 * 64 * 4, 4),
                     ("reduce-scatter", 16 * 32 * 4, 2)]
    p = cost.redistribute_plan((Shard(0), Replicate()),
                               (Replicate(), Shard(0)), (16, 8), 4, sizes)
    assert p.ops == [("all-gather", 64 * 8 * 4, 4)]
    assert cost.redistribute_plan((Shard(0), Shard(1)), (Shard(0), Shard(1)),
                                  (16, 8), 4, sizes).ops == []


def test_roofline_h100_terms():
    r = cost.Roofline(flops=989e12, hbm_bytes=3.35e12, wire_bytes=450e9,
                      chips=8, model_flops=8 * 989e12 / 2)
    assert r.compute_s == pytest.approx(1.0)
    assert r.memory_s == pytest.approx(1.0)
    assert r.collective_s == pytest.approx(1.0)      # NVLink within 8
    assert r.useful_flops_frac == pytest.approx(0.5)
    big = cost.Roofline(flops=67e12, hbm_bytes=0, wire_bytes=50e9, chips=256,
                        bf16=False)
    assert big.compute_s == pytest.approx(1.0)       # f32 rate
    assert big.collective_s == pytest.approx(1.0)    # InfiniBand beyond 8
    s = big.summary()
    assert s["dominant"] in ("compute", "collective") and s["chips"] == 256
    # no TPU figure is carried over
    assert cost.H100_BF16_FLOPS != hlo_analysis.PEAK_FLOPS
    assert cost.H100_HBM_BW != hlo_analysis.HBM_BW
