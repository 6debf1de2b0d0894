"""The gather-baseline cell and the open-loop cell at a tiny size on the
CPU: each run is correct, a fault planted in the gather merge turns
``correct`` false, and the cells' per-layer readers read a number where
their counter exists and None where it does not."""

import types

import pytest

from perfbench import harness, spec, tiny, work

GATHER = "deep1b-gather.batch128_l100"
OPEN = "deep1b.open_l10"
SEED = 2**34 + 29


def cell(name):
    c = tiny.cell(name)
    if name == OPEN:
        # a rate the plain kernels keep up with, small buckets
        c.workload["params"]["rate"] = 40.0
        c.config["service"] = dict(c.config["service"],
                                   bucket_sizes=[1, 2, 4, 8])
    return c


def run(name, traced=False, seed=SEED):
    # the open loop sends ~40 requests at its rate here
    seconds = 1.0 if name == OPEN else 0.3
    return harness.run_cell(cell(name), seed, seconds, traced, "cpu", 0.0)


@pytest.mark.parametrize("name", [GATHER, OPEN])
def test_new_cell_run_is_correct(name):
    line = run(name)
    checks = line["checks"]
    assert line["correct"], checks
    assert line["failed"] == 0 and checks["bad_answers"]["value"] == 0
    assert checks["sampled"]["value"] == min(16, line["attempted"]) > 0
    metrics = line["metrics"]
    assert set(metrics) == {"latency_p95_ms", "setup_s"}
    assert metrics["latency_p95_ms"]["value"] > 0


def test_gather_cell_serves_through_the_merge():
    c = cell(GATHER)
    assert harness.service_config(c.config).sampler == "gather"
    assert spec.cell(GATHER).workload["params"] == spec.cell(
        "deep1b.batch128_l100").workload["params"]


def _swap_last_winner(knn, monkeypatch):
    """The merge keeps the (l+1)-th candidate in place of the l-th."""
    real = knn.kops

    def local_topk(values, l):
        v, i = real.local_topk(values, l + 1)
        keep = list(range(l - 1)) + [l]
        return v[..., keep], i[..., keep]

    proxy = types.SimpleNamespace(
        **{n: getattr(real, n) for n in dir(real) if not n.startswith("_")})
    proxy.local_topk = local_topk
    monkeypatch.setattr(knn, "kops", proxy)


def test_planted_merge_fault_is_caught(monkeypatch):
    from repro_torch.core import knn

    _swap_last_winner(knn, monkeypatch)
    line = run(GATHER)
    assert not line["correct"], line["checks"]
    assert line["checks"]["rank_gap"]["value"] > line["checks"][
        "rank_gap"]["limit"]


def read(name, ctx):
    return spec.load_module("metrics", name).read(ctx)


def context(stats0, stats1, window=None, trace=None, c=None, batches=()):
    return harness.Context(cell=c, window=window, setup_s=0.0,
                           stats0=stats0, stats1=stats1,
                           batches=list(batches), peaks=work.peaks(),
                           trace=trace)


@pytest.mark.parametrize("name,readers", [
    (GATHER, ["gather.merge_ms_per_batch"]),
    (OPEN, ["serve.rows_per_batch", "traffic.lateness_ms_p99"])])
def test_readers_on_a_traced_run(name, readers):
    line = run(name, traced=True)
    assert line["correct"], line["checks"]
    for r in readers:
        assert line["metrics"][r]["value"] >= 0, r
    if name == OPEN:
        rows = line["metrics"]["serve.rows_per_batch"]["value"]
        assert 1 <= rows <= 8
    else:
        assert line["metrics"]["gather.merge_ms_per_batch"]["value"] > 0


def test_counter_readers_without_their_counter():
    s0 = {"batches": 10, "queries": 40, "merge_s": 0.5}
    s1 = {"batches": 14, "queries": 60, "merge_s": 0.7}
    assert read("gather.merge_ms_per_batch",
                context(s0, s1)) == pytest.approx(50.0)
    assert read("serve.rows_per_batch", context(s0, s1)) == 5.0
    # the parent's server keeps no merge sum; a window with no batch;
    # a selection server's merge sum stays 0
    old = {k: v for k, v in s1.items() if k != "merge_s"}
    assert read("gather.merge_ms_per_batch", context(s0, old)) is None
    assert read("gather.merge_ms_per_batch", context(s1, s1)) is None
    assert read("serve.rows_per_batch", context(s1, s1)) is None
    win = types.SimpleNamespace(lateness_s=[0.001] * 99 + [0.101])
    assert read("traffic.lateness_ms_p99", context(
        s0, s1, window=win)) == pytest.approx(2.0)
    closed = types.SimpleNamespace(lateness_s=[])
    assert read("traffic.lateness_ms_p99",
                context(s0, s1, window=closed)) is None


def test_gather_roofline_reads_as_the_step_roofline():
    c = cell(GATHER)
    batches = [{"n_real": 128}, {"n_real": 100}]
    trace = {"step_device_s": 0.4, "window_s": 0.5}
    ctx = context({}, {}, trace=trace, c=c, batches=batches)
    got = read("gather.topl_step_roofline", ctx)
    assert got is not None and got > 0
    assert got == read("topl_step_roofline", ctx)
    # no trace, or no step time in it
    assert read("gather.topl_step_roofline",
                context({}, {}, c=c, batches=batches)) is None
    ctx = context({}, {}, trace=dict(trace, step_device_s=None), c=c,
                  batches=batches)
    assert read("gather.topl_step_roofline", ctx) is None
