"""The uint8 cell and the decode cell at a tiny size on the CPU: the uint8
data generator, the reference on uint8 chunks, the uint8 step's work
count and roofline reader, and a planted off-by-one distance caught under
the cell's 0 limits."""

import numpy as np
import pytest
import torch

from perfbench import check, harness, spec, tiny, work
from perfbench.reference import exact_topl
from perfbench.work import topl_step_u8

BIGANN = "bigann.batch128_l10"
DECODE = "knnlm.decode32_l1024"
SEED = 2**34 + 41


def run(name, traced=False, seed=SEED):
    return harness.run_cell(tiny.cell(name), seed, 0.3, traced, "cpu", 0.0)


def gen():
    return spec.load_module("data", "mixture_u8")


def params():
    return dict(spec.cell(BIGANN).config["data"]["params"], chunk_rows=300)


def test_mixture_u8_chunks_remade_equal_the_whole_set():
    g, p = gen(), params()
    whole = g.points(1000, 128, p, SEED, "cpu")
    assert whole.dtype == torch.uint8 and whole.shape == (1000, 128)
    parts = list(g.chunks(1000, 128, p, SEED, "cpu"))
    assert [r0 for r0, _ in parts] == [0, 300, 600, 900]
    assert torch.equal(torch.cat([x for _, x in parts]), whole)
    # chunk c alone, made again from its own seed
    centers = g.make_centers(128, p, SEED, "cpu")
    assert torch.equal(g.chunk(2, 1000, centers, p, SEED), whole[600:900])
    q = g.queries(50, 128, p, SEED, "cpu")
    assert q.dtype == torch.uint8 and not torch.equal(q, whole[:50])
    # SIFT-like: many small values, norms of a few hundred
    norms = whole.double().norm(dim=1)
    assert 350 < float(norms.median()) < 650
    assert float((whole < 16).double().mean()) > 0.1


def test_reference_scans_uint8_chunks_like_an_f64_brute_force():
    g, p = gen(), params()
    pts = g.points(1000, 128, p, SEED, "cpu")
    q = g.queries(6, 128, p, SEED, "cpu")
    ref = exact_topl.scan(q, 10, g.chunks(1000, 128, p, SEED, "cpu"),
                          torch.arange(10).repeat(6, 1))
    d = ((q.double()[:, None, :] - pts.double()[None]) ** 2).sum(-1)
    for s in range(6):
        order = np.lexsort((np.arange(1000), d[s].numpy()))[:10]
        assert np.array_equal(ref["top_i"][s].numpy(), order)
        assert np.array_equal(ref["top_d"][s].numpy(), d[s, order].numpy())
        assert np.array_equal(ref["served_d"][s].numpy(), d[s, :10].numpy())
    assert ref["max_norm2"] == float((pts.double() ** 2).sum(1).max())


@pytest.mark.parametrize("name", [BIGANN, DECODE])
def test_new_cell_run_is_correct(name):
    line = run(name)
    checks = line["checks"]
    assert line["correct"], checks
    assert line["failed"] == 0 and checks["bad_answers"]["value"] == 0
    assert checks["sampled"]["value"] > 0
    assert set(line["metrics"]) == {"latency_p95_ms", "setup_s"}
    if name == BIGANN:
        # exact integer distances: the served answer is the exact one
        assert checks["dist_gap"] == {"value": 0.0, "limit": 0}
        assert checks["rank_gap"] == {"value": 0.0, "limit": 0}


def test_bigann_cell_serves_uint8_points():
    c = tiny.cell(BIGANN)
    assert c.config["dtype"] == "uint8"
    assert c.workload["check"]["limits"] == {"dist_gap": 0, "rank_gap": 0}
    pts = gen().points(c.config["n_points"], c.config["dim"],
                       c.config["data"]["params"], SEED, "cpu")
    from repro_torch.runtime.knn_server import KnnServer
    srv = KnnServer(pts, cfg=harness.service_config(c.config),
                    shards=c.config["shards"], device="cpu")
    assert srv._points.dtype == torch.uint8
    srv.close()


def test_planted_off_by_one_distance_is_caught(monkeypatch):
    """One served distance 1 above the exact integer turns `correct`
    false under the cell's 0 limits."""
    from repro_torch.core import knn

    real = knn.local_distance_top_l

    def off_by_one(*args, **kwargs):
        out = real(*args, **kwargs)
        v = out[0].clone()
        v[..., 0] += 1.0
        return (v,) + tuple(out[1:])

    monkeypatch.setattr(knn, "local_distance_top_l", off_by_one)
    line = run(BIGANN)
    assert not line["correct"]
    assert line["checks"]["dist_gap"]["value"] > 0


def test_u8_step_work_by_hand():
    cfg = spec.load_json(spec.HERE / "configs" / "bigann-128d-u8.json")
    n, d, k = cfg["n_points"], cfg["dim"], cfg["shards"]
    ops, nbytes = topl_step_u8.work(n, d, k, 128, 10)
    # 2 * 128 * 5e8 * 128; one byte a coordinate, f32 queries, 8-byte pairs
    assert ops == 2.0 * 128 * 5e8 * 128
    assert nbytes == n * d + 128 * d * 4 + k * 128 * 10 * 8
    assert nbytes / 1e9 == pytest.approx(64.0, rel=1e-3)
    pk = work.peaks()
    bound = topl_step_u8.bound_s(ops, nbytes, pk)
    # bound by the bytes: 19.1 ms; the operations 8.3 ms at the int8 peak
    assert bound * 1e3 == pytest.approx(19.10, rel=1e-3)
    assert ops / topl_step_u8.INT8_DENSE_OPS_PER_S * 1e3 == pytest.approx(
        8.28, rel=1e-2)
    assert topl_step_u8.INT8_DENSE_OPS_PER_S > pk["f32_flops_per_s"] * 20
    batches = [{"n_real": 128}, {"n_real": 3}]
    assert topl_step_u8.window_bound_s(cfg, batches, pk) == pytest.approx(
        bound + topl_step_u8.bound_s(*topl_step_u8.work(n, d, k, 3, 10), pk))


def test_u8_roofline_reader():
    c = tiny.cell(BIGANN)
    batches = [{"n_real": 128}, {"n_real": 64}]
    bound = topl_step_u8.window_bound_s(c.config, batches, work.peaks())

    def ctx(trace):
        return harness.Context(cell=c, window=None, setup_s=0.0, stats0={},
                               stats1={}, batches=batches,
                               peaks=work.peaks(), trace=trace)

    read = spec.load_module("metrics", "u8.topl_step_roofline").read
    assert read(ctx({"step_device_s": 4 * bound})) == pytest.approx(25.0)
    assert read(ctx(None)) is None
    assert read(ctx({"step_device_s": None})) is None


def test_new_entries_name_only_their_cells():
    bench = spec.load_json(spec.REPO / "BENCHMARK.json")
    metric = next(m for m in bench["per_layer"]
                  if m["name"] == "u8.topl_step_roofline")
    assert metric["workloads"] == [BIGANN]
    assert metric["unit"] == "%" and metric["layer"] == "kernels"
    cells = {w["name"]: w for w in bench["workloads"]}
    assert cells[BIGANN]["chips"] == cells[DECODE]["chips"] == 1
    decode = spec.cell(DECODE)
    assert decode.workload["params"]["clients"] == 1
    assert decode.workload["params"]["requests_per_round"] == 32
    assert decode.per_layer and BIGANN not in [
        w for m in bench["per_layer"] if m["name"] != metric["name"]
        for w in m.get("workloads", [])]


def test_served_matrix_holds_uint8_answers():
    """The check's numbers on exact integer answers read exactly 0."""
    q = torch.tensor([[1, 2], [3, 4]], dtype=torch.uint8)
    p = torch.tensor([[1, 2], [3, 5], [0, 0]], dtype=torch.uint8)
    served_i = [np.array([0, 2]), np.array([1, 0])]
    served_d = [np.array([0.0, 5.0], np.float32),
                np.array([1.0, 8.0], np.float32)]
    ref = exact_topl.scan(q, 2, [(0, p)],
                          torch.from_numpy(check.served_matrix(served_i, 2)))
    got = check.numbers(served_d, served_i, [2, 2], ref, 3,
                        (q.double() ** 2).sum(1).numpy())
    assert got == {"bad_answers": 0, "dist_gap": 0.0, "rank_gap": 0.0}
    # the second nearest of the first query swapped for the third
    served_i[0], served_d[0] = np.array([0, 1]), np.array([0.0, 13.0])
    ref = exact_topl.scan(q, 2, [(0, p)],
                          torch.from_numpy(check.served_matrix(served_i, 2)))
    got = check.numbers(served_d, served_i, [2, 2], ref, 3,
                        (q.double() ** 2).sum(1).numpy())
    assert got["dist_gap"] == 0.0 and got["rank_gap"] > 0


def test_tf32_control_reads_0_and_bf16_keys_do_not():
    """Products in TF32 hold 8-bit integers and their f32 sums below 2^24
    exactly, so the TF32 control on uint8 points reads 0 too: the cell's
    0 limits are the arithmetic's own.  Distances kept one precision
    below the f32 keys, in bf16, fail them.  (``control.py`` squares the
    points in their stored type, which wraps at uint8, so the control is
    run here on the points widened to f32.)"""
    c = tiny.cell(BIGANN)
    g = gen()
    cfg, wl = c.config, c.workload
    n, d, l = cfg["n_points"], cfg["dim"], wl["params"]["l"]
    p = cfg["data"]["params"]
    pool = g.queries(wl["query_pool"], d, p, SEED, "cpu").numpy()[:8]
    q = torch.from_numpy(pool)
    widened = ((r0, x.float()) for r0, x in g.chunks(n, d, p, SEED, "cpu"))
    tf32 = exact_topl.scan(q.float(), l, widened, precision="tf32")
    exact = exact_topl.scan(q, l, g.chunks(n, d, p, SEED, "cpu"))
    assert torch.equal(tf32["top_i"], exact["top_i"])
    assert torch.equal(tf32["top_d"].double(), exact["top_d"])
    for keys, passes in ((exact["top_d"].float(), True),
                         (exact["top_d"].to(torch.bfloat16).float(), False)):
        values = harness.compare(c, pool, [l] * 8, list(keys.numpy()),
                                 list(exact["top_i"].numpy()), g, SEED,
                                 "cpu")
        ok, _ = check.verdict(values, wl["check"]["limits"])
        assert ok == passes and (values["dist_gap"] == 0) == passes
