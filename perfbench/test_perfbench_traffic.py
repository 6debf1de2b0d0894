"""The traffic loops and the data generator, rehearsed on the CPU against
``KnnServer(device="cpu")`` at tiny sizes."""

import numpy as np
import pytest
import torch

from perfbench import harness, spec, tiny


@pytest.fixture(scope="module")
def served():
    c = tiny.cell("deep1b.batch128_l100")
    gen = spec.load_module("data", "mixture")
    params = c.config["data"]["params"]
    pts = gen.points(c.config["n_points"], 96, params, 11, "cpu")
    pool = gen.queries(64, 96, params, 11, "cpu").numpy()
    from repro_torch.runtime.knn_server import KnnServer

    cfg = harness.service_config(c.config)
    server = KnnServer(pts, cfg=cfg, shards=8, device="cpu", seed=11)
    with server.serving():
        yield c, server, pool
    server.close()


def test_mixture_is_seeded_chunked_and_unit(served):
    c, _, _ = served
    gen = spec.load_module("data", "mixture")
    params = c.config["data"]["params"]
    n = c.config["n_points"]
    a = gen.points(n, 96, params, 2**40 + 3, "cpu")
    b = torch.cat([x for _, x in gen.chunks(n, 96, params, 2**40 + 3,
                                            "cpu")])
    assert torch.equal(a, b)
    assert not torch.equal(a, gen.points(n, 96, params, 2**40 + 4, "cpu"))
    assert torch.allclose(a.norm(dim=1), torch.ones(n), atol=1e-5)
    q = gen.queries(16, 96, params, 2**40 + 3, "cpu")
    assert torch.equal(q, gen.queries(16, 96, params, 2**40 + 3, "cpu"))
    # queries are further draws: unit length, none of them a point
    assert torch.allclose(q.norm(dim=1), torch.ones(16), atol=1e-5)
    assert float(torch.cdist(q, a).min()) > 0.1


def test_closed_loop_rounds(served):
    c, server, pool = served
    traffic = spec.load_module("traffic", "closed_loop")
    params = dict(c.workload["params"], clients=2, requests_per_round=8)
    b0 = server.stats.snapshot()["batches"]
    win = traffic.warmup(server, pool, dict(params, warmup_rounds=2), 0)
    assert len(win.requests) == 2 * 2 * 8
    assert len(win.answered()) == len(win.requests)
    assert sorted({r.index for r in win.requests}) == list(range(32, 64))
    # a window shorter than a round still has each client's first round
    win = traffic.run(server, pool, params, 0, 0.0)
    assert len(win.requests) == len(win.answered()) == 2 * 8
    assert sorted(r.index for r in win.requests) == list(range(16))
    win = traffic.run(server, pool, params, 0, 0.2)
    reqs = win.answered()
    assert reqs and len(reqs) % 8 == 0 and len(reqs) == len(win.requests)
    assert all(r.t_answer >= r.t_send == r.t_due for r in reqs)
    assert all(r.batch > b0 and r.bucket in (8, 16) for r in reqs)
    assert all(len(r.ids) == r.l == params["l"] for r in reqs)
    assert win.t1 == max(r.t_answer for r in reqs) and win.seconds > 0
    # each client's first round takes rows 0-7 and 8-15
    assert {r.index for r in reqs[:8]} | {r.index for r in reqs
                                          if r.index < 16} >= set(range(8))
    batches = harness.batches_of(win)
    assert sum(b["n_real"] for b in batches) == len(reqs)


def test_open_loop_schedule_and_lateness(served):
    c, server, pool = served
    traffic = spec.load_module("traffic", "open_loop")
    due = traffic.schedule({"rate": 1000.0}, 5, 20.0)
    assert 19000 < len(due) < 21000 and np.all(np.diff(due) >= 0)
    np.testing.assert_array_equal(due, traffic.schedule({"rate": 1000.0},
                                                         5, 20.0))
    win = traffic.run(server, pool, {"rate": 50.0, "l": 10}, 7, 0.3)
    assert len(win.lateness_s) == len(win.requests) > 0
    assert all(x >= 0 for x in win.lateness_s)
    assert all(r.answered and r.t_answer > r.t_due for r in win.requests)
    assert all(len(r.ids) == 10 for r in win.requests)
