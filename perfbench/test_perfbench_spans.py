"""The idle split by the program's spans, and the readers of the spans'
numbers, on events and spans laid out by hand."""

import pytest

from perfbench import harness, spec
from perfbench.spans import summarize
from perfbench.trace import Ev, WINDOW

# the anchor maps a span's perf_counter seconds t to t + 10 on the trace
ANCHOR = [5_000_000_000, 15_000_000_000]


def rec(span, parent, name, t0, t1, **attrs):
    r = {"trace": 1, "span": span, "parent": parent, "name": name,
         "t0": t0 - 10.0, "t1": t1 - 10.0}
    if attrs:
        r["attrs"] = attrs
    return r


def records():
    """One dispatch tree, given in trace seconds, and a request tree,
    which carries no anchor and is not read."""
    return [
        rec(1, None, "dispatch", 11.0, 13.0, anchor=ANCHOR),
        rec(2, 1, "snapshot", 11.0, 11.1),
        rec(3, 1, "kernel", 11.1, 12.5),
        rec(4, 3, "topl", 11.1, 11.6, device_s=0.45),
        rec(5, 3, "prune", 11.6, 11.7),
        rec(6, 3, "select", 11.7, 12.2, iterations=2, host_syncs=3),
        rec(7, 3, "gather", 12.2, 12.3),
        rec(8, 3, "readback", 12.3, 12.5),
        rec(9, 1, "resolve", 12.6, 13.0),
        dict(rec(10, None, "request", 10.5, 13.0), trace=10),
    ]


def events():
    return [
        Ev(WINDOW, False, 10.0, 20.0, 1),
        Ev("cudaLaunchKernel", False, 11.15, 11.16, 7, 1),
        Ev("cudaLaunchKernel", False, 11.75, 11.76, 7, 2),
        Ev("cudaLaunchKernel", False, 11.95, 11.96, 7, 3),
        Ev("cudaLaunchKernel", False, 12.05, 12.06, 7, 4),
        Ev("cudaLaunchKernel", False, 12.22, 12.23, 7, 5),
        Ev("cudaMemcpyAsync", False, 12.32, 12.36, 7, 6),
        Ev("cudaLaunchKernel", False, 11.8, 11.81, 9, 7),   # another thread
        Ev("distance", True, 11.2, 11.6, 0, 1),
        Ev("loop", True, 11.8, 11.9, 0, 2),
        Ev("loop", True, 12.0, 12.1, 0, 3),
        Ev("gather", True, 12.25, 12.3, 0, 5),
        Ev("copy", True, 12.35, 12.4, 0, 6),
        Ev("warmup", True, 5.0, 9.0, 0, 0),
    ]


def test_idle_parts_sum_to_the_windows_idle():
    s = summarize(events(), records())
    assert s["window_s"] == 10.0
    assert abs(s["idle_s"] - (10.0 - 0.7)) < 1e-9
    want = {"between_dispatches": 8.0, "snapshot": 0.1, "topl": 0.1,
            "prune": 0.1, "select": 0.3, "gather": 0.05, "readback": 0.15,
            "dispatch": 0.1, "resolve": 0.4}
    assert set(s["idle"]) == set(want)
    for name, v in want.items():
        assert abs(s["idle"][name] - v) < 1e-6, name


def test_launches_inside_select_and_alignment():
    s = summarize(events(), records(), dropped=0)
    assert (s["select_spans"], s["select_launches"]) == (1, 3)
    assert s["readbacks"] == 1 and s["aligned"] == 1.0 and s["dropped"] == 0
    ev = [e for e in events() if e.name != "cudaMemcpyAsync"]
    ev.append(Ev("cudaMemcpyAsync", False, 12.45, 12.55, 7, 6))
    assert summarize(ev, records())["aligned"] == 0.0


def test_no_window_or_no_anchor():
    assert summarize([e for e in events() if e.name != WINDOW],
                     records()) is None
    bare = [dict(r, attrs={}) if r["name"] == "dispatch" else r
            for r in records()]
    s = summarize(events(), bare)
    assert s["idle"] == {"between_dispatches": pytest.approx(9.3)}
    assert s["select_spans"] == 0 and s["aligned"] is None


def context(spans=None, stats0=None, stats1=None):
    ctx = harness.Context(cell=None, window=None, setup_s=0.0,
                          stats0=stats0 or {"batches": 0},
                          stats1=stats1 or {"batches": 0}, batches=[],
                          peaks={})
    if spans is not None:
        ctx.spans = spans
    return ctx


def read(name, ctx):
    return spec.load_module("metrics", name).read(ctx)


SPAN_READERS = {"alg.idle_share": 100 * (0.1 + 0.3 + 0.05) / 10,
                "serve.idle_share": 100 * (0.1 + 0.4 + 0.1 + 8.0) / 10,
                "alg.select_launches_per_batch": 3.0}


@pytest.mark.parametrize("name", sorted(SPAN_READERS))
def test_span_readers(name):
    s = summarize(events(), records())
    assert read(name, context(s)) == pytest.approx(SPAN_READERS[name])
    assert read(name, context()) is None                 # no spans kept
    assert read(name, context(dict(s, dropped=1))) is None
    assert read(name, context(dict(s, aligned=0.98))) is None
    assert read(name, context(dict(s, aligned=None))) is None


@pytest.mark.parametrize("name,key,ms", [
    ("kernels.topl_step_ms", "topl_device_s", 200.0),
    ("alg.select_ms_per_batch", "select_s", 50.0)])
def test_server_sum_readers(name, key, ms):
    s0 = {"batches": 10, "topl_device_s": 1.0, "select_s": 0.5}
    s1 = {"batches": 14, "topl_device_s": 1.8, "select_s": 0.7}
    assert read(name, context(stats0=s0, stats1=s1)) == pytest.approx(ms)
    # a server without the sum (the parent's) or without a batch
    old = {k: v for k, v in s1.items() if k != key}
    assert read(name, context(stats0=s0, stats1=old)) is None
    assert read(name, context(stats0=s1, stats1=s1)) is None
