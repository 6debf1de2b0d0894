"""The device's idle time in the traced window, split by the program's
own spans.

With ``obs_trace`` on, the server records one ``dispatch`` tree a batch
(``snapshot``, ``route``, ``kernel`` with Algorithm 2's phases ``topl``,
``prune``, ``select``, ``gather`` and then ``readback``, ``predict``
under it, ``shadow_audit``, ``resolve``).  Its spans are stamped with
the monotonic clock; each ``dispatch`` carries an ``anchor``
``[perf_counter_ns, time_ns]``, through which every span of its tree
maps to the Unix nanoseconds the profiler stamps its events with.  From
the profiler's events (``trace.from_profiler``) and the tracer's
exported records this module takes:

``idle``              the device's idle time inside the window, reckoned
                      as ``trace.summarize`` reckons it, split by the
                      innermost span of a dispatch tree open at each
                      instant: a phase, ``snapshot``, ``route``,
                      ``resolve``, ``shadow_audit``, the self time of
                      ``kernel`` and of ``dispatch``; time with no
                      dispatch open is ``between_dispatches``
``select_launches``   the serving thread's kernel launches (the runtime
                      calls) that start inside a ``select`` span of the
                      window, and ``select_spans`` those spans
``aligned``           the share of the window's ``readback`` spans that
                      contain one of the serving thread's
                      ``cudaMemcpyAsync`` calls: whether the two clocks
                      agree (None without a readback)
``dropped``           spans the ring evicted by the window's end, as the
                      caller read them (``Tracer.stats()``)

The serving thread is the one that launched the most kernels in the
window.  :func:`sound` is what the readers of these numbers read: None
where the ring dropped spans or the clocks did not align.
"""

from __future__ import annotations

import bisect
import re

from perfbench.trace import WINDOW, _union

LOOP = ("prune", "select", "gather")
BETWEEN = "between_dispatches"
SERVE = ("snapshot", "route", "resolve", "shadow_audit", "dispatch",
         BETWEEN)
ALIGNED_MIN = 0.99
_LAUNCH = re.compile(r"^cu(da)?LaunchKernel")


def _mapped(records) -> list:
    """``(start, end, depth, name)`` in seconds on the trace's clock for
    every span of a dispatch tree whose root carries an anchor."""
    by_id = {r["span"]: r for r in records}
    anchors = {r["span"]: r["attrs"]["anchor"] for r in records
               if r["name"] == "dispatch" and r["parent"] is None
               and r.get("attrs", {}).get("anchor")}
    out = []
    for r in records:
        depth, root = 0, r
        while root["parent"] is not None and root["parent"] in by_id:
            root = by_id[root["parent"]]
            depth += 1
        anchor = anchors.get(root["span"])
        if anchor is None or root["parent"] is not None:
            continue
        p_ns, u_ns = anchor
        out.append(((u_ns + r["t0"] * 1e9 - p_ns) * 1e-9,
                    (u_ns + r["t1"] * 1e9 - p_ns) * 1e-9, depth, r["name"]))
    return out


def _innermost(spans) -> list:
    """Disjoint ``(start, end, name)`` pieces, ascending: at each instant
    the deepest open span (the later started of two as deep)."""
    bounds = sorted({t for s, e, _, _ in spans for t in (s, e)})
    opens = sorted(spans)
    pieces, active, k = [], [], 0
    for a, b in zip(bounds, bounds[1:]):
        while k < len(opens) and opens[k][0] <= a:
            active.append(opens[k])
            k += 1
        active = [s for s in active if s[1] > a]
        if active:
            top = max(active, key=lambda s: (s[2], s[0]))
            if pieces and pieces[-1][2] == top[3] and pieces[-1][1] == a:
                pieces[-1][1] = b
            else:
                pieces.append([a, b, top[3]])
    return pieces


def _idle_gaps(events, w0, w1) -> list:
    dev = [e for e in events if e.device and e.end > w0 and e.start < w1]
    busy = _union((max(e.start, w0), min(e.end, w1)) for e in dev)
    gaps, prev = [], w0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if prev < w1:
        gaps.append((prev, w1))
    return gaps


def _split(gaps, pieces) -> dict:
    """Each gap's length by the piece covering it, the rest
    ``between_dispatches``."""
    idle = {}
    starts = [p[0] for p in pieces]
    for g0, g1 in gaps:
        covered = 0.0
        k = max(bisect.bisect_right(starts, g0) - 1, 0)
        while k < len(pieces) and pieces[k][0] < g1:
            s, e, name = pieces[k]
            part = min(e, g1) - max(s, g0)
            if part > 0:
                idle[name] = idle.get(name, 0.0) + part
                covered += part
            k += 1
        idle[BETWEEN] = idle.get(BETWEEN, 0.0) + (g1 - g0 - covered)
    return idle


def summarize(events, records, dropped: int = 0):
    """The numbers of the module docstring from the profiler's
    ``events`` and the tracer's span ``records``; None when the trace
    holds no window range."""
    wins = [e for e in events if not e.device and e.name == WINDOW]
    if not wins:
        return None
    w0, w1 = wins[-1].start, wins[-1].end
    spans = _mapped(records)
    idle = _split(_idle_gaps(events, w0, w1), _innermost(spans))

    calls = [e for e in events if not e.device and e.end > w0
             and e.start < w1]
    launches = {}
    for e in calls:
        if _LAUNCH.match(e.name):
            launches.setdefault(e.thread, []).append(e.start)
    serving = max(launches, key=lambda t: len(launches[t]), default=None)
    starts = sorted(launches.get(serving, []))
    copies = sorted((e.start, e.end) for e in calls
                    if e.thread == serving and e.name == "cudaMemcpyAsync")

    inside = [s for s in spans if s[0] >= w0 and s[1] <= w1]
    selects = [s for s in inside if s[3] == "select"]
    n_launch = sum(bisect.bisect_right(starts, e) - bisect.bisect_left(
        starts, s) for s, e, _, _ in selects)
    readbacks = [s for s in inside if s[3] == "readback"]
    hit = 0
    for s, e, _, _ in readbacks:
        k = bisect.bisect_left(copies, (s, s))
        hit += k < len(copies) and copies[k][1] <= e
    return {"window_s": w1 - w0, "idle_s": sum(idle.values()),
            "idle": idle, "select_spans": len(selects),
            "select_launches": n_launch, "readbacks": len(readbacks),
            "aligned": hit / len(readbacks) if readbacks else None,
            "dropped": int(dropped)}


def sound(ctx):
    """The run's ``spans`` numbers where they can be read (ring whole,
    clocks aligned), else None."""
    s = getattr(ctx, "spans", None)
    if (not s or s["dropped"] > 0 or s["aligned"] is None
            or s["aligned"] < ALIGNED_MIN or s["window_s"] <= 0):
        return None
    return s


def idle_share(ctx, names) -> float | None:
    """Idle inside the spans ``names`` over the window, in %."""
    s = sound(ctx)
    if s is None:
        return None
    return 100.0 * sum(s["idle"].get(n, 0.0) for n in names) / s["window_s"]
