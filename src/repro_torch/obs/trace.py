"""Flight-recorder tracing: monotonic-clock spans in a ring buffer.

The port's own copy of ``repro.obs.trace``, plus the phase clock and
the anchors.  Stdlib only at import (a :class:`PhaseClock` for the card
imports torch for its events): the serving path
(`runtime/knn_server.py`), the mutable store and the background
maintenance worker import it, and it costs ~nothing when disabled.

Model
-----
A **span** is one timed operation: ``(trace_id, span_id, parent_id,
name, t0, t1, attrs)``.  Times are ``time.perf_counter()`` floats (the
monotonic clock — immune to wall-clock steps; every span in one process
shares the clock, so cross-thread interleavings are directly
comparable).  Spans form trees through ``parent_id``; a span with
``parent_id=None`` roots a new trace and its ``trace_id`` is its own
``span_id``.  Cross-tree references (a request span pointing at the
micro-batch dispatch span that carried it) go through *attributes*, not
parent links, so every tree stays single-rooted and well-formed.

Two ways to produce a span:

* ``begin(name, ...)`` / ``Span.end(...)`` — for operations that start
  and finish in different stack frames (or different threads: a request
  span begins in ``submit()`` on the caller's thread and ends in the
  micro-batcher's resolve loop).
* ``record(name, t0, t1, ...)`` — retroactive: for intervals whose
  endpoints were already measured (the queued interval is
  ``t_enqueue → t_dispatch``, both captured anyway).
* ``span(name, ...)`` — context-manager sugar over begin/end for
  same-frame intervals.

The recorder is a fixed-capacity ring (`collections.deque(maxlen=...)`):
a long-running server never grows without bound, the newest spans win —
flight-recorder semantics.  ``export_jsonl()`` dumps the ring, one JSON
object per line, for offline assembly into trees.

``NULL_TRACER`` is the disabled plane: every call funnels to a shared
no-op span, no lock, no allocation — the `obs=off` arm the ≤10%
overhead guard (tests/test_obs.py) compares against.

**One clock with a device trace.**  ``Tracer.anchor()`` reads the
monotonic clock and the Unix clock back to back, the tightest of a few
tries; the server stamps one on each ``dispatch`` span.  A span's time
``t`` then maps to Unix nanoseconds, the clock ``torch.profiler``
stamps its events with, as ``time_ns + (t * 1e9 - perf_counter_ns)``
with the pair ``[perf_counter_ns, time_ns]`` of its batch: one anchor a
batch holds the drift between the two clocks to one batch's length.

**Phases.**  A :class:`PhaseClock` marks the phases of one device batch
(Algorithm 2's ``topl``, ``prune``, ``select``, ``gather``, then the
server's ``readback``): a host stamp at each mark and, on the card, a
CUDA timing event on the current stream, from a pool built once.  The
events are read only after a readback has waited for the stream, so the
clock adds no sync and launches nothing.  ``NULL_PHASES`` is its no-op
stand-in.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from collections import deque
from typing import Optional

_ids = itertools.count(1)      # process-wide: span ids unique across tracers


class Span:
    """One in-flight (or finished) span.  End it exactly once."""

    __slots__ = ("tracer", "name", "span_id", "trace_id", "parent_id",
                 "t0", "t1", "attrs")

    def __init__(self, tracer: "Tracer", name: str, span_id: int,
                 trace_id: int, parent_id: Optional[int], t0: float,
                 attrs: dict):
        self.tracer = tracer
        self.name = name
        self.span_id = span_id
        self.trace_id = trace_id
        self.parent_id = parent_id
        self.t0 = t0
        self.t1: Optional[float] = None
        self.attrs = attrs

    def end(self, **attrs) -> "Span":
        """Finish the span (idempotent: a second end is ignored)."""
        if self.t1 is None:
            self.t1 = time.perf_counter()
            if attrs:
                self.attrs.update(attrs)
            self.tracer._finish(self)
        return self

    def annotate(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    # context-manager sugar (see Tracer.span)
    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        self.end()
        return False


class _NullSpan:
    """Shared no-op span: the disabled tracer hands this out everywhere."""

    __slots__ = ()
    span_id = 0
    trace_id = 0
    parent_id = None

    def end(self, **attrs):
        return self

    def annotate(self, **attrs):
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class Tracer:
    """Ring-buffer span recorder; see module docstring.

    Thread-safe: ``begin``/``record`` may race from the submitting
    thread, the micro-batcher, the maintenance worker, and mutators —
    the ring append and the active-span accounting share one lock.
    """

    enabled = True

    def __init__(self, capacity: int = 8192):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self._ring: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._active = 0          # begun, not yet ended (torn-span probe)
        self.dropped = 0          # spans evicted by the ring
        self.anchor_gap_ns = 0    # the widest anchor's read-to-read gap

    # ---- producing spans -------------------------------------------------

    def begin(self, name: str, *, parent=None, t0: Optional[float] = None,
              **attrs) -> Span:
        """Start a span now (or at ``t0``).  ``parent`` is a Span (or
        None to root a new trace)."""
        sid = next(_ids)
        if parent is None or parent.span_id == 0:
            trace_id, parent_id = sid, None
        else:
            trace_id, parent_id = parent.trace_id, parent.span_id
        span = Span(self, name, sid, trace_id, parent_id,
                    time.perf_counter() if t0 is None else t0, attrs)
        with self._lock:
            self._active += 1
        return span

    def span(self, name: str, *, parent=None, **attrs) -> Span:
        """``with tracer.span("kernel", parent=dspan): ...``"""
        return self.begin(name, parent=parent, **attrs)

    def record(self, name: str, t0: float, t1: float, *, parent=None,
               **attrs) -> Span:
        """Retroactive span: both endpoints already measured."""
        span = self.begin(name, parent=parent, t0=t0, **attrs)
        span.t1 = t1
        self._finish(span)
        return span

    def anchor(self) -> list:
        """``[perf_counter_ns, time_ns]`` read back to back: of three
        tries, the one whose two monotonic reads around the Unix read lie
        closest, with their midpoint (module docstring)."""
        best = None
        for _ in range(3):
            a = time.perf_counter_ns()
            u = time.time_ns()
            b = time.perf_counter_ns()
            if best is None or b - a < best[0]:
                best = (b - a, (a + b) // 2, u)
        with self._lock:
            self.anchor_gap_ns = max(self.anchor_gap_ns, best[0])
        return [best[1], best[2]]

    def _finish(self, span: Span) -> None:
        rec = {"trace": span.trace_id, "span": span.span_id,
               "parent": span.parent_id, "name": span.name,
               "t0": span.t0, "t1": span.t1}
        if span.attrs:
            rec["attrs"] = span.attrs
        with self._lock:
            if len(self._ring) == self.capacity:
                self.dropped += 1
            self._ring.append(rec)
            self._active -= 1

    # ---- reading ---------------------------------------------------------

    def spans(self) -> list:
        """Snapshot of the finished-span ring (oldest first)."""
        with self._lock:
            return list(self._ring)

    def active_count(self) -> int:
        """Spans begun but not yet ended — 0 after a clean quiesce (the
        no-torn-spans probe tests/test_obs.py asserts on)."""
        with self._lock:
            return self._active

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self.dropped = 0
            self.anchor_gap_ns = 0

    def stats(self) -> dict:
        with self._lock:
            return {"enabled": True, "capacity": self.capacity,
                    "recorded": len(self._ring), "dropped": self.dropped,
                    "active": self._active,
                    "anchor_gap_ns": self.anchor_gap_ns}

    def export_jsonl(self, path_or_file) -> int:
        """Write the ring as JSONL (one span object per line); returns
        the number of spans written."""
        recs = self.spans()
        if hasattr(path_or_file, "write"):
            for r in recs:
                path_or_file.write(json.dumps(r) + "\n")
        else:
            with open(path_or_file, "w") as f:
                for r in recs:
                    f.write(json.dumps(r) + "\n")
        return len(recs)


class NullTracer:
    """The disabled plane: every producer call returns the shared no-op
    span.  No lock, no allocation — obs=off costs one attribute load and
    one call per instrumentation point."""

    enabled = False
    capacity = 0
    dropped = 0

    def begin(self, name, *, parent=None, t0=None, **attrs):
        return _NULL_SPAN

    def span(self, name, *, parent=None, **attrs):
        return _NULL_SPAN

    def record(self, name, t0, t1, *, parent=None, **attrs):
        return _NULL_SPAN

    def anchor(self):
        return None

    def spans(self):
        return []

    def active_count(self):
        return 0

    def clear(self):
        pass

    def stats(self):
        return {"enabled": False, "capacity": 0, "recorded": 0,
                "dropped": 0, "active": 0}

    def export_jsonl(self, path_or_file):
        return 0


NULL_TRACER = NullTracer()


class PhaseClock:
    """The phases of one device batch (module docstring).

    ``mark(name, **attrs)`` closes the open phase and opens ``name``;
    ``annotate`` adds attributes to the open phase; ``close()`` closes
    the last one with a host stamp alone.  ``phases()`` lists ``(name,
    t0, t1, device_s, attrs)`` in order: ``device_s`` is the elapsed
    time between the phase's two events, None where its closing mark
    recorded none (on the CPU, for the last phase, past the pool).  Call
    ``phases()`` only after a readback that follows the closing event
    has returned: then every event it reads has completed.  ``reset()``
    starts the next batch on the same events.
    """

    EVENTS = 6      # one a phase of a batch; the close records none

    def __init__(self, device):
        self._device = device
        self._events = []
        if device.type == "cuda":
            import torch

            self._stream = torch.cuda.current_stream
            self._events = [torch.cuda.Event(enable_timing=True)
                            for _ in range(self.EVENTS)]
        self._marks: list = []

    def reset(self) -> "PhaseClock":
        self._marks.clear()
        return self

    def mark(self, name: str, **attrs) -> None:
        i = len(self._marks)
        t = time.perf_counter()
        event = self._events[i] if i < len(self._events) else None
        if event is not None:
            event.record(self._stream(self._device))
        self._marks.append((name, t, event, attrs))

    def annotate(self, **attrs) -> None:
        self._marks[-1][3].update(attrs)

    def close(self) -> None:
        self._marks.append((None, time.perf_counter(), None, {}))

    def phases(self) -> list:
        out = []
        for (name, t0, e0, attrs), (_, t1, e1, _) in zip(self._marks,
                                                         self._marks[1:]):
            dev = (e0.elapsed_time(e1) * 1e-3
                   if e0 is not None and e1 is not None else None)
            out.append((name, t0, t1, dev, attrs))
        return out


class _NullPhases:
    """No phases: every mark is a no-op."""

    __slots__ = ()

    def mark(self, name, **attrs):
        pass

    def annotate(self, **attrs):
        pass

    def close(self):
        pass


NULL_PHASES = _NullPhases()


def build_trees(records: list) -> dict:
    """Assemble exported span records into ``{trace_id: [records]}`` and
    verify well-formedness; offline helper for tests and the obs-smoke
    checker.  Raises ValueError on a malformed forest (orphaned parent,
    unfinished span, child outside its parent's interval)."""
    by_id = {r["span"]: r for r in records}
    trees: dict = {}
    eps = 5e-4          # perf_counter jitter guard between threads
    for r in records:
        if r["t1"] is None:
            raise ValueError(f"unfinished span exported: {r}")
        if r["t1"] + eps < r["t0"]:
            raise ValueError(f"span ends before it starts: {r}")
        if r["parent"] is not None:
            parent = by_id.get(r["parent"])
            if parent is None:
                raise ValueError(f"orphaned span (parent evicted?): {r}")
            if parent["trace"] != r["trace"]:
                raise ValueError(f"span crosses traces: {r}")
            if (r["t0"] + eps < parent["t0"]
                    or r["t1"] > parent["t1"] + eps):
                raise ValueError(
                    f"child outside parent interval: {r} vs {parent}")
        trees.setdefault(r["trace"], []).append(r)
    return trees
