"""Unified metrics registry: counters, gauges, streaming-quantile
histograms and sliding time windows.

The port's own copy of ``repro.obs.metrics``.  Stdlib only: the kernel
dispatcher, the store and the serving path import it.  ``snapshot()``
returns one consistent dict and ``export_jsonl()`` dumps it one metric
a line.

Histogram design — **no per-observe sort**.  Observations land in
geometric buckets ``index = floor(log(v) / log(GROWTH))`` kept in a
dict, so ``observe`` is O(1) (one ``math.log``, one dict add) and memory
is O(distinct buckets), never O(observations).  Quantiles are computed
*at read time* by walking the sorted bucket keys (O(B log B) for B
occupied buckets — B is tens, reads are rare) and returning the
geometric midpoint of the bucket holding the target rank, clamped to
the observed [min, max].  With ``GROWTH = 2**(1/16)`` a bucket spans
~4.4%, so any quantile is within ~2.2% relative error of the exact
order statistic (tests/test_obs.py checks against a sorted oracle).

Non-positive observations (all repo metrics are durations, counts, or
sizes, so these are exceptional) share one underflow bucket whose
representative value is the observed minimum.
"""

from __future__ import annotations

import json
import math
import threading
import time
from collections import deque
from typing import Optional

GROWTH = 2.0 ** (1.0 / 16.0)
_LOG_G = math.log(GROWTH)
_SQRT_G = GROWTH ** 0.5


class Counter:
    __slots__ = ("_lock", "value")

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n

    def snapshot(self):
        return self.value


class Gauge:
    __slots__ = ("_lock", "value")

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self.value = v

    def snapshot(self):
        return self.value


class Histogram:
    """Streaming-quantile histogram; see module docstring."""

    __slots__ = ("_lock", "count", "total", "min", "max", "_buckets",
                 "_underflow")

    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._buckets: dict = {}
        self._underflow = 0       # observations <= 0

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.total += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v
            if v > 0.0:
                idx = math.floor(math.log(v) / _LOG_G)
                self._buckets[idx] = self._buckets.get(idx, 0) + 1
            else:
                self._underflow += 1

    def quantile(self, q: float) -> float:
        """Approximate q-quantile (0 <= q <= 1) of everything observed,
        within one bucket width (~2.2% relative) of the exact order
        statistic.  An empty histogram returns NaN *explicitly* — not
        the ``min``/``max`` seeds (+inf/-inf), which must never leak to
        a reader (tests/test_obs.py pins this and the q=0.0/q=1.0
        nearest-rank edges against a sorted oracle)."""
        with self._lock:
            return self._quantile_locked(q)

    def _quantile_locked(self, q: float) -> float:
        if self.count == 0:
            return math.nan
        # rank of the order statistic we report (1-based, ceil like the
        # "nearest-rank" definition; q=0 -> min, q=1 -> max)
        rank = min(max(int(math.ceil(q * self.count)), 1), self.count)
        if rank <= self._underflow:
            return self.min
        rank -= self._underflow
        for idx in sorted(self._buckets):
            rank -= self._buckets[idx]
            if rank <= 0:
                mid = math.exp(idx * _LOG_G) * _SQRT_G
                return min(max(mid, self.min), self.max)
        return self.max

    def bucket_counts(self) -> tuple:
        """``([(upper_edge, count), ...] ascending, underflow)`` — the raw
        geometric bucket layout for the exposition exporters
        (obs/export.py turns these into cumulative ``le`` buckets).
        ``upper_edge`` is the bucket's exclusive-ish upper boundary
        ``GROWTH**(idx+1)``; the underflow count holds observations
        <= 0, which sort below every positive edge."""
        with self._lock:
            edges = [(math.exp((idx + 1) * _LOG_G), c)
                     for idx, c in sorted(self._buckets.items())]
            return edges, self._underflow

    def snapshot(self) -> dict:
        with self._lock:
            if self.count == 0:
                # Full-key payload even when empty: readers (bench
                # reports, check_obs gates) index ["p99"]/["mean"]
                # unconditionally, and the internal min/max seeds
                # (+inf/-inf) must not escape as observed values.
                return {"count": 0, "sum": 0.0, "mean": 0.0,
                        "min": 0.0, "max": 0.0,
                        "p50": math.nan, "p90": math.nan,
                        "p99": math.nan}
            return {
                "count": self.count,
                "sum": self.total,
                "mean": self.total / self.count,
                "min": self.min,
                "max": self.max,
                "p50": self._quantile_locked(0.50),
                "p90": self._quantile_locked(0.90),
                "p99": self._quantile_locked(0.99),
            }


class Window:
    """Sliding *time*-window series — the registry's fourth metric type,
    added for the SLO engine (obs/slo.py).

    A histogram aggregates forever; an SLO burn rate is a statement about
    the last N seconds.  A Window keeps raw ``(t, v)`` observations in a
    bounded deque (age- and length-trimmed on every write, so memory is
    O(max_len) regardless of traffic) and answers *windowed* reads:
    count/sum/min/max/quantile over exactly the observations younger than
    ``window_s``.  Reads sort the windowed slice at call time — windows
    are bounded and reads happen once per SLO evaluation, not per
    request, so O(w log w) at read beats any per-observe bookkeeping.

    Timestamps are ``time.monotonic()`` floats; pass ``t=``/``now=``
    explicitly to replay a synthetic stream in tests (the SLO burn-rate
    units drive a fake clock through here).
    """

    __slots__ = ("_lock", "_events", "max_age_s", "max_len", "count",
                 "total")

    def __init__(self, max_age_s: float = 900.0, max_len: int = 32768):
        self._lock = threading.Lock()
        self._events: deque = deque()       # (t, v), ascending t
        self.max_age_s = float(max_age_s)
        self.max_len = int(max_len)
        self.count = 0                      # lifetime observations
        self.total = 0.0

    def observe(self, v: float, t: Optional[float] = None) -> None:
        t = time.monotonic() if t is None else float(t)
        v = float(v)
        with self._lock:
            self.count += 1
            self.total += v
            self._events.append((t, v))
            self._trim_locked(t)

    def _trim_locked(self, now: float) -> None:
        horizon = now - self.max_age_s
        ev = self._events
        while ev and (ev[0][0] < horizon or len(ev) > self.max_len):
            ev.popleft()

    def _window_values(self, window_s: float, now: Optional[float]):
        now = time.monotonic() if now is None else float(now)
        horizon = now - float(window_s)
        with self._lock:
            return [v for (t, v) in self._events if t >= horizon]

    def window(self, window_s: float, now: Optional[float] = None) -> dict:
        """Aggregates over observations younger than ``window_s``; the
        empty window returns count 0 and NaN extremes (never ±inf)."""
        vals = self._window_values(window_s, now)
        if not vals:
            return {"count": 0, "sum": 0.0, "mean": math.nan,
                    "min": math.nan, "max": math.nan}
        return {"count": len(vals), "sum": float(sum(vals)),
                "mean": float(sum(vals)) / len(vals),
                "min": min(vals), "max": max(vals)}

    def quantile(self, q: float, window_s: float,
                 now: Optional[float] = None) -> float:
        """Exact nearest-rank q-quantile of the windowed observations
        (sorted at read time; NaN when the window is empty)."""
        vals = sorted(self._window_values(window_s, now))
        if not vals:
            return math.nan
        rank = min(max(int(math.ceil(q * len(vals))), 1), len(vals))
        return vals[rank - 1]

    def snapshot(self) -> dict:
        with self._lock:
            return {"count": self.count, "sum": self.total,
                    "retained": len(self._events),
                    "max_age_s": self.max_age_s}


class MetricsRegistry:
    """Create-or-get registry of named metrics.

    Names are dotted paths (``serve.latency_s``, ``maint.commit_s``,
    ``kernel.fallback.vmem``); the registry is flat — grouping is a
    reader-side convention.  Asking for an existing name with a
    different type raises (one name, one meaning).  ``snapshot()`` is
    one lock pass over the name table plus per-metric atomic snapshots,
    so the returned dict never tears against concurrent writers.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict = {}

    def _get(self, name: str, cls):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls()
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, asked for {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def window(self, name: str) -> Window:
        return self._get(name, Window)

    def items(self) -> list:
        """Sorted ``(name, metric object)`` pairs — the exporter surface
        (obs/export.py needs the live objects for histogram bucket
        layout, not just ``snapshot()``'s quantile digest)."""
        with self._lock:
            return sorted(self._metrics.items())

    def get(self, name: str):
        """The metric object, or None (read-only peek; no create)."""
        with self._lock:
            return self._metrics.get(name)

    def value(self, name: str, default=0):
        """Counter/gauge value by name (default when absent)."""
        m = self.get(name)
        return default if m is None else m.snapshot()

    def snapshot(self, prefix: str = "") -> dict:
        with self._lock:
            items = [(n, m) for n, m in self._metrics.items()
                     if n.startswith(prefix)]
        return {n: m.snapshot() for n, m in sorted(items)}

    def export_jsonl(self, path_or_file, prefix: str = "") -> int:
        """One ``{"metric": name, ...payload}`` object per line."""
        snap = self.snapshot(prefix)
        lines = []
        for name, payload in snap.items():
            rec = {"metric": name}
            if isinstance(payload, dict):
                rec.update(payload)
            else:
                rec["value"] = payload
            lines.append(json.dumps(rec) + "\n")
        if hasattr(path_or_file, "write"):
            path_or_file.writelines(lines)
        else:
            with open(path_or_file, "w") as f:
                f.writelines(lines)
        return len(lines)

