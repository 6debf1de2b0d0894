"""Metrics registry: counters, gauges and streaming-quantile histograms.

The port's own copy of the subset of ``repro.obs.metrics`` that the
query server, the mutable store and the kernel dispatcher use.  Stdlib
only.

Histograms keep no samples: an observation lands in the geometric bucket
``floor(log(v) / log(GROWTH))``, so ``observe`` is O(1) and memory is
O(occupied buckets).  Quantiles are read by walking the sorted buckets
and returning the geometric midpoint of the one holding the target rank,
clamped to the observed [min, max]: within ~2.2% of the exact order
statistic with ``GROWTH = 2**(1/16)``.  Non-positive observations share
one underflow bucket represented by the observed minimum.
"""

from __future__ import annotations

import math
import threading
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
        self._underflow = 0

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.total += v
            self.min = min(self.min, v)
            self.max = max(self.max, v)
            if v > 0.0:
                idx = math.floor(math.log(v) / _LOG_G)
                self._buckets[idx] = self._buckets.get(idx, 0) + 1
            else:
                self._underflow += 1

    def quantile(self, q: float) -> float:
        """Approximate q-quantile (nearest rank); NaN when empty."""
        with self._lock:
            return self._quantile_locked(q)

    def _quantile_locked(self, q: float) -> float:
        if self.count == 0:
            return math.nan
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

    def snapshot(self) -> dict:
        with self._lock:
            if self.count == 0:
                return {"count": 0, "sum": 0.0, "mean": 0.0,
                        "min": 0.0, "max": 0.0,
                        "p50": math.nan, "p90": math.nan, "p99": math.nan}
            return {"count": self.count, "sum": self.total,
                    "mean": self.total / self.count,
                    "min": self.min, "max": self.max,
                    "p50": self._quantile_locked(0.50),
                    "p90": self._quantile_locked(0.90),
                    "p99": self._quantile_locked(0.99)}


class MetricsRegistry:
    """Create-or-get registry of named metrics (one name, one type)."""

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

    def value(self, name: str, default=0):
        """Counter or gauge value by name (default when absent)."""
        with self._lock:
            m = self._metrics.get(name)
        return default if m is None else m.snapshot()

    def snapshot(self, prefix: str = "") -> dict:
        with self._lock:
            items = [(n, m) for n, m in self._metrics.items()
                     if n.startswith(prefix)]
        return {n: m.snapshot() for n, m in sorted(items)}


# Process-wide registry for code with no handle to a server (the kernel
# dispatcher's per-path tallies); each server keeps its own registry.
_DEFAULT: Optional[MetricsRegistry] = None
_DEFAULT_LOCK = threading.Lock()


def default_registry() -> MetricsRegistry:
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = MetricsRegistry()
        return _DEFAULT
