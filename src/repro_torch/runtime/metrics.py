"""Step telemetry: metric logging + straggler watchdog.

Port of ``repro.runtime.metrics``, over the port's own
``repro_torch.obs.metrics``.  Both are backed by the unified obs plane:
``MetricLogger`` can mirror every numeric it logs into a
``MetricsRegistry`` so training/bench telemetry shows up in the same
``snapshot()`` as the serving metrics, and ``StepWatchdog`` keeps its
running p50 in a streaming-quantile histogram — O(1) per observation
instead of the old full re-sort (O(n log n) per step, O(n) memory
traffic) that made a long-running watchdog quadratic overall.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Optional, TextIO

from repro_torch.obs.metrics import Histogram, MetricsRegistry


class MetricLogger:
    def __init__(self, stream: Optional[TextIO] = None, quiet: bool = False,
                 registry: Optional[MetricsRegistry] = None,
                 prefix: str = "train."):
        self.stream = stream or sys.stderr
        self.quiet = quiet
        self.history: list[dict] = []
        self.registry = registry
        self.prefix = prefix

    def log(self, step: int, **kwargs):
        rec = {"step": step, "t": time.time(), **kwargs}
        self.history.append(rec)
        if self.registry is not None:
            for k, v in kwargs.items():
                if isinstance(v, bool):
                    continue
                if isinstance(v, (int, float)):
                    self.registry.histogram(self.prefix + k).observe(v)
        if not self.quiet:
            self.stream.write(json.dumps(rec) + "\n")


class StepWatchdog:
    """Flags steps slower than `factor` x the running p50 once warmed up.

    At fleet scale this signal feeds the slow-host eviction controller; in
    this repo it is logged and asserted on by the straggler test.

    The running p50 comes from a streaming-quantile histogram, so each
    ``observe`` is O(1); the flagging semantics are unchanged — a step is
    compared against the median of all *prior* steps, and flagging only
    starts once ``warmup`` prior steps exist.  (Quantile reads clamp to
    the observed [min, max], so a warmup of identical durations yields
    the exact median — no approximation slack on the degenerate case the
    straggler test exercises.)
    """

    def __init__(self, factor: float = 3.0, warmup: int = 5,
                 registry: Optional[MetricsRegistry] = None,
                 name: str = "watchdog.step_s"):
        self.factor = factor
        self.warmup = warmup
        self.times: list[float] = []        # kept for inspection/back-compat
        self.flagged: list[int] = []
        self._hist = (registry.histogram(name) if registry is not None
                      else Histogram())
        if registry is not None:
            self._flagged_ctr = registry.counter(name + ".flagged")
        else:
            self._flagged_ctr = None

    def observe(self, dt: float) -> bool:
        prior = self._hist.count
        p50 = self._hist.quantile(0.5) if prior >= self.warmup else None
        self.times.append(dt)
        self._hist.observe(dt)
        if p50 is None:
            return False
        slow = dt > self.factor * p50
        if slow:
            self.flagged.append(len(self.times) - 1)
            if self._flagged_ctr is not None:
                self._flagged_ctr.inc()
        return slow
