"""Config-declared SLO engine: multi-window burn-rate alerting over the
metrics registry's sliding windows.

The port's own copy of ``repro.obs.slo``.

The flight recorder (trace ring, histograms, auditors) answers "what
happened"; this module answers the operator's standing question — "are
we *currently* violating what we promised?" — for five promises the
config can declare (configs/knn_service.py ``slo_*`` knobs):

* ``latency_p99`` — per-request end-to-end latency bound (seconds),
* ``recall_min`` — shadow-audited minimum recall@l floor (approx tier),
* ``label_agreement`` — shadow-audited ensemble-vs-exact label
  agreement floor (ensemble prediction tier),
* ``staleness`` — answer generation lag behind the store head
  (generations; an epoch-swapped server normally serves lag 0/1),
* ``contract`` — Theorem-1 round/message envelope verdicts (any
  violation is bad).

Mechanics are the standard SRE multi-window burn rate: every
measurement becomes a good/bad event in a :class:`~repro_torch.obs.metrics.
Window` (``slo.events.<name>``), the bad fraction over a window divided
by the error ``budget`` is the burn rate, and an alert **fires** only
when both the fast and the slow window burn above ``threshold`` (fast
window for responsiveness, slow window so a single bad blip can't
page) with at least ``_MIN_EVENTS`` events each — and **clears** when
the fast window's burn drops back under threshold (or drains empty).
Alert transitions are emitted as spans into the existing trace ring —
``slo.fire`` / ``slo.clear`` as zero-length marks at the transition,
plus one ``slo.alert`` span covering the whole fired interval on clear
— so alert history rides the same flight recorder as everything else,
and as ``slo.alerts_fired`` / ``slo.alerts_cleared`` counters in the
registry.  ``snapshot()`` (surfaced via ``KnnServer.obs_snapshot()
["slo"]``) evaluates first, so a read is never stale.

Clocks: observations and evaluation share one monotonic timebase;
every entry point takes an explicit ``now``/``t`` so tests replay a
synthetic stream deterministically (tests/test_operator.py drives a
fake clock through fire and clear).  Stdlib-only, like the rest of the
obs plane's hot-path modules.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from repro_torch.obs.metrics import MetricsRegistry

_MIN_EVENTS = 4          # windows thinner than this can't page


class SloObjective:
    """One declared promise: ``value`` is bad when it crosses ``bound``
    in the ``kind`` direction ("upper": bad above; "lower": bad below).
    """

    __slots__ = ("name", "kind", "bound")

    def __init__(self, name: str, kind: str, bound: float):
        if kind not in ("upper", "lower"):
            raise ValueError(f"kind must be 'upper' or 'lower', "
                             f"got {kind!r}")
        self.name = name
        self.kind = kind
        self.bound = float(bound)

    def is_bad(self, value: float) -> bool:
        return (value > self.bound if self.kind == "upper"
                else value < self.bound)


class SloEngine:
    """Burn-rate evaluator over declared objectives; see module
    docstring.  Thread-safe: ``measure`` races from the micro-batcher
    and callers' flushes; the fire/clear state machine runs under one
    lock."""

    def __init__(self, registry: MetricsRegistry, tracer, objectives,
                 *, fast_window_s: float = 60.0,
                 slow_window_s: float = 300.0,
                 burn_threshold: float = 1.0,
                 budget: float = 0.01):
        if budget <= 0.0:
            raise ValueError(f"budget must be > 0, got {budget}")
        if not objectives:
            raise ValueError("an SloEngine needs at least one objective "
                             "(use from_config, which returns None when "
                             "nothing is declared)")
        self.registry = registry
        self.tracer = tracer
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.burn_threshold = float(burn_threshold)
        self.budget = float(budget)
        self._objectives = {o.name: o for o in objectives}
        retain = max(self.slow_window_s, self.fast_window_s) * 3.0
        self._windows = {}
        for name in self._objectives:
            w = registry.window(f"slo.events.{name}")
            w.max_age_s = max(w.max_age_s, retain)
            self._windows[name] = w
        self._fired: dict = {}            # name -> fired_at (monotonic)
        self._lock = threading.Lock()
        self._fired_total = registry.counter("slo.alerts_fired")
        self._cleared_total = registry.counter("slo.alerts_cleared")

    # ---- construction ----------------------------------------------------

    @classmethod
    def from_config(cls, cfg, registry: MetricsRegistry,
                    tracer) -> Optional["SloEngine"]:
        """The declared engine, or None when no ``slo_*`` knob enables
        an objective (the common case — SLOs are opt-in)."""
        objectives = []
        if getattr(cfg, "slo_latency_p99_s", 0.0) > 0.0:
            objectives.append(SloObjective(
                "latency_p99", "upper", cfg.slo_latency_p99_s))
        if getattr(cfg, "slo_recall_floor", 0.0) > 0.0:
            objectives.append(SloObjective(
                "recall_min", "lower", cfg.slo_recall_floor))
        if getattr(cfg, "slo_label_agreement_floor", 0.0) > 0.0:
            objectives.append(SloObjective(
                "label_agreement", "lower",
                cfg.slo_label_agreement_floor))
        if getattr(cfg, "slo_staleness_generations", 0) > 0:
            objectives.append(SloObjective(
                "staleness", "upper", cfg.slo_staleness_generations))
        if getattr(cfg, "slo_contract_violations", False):
            objectives.append(SloObjective("contract", "upper", 0.0))
        if not objectives:
            return None
        return cls(
            registry, tracer, objectives,
            fast_window_s=getattr(cfg, "slo_fast_window_s", 60.0),
            slow_window_s=getattr(cfg, "slo_slow_window_s", 300.0),
            burn_threshold=getattr(cfg, "slo_burn_threshold", 1.0),
            budget=getattr(cfg, "slo_budget", 0.01))

    # ---- producing -------------------------------------------------------

    def measure(self, name: str, value: float,
                now: Optional[float] = None) -> None:
        """Feed one measurement to objective ``name`` (unknown names are
        ignored — producers report what they have, the config decides
        what is promised)."""
        obj = self._objectives.get(name)
        if obj is None:
            return
        self._windows[name].observe(
            1.0 if obj.is_bad(float(value)) else 0.0, t=now)

    # ---- evaluating ------------------------------------------------------

    def _burn(self, win: dict) -> float:
        """Burn rate of one window aggregate: bad fraction over budget
        (0.0 for an empty window — no evidence is not a violation)."""
        if win["count"] == 0:
            return 0.0
        return (win["sum"] / win["count"]) / self.budget

    def evaluate(self, now: Optional[float] = None) -> list:
        """Run the fire/clear state machine once; returns the list of
        transition events this evaluation produced (empty when nothing
        changed)."""
        now = time.monotonic() if now is None else float(now)
        events = []
        with self._lock:
            for name, obj in sorted(self._objectives.items()):
                w = self._windows[name]
                fast = w.window(self.fast_window_s, now)
                slow = w.window(self.slow_window_s, now)
                burn_fast = self._burn(fast)
                burn_slow = self._burn(slow)
                fired_at = self._fired.get(name)
                breach = (fast["count"] >= _MIN_EVENTS
                          and slow["count"] >= _MIN_EVENTS
                          and burn_fast > self.burn_threshold
                          and burn_slow > self.burn_threshold)
                if fired_at is None and breach:
                    self._fired[name] = now
                    self._fired_total.inc()
                    self.tracer.record(
                        "slo.fire", now, now, objective=name,
                        bound=obj.bound, kind=obj.kind,
                        burn_fast=burn_fast, burn_slow=burn_slow,
                        fast_events=fast["count"],
                        slow_events=slow["count"])
                    events.append({"objective": name, "event": "fire",
                                   "burn_fast": burn_fast,
                                   "burn_slow": burn_slow, "at": now})
                elif fired_at is not None and (
                        fast["count"] == 0
                        or burn_fast <= self.burn_threshold):
                    del self._fired[name]
                    self._cleared_total.inc()
                    self.tracer.record(
                        "slo.clear", now, now, objective=name,
                        burn_fast=burn_fast,
                        fired_for_s=now - fired_at)
                    # the whole fired interval as one span, so trace
                    # tooling sees alert duration without event pairing
                    self.tracer.record(
                        "slo.alert", fired_at, now, objective=name,
                        bound=obj.bound, kind=obj.kind)
                    events.append({"objective": name, "event": "clear",
                                   "burn_fast": burn_fast, "at": now,
                                   "fired_for_s": now - fired_at})
        return events

    def snapshot(self, now: Optional[float] = None) -> dict:
        """Evaluate, then report per-objective state plus lifetime alert
        counters — the ``obs_snapshot()["slo"]`` payload."""
        now = time.monotonic() if now is None else float(now)
        self.evaluate(now)
        with self._lock:
            objectives = {}
            for name, obj in sorted(self._objectives.items()):
                w = self._windows[name]
                fast = w.window(self.fast_window_s, now)
                slow = w.window(self.slow_window_s, now)
                objectives[name] = {
                    "bound": obj.bound,
                    "kind": obj.kind,
                    "firing": name in self._fired,
                    "burn_fast": self._burn(fast),
                    "burn_slow": self._burn(slow),
                    "fast_events": fast["count"],
                    "slow_events": slow["count"],
                    "bad_fast": fast["sum"],
                    "bad_slow": slow["sum"],
                }
            return {
                "budget": self.budget,
                "burn_threshold": self.burn_threshold,
                "fast_window_s": self.fast_window_s,
                "slow_window_s": self.slow_window_s,
                "alerts_fired": self._fired_total.snapshot(),
                "alerts_cleared": self._cleared_total.snapshot(),
                "firing": sorted(self._fired),
                "objectives": objectives,
            }
