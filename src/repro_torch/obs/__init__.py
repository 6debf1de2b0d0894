"""Flight-recorder observability plane: tracing, metrics, auditors and the
operator layer (explain reports, SLOs, exporters).

The port's own copy of ``repro.obs``.  One :class:`ObsPlane` per server
bundles what the serving stack threads through itself:

* ``plane.tracer`` — a :class:`~repro_torch.obs.trace.Tracer` ring
  buffer, or the shared :data:`~repro_torch.obs.trace.NULL_TRACER` when
  tracing is off (no lock, no allocation).
* ``plane.metrics`` — a private :class:`~repro_torch.obs.metrics.
  MetricsRegistry`, so two servers in one process never mix tallies.

A store-backed server hands its plane to the store
(``MutableStore.attach_obs``), so applies and maintenance cycles land in
the same trace and registry as the queries racing them.  ``from_config``
maps the ``obs_trace`` / ``obs_trace_capacity`` knobs; the registry is
always live.
"""

from __future__ import annotations

from repro_torch.obs.audit import ContractAuditor, ShadowAuditor
from repro_torch.obs.explain import BatchCapture, ExplainRecord
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, Window)
from repro_torch.obs.slo import SloEngine, SloObjective
from repro_torch.obs.trace import (NULL_PHASES, NULL_TRACER, NullTracer,
                                   PhaseClock, Span, Tracer, build_trees)

__all__ = [
    "ObsPlane", "Tracer", "NullTracer", "NULL_TRACER", "Span",
    "PhaseClock", "NULL_PHASES", "build_trees", "Counter", "Gauge",
    "Histogram", "Window", "MetricsRegistry", "ContractAuditor",
    "ShadowAuditor", "BatchCapture", "ExplainRecord", "SloEngine",
    "SloObjective",
]


class ObsPlane:
    """Tracer + metrics registry for one serving stack."""

    def __init__(self, *, trace: bool = False, trace_capacity: int = 8192,
                 registry: MetricsRegistry | None = None):
        self.tracer = Tracer(trace_capacity) if trace else NULL_TRACER
        self.metrics = registry if registry is not None else MetricsRegistry()

    @classmethod
    def from_config(cls, cfg) -> "ObsPlane":
        return cls(trace=getattr(cfg, "obs_trace", False),
                   trace_capacity=getattr(cfg, "obs_trace_capacity", 8192))

    def snapshot(self) -> dict:
        return {"trace": self.tracer.stats(),
                "metrics": self.metrics.snapshot()}

    def export_trace_jsonl(self, path_or_file) -> int:
        return self.tracer.export_jsonl(path_or_file)
