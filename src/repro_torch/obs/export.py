"""Standard exporters for the metrics registry: Prometheus text
exposition, OTLP-ish JSON, and a tiny stdlib HTTP endpoint.

The port's own copy of ``repro.obs.export``: the same names, text and
JSON, so a scraper reads either package's endpoint alike.

Naming is stable and mechanical: registry name ``serve.latency_s``
becomes ``knn_serve_latency_s`` (``knn_`` prefix, dots → underscores),
counters get the conventional ``_total`` suffix.  The repo's geometric
histograms (obs/metrics.py) export losslessly: each occupied bucket's
exclusive upper edge becomes a cumulative ``le`` bound, the underflow
(observations <= 0) folds into every cumulative count (it sorts below
every positive edge), and ``+Inf`` equals the observation count — so
:func:`parse_prometheus_text` can re-derive count/sum per metric and
verify bucket monotonicity, which is exactly what the golden-format
round-trip test and the obs-smoke gate do.  Sliding windows
(obs/slo.py's event streams) are point-in-time constructs, not
cumulative series, so the exporters skip them.

The OTLP-ish JSON mirrors the opentelemetry metrics data model
(resourceMetrics → scopeMetrics → metrics with sum/gauge/histogram
data points, cumulative temporality, non-cumulative bucketCounts with
``len(explicitBounds) + 1`` entries) closely enough for a collector to
ingest, without pretending to be a pinned proto rev.

:class:`ObsHttpServer` serves ``/metrics`` (Prometheus text),
``/metrics.json`` (OTLP-ish), and ``/obs`` (a full snapshot callback —
the server wires ``obs_snapshot`` in) on ``cfg.obs_http_port`` via a
daemonized stdlib ``ThreadingHTTPServer``; port 0 binds ephemerally
(tests) and the knob's default 0 means "don't serve".
"""

from __future__ import annotations

import json
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry

PREFIX = "knn_"


def metric_name(name: str) -> str:
    """Registry name -> exposition name (stable, mechanical)."""
    return PREFIX + name.replace(".", "_").replace("-", "_")


def _fmt(v: float) -> str:
    """Prometheus float formatting that round-trips through float()."""
    if v != v:
        return "NaN"
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    return repr(float(v))


# ---- Prometheus text exposition ------------------------------------------


def prometheus_text(registry: MetricsRegistry) -> str:
    """The registry as Prometheus text exposition format v0.0.4."""
    lines = []
    for name, metric in registry.items():
        pname = metric_name(name)
        if isinstance(metric, Counter):
            lines.append(f"# TYPE {pname}_total counter")
            lines.append(f"{pname}_total {metric.snapshot()}")
        elif isinstance(metric, Gauge):
            lines.append(f"# TYPE {pname} gauge")
            lines.append(f"{pname} {_fmt(metric.snapshot())}")
        elif isinstance(metric, Histogram):
            edges, underflow = metric.bucket_counts()
            with metric._lock:
                count, total = metric.count, metric.total
            lines.append(f"# TYPE {pname} histogram")
            cum = underflow
            for edge, c in edges:
                cum += c
                lines.append(
                    f'{pname}_bucket{{le="{_fmt(edge)}"}} {cum}')
            lines.append(f'{pname}_bucket{{le="+Inf"}} {count}')
            lines.append(f"{pname}_sum {_fmt(total)}")
            lines.append(f"{pname}_count {count}")
        # Window: sliding event stream, not a cumulative series — skip.
    return "\n".join(lines) + "\n"


def parse_prometheus_text(text: str) -> dict:
    """Parse an exposition back into ``{name: payload}`` and *validate*
    it: known TYPE per sample, cumulative ``le`` buckets monotone
    non-decreasing in both bound and count, ``+Inf`` bucket equal to
    ``_count``.  Raises ValueError on any malformation — this is the
    round-trip gate, not a lenient scraper."""
    types: dict = {}
    out: dict = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
            continue
        name_part, _, value_part = line.rpartition(" ")
        if not name_part:
            raise ValueError(f"line {lineno}: no sample value: {line!r}")
        value = float(value_part)
        if "{" in name_part:
            base, _, label = name_part.partition("{")
            label = label.rstrip("}")
            if not base.endswith("_bucket") or not label.startswith('le="'):
                raise ValueError(f"line {lineno}: unsupported labeled "
                                 f"sample: {line!r}")
            hist = base[:-len("_bucket")]
            le = label[len('le="'):].rstrip('"')
            bound = math.inf if le == "+Inf" else float(le)
            out.setdefault(hist, {"type": "histogram", "buckets": []})
            out[hist]["buckets"].append((bound, value))
        elif name_part.endswith("_sum") and name_part[:-4] in out:
            out[name_part[:-4]]["sum"] = value
        elif name_part.endswith("_count") and name_part[:-6] in out:
            out[name_part[:-6]]["count"] = value
        else:
            t = types.get(name_part) or (
                "counter" if name_part.endswith("_total") else None)
            if t is None:
                raise ValueError(f"line {lineno}: sample {name_part!r} "
                                 f"has no TYPE declaration")
            out[name_part] = {"type": t, "value": value}
    for name, payload in out.items():
        if payload.get("type") != "histogram":
            continue
        if "count" not in payload or "sum" not in payload:
            raise ValueError(f"histogram {name!r} missing _sum/_count")
        buckets = payload["buckets"]
        if not buckets:
            raise ValueError(f"histogram {name!r} has no buckets")
        prev_bound, prev_cum = -math.inf, -math.inf
        for bound, cum in buckets:
            if bound <= prev_bound:
                raise ValueError(
                    f"histogram {name!r}: bounds not increasing at "
                    f"le={bound}")
            if cum < prev_cum:
                raise ValueError(
                    f"histogram {name!r}: cumulative count decreases at "
                    f"le={bound}")
            prev_bound, prev_cum = bound, cum
        if buckets[-1][0] != math.inf:
            raise ValueError(f"histogram {name!r}: missing +Inf bucket")
        if buckets[-1][1] != payload["count"]:
            raise ValueError(
                f"histogram {name!r}: +Inf bucket {buckets[-1][1]} != "
                f"count {payload['count']}")
    return out


# ---- OTLP-ish JSON -------------------------------------------------------


def otlp_json(registry: MetricsRegistry,
              service_name: str = "repro-knn") -> dict:
    """The registry in the opentelemetry metrics JSON shape (see module
    docstring for the fidelity disclaimer)."""
    metrics = []
    for name, metric in registry.items():
        pname = metric_name(name)
        if isinstance(metric, Counter):
            metrics.append({
                "name": pname + "_total",
                "sum": {"dataPoints": [{"asInt": int(metric.snapshot())}],
                        "isMonotonic": True,
                        "aggregationTemporality": 2}})
        elif isinstance(metric, Gauge):
            metrics.append({
                "name": pname,
                "gauge": {"dataPoints": [
                    {"asDouble": float(metric.snapshot())}]}})
        elif isinstance(metric, Histogram):
            edges, underflow = metric.bucket_counts()
            with metric._lock:
                count, total = metric.count, metric.total
            # bounds[0] = 0.0 so the first bucketCounts entry is exactly
            # the underflow (observations <= 0); every occupied
            # geometric bucket contributes (bounds[i-1], bounds[i]]
            # non-cumulatively; the final entry is the (empty) overflow.
            bounds = [0.0] + [e for e, _ in edges]
            bucket_counts = [underflow] + [c for _, c in edges] + [0]
            metrics.append({
                "name": pname,
                "histogram": {
                    "dataPoints": [{
                        "count": count,
                        "sum": total,
                        "explicitBounds": bounds,
                        "bucketCounts": bucket_counts}],
                    "aggregationTemporality": 2}})
    return {"resourceMetrics": [{
        "resource": {"attributes": [
            {"key": "service.name",
             "value": {"stringValue": service_name}}]},
        "scopeMetrics": [{
            "scope": {"name": "repro.obs", "version": "1"},
            "metrics": metrics}]}]}


# ---- HTTP endpoint -------------------------------------------------------


class ObsHttpServer:
    """Stdlib HTTP exposition endpoint; see module docstring.  Construct
    with ``port=0`` for an ephemeral port (``.port`` reports the bound
    one); ``close()`` is idempotent and joins the serving thread."""

    def __init__(self, registry: MetricsRegistry, *, port: int = 0,
                 host: str = "127.0.0.1",
                 snapshot_fn: Optional[Callable[[], dict]] = None):
        self.registry = registry
        self._snapshot_fn = snapshot_fn

        outer = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                try:
                    if self.path == "/metrics":
                        body = prometheus_text(outer.registry).encode()
                        ctype = "text/plain; version=0.0.4"
                    elif self.path == "/metrics.json":
                        body = json.dumps(
                            otlp_json(outer.registry)).encode()
                        ctype = "application/json"
                    elif self.path == "/obs":
                        snap = (outer._snapshot_fn()
                                if outer._snapshot_fn is not None
                                else outer.registry.snapshot())
                        body = json.dumps(snap, default=str).encode()
                        ctype = "application/json"
                    else:
                        self.send_error(404)
                        return
                except Exception as exc:    # surface, don't kill the thread
                    self.send_error(500, str(exc))
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):   # stay silent in tests/benches
                pass

        self._httpd = ThreadingHTTPServer((host, int(port)), _Handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="obs-http", daemon=True)
        self._thread.start()
        self._closed = False

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "ObsHttpServer":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
