"""Unified telemetry layer: metrics registry, Prometheus exposition, and
end-to-end request tracing.

Counterpart of ``incubator_predictionio_tpu/obs``:

- :mod:`.metrics` — process-wide counters/gauges/histograms + ``/metrics``
  text exposition (:data:`~.metrics.REGISTRY`);
- :mod:`.trace` — contextvar trace/span IDs, the recent-trace ring buffer,
  ``X-PIO-Trace`` propagation;
- :mod:`.profile` — phase timers fenced on the card's streams, the
  wall-stack sampler, the MFU gauge and device-memory watermarks;
- :mod:`.http` — the aiohttp telemetry middleware and shared
  ``/metrics``, ``/traces.json`` and ``/profile.json`` routes (imported by
  servers; kept out of this namespace so non-server processes never pay
  the aiohttp import).

The span spool, cross-process trace assembly, the metrics history and the
SLO engine are the next part of ROADMAP.md item 6.
"""

from incubator_predictionio_tpu_torch.obs.metrics import (  # noqa: F401
    DEFAULT_LATENCY_BUCKETS,
    LatencyReservoir,
    MetricError,
    MetricsRegistry,
    REGISTRY,
    bucket_quantiles,
    nearest_rank_percentiles,
    parse_prometheus_text,
    timed,
)
from incubator_predictionio_tpu_torch.obs.trace import (  # noqa: F401
    TRACE_HEADER,
    TRACES,
    SpanContext,
    TraceBuffer,
    current_trace_id,
    span,
    trace_scope,
)

__all__ = [
    "DEFAULT_LATENCY_BUCKETS", "LatencyReservoir",
    "MetricError", "MetricsRegistry", "REGISTRY",
    "bucket_quantiles", "nearest_rank_percentiles", "parse_prometheus_text",
    "timed",
    "TRACE_HEADER", "TRACES", "SpanContext", "TraceBuffer",
    "current_trace_id", "span", "trace_scope",
]
