"""Counterpart of ``incubator_predictionio_tpu/obs``, cut to what is ported:
the metrics registry (:mod:`.metrics`) the breakers, the admission
controller, the drain state and the query server write to. The ``/metrics``
route, request traces, the span spool, the profiler, the SLO engine and
the metrics history come with the telemetry half of the tooling slice
(ROADMAP.md item 6).
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

__all__ = [
    "DEFAULT_LATENCY_BUCKETS", "LatencyReservoir",
    "MetricError", "MetricsRegistry", "REGISTRY",
    "bucket_quantiles", "nearest_rank_percentiles", "parse_prometheus_text",
    "timed",
]
