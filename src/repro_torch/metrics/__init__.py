"""repro_torch.metrics — live metrics plane derived from the trace stream
(counterpart of ``repro/metrics/``; the same ``repro_*`` series).

Counters/gauges/fixed-bucket histograms (:mod:`.registry`), a trace-event
sink that keeps them current (:mod:`.sink`), an adaptive sampling controller
that bounds self-measured tracing overhead (:mod:`.controller`) and a stdlib
HTTP scrape endpoint (:mod:`.http`).
"""
from repro_torch.metrics.controller import (
    DEFAULT_BUDGET_PCT,
    AdaptiveController,
    DeviceCaptureBudget,
    calibrate_noop,
)
from repro_torch.metrics.http import MetricsHTTPServer, serve_metrics
from repro_torch.metrics.registry import (
    DEFAULT_BUCKETS_MS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from repro_torch.metrics.sink import TIMED_UNITS, MetricsPlane, MetricsSink

__all__ = [
    "DEFAULT_BUCKETS_MS",
    "DEFAULT_BUDGET_PCT",
    "TIMED_UNITS",
    "AdaptiveController",
    "DeviceCaptureBudget",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsHTTPServer",
    "MetricsPlane",
    "MetricsRegistry",
    "MetricsSink",
    "calibrate_noop",
    "serve_metrics",
]
