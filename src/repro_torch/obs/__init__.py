"""Observability for the serving stack and the core: per-query span trees
and the active context the core's spans and counters record into
(``tracer``), a lock-protected metrics registry with streaming histograms
(``metrics``), and Prometheus/JSON/Chrome-trace exposition (``export``).
Dependency-free by design (stdlib only) — it imports nothing from the rest
of the package, so every layer can instrument itself without cycles. The
port's own copy of ``repro/obs``; naming and span taxonomy: DESIGN.md §12.
"""

from repro_torch.obs.metrics import (
    DEFAULT_TIME_BUCKETS,
    GLOBAL,
    Counter,
    Gauge,
    Histogram,
    HistogramSnapshot,
    MetricsRegistry,
    merged_snapshot,
    time_buckets,
)
from repro_torch.obs.tracer import Span, TraceContext, Tracer, active, count, span, tracing
from repro_torch.obs.export import (
    chrome_trace,
    write_chrome_trace,
    write_metrics_snapshot,
)

__all__ = [
    "DEFAULT_TIME_BUCKETS",
    "GLOBAL",
    "Counter",
    "Gauge",
    "Histogram",
    "HistogramSnapshot",
    "MetricsRegistry",
    "merged_snapshot",
    "time_buckets",
    "Span",
    "TraceContext",
    "Tracer",
    "active",
    "count",
    "span",
    "tracing",
    "chrome_trace",
    "write_chrome_trace",
    "write_metrics_snapshot",
]
