"""The port's metrics core: its own copy of the JAX package's
``obs/core.py`` (registry, counters, gauges, histograms, the renderer
and the parse helpers).  The rest of the reference's ``obs/`` (alerts,
the flight recorder, the profiler, the TSDB) comes with the HTTP tier.
"""

from .core import (
    FAST_BUCKETS_S,
    LATENCY_BUCKETS_S,
    OPENMETRICS_CONTENT_TYPE,
    SLOW_BUCKETS_S,
    TEXT_CONTENT_TYPE,
    Counter,
    Gauge,
    Histogram,
    ProcessCollector,
    Registry,
    ScrapeMeta,
    attach_process_collector,
    escape_help,
    escape_label_value,
    histogram_quantile,
    negotiate_openmetrics,
    parse_exposition,
)

__all__ = [
    "FAST_BUCKETS_S",
    "LATENCY_BUCKETS_S",
    "OPENMETRICS_CONTENT_TYPE",
    "SLOW_BUCKETS_S",
    "TEXT_CONTENT_TYPE",
    "Counter",
    "Gauge",
    "Histogram",
    "ProcessCollector",
    "Registry",
    "ScrapeMeta",
    "attach_process_collector",
    "escape_help",
    "escape_label_value",
    "histogram_quantile",
    "negotiate_openmetrics",
    "parse_exposition",
]
