"""The port's observability stack: its own copy of the JAX package's
``obs/`` (registry and renderer, spans, trace contexts, the flight
recorder, stitching, SLO accounting, the TSDB, alerting, the sampling
profiler and incident bundles), exporting the same names.  The port
imports nothing of that package.
"""

from .alerts import (
    ALERT_TRANSITION_EVENT,
    SEVERITY_INFO,
    SEVERITY_PAGE,
    SEVERITY_TICKET,
    AlertCondition,
    AlertEvaluator,
    AlertRule,
    burn_rate,
    burn_rate_rules,
    load_alert_rules,
    parse_alert_rules,
    threshold_rule,
)
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
from .incident import (
    BUNDLE_PREFIX,
    BUNDLE_SCHEMA,
    INCIDENT_EVENT,
    TSDB_SNAPSHOT_SCHEMA,
    IncidentManager,
    read_bundle,
)
from .profiler import (
    PROFILE_SCHEMA,
    SamplingProfiler,
    fold_stack,
)
from .recorder import Event, FlightRecorder
from .slo import (
    SLOAccountant,
    SLOPolicy,
    default_slo_policies,
    parse_slo_specs,
)
from .span import Span, span
from .stitch import event_severity, flatten, render_tree, stitch
from .trace import (
    TraceContext,
    new_trace,
    parse_traceparent,
    trace_from_header,
)
from .tsdb import (
    TSDB,
    expr_metric_names,
    format_duration,
    parse_duration,
    parse_expr,
)

__all__ = [
    "ALERT_TRANSITION_EVENT",
    "BUNDLE_PREFIX",
    "BUNDLE_SCHEMA",
    "FAST_BUCKETS_S",
    "INCIDENT_EVENT",
    "LATENCY_BUCKETS_S",
    "OPENMETRICS_CONTENT_TYPE",
    "PROFILE_SCHEMA",
    "SEVERITY_INFO",
    "SEVERITY_PAGE",
    "SEVERITY_TICKET",
    "SLOW_BUCKETS_S",
    "TEXT_CONTENT_TYPE",
    "TSDB",
    "TSDB_SNAPSHOT_SCHEMA",
    "AlertCondition",
    "AlertEvaluator",
    "AlertRule",
    "Counter",
    "Event",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "IncidentManager",
    "ProcessCollector",
    "Registry",
    "SLOAccountant",
    "SLOPolicy",
    "SamplingProfiler",
    "ScrapeMeta",
    "Span",
    "TraceContext",
    "attach_process_collector",
    "burn_rate",
    "burn_rate_rules",
    "default_slo_policies",
    "escape_help",
    "escape_label_value",
    "event_severity",
    "expr_metric_names",
    "flatten",
    "fold_stack",
    "format_duration",
    "histogram_quantile",
    "load_alert_rules",
    "negotiate_openmetrics",
    "new_trace",
    "parse_alert_rules",
    "parse_duration",
    "parse_expr",
    "parse_exposition",
    "parse_slo_specs",
    "parse_traceparent",
    "read_bundle",
    "render_tree",
    "span",
    "stitch",
    "threshold_rule",
    "trace_from_header",
]
