"""Health subsystem: the exporter's probe server and Prometheus surface,
and the plugin's client (the port's counterpart of the JAX package's
``health/``)."""

from .client import get_gpu_health
from .metrics import MetricsHTTPServer, render_metrics
from .server import GpuHealthServer, probe_gpu_states

__all__ = [
    "GpuHealthServer",
    "MetricsHTTPServer",
    "get_gpu_health",
    "probe_gpu_states",
    "render_metrics",
]
