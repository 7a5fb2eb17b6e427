"""Prometheus surface of the gpu-metrics-exporter daemon.

The port's counterpart of the JAX package's ``health/metrics.py``: a
``/metrics`` endpoint with per-GPU health gauges and error counters,
rendered through the port's :mod:`..obs` registry (each server owns its
own Registry), beside ``/healthz`` and the retention surface
(``/debug/query``, ``/alerts``, ``/debug/pprof``).  Families keep the
reference's names; those that named TPU chips name GPUs:

- ``tpu_device_health{gpu,device} 0|1`` -- the probe of the health RPC
- ``tpu_device_uncorrectable_errors_total{gpu}`` -- the PCI function's
  AER ``TOTAL_ERR_FATAL`` (present only where AER is exposed)
- ``tpu_exporter_gpus`` / ``tpu_exporter_unhealthy_gpus`` -- node rollups
- ``tpu_exporter_granular_health`` -- 1 when AER attributes are exposed
- ``tpu_exporter_nvml_available`` -- 1 when NVML answers
- ``tpu_exporter_scrapes_total``, ``tpu_exporter_probe_seconds``
"""

from __future__ import annotations

import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .. import obs
from ..gpu import discovery
from ..types import constants
from .server import (
    granular_health_available,
    probe_gpu_states,
    read_aer_fatal,
)

log = logging.getLogger(__name__)

def update_metrics(sysfs_root: str = "/sys", dev_root: str = "/dev",
                   proc_root: str = "/proc", nvml=None, scrapes: int = 0,
                   registry: Optional[obs.Registry] = None
                   ) -> obs.Registry:
    """One probe pass: walk every GPU and refresh the health instruments
    on *registry* (a fresh one when None).  Split from
    :func:`render_metrics` so the HTTP server can run it as a render-time
    collect hook: the TSDB's sampling tick then sees fresh probes."""
    reg = registry if registry is not None else obs.Registry()
    t0 = time.perf_counter()
    gpus, _ = discovery.get_gpus(sysfs_root, dev_root, proc_root, nvml)
    states = probe_gpu_states(sysfs_root, dev_root, proc_root, nvml=nvml,
                              gpus=gpus)
    probe_dt = time.perf_counter() - t0

    health = reg.gauge(
        "tpu_device_health", "Per-GPU health (1 healthy, 0 unhealthy).",
        ("gpu", "device"))
    ue = reg.counter(
        "tpu_device_uncorrectable_errors_total",
        "PCIe AER fatal (uncorrectable) error count.", ("gpu",))
    # per-GPU label sets rebuild from scratch: an unplugged GPU must not
    # leave a stale series in a long-lived registry
    health.clear()
    ue.clear()
    unhealthy = 0
    for gid in sorted(states):
        st = states[gid]
        up = 1 if st.health == constants.HEALTHY else 0
        unhealthy += 1 - up
        health.labels(gpu=gid, device=st.device).set(up)
        n = read_aer_fatal(gpus[gid].pci_path)
        if n is not None:
            ue.labels(gpu=gid)._set(n)
    reg.gauge(
        "tpu_exporter_granular_health",
        "GPUs expose aer_dev_fatal (0 = fatal-error detection degraded to "
        "device-node checks).",
    ).set(1 if gpus and granular_health_available(gpus) else 0)
    reg.gauge(
        "tpu_exporter_nvml_available",
        "NVML answers (0 = no remapped-row health, NVLink or MIG data).",
    ).set(1 if nvml is not None else 0)
    reg.gauge("tpu_exporter_gpus", "GPUs the exporter probes.").set(
        len(states))
    reg.gauge("tpu_exporter_unhealthy_gpus",
              "GPUs currently unhealthy.").set(unhealthy)
    reg.counter("tpu_exporter_scrapes_total", "Scrapes served.")._set(
        scrapes)
    reg.histogram(
        "tpu_exporter_probe_seconds",
        "One full probe walk (discovery + per-GPU state).",
        buckets=obs.FAST_BUCKETS_S).observe(probe_dt)
    return reg


def render_metrics(sysfs_root: str = "/sys", dev_root: str = "/dev",
                   proc_root: str = "/proc", nvml=None, scrapes: int = 0,
                   registry: Optional[obs.Registry] = None,
                   openmetrics: bool = False) -> str:
    """One scrape: probe every GPU and render the exposition text.
    *registry* keeps instruments alive across scrapes (the HTTP server
    passes its own); bare calls get a fresh one."""
    reg = update_metrics(sysfs_root, dev_root, proc_root, nvml=nvml,
                         scrapes=scrapes, registry=registry)
    return obs.ScrapeMeta(reg).render(openmetrics=openmetrics)


def default_exporter_alert_rules() -> "list[obs.AlertRule]":
    """The exporter's built-in rule: unhealthy GPUs are a ticket after a
    minute of dwell (one flapping probe must not page)."""
    return [obs.threshold_rule(
        "tpu_unhealthy_gpus", "tpu_exporter_unhealthy_gpus",
        ">", 0, for_s=60.0, severity="ticket",
        description="One or more GPUs on this node have probed "
                    "unhealthy for over a minute.")]


class MetricsHTTPServer:
    """``/metrics`` (Prometheus), ``/healthz`` and the retention surface
    (``/debug/query``, ``/alerts``) on a TCP port, probing the same
    injectable roots and NVML source as the gRPC service."""

    def __init__(self, port: int = constants.METRICS_HTTP_PORT,
                 sysfs_root: str = "/sys", dev_root: str = "/dev",
                 proc_root: str = "/proc", nvml=None,
                 host: str = "0.0.0.0",
                 alert_rules: Optional[list] = None,
                 tick_interval_s: float = 15.0,
                 profiler_hz: float = 19.0):
        self._port = port
        self._host = host
        self._roots = (sysfs_root, dev_root, proc_root)
        self._nvml = nvml
        self._scrapes = 0
        self._lock = threading.Lock()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._tick_interval_s = tick_interval_s
        # persistent across scrapes so the probe-duration histogram
        # accumulates a real distribution
        self.registry = obs.Registry()
        # probe refresh rides the registry's collect hook: every
        # render — an HTTP scrape OR a TSDB sampling tick — sees a
        # fresh probe walk, so retained series never go stale between
        # scrapes
        self.registry.on_collect(self._refresh)
        self.scrape_meta = obs.ScrapeMeta(self.registry)
        self.recorder = obs.FlightRecorder(registry=self.registry)
        self.tsdb = obs.TSDB(self.registry)
        rules = (list(alert_rules) if alert_rules is not None
                 else default_exporter_alert_rules())
        self.alerts = obs.AlertEvaluator(
            self.tsdb, rules, recorder=self.recorder)
        # continuous sampling profiler: the exporter is mostly idle, but
        # a probe walk wedged on sysfs shows up here
        self.profiler = obs.SamplingProfiler(
            self.registry, hz=profiler_hz)

    def _refresh(self) -> None:
        with self._lock:
            n = self._scrapes
        update_metrics(*self._roots, nvml=self._nvml, scrapes=n,
                       registry=self.registry)

    @property
    def port(self) -> int:
        return self._httpd.server_address[1] if self._httpd else self._port

    def start(self) -> "MetricsHTTPServer":
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                from urllib.parse import parse_qsl, urlsplit

                parts = urlsplit(self.path)
                if parts.path == "/healthz":
                    self._send(200, "text/plain", "ok\n")
                    return
                if parts.path == "/alerts":
                    self._send(200, "application/json",
                               outer.alerts.status_json() + "\n")
                    return
                if parts.path == "/debug/query":
                    params = dict(parse_qsl(parts.query))
                    try:
                        body = outer.tsdb.handle_query_json(params)
                    except ValueError as e:
                        self._send(400, "text/plain", f"{e}\n")
                        return
                    self._send(200, "application/json", body + "\n")
                    return
                if parts.path == "/debug/pprof":
                    from urllib.parse import parse_qs
                    try:
                        ctype, body = outer.profiler.handle_pprof(
                            parse_qs(parts.query))
                    except ValueError as e:
                        self._send(400, "text/plain", f"{e}\n")
                        return
                    self._send(200, ctype, body)
                    return
                if parts.path != "/metrics":
                    self._send(404, "text/plain", "not found\n")
                    return
                with outer._lock:
                    outer._scrapes += 1
                # OpenMetrics negotiation for parity with the other
                # surfaces (the exporter records no exemplars today,
                # but a scraper asking for the format must get a
                # format-valid body with the # EOF terminator)
                om = obs.negotiate_openmetrics(
                    self.headers.get("Accept"))
                try:
                    # probe refresh runs inside render via the
                    # registry collect hook; ScrapeMeta accounts the
                    # exposition itself (tpu_scrape_*)
                    body = outer.scrape_meta.render(openmetrics=om)
                except Exception:  # scrape must not kill the daemon
                    log.exception("metrics scrape failed")
                    self._send(500, "text/plain",
                               "scrape failed; see exporter logs\n")
                    return
                self._send(200,
                           obs.OPENMETRICS_CONTENT_TYPE if om
                           else obs.TEXT_CONTENT_TYPE,
                           body)

            def _send(self, code, ctype, body: str):
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, fmt, *args):
                log.debug("metrics-http: " + fmt, *args)

        self._httpd = ThreadingHTTPServer((self._host, self._port), Handler)
        threading.Thread(target=self._httpd.serve_forever,
                         name="metrics-http", daemon=True).start()
        self.tsdb.start(self._tick_interval_s)
        self.profiler.start()
        log.info("prometheus metrics on http://%s:%d/metrics",
                 self._host, self.port)
        return self

    def stop(self) -> None:
        self.tsdb.stop()
        self.profiler.stop()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
