"""Opt-in debug and observability HTTP endpoint of the device plugin.

The port's copy of the JAX package's ``observability.py``: a flag-gated
loopback HTTP server with

  GET /healthz        liveness (200 "ok")
  GET /debug/status   JSON: served resources, per-device health, RPC
                      counters, the GPU topology summary
  GET /debug/threads  all-thread stack dump
  GET /debug/traces   flight-recorder timelines (?trace_id=... for one)
  GET /debug/events   the raw event journal (?since=<unix seconds>)
  GET /debug/query    the in-process TSDB; GET /alerts its alert states
  GET /debug/pprof    the continuous sampling profiler
  GET /metrics        the registry in Prometheus exposition format (the
                      OpenMetrics Accept type adds trace-id exemplars)

Disabled unless --debug-port is set; binds loopback by default (it
exposes internal state and has no auth).
"""

from __future__ import annotations

import json
import logging
import sys
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, TYPE_CHECKING
from urllib.parse import parse_qs, urlparse

from . import __version__, obs
from .resilience import suppressed

if TYPE_CHECKING:
    from .manager import PluginManager

log = logging.getLogger(__name__)


def thread_dump() -> str:
    """Stack traces of every live thread (a goroutine-dump analog)."""
    frames = sys._current_frames()
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for ident, frame in frames.items():
        out.append(f"--- thread {names.get(ident, '?')} ({ident}) ---")
        out.extend(line.rstrip() for line in traceback.format_stack(frame))
    return "\n".join(out) + "\n"


def manager_status(manager: "PluginManager") -> dict:
    """Snapshot of what the manager is serving, for /debug/status.  All
    plugin/lock discipline lives behind PluginManager.status_snapshot()."""
    status: dict = {
        "version": __version__,
        "pulse_seconds": manager.pulse,
        "kubelet_dir": manager.kubelet_dir,
        "resources": manager.status_snapshot(),
    }
    # impl-level counters are node-wide, not per-resource (e.g. how many
    # Allocates spanned NVLink cliques on a fragmented node)
    impl_counters = getattr(manager.impl, "counters", None)
    if callable(impl_counters):
        status["impl_counters"] = impl_counters()
    topo = getattr(manager.impl, "topology", None)
    if topo is not None:
        status["topology"] = {
            "product": topo.spec.product if topo.spec else "",
            "gpus": len(topo.numa),
            "nvlink_topology": topo.topology_str,
            "cliques": [list(c) for c in topo.cliques],
        }
    client = getattr(manager, "slice_client", None)
    if client is not None:
        m = client.membership
        overlay = client.health_overlay()
        status["slice"] = {
            "formed": m is not None,
            "slice_id": m.slice_id if m else "",
            "rank": client.rank,
            "hostnames": list(m.hostnames) if m else [],
            "coordinator_address": m.coordinator_address if m else "",
            "generation": m.generation if m else 0,
            "degraded": m.degraded if m else False,
            "reshaped_from": list(m.reshaped_from) if m else [],
            # null until the first heartbeat verdict arrives
            "healthy": None if overlay is None else overlay[0],
            "unhealthy_hostnames": [] if overlay is None else overlay[1],
        }
    return status


def update_plugin_metrics(manager: "PluginManager",
                          registry: "obs.Registry") -> None:
    """Refresh the snapshot-style plugin families (kubelet RPC
    counters, device health rollups, impl counters) from the manager's
    status.  The persistent instruments — Allocate latency, frame
    build, pulse round — live on the same registry and
    need no refreshing; this only bridges the state that predates it.

    Impl counters gain the ``_total`` suffix the exposition format
    requires of counters (``tpu_plugin_cross_clique_allocations_total``)."""
    status = manager_status(manager)
    rpc = registry.counter(
        "tpu_plugin_rpc_total", "Kubelet device-plugin RPCs served.",
        ("resource", "rpc"))
    healthy = registry.gauge(
        "tpu_plugin_devices_healthy", "Devices advertised Healthy.",
        ("resource",))
    unhealthy = registry.gauge(
        "tpu_plugin_devices_unhealthy", "Devices advertised Unhealthy.",
        ("resource",))
    for fam in (rpc, healthy, unhealthy):
        fam.clear()  # a dropped resource must not leave stale series
    for resource, st in sorted(status["resources"].items()):
        if "error" in st:
            continue
        for rpc_name, n in sorted(st.get("rpc_counts", {}).items()):
            rpc.labels(resource=resource, rpc=rpc_name)._set(n)
        healthy.labels(resource=resource).set(st.get("healthy", 0))
        unhealthy.labels(resource=resource).set(st.get("unhealthy", 0))
    for name, value in status.get("impl_counters", {}).items():
        cname = f"tpu_plugin_{name}"
        if not cname.endswith("_total"):
            cname += "_total"
        registry.counter(
            cname, f"Device-impl counter {name} (node-wide).")._set(value)


def render_plugin_metrics(manager: "PluginManager",
                          openmetrics: bool = False) -> str:
    """The plugin debug /metrics body: the manager's obs.Registry
    (Allocate/frame/pulse histograms) plus the bridged
    status snapshot, through the one shared renderer.  *openmetrics*
    adds trace-id exemplars + ``# EOF`` (serve only under the
    OpenMetrics content type)."""
    registry = getattr(manager, "registry", None)
    if registry is None:  # bare managers in tests / external embedders
        registry = obs.Registry()
    update_plugin_metrics(manager, registry)
    return registry.render(openmetrics=openmetrics)


class DebugServer:
    """Loopback HTTP server for the debug surface."""

    def __init__(self, manager: "PluginManager", port: int,
                 host: str = "127.0.0.1",
                 alert_rules: Optional[list] = None,
                 tick_interval_s: float = 15.0,
                 incident_dir: Optional[str] = None,
                 profiler_hz: float = 19.0):
        self._manager = manager
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._host = host
        self._port = port
        self._tick_interval_s = tick_interval_s
        # the manager's registry when it has one (shared with the
        # Allocate/pulse instruments), a private one otherwise: the
        # retention layer needs a stable registry either way
        registry = getattr(manager, "registry", None)
        self.registry: obs.Registry = (
            registry if registry is not None else obs.Registry())
        # bridged snapshot families refresh at render time, so the
        # TSDB's sampling tick sees fresh RPC counts — same collect
        # hook discipline as the health exporter
        self.registry.on_collect(self._refresh)
        self.scrape_meta = obs.ScrapeMeta(self.registry)
        self.tsdb = obs.TSDB(self.registry)
        self.alerts = obs.AlertEvaluator(
            self.tsdb, list(alert_rules or ()),
            recorder=getattr(manager, "recorder", None))
        # continuous sampling profiler + alert-triggered incident
        # bundles: the plugin's flight data recorder
        self.profiler = obs.SamplingProfiler(
            self.registry, hz=profiler_hz)
        self._incidents: Optional[obs.IncidentManager] = None
        if incident_dir:
            self._incidents = obs.IncidentManager(
                incident_dir, self.alerts,
                registry=self.registry,
                recorder=getattr(manager, "recorder", None),
                tsdb=self.tsdb,
                profiler=self.profiler,
                metric_prefixes=("tpu_plugin_", "tpu_slice_"),
                collectors={
                    "statz.json": lambda: manager_status(self._manager),
                })

    def _refresh(self) -> None:
        try:
            update_plugin_metrics(self._manager, self.registry)
        except Exception as e:
            # a broken status snapshot degrades one render's
            # freshness, never the render (or the TSDB tick) itself
            suppressed("debug.metrics_refresh", e, logger=log,
                       metrics=getattr(self._manager, "resilience",
                                       None))

    @property
    def port(self) -> int:
        """Actual bound port (differs from the requested one for port 0)."""
        return self._httpd.server_address[1] if self._httpd else self._port

    def start(self) -> "DebugServer":
        manager = self._manager
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                url = urlparse(self.path)
                if url.path == "/healthz":
                    self._send(200, "text/plain", "ok\n")
                elif url.path == "/alerts":
                    self._send(200, "application/json",
                               outer.alerts.status_json() + "\n")
                elif url.path == "/debug/query":
                    params = {k: v[0] for k, v
                              in parse_qs(url.query).items()}
                    try:
                        body = outer.tsdb.handle_query_json(params)
                    except ValueError as e:
                        self._send(400, "application/json", json.dumps(
                            {"error": str(e)}) + "\n")
                        return
                    self._send(200, "application/json", body + "\n")
                elif url.path == "/debug/status":
                    try:
                        body = json.dumps(manager_status(manager), indent=2)
                        self._send(200, "application/json", body + "\n")
                    except Exception as e:
                        # full traceback to the LOG, generic body to the
                        # CLIENT: raw exception text can leak paths and
                        # internal state, and without the traceback the
                        # operator had nothing to debug with; the
                        # suppressed counter makes repeated failures
                        # visible on /metrics
                        log.exception("/debug/status failed")
                        suppressed("debug.status", e, logger=log,
                                   metrics=getattr(manager, "resilience",
                                                   None))
                        self._send(500, "text/plain",
                                   "internal error; see plugin logs\n")
                elif url.path == "/debug/threads":
                    self._send(200, "text/plain", thread_dump())
                elif url.path == "/debug/pprof":
                    try:
                        ctype, body = outer.profiler.handle_pprof(
                            parse_qs(url.query))
                    except ValueError as e:
                        self._send(400, "application/json", json.dumps(
                            {"error": str(e)}) + "\n")
                        return
                    self._send(200, ctype, body)
                elif url.path in ("/debug/traces", "/debug/events"):
                    recorder = getattr(manager, "recorder", None)
                    if recorder is None:
                        self._send(404, "application/json", json.dumps(
                            {"error": "no flight recorder on this "
                                      "manager"}) + "\n")
                        return
                    q = parse_qs(url.query)
                    if url.path == "/debug/traces":
                        tid = q.get("trace_id", [None])[0]
                        if tid:
                            body = {"trace_id": tid,
                                    "events": recorder.events(
                                        trace_id=tid)}
                        else:
                            body = {"traces": recorder.trace_ids()}
                    else:
                        try:
                            since = float(q.get("since", ["0"])[0])
                        except ValueError:
                            self._send(400, "application/json",
                                       json.dumps({
                                           "error": "'since' must be "
                                           "a unix timestamp"}) + "\n")
                            return
                        body = {"since": since,
                                "dropped": recorder.dropped,
                                "events": recorder.events(since=since)}
                    self._send(200, "application/json",
                               json.dumps(body, indent=2) + "\n")
                elif url.path == "/metrics":
                    om = obs.negotiate_openmetrics(
                        self.headers.get("Accept"))
                    try:
                        # bridged families refresh via the registry
                        # collect hook; ScrapeMeta accounts the
                        # exposition itself (tpu_scrape_*)
                        self._send(
                            200,
                            obs.OPENMETRICS_CONTENT_TYPE if om
                            else obs.TEXT_CONTENT_TYPE,
                            outer.scrape_meta.render(openmetrics=om),
                        )
                    except Exception as e:
                        log.exception("/metrics render failed")
                        suppressed("debug.metrics_render", e,
                                   logger=log,
                                   metrics=getattr(manager, "resilience",
                                                   None))
                        self._send(500, "text/plain",
                                   "internal error; see plugin logs\n")
                else:
                    self._send(404, "text/plain", "not found\n")

            def _send(self, code, ctype, body: str):
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, fmt, *args):
                log.debug("debug-http: " + fmt, *args)

        self._httpd = ThreadingHTTPServer((self._host, self._port), Handler)
        t = threading.Thread(
            target=self._httpd.serve_forever, name="debug-http", daemon=True
        )
        t.start()
        self.tsdb.start(self._tick_interval_s)
        self.profiler.start()
        if self._incidents is not None:
            self._incidents.start()
        log.info("debug endpoint on http://%s:%d", self._host, self.port)
        return self

    def stop(self) -> None:
        self.tsdb.stop()
        self.profiler.stop()
        if self._incidents is not None:
            self._incidents.stop()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
