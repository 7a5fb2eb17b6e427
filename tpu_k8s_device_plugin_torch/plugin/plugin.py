"""Plugin adapter: implements the kubelet DevicePluginServer, delegating
every RPC to a DeviceImpl.

The port's copy of the JAX package's ``plugin/plugin.py`` on the port's
``obs``: it owns the heartbeat and stop signalling of the ListAndWatch
stream; all device knowledge lives behind the DeviceImpl contract.  The
metric families and journal events keep the reference's names.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import List, Optional

import grpc

from .. import obs
from ..proto import (
    deviceplugin_pb2 as pluginapi,
    deviceplugin_pb2_grpc as pluginapi_grpc,
)
from ..types import DeviceImpl, DevicePluginContext, constants

log = logging.getLogger(__name__)

_BEAT = "beat"
_STOP = "stop"


class PluginMetrics:
    """Per-resource latency instruments shared by every plugin a
    manager serves (one family, ``resource`` label).  Lives on the
    manager's obs.Registry so the debug /metrics surface renders it."""

    def __init__(self, registry: obs.Registry):
        self.allocate_seconds = registry.histogram(
            "tpu_plugin_allocate_seconds",
            "Allocate RPC latency (env/mount/device-spec build).",
            ("resource",), buckets=obs.FAST_BUCKETS_S)
        self.frame_seconds = registry.histogram(
            "tpu_plugin_list_and_watch_frame_seconds",
            "Building one ListAndWatch frame (enumeration or health "
            "refresh + response construction).",
            ("resource",), buckets=obs.FAST_BUCKETS_S)
        self.probe_seconds = registry.histogram(
            "tpu_plugin_health_probe_seconds",
            "One health probe (DeviceImpl.update_health) on a beat.",
            ("resource",), buckets=obs.FAST_BUCKETS_S)


class GpuDevicePlugin(pluginapi_grpc.DevicePluginServicer):
    """One instance serves one resource name."""

    def __init__(self, device_impl: DeviceImpl, ctx: DevicePluginContext,
                 metrics: Optional[PluginMetrics] = None,
                 recorder: Optional[obs.FlightRecorder] = None):
        self.impl = device_impl
        self.ctx = ctx
        self.metrics = metrics
        # flight recorder: Allocate spans and device health
        # transitions journal here so a post-mortem can say WHICH
        # device demoted, when, and in which trace
        self.recorder = recorder
        self._lock = threading.Lock()
        self._watchers: List[queue.Queue] = []
        self._stopped = False
        # RPC counters for the debug endpoint; ints mutated under _lock
        # so the debug reader sees consistent values
        self.rpc_counts = {
            "allocate": 0,
            "get_preferred_allocation": 0,
            "list_and_watch_streams": 0,
        }
        # last device list sent down any ListAndWatch stream — the debug
        # endpoint serves this instead of re-probing hardware per request
        # (published by reference assignment; lists are never mutated)
        self.last_devices: Optional[List] = None

    def _count(self, rpc: str) -> None:
        with self._lock:
            self.rpc_counts[rpc] += 1

    def counters(self) -> dict:
        """Consistent copy of the RPC counters (debug surface)."""
        with self._lock:
            return dict(self.rpc_counts)

    def _record_health_diff(self, prev, devices, trace) -> None:
        """Journal per-device health transitions between two
        ListAndWatch frames: the discrete demotion/recovery events a
        post-mortem needs (the gauges only show the rollup)."""
        if self.recorder is None or prev is None:
            return
        prev_map = {d.ID: d.health for d in prev}
        for d in devices:
            old = prev_map.get(d.ID)
            if old is None or old == d.health:
                continue
            self.recorder.record(
                "tpu_device_recovered" if d.health == constants.HEALTHY
                else "tpu_device_demoted",
                trace=trace, device=d.ID,
                resource=self.ctx.resource_name(),
                health=d.health, was=old)

    # -- lifecycle signalling ------------------------------------------------

    def beat(self) -> None:
        """Pulse: every open ListAndWatch stream re-probes health and
        resends its device list."""
        with self._lock:
            for q in self._watchers:
                q.put(_BEAT)

    def stop(self) -> None:
        """Terminate all ListAndWatch streams (plugin shutdown)."""
        with self._lock:
            self._stopped = True
            for q in self._watchers:
                q.put(_STOP)

    def start(self) -> None:
        """Called after construction, before kubelet registration."""
        self.impl.start(self.ctx)

    # -- DevicePluginServer RPCs -------------------------------------------

    def GetDevicePluginOptions(self, request, context):
        try:
            return self.impl.get_options(self.ctx)
        except Exception as e:
            context.abort(grpc.StatusCode.INTERNAL, str(e))

    def ListAndWatch(self, request, context):
        """Initial device list, then health-refreshed resends on every
        heartbeat."""
        t0 = time.perf_counter()
        # one ROOT trace per stream: every frame and health transition
        # this stream produces shares it, so "what happened on this
        # kubelet watch" is a single /debug/traces query
        stream_trace = obs.new_trace()
        try:
            devices = self.impl.enumerate(self.ctx)
        except Exception as e:
            context.abort(grpc.StatusCode.INTERNAL, str(e))
            return
        # register the watcher before the first send so a beat() arriving
        # while the initial frame is in flight is never dropped
        q: queue.Queue = queue.Queue()
        with self._lock:
            if self._stopped:
                return
            self._watchers.append(q)
            self.rpc_counts["list_and_watch_streams"] += 1
        # client disconnect must unblock q.get() — otherwise every kubelet
        # restart leaks one executor thread parked in get() forever
        context.add_callback(lambda: q.put(_STOP))
        try:
            self.last_devices = devices
            frame = pluginapi.ListAndWatchResponse(devices=devices)
            if self.metrics:
                self.metrics.frame_seconds.labels(
                    resource=self.ctx.resource_name()).observe(
                        time.perf_counter() - t0)
            if self.recorder is not None:
                self.recorder.record(
                    "tpu_plugin_list_and_watch_frame",
                    trace=stream_trace,
                    resource=self.ctx.resource_name(),
                    devices=len(devices),
                    unhealthy=sum(d.health != constants.HEALTHY
                                  for d in devices),
                    duration_s=time.perf_counter() - t0)
            yield frame
            while context.is_active():
                msg = q.get()
                if msg == _STOP:
                    log.info(
                        "ListAndWatch(%s): stop signal, closing stream",
                        self.ctx.resource_name(),
                    )
                    return
                t0 = time.perf_counter()
                try:
                    devices = self.impl.update_health(self.ctx)
                except Exception as e:
                    log.error("UpdateHealth failed: %s", e)
                    continue
                finally:
                    # probe duration records failed probes too — a
                    # probe that times out is exactly the latency an
                    # operator needs to see
                    if self.metrics:
                        self.metrics.probe_seconds.labels(
                            resource=self.ctx.resource_name()).observe(
                                time.perf_counter() - t0)
                self._record_health_diff(self.last_devices, devices,
                                         stream_trace)
                self.last_devices = devices
                frame = pluginapi.ListAndWatchResponse(devices=devices)
                if self.metrics:
                    self.metrics.frame_seconds.labels(
                        resource=self.ctx.resource_name()).observe(
                            time.perf_counter() - t0)
                yield frame
        finally:
            with self._lock:
                if q in self._watchers:
                    self._watchers.remove(q)

    def GetPreferredAllocation(self, request, context):
        self._count("get_preferred_allocation")
        try:
            return self.impl.get_preferred_allocation(self.ctx, request)
        except Exception as e:
            log.error("GetPreferredAllocation failed: %s", e)
            context.abort(grpc.StatusCode.INTERNAL, str(e))

    def Allocate(self, request, context):
        self._count("allocate")
        # span: latency histogram + a trace-tagged log line per grant
        # (outcome=error when impl.allocate raises → context.abort).
        # Each Allocate opens a ROOT trace tagged with the granted
        # device ids: the id in the span line / exemplar / recorder
        # event is what stitches a pod's placement to later demotions
        device_ids = [d for cr in request.container_requests
                      for d in cr.devices_ids]
        with obs.span(
            "tpu_plugin_allocate",
            histogram=self.metrics.allocate_seconds if self.metrics
            else None,
            labels={"resource": self.ctx.resource_name()},
            logger=log, trace=obs.new_trace(), recorder=self.recorder,
        ) as sp:
            sp.annotate(containers=len(request.container_requests),
                        devices=",".join(device_ids) or "-")
            try:
                return self.impl.allocate(self.ctx, request)
            except Exception as e:
                log.error("Allocate failed: %s", e)
                context.abort(grpc.StatusCode.INTERNAL, str(e))

    def PreStartContainer(self, request, context):
        # Not required (pre_start_required=false), but answer gracefully.
        return pluginapi.PreStartContainerResponse()
