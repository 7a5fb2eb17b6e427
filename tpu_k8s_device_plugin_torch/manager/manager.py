"""Plugin lifecycle: serve per-resource gRPC sockets, register with the
kubelet, re-register on kubelet restart, pulse the health heartbeat.

The port's copy of the JAX package's ``manager/manager.py`` on the
port's ``obs``, ``resilience`` and ``gpuprobe.DirWatcher``:

- one unix socket + gRPC server per resource, named
  ``nvidia.com_<res>`` in the kubelet device-plugin dir
- the Register RPC to kubelet.sock under a retry policy
- a watch on the kubelet socket: on re-create, re-serve every plugin's
  endpoint socket (a restarting kubelet wipes the device-plugin dir) and
  re-register; on remove, keep serving and wait for it to come back
- a pulse thread driving rediscovery and UpdateHealth -> ListAndWatch
  resends
- resource-list diffing: start/stop plugin servers as the advertised
  resource set changes

The watch uses the native inotify shim when it builds, stat polling
otherwise.  Slice coordination (the reference's slice heartbeat on each
pulse) comes with ROADMAP item 8.3.
"""

from __future__ import annotations

import concurrent.futures
import logging
import os
import threading
import time
from typing import Dict, List, Optional

import grpc

from .. import obs, resilience
from ..allocator import BestEffortPolicy
from ..plugin import GpuDevicePlugin, PluginMetrics
from ..proto import (
    deviceplugin_pb2 as pluginapi,
    deviceplugin_pb2_grpc as pluginapi_grpc,
)
from ..resilience import faults
from ..types import DeviceImpl, DevicePluginContext, constants

log = logging.getLogger(__name__)

# Register retry shape (consumed by the shared RetryPolicy below; kept
# as module constants so tests can shrink the delay)
_REGISTER_RETRIES = 3
_REGISTER_RETRY_DELAY_S = 3.0
# bounded stop(): how long to wait for the watch/pulse threads to exit
# before logging and moving on (they are daemons; a wedged probe must
# not block process shutdown forever)
_THREAD_JOIN_TIMEOUT_S = 5.0


class _ServedPlugin:
    """One resource's plugin server and socket."""

    def __init__(self, resource: str, plugin: GpuDevicePlugin, socket_path: str):
        self.resource = resource
        self.plugin = plugin
        self.socket_path = socket_path
        self.server: Optional[grpc.Server] = None

    def serve(self) -> None:
        if os.path.exists(self.socket_path):
            os.remove(self.socket_path)
        self.server = grpc.server(
            concurrent.futures.ThreadPoolExecutor(max_workers=8)
        )
        pluginapi_grpc.add_DevicePluginServicer_to_server(
            self.plugin, self.server
        )
        self.server.add_insecure_port(f"unix://{self.socket_path}")
        self.server.start()
        log.info("serving %s on %s", self.resource, self.socket_path)

    def restart_server(self) -> None:
        """Tear down and re-create the gRPC server + socket, keeping the
        plugin (and its DeviceImpl state) alive.  Needed after a kubelet
        restart: kubelet wipes the device-plugin dir on startup, unlinking
        our socket while the old server keeps listening on a dead inode."""
        if self.server is not None:
            self.server.stop(grace=0.5).wait()
            self.server = None
        self.serve()

    def shutdown(self) -> None:
        self.plugin.stop()
        if self.server is not None:
            self.server.stop(grace=1.0).wait()
            self.server = None
        if os.path.exists(self.socket_path):
            try:
                os.remove(self.socket_path)
            except OSError:
                pass


class PluginManager:
    """Drives the full plugin lifecycle for a DeviceImpl."""

    def __init__(
        self,
        device_impl: DeviceImpl,
        pulse_seconds: int = 0,
        kubelet_dir: str = constants.DEVICE_PLUGIN_PATH,
        resource_namespace: str = constants.RESOURCE_NAMESPACE,
        kubelet_watch_interval_s: float = 1.0,
        registry: Optional[obs.Registry] = None,
        recorder: Optional[obs.FlightRecorder] = None,
    ):
        self.impl = device_impl
        self.pulse = pulse_seconds
        self.kubelet_dir = kubelet_dir
        # the node's ONE metrics registry: plugin latency histograms,
        # pulse rounds and the debug endpoint's bridged status snapshot
        # all render from here
        self.registry = registry if registry is not None else obs.Registry()
        # the node's ONE flight recorder: Allocate/ListAndWatch spans,
        # device demotions/recoveries and pulse rounds journal here; the
        # debug /debug/traces and /debug/events endpoints read it and
        # --flight-record-dir dumps it on exit/SIGTERM
        self.recorder = (recorder if recorder is not None
                         else obs.FlightRecorder(registry=self.registry))
        # shared resilience instrumentation: Register retries, the
        # probe breaker/watchdog (wired into the impl below), and the
        # suppressed-error counter all render from this registry
        self.resilience = resilience.ResilienceMetrics(self.registry)
        set_res = getattr(device_impl, "set_resilience", None)
        if callable(set_res):
            set_res(metrics=self.resilience, recorder=self.recorder)
        self._plugin_metrics = PluginMetrics(self.registry)
        self._m_pulse = self.registry.histogram(
            "tpu_plugin_pulse_round_seconds",
            "One pulse round: rediscovery + plugin beats.",
            buckets=obs.LATENCY_BUCKETS_S)
        self.kubelet_socket = os.path.join(kubelet_dir, "kubelet.sock")
        self.namespace = resource_namespace
        self._watch_interval = kubelet_watch_interval_s
        self._plugins: Dict[str, _ServedPlugin] = {}
        # guards _plugins: mutated by update_resources()/stop() on caller
        # threads while the kubelet-watch thread iterates it to re-register
        self._plugins_lock = threading.Lock()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []

    # -- public API ---------------------------------------------------------

    def run(self, block: bool = True) -> None:
        """Start serving and registering; optionally block until stop()."""
        self._sync_plugins(self.impl.get_resource_names())
        self._register_all()
        t = threading.Thread(
            target=self._kubelet_watch_loop, name="kubelet-watch", daemon=True
        )
        t.start()
        self._threads.append(t)
        if self.pulse > 0:
            t = threading.Thread(
                target=self._pulse_loop, name="pulse", daemon=True
            )
            t.start()
            self._threads.append(t)
        if block:
            try:
                while not self._stop.is_set():
                    time.sleep(0.5)
            except KeyboardInterrupt:
                pass
            self.stop()

    def stop(self) -> None:
        self._stop.set()
        with self._plugins_lock:
            plugins = list(self._plugins.values())
            self._plugins.clear()
        for sp in plugins:
            sp.shutdown()
        # join the watch/pulse threads with a bound: a thread that
        # fails to exit is a wedged call we must not wait on forever,
        # but it must also not die silently (leaked threads across
        # restarts are how socket flaps become fd exhaustion)
        me = threading.current_thread()
        for t in self._threads:
            if t is me:
                continue
            t.join(timeout=_THREAD_JOIN_TIMEOUT_S)
            if t.is_alive():
                log.warning(
                    "thread %s did not exit within %.0fs of stop()",
                    t.name, _THREAD_JOIN_TIMEOUT_S)
        self._threads = [t for t in self._threads if t.is_alive()]

    def update_resources(self, resources: List[str]) -> None:
        """Diff the advertised resource set, starting/stopping plugin
        servers as needed."""
        self._sync_plugins(resources)
        self._register_all()

    def status_snapshot(self) -> Dict[str, dict]:
        """Per-resource serving state for the debug endpoint.  Health comes
        from each plugin's last ListAndWatch frame (no hardware probing on
        this path — request rate stays decoupled from probe rate), falling
        back to the precomputed enumerate list before any stream opened."""
        with self._plugins_lock:
            plugins = list(self._plugins.items())
        out: Dict[str, dict] = {}
        for resource, sp in plugins:
            plugin = sp.plugin
            devices = plugin.last_devices
            if devices is None:
                try:
                    devices = self.impl.enumerate(plugin.ctx)
                except Exception as e:
                    # surfaced to the /debug caller in the payload, and
                    # logged so the failure is greppable without one
                    log.debug("debug-status enumerate failed for %s: %s",
                              resource, e)
                    out[resource] = {"error": str(e)}
                    continue
            out[resource] = {
                "endpoint": sp.socket_path,
                "devices": {d.ID: d.health for d in devices},
                "healthy": sum(d.health == constants.HEALTHY for d in devices),
                "unhealthy": sum(d.health != constants.HEALTHY for d in devices),
                # capability, not failure: False means GetPreferred-
                # Allocation answers first fit (allocator init failed)
                "preferred_allocation_enabled": (
                    not plugin.ctx.get_allocator_error()
                ),
                "rpc_counts": plugin.counters(),
            }
        return out

    # -- internals ----------------------------------------------------------

    def _endpoint(self, resource: str) -> str:
        return f"{self.namespace}_{resource}"

    def _sync_plugins(self, resources: List[str]) -> None:
        wanted = set(resources)
        with self._plugins_lock:
            current = set(self._plugins)
            removed = [self._plugins.pop(r) for r in current - wanted]
        for sp in removed:
            log.info("resource %s no longer advertised; stopping", sp.resource)
            sp.shutdown()
        for resource in sorted(wanted - current):
            if self._stop.is_set():
                return
            ctx = DevicePluginContext(resource, BestEffortPolicy())
            plugin = GpuDevicePlugin(self.impl, ctx,
                                     metrics=self._plugin_metrics,
                                     recorder=self.recorder)
            plugin.start()
            sp = _ServedPlugin(
                resource,
                plugin,
                os.path.join(self.kubelet_dir, self._endpoint(resource)),
            )
            sp.serve()
            with self._plugins_lock:
                if self._stop.is_set():
                    # a concurrent stop() already drained _plugins; inserting
                    # now would resurrect a server nothing will ever shut down
                    sp.shutdown()
                    return
                self._plugins[resource] = sp

    def _register_all(self) -> None:
        with self._plugins_lock:
            plugins = list(self._plugins.items())
        for resource, sp in plugins:
            self._register(resource, sp)

    def _register(self, resource: str, sp: _ServedPlugin) -> bool:
        """Register RPC through the shared RetryPolicy (jittered
        exponential backoff, retry metrics, stop-event abort).  A final
        failure is non-fatal: the kubelet-watch loop re-registers on the
        next socket event."""
        try:
            options = self.impl.get_options(sp.plugin.ctx)
        except Exception as e:
            log.error("GetOptions failed for %s: %s", resource, e)
            options = pluginapi.DevicePluginOptions()
        req = pluginapi.RegisterRequest(
            version=constants.KUBELET_DP_VERSION,
            endpoint=self._endpoint(resource),
            resource_name=f"{self.namespace}/{resource}",
            options=options,
        )

        def _rpc():
            if faults.ACTIVE is not None:
                faults.ACTIVE.fire("kubelet.register")
            with grpc.insecure_channel(
                f"unix://{self.kubelet_socket}"
            ) as ch:
                stub = pluginapi_grpc.RegistrationStub(ch)
                stub.Register(req, timeout=5.0)

        policy = resilience.RetryPolicy(
            max_attempts=_REGISTER_RETRIES,
            initial_backoff_s=_REGISTER_RETRY_DELAY_S,
            max_backoff_s=_REGISTER_RETRY_DELAY_S * 4,
        )
        try:
            policy.call(
                _rpc, op="kubelet.register",
                retry_on=(grpc.RpcError, faults.InjectedFault),
                stop=self._stop, metrics=self.resilience,
                recorder=self.recorder, logger=log)
        except (grpc.RpcError, faults.InjectedFault) as e:
            log.warning("register %s failed after retries: %s",
                        resource, e)
            return False
        except resilience.CircuitOpenError:
            return False  # stop() landed before the first attempt
        log.info("registered %s/%s with kubelet", self.namespace, resource)
        return True

    def _kubelet_watch_loop(self) -> None:
        """Re-register on kubelet socket re-creation; keep serving while
        the socket is gone.  Uses the native inotify shim when it builds,
        else stat polling."""
        def make_watcher():
            try:
                from ..hostinfo import gpuprobe
                return gpuprobe.DirWatcher(self.kubelet_dir)
            except Exception as e:
                # no native shim / no inotify budget: poll instead —
                # counted, not silent
                resilience.suppressed("manager.make_watcher", e,
                                      logger=log,
                                      metrics=self.resilience)
                return None

        watcher = make_watcher()
        last_stat = self._socket_stat()
        while not self._stop.is_set():
            if watcher is not None:
                try:
                    watcher.wait(timeout_s=self._watch_interval)
                except OSError as e:
                    # ESTALE: the watched dir was deleted+recreated (some
                    # kubelet restarts do this) — re-watch the new inode;
                    # only fall back to polling when that fails too
                    log.warning("inotify watch broke (%s); re-creating", e)
                    try:
                        watcher.close()
                    except Exception as ce:
                        resilience.suppressed("manager.watcher_close",
                                              ce, logger=log,
                                              metrics=self.resilience)
                    watcher = make_watcher()
                    if watcher is None:
                        log.warning("watch re-creation failed; polling")
            else:
                time.sleep(self._watch_interval)
            cur = self._socket_stat()
            if cur == last_stat:
                continue
            if cur is None:
                log.warning("kubelet socket disappeared; waiting for restart")
            else:
                log.info(
                    "kubelet socket (re)created; re-serving and "
                    "re-registering plugins"
                )
                # small grace: kubelet needs a moment to start serving
                time.sleep(1.0)
                if self._stop.is_set():
                    return
                # snapshot after the sleep, and re-serve under the lock so a
                # concurrent stop()/_sync_plugins shutdown can't be undone by
                # resurrecting a server the manager no longer tracks
                with self._plugins_lock:
                    for sp in self._plugins.values():
                        # kubelet wipes the dp dir on restart; our endpoint
                        # socket must exist before Register advertises it
                        if not os.path.exists(sp.socket_path):
                            sp.restart_server()
                self._register_all()
            last_stat = cur

    def _socket_stat(self):
        try:
            st = os.stat(self.kubelet_socket)
            # ctime matters: a fast kubelet restart can reuse the inode
            # (observed on tmpfs), making (ino, dev) alone miss the re-create
            return (st.st_ino, st.st_dev, st.st_ctime_ns)
        except OSError:
            return None

    def _pulse_loop(self) -> None:
        """Heartbeat: re-check the hardware inventory, then trigger a
        health refresh on every plugin.  The beat after a rediscovery is
        what pushes the changed device list down every open ListAndWatch
        stream."""
        while not self._stop.wait(self.pulse):
            # every pulse round is a ROOT trace
            ctx = obs.new_trace()
            with self._plugins_lock:
                resources = sorted(self._plugins)
            with obs.span("tpu_plugin_pulse_round",
                          histogram=self._m_pulse, logger=log,
                          trace=ctx, recorder=self.recorder) as sp:
                sp.annotate(resources=",".join(resources) or "-")
                self._maybe_rediscover()
                with self._plugins_lock:
                    plugins = list(self._plugins.values())
                for sp in plugins:
                    sp.plugin.beat()

    def _maybe_rediscover(self) -> None:
        """Runtime resource rediscovery: when the GPU set changed, re-diff
        the served resources and re-init surviving plugins' allocators
        against the new device set."""
        if self._stop.is_set():
            return
        try:
            changed = self.impl.rediscover()
        except Exception as e:
            log.error("rediscovery probe failed: %s", e)
            return
        if not changed:
            return
        resources = self.impl.get_resource_names()
        log.info("re-advertising resources after hardware change: %s",
                 resources)
        with self._plugins_lock:
            survivors = set(self._plugins)
        self.update_resources(resources)
        # Fresh plugins were init'd against the new device set inside
        # _sync_plugins; only survivors hold a stale allocator.
        with self._plugins_lock:
            stale = [sp for r, sp in self._plugins.items() if r in survivors]
        for sp in stale:
            self._reinit_allocator(sp)

    def _reinit_allocator(self, sp: _ServedPlugin) -> None:
        """Swap in a freshly initialised policy.  A new context + policy is
        built off to the side and published with one reference assignment:
        in-flight GetPreferredAllocation calls keep the fully-built old
        policy; later calls see the fully-built new one.  Mutating the live
        policy in place would let a concurrent RPC observe a half-built
        weight table."""
        ctx = DevicePluginContext(sp.resource, BestEffortPolicy())
        try:
            self.impl.start(ctx)
        except Exception as e:
            log.error("allocator re-init failed for %s: %s", sp.resource, e)
            ctx.set_allocator_error(True)
        sp.plugin.ctx = ctx
