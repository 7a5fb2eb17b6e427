"""Container-workload device implementation for NVIDIA GPUs.

The port's counterpart of the JAX package's ``tpu/device_impl.py``:
discovers the GPUs at init, precomputes the device list, answers every
kubelet RPC from memory, and hands a container exactly its GPUs: the
allocated ``/dev/nvidia<minor>`` nodes, the control nodes once, and
``NVIDIA_VISIBLE_DEVICES`` naming them for the container runtime.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Callable, Dict, List, Optional, Tuple

from .. import resilience
from ..allocator import AllocationError, devices_from_discovery, first_fit
from ..proto import deviceplugin_pb2 as pluginapi
from ..types import DeviceImpl, DevicePluginContext, constants
from . import discovery
from .discovery import GpuDevice
from .topology import GpuTopology, build_topology

log = logging.getLogger(__name__)

# Signature of the granular health overlay (the metrics exporter's
# client; injected so the impl is testable without a running exporter).
HealthFn = Callable[[], Dict[str, str]]


class GpuContainerImpl(DeviceImpl):
    """DeviceImpl for container workloads through the nvidia driver."""

    def __init__(
        self,
        sysfs_root: str = "/sys",
        dev_root: str = "/dev",
        proc_root: str = "/proc",
        nvml=None,
        health_fn: Optional[HealthFn] = None,
        probe_watchdog_s: float = constants.PROBE_WATCHDOG_TIMEOUT_S,
    ):
        self._sysfs_root = sysfs_root
        self._dev_root = dev_root
        self._proc_root = proc_root
        self._nvml = nvml
        self._health_fn = health_fn
        # hung-probe containment, as in the reference: the watchdog
        # abandons a probe wedged in a C call, the breaker stops paying
        # the timeout once hanging is established, and _probe_wedged
        # demotes every advertised device until a probe succeeds again
        self._probe_watchdog_s = probe_watchdog_s
        self._probe_wedged = False
        self.set_resilience()

        self.gpus: Dict[str, GpuDevice] = {}
        self.topology: Optional[GpuTopology] = None
        self._control_nodes: List[Tuple[str, str]] = []
        self._dev_list: List[pluginapi.Device] = []
        # operator-visible fragmentation signal: Allocates whose GPUs
        # span NVLink cliques when one clique could have held them
        self._counters_lock = threading.Lock()
        self._cross_clique = 0

        self._apply_discovery(*self._discover())

    # -- discovery -----------------------------------------------------------

    def _discover(self):
        """Run discovery and keep what the container path can serve
        (raises on an unusable host).  Shared by init and rediscovery."""
        gpus, topology = discovery.get_gpus(
            self._sysfs_root, self._dev_root, self._proc_root, self._nvml)
        if not gpus:
            raise RuntimeError(
                f"no NVIDIA GPU found: nothing bound to the nvidia driver "
                f"under {self._sysfs_root}, and none in NVML")
        # discovery lists only GPUs bound to nvidia; of those, only the
        # ones with a device node here: in a container sysfs can list
        # every GPU of the host while only the allocated /dev/nvidiaN
        # exists
        usable = [g for g in gpus.values()
                  if g.dev_path and os.path.exists(g.dev_path)]
        if not usable:
            raise RuntimeError(
                f"no NVIDIA GPU bound to the nvidia driver has a device "
                f"node under {self._dev_root}")
        topology = build_topology(usable, topology.spec)
        return ({g.id: g for g in usable}, topology,
                discovery.control_nodes(self._dev_root))

    def _apply_discovery(self, gpus, topology, control_nodes) -> None:
        """Swap in a discovery result: the id map before the device list,
        since concurrent handlers read the list and index the map."""
        self.gpus = gpus
        self.topology = topology
        self._control_nodes = control_nodes
        self._dev_list = [
            pluginapi.Device(
                ID=g.id,
                health=constants.HEALTHY,
                topology=pluginapi.TopologyInfo(
                    nodes=[pluginapi.NUMANode(ID=g.numa_node)]),
            )
            for g in gpus.values()
        ]

    @staticmethod
    def _signature(gpus, topology):
        return (tuple(sorted((g.id, g.minor, g.uuid) for g in gpus.values())),
                topology.topology_str if topology else "")

    def rediscover(self) -> bool:
        """Pulse-driven re-enumeration; keeps the last good state when
        the host is transiently unusable (the simple health check demotes
        the node then)."""
        try:
            found = self._discover()
        except RuntimeError as e:
            log.warning("rediscovery failed; keeping current state: %s", e)
            return False
        if self._signature(found[0], found[1]) == self._signature(
                self.gpus, self.topology):
            return False
        log.info("hardware changed: %d GPU(s), NVLink %s", len(found[0]),
                 found[1].topology_str)
        self._apply_discovery(*found)
        return True

    # -- DeviceImpl RPC surface ----------------------------------------------

    def get_resource_names(self) -> List[str]:
        # whole GPUs only: MIG-typed names (the mixed naming strategy)
        # come with ROADMAP item 8.2
        return [constants.DEVICE_TYPE_GPU] if self.gpus else []

    def start(self, ctx: DevicePluginContext) -> None:
        """Initialise this resource's allocator; failure degrades to the
        kubelet's default allocation."""
        policy = ctx.get_allocator()
        if policy is None:
            ctx.set_allocator_error(True)
            return
        try:
            policy.init(devices_from_discovery(self.gpus), self.topology)
            # start() re-runs after rediscovery: a successful re-init
            # clears a previous sticky failure
            ctx.set_allocator_error(False)
        except AllocationError as e:
            log.error("allocator init failed for %s; falling back to "
                      "kubelet default allocation: %s",
                      ctx.resource_name(), e)
            ctx.set_allocator_error(True)

    def get_options(self, ctx: DevicePluginContext
                    ) -> pluginapi.DevicePluginOptions:
        if ctx.get_allocator_error():
            return pluginapi.DevicePluginOptions()
        return pluginapi.DevicePluginOptions(
            get_preferred_allocation_available=True)

    def enumerate(self, ctx: DevicePluginContext) -> List[pluginapi.Device]:
        return list(self._dev_list)

    def allocate(self, ctx: DevicePluginContext,
                 req: pluginapi.AllocateRequest
                 ) -> pluginapi.AllocateResponse:
        """Device nodes and env for each container: map lookups only, no
        sysfs I/O."""
        resp = pluginapi.AllocateResponse()
        for creq in req.container_requests:
            car = resp.container_responses.add()
            gpus: List[GpuDevice] = []
            for dev_id in creq.devices_ids:
                gpu = self.gpus.get(dev_id)
                if gpu is None:
                    raise RuntimeError(f"allocate for unknown device {dev_id}")
                if gpu not in gpus:
                    gpus.append(gpu)
            for gpu in gpus:
                car.devices.add(host_path=gpu.dev_path,
                                container_path=gpu.container_path,
                                permissions="rw")
            for host_path, container_path in self._control_nodes:
                car.devices.add(host_path=host_path,
                                container_path=container_path,
                                permissions="rw")
            # the runtime exposes exactly these GPUs; CUDA_VISIBLE_DEVICES
            # stays unset, since inside the container CUDA numbers only
            # the nodes it can open
            car.envs[constants.ENV_NVIDIA_VISIBLE_DEVICES] = ",".join(
                g.visible_id for g in gpus)
            self._check_cliques(gpus)
        return resp

    def _check_cliques(self, gpus: List[GpuDevice]) -> None:
        """Count (and warn of) a grant that spans NVLink cliques although
        one clique could have held it: that pod's collectives cross PCIe
        because the node is fragmented."""
        topo = self.topology
        if topo is None or len(gpus) < 2 or len(gpus) > topo.largest_clique:
            return
        spanned = {topo.clique_of(g.id) for g in gpus}
        if len(spanned) < 2:
            return
        with self._counters_lock:
            self._cross_clique += 1
        log.warning(
            "allocation %s spans %d NVLink cliques: this pod's collectives "
            "will cross PCIe; node is fragmented",
            [g.id for g in gpus], len(spanned))

    def get_preferred_allocation(
        self, ctx: DevicePluginContext,
        req: pluginapi.PreferredAllocationRequest,
    ) -> pluginapi.PreferredAllocationResponse:
        resp = pluginapi.PreferredAllocationResponse()
        policy = ctx.get_allocator()
        for creq in req.container_requests:
            if policy is None or ctx.get_allocator_error():
                # no policy / failed init is a supported degraded state:
                # answer first fit, as the kubelet would
                ids = first_fit(list(creq.available_deviceIDs),
                                list(creq.must_include_deviceIDs),
                                int(creq.allocation_size))
            else:
                ids = policy.allocate(list(creq.available_deviceIDs),
                                      list(creq.must_include_deviceIDs),
                                      int(creq.allocation_size))
            resp.container_responses.add(deviceIDs=ids)
        return resp

    def counters(self) -> Dict[str, int]:
        """Impl-level counters for the debug and metrics surfaces."""
        with self._counters_lock:
            return {"cross_clique_allocations": self._cross_clique}

    # -- health --------------------------------------------------------------

    def set_resilience(self, metrics=None, recorder=None) -> None:
        """(Re)build the probe watchdog and breaker, optionally wired to
        a registry's resilience families and the flight recorder (the
        PluginManager passes its own)."""
        self._probe_watchdog = resilience.Watchdog(
            "probe", self._probe_watchdog_s,
            metrics=metrics, recorder=recorder, logger=log)
        self._probe_breaker = resilience.CircuitBreaker(
            "probe", failure_threshold=3,
            reset_timeout_s=self._probe_watchdog_s * 3,
            metrics=metrics, recorder=recorder, logger=log)

    def _granular_health(self) -> Dict[str, str]:
        """Per-GPU health overlay from the exporter; {} when unwired or
        failing.  A probe that hangs trips the watchdog and flips
        ``_probe_wedged``: update_health then demotes every device, since
        a wedged probe usually means the driver under the GPUs is wedged
        too.  Fast failures fall back to the simple node check."""
        if self._health_fn is None:
            return {}
        try:
            out = self._probe_breaker.call(
                lambda: self._probe_watchdog.call(self._health_fn))
        except resilience.WatchdogTimeout:
            self._probe_wedged = True
            return {}
        except resilience.CircuitOpenError:
            # breaker open: skip the probe, keep the standing verdict
            return {}
        except Exception as e:
            log.warning("granular health probe failed: %s", e)
            return {}
        self._probe_wedged = False
        return out

    def simple_health_check(self) -> bool:
        """Cheap whole-node probe: every advertised GPU found in sysfs is
        still bound to the nvidia driver, and every device node exists."""
        bound = {bus for bus, _ in
                 discovery.list_nvidia_bound(self._sysfs_root)}
        for gpu in self.gpus.values():
            if gpu.source == discovery.SOURCE_SYSFS and gpu.id not in bound:
                return False
            if not os.path.exists(gpu.dev_path):
                return False
        return True

    def update_health(self, ctx: DevicePluginContext
                      ) -> List[pluginapi.Device]:
        node_health = (constants.HEALTHY if self.simple_health_check()
                       else constants.UNHEALTHY)
        per_gpu = self._granular_health()
        if self._probe_wedged:
            # nothing can vouch for the GPUs while the probe hangs: this
            # frame, within one pulse of the hang, demotes everything
            node_health = constants.UNHEALTHY
            per_gpu = {}
        # fresh messages: the cached list is shared with every open
        # ListAndWatch stream
        out: List[pluginapi.Device] = []
        for dev in self._dev_list:
            fresh = pluginapi.Device()
            fresh.CopyFrom(dev)
            fresh.health = per_gpu.get(dev.ID, node_health)
            out.append(fresh)
        return out
