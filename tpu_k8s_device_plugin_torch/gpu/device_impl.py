"""Container-workload device implementation for NVIDIA GPUs.

The port's counterpart of the JAX package's ``tpu/device_impl.py``:
discovers the GPUs at init, precomputes a device list per resource,
answers every kubelet RPC from memory, and hands a container exactly its
GPUs: the allocated ``/dev/nvidia<minor>`` nodes, the control nodes
once, and ``NVIDIA_VISIBLE_DEVICES`` naming them for the container
runtime.

MIG devices take the place of the reference's TensorCore partitions: a
MIG-enabled GPU serves one device per MIG device (the parent's node, the
control nodes, and its GPU and compute instance capability nodes under
``/dev/nvidia-caps``; ``NVIDIA_VISIBLE_DEVICES=MIG-<uuid>``), the
``single`` strategy names uniform devices ``nvidia.com/gpu`` and
refuses a heterogeneous node, and ``mixed`` names whole GPUs
``nvidia.com/gpu`` and MIG devices ``nvidia.com/mig-<profile>``.

On a member of a multi-host slice (:mod:`..slice`), a full-host grant
also carries the slice's ``torch.distributed`` env, and a slice-wide
Unhealthy verdict demotes every device of every member.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import (TYPE_CHECKING, Callable, Dict, List, Optional, Tuple,
                    Union)

from .. import resilience
from ..allocator import AllocationError, devices_from_discovery, first_fit
from ..proto import deviceplugin_pb2 as pluginapi
from ..types import DeviceImpl, DevicePluginContext, constants
from . import discovery
from .discovery import GpuDevice, MigPartition
from .topology import GpuTopology, build_topology

if TYPE_CHECKING:  # hints only; the slice stays an optional wiring
    from ..slice import SliceClient

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
        resource_naming_strategy: str = (
            constants.RESOURCE_NAMING_STRATEGY_SINGLE),
    ):
        self._strategy = resource_naming_strategy
        self._slice: Optional["SliceClient"] = None
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
        self._homogeneous = True
        self._control_nodes: List[Tuple[str, str]] = []
        # per resource: the advertised devices; per kubelet id: the GPU
        # or MIG device it names
        self._dev_list: Dict[str, List[pluginapi.Device]] = {}
        self._by_dev_id: Dict[str, Union[GpuDevice, MigPartition]] = {}
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
        gpus = {g.id: g for g in usable}
        homogeneous = discovery.is_homogeneous(gpus)
        if (not homogeneous and self._strategy
                == constants.RESOURCE_NAMING_STRATEGY_SINGLE):
            raise RuntimeError(
                "GPUs with different MIG partitions on one node require "
                "resource_naming_strategy=mixed")
        return (gpus, topology, discovery.control_nodes(self._dev_root),
                homogeneous)

    def _apply_discovery(self, gpus, topology, control_nodes,
                         homogeneous) -> None:
        """Swap in a discovery result: the id map before the device
        lists, since concurrent handlers read a list and index the
        map."""
        self.gpus = gpus
        self.topology = topology
        self._control_nodes = control_nodes
        self._homogeneous = homogeneous
        by_dev_id: Dict[str, Union[GpuDevice, MigPartition]] = {}
        dev_list: Dict[str, List[pluginapi.Device]] = {}
        for resource in self.get_resource_names():
            devs = []
            for ad in self._alloc_devices_for(resource):
                gpu = gpus[ad.parent_id]
                by_dev_id[ad.id] = (gpu if ad.id == gpu.id else
                                    next(m for m in gpu.mig
                                         if m.id == ad.id))
                devs.append(pluginapi.Device(
                    ID=ad.id,
                    health=constants.HEALTHY,
                    topology=pluginapi.TopologyInfo(
                        nodes=[pluginapi.NUMANode(ID=gpu.numa_node)])))
            dev_list[resource] = devs
        self._by_dev_id = by_dev_id
        self._dev_list = dev_list

    @staticmethod
    def _signature(gpus, topology):
        return (tuple(sorted((g.id, g.minor, g.uuid, g.mig_mode,
                              tuple(m.id for m in g.mig))
                             for g in gpus.values())),
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

    # -- resource naming -----------------------------------------------------

    def get_resource_names(self) -> List[str]:
        """The reference's rules with MIG profiles for partition modes:
        one "gpu" under ``single`` (whole GPUs, or MIG devices of one
        profile); under ``mixed``, "gpu" for whole GPUs and
        ``mig-<profile>`` for each profile present."""
        if not self.gpus:
            return []
        counts = discovery.unique_partition_config_count(self.gpus)
        if not counts:
            # every GPU MIG-enabled with no MIG device made yet
            return []
        if (self._homogeneous and self._strategy
                == constants.RESOURCE_NAMING_STRATEGY_SINGLE):
            return [constants.DEVICE_TYPE_GPU]
        return sorted(counts)

    def _alloc_devices_for(self, resource: str):
        """The allocatable devices a resource advertises."""
        devices = devices_from_discovery(self.gpus)
        if (self._homogeneous and self._strategy
                == constants.RESOURCE_NAMING_STRATEGY_SINGLE):
            return devices
        return [d for d in devices if d.partition_type == resource]

    # -- DeviceImpl RPC surface ----------------------------------------------

    def start(self, ctx: DevicePluginContext) -> None:
        """Initialise this resource's allocator; failure degrades to the
        kubelet's default allocation."""
        policy = ctx.get_allocator()
        if policy is None:
            ctx.set_allocator_error(True)
            return
        try:
            policy.init(self._alloc_devices_for(ctx.resource_name()),
                        self.topology)
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
        return list(self._dev_list.get(ctx.resource_name(), []))

    def allocate(self, ctx: DevicePluginContext,
                 req: pluginapi.AllocateRequest
                 ) -> pluginapi.AllocateResponse:
        """Device nodes and env for each container: map lookups only, no
        sysfs I/O."""
        resp = pluginapi.AllocateResponse()
        for creq in req.container_requests:
            car = resp.container_responses.add()
            gpus: List[GpuDevice] = []
            migs: List[MigPartition] = []
            for dev_id in creq.devices_ids:
                dev = self._by_dev_id.get(dev_id)
                if dev is None:
                    raise RuntimeError(f"allocate for unknown device {dev_id}")
                if isinstance(dev, MigPartition):
                    if dev not in migs:
                        migs.append(dev)
                    dev = self.gpus[dev.parent_id]
                if dev not in gpus:
                    gpus.append(dev)
            # a MIG device opens its parent's node (once, however many of
            # its MIG devices the container holds)
            for gpu in gpus:
                car.devices.add(host_path=gpu.dev_path,
                                container_path=gpu.container_path,
                                permissions="rw")
            for host_path, container_path in self._control_nodes:
                car.devices.add(host_path=host_path,
                                container_path=container_path,
                                permissions="rw")
            for mig in migs:
                for minor in (mig.gi_cap_minor, mig.ci_cap_minor):
                    path = discovery.cap_node(self._dev_root, minor)
                    if path:
                        car.devices.add(
                            host_path=path,
                            container_path=discovery.cap_node("/dev", minor),
                            permissions="rw")
            # the runtime exposes exactly these GPUs or MIG devices;
            # CUDA_VISIBLE_DEVICES stays unset, since inside the
            # container CUDA numbers only what it can open
            car.envs[constants.ENV_NVIDIA_VISIBLE_DEVICES] = ",".join(
                _mig_visible_id(m, self.gpus[m.parent_id]) for m in migs
            ) if migs else ",".join(g.visible_id for g in gpus)
            if not migs:
                self._check_cliques(gpus)
            if len(gpus) == len(self.gpus) and self._slice is not None:
                # whole host granted: the pod is this host's worker of a
                # multi-host slice, so it gets the rendezvous-agreed
                # torch.distributed env, identical on every member but
                # for the rank (empty before formation); a sub-host grant
                # is a standalone job and gets none
                for key, val in self._slice.slice_env().items():
                    car.envs[key] = val
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

    def set_slice_client(self, client: Optional["SliceClient"]) -> None:
        """Late wiring: the client needs this impl's GPU count and
        local_health before it can be built, so the CLI attaches it
        after construction."""
        self._slice = client

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

    def local_health(self) -> Tuple[bool, str]:
        """This host's contribution to slice-wide health, what the slice
        client reports in every heartbeat: one faulty GPU makes the
        whole host unhealthy here, and the coordinator fans that out to
        the whole slice."""
        if not self.simple_health_check():
            return False, "node health probe failed"
        per_gpu = self._granular_health()
        if self._probe_wedged:
            return False, "health probe hung (watchdog abandoned it)"
        bad = sorted(gid for gid in self.gpus
                     if per_gpu.get(gid, constants.HEALTHY)
                     != constants.HEALTHY)
        if bad:
            return False, "unhealthy GPUs: " + ",".join(bad)
        return True, ""

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
        # slice-wide verdict: any member's faulty GPU (or a silent
        # member) stalls every rank's collectives, so an Unhealthy
        # verdict demotes every local device until the slice recovers;
        # None while the slice forms or this host is evicted
        overlay = self._slice.health_overlay() if self._slice else None
        slice_down = overlay is not None and not overlay[0]
        if slice_down:
            log.debug("slice unhealthy (members: %s); demoting all local "
                      "devices", overlay[1])
        # fresh messages: the cached list is shared with every open
        # ListAndWatch stream
        out: List[pluginapi.Device] = []
        for dev in self._dev_list.get(ctx.resource_name(), []):
            fresh = pluginapi.Device()
            fresh.CopyFrom(dev)
            if slice_down:
                fresh.health = constants.UNHEALTHY
            else:
                # a MIG device's health is its parent GPU's; .get(): a
                # rediscovery swap can land between the list read and
                # this lookup, leaving the id unknown for one frame
                owner = self._by_dev_id.get(dev.ID)
                gid = getattr(owner, "parent_id", dev.ID)
                fresh.health = per_gpu.get(gid, node_health)
            out.append(fresh)
        return out


def _mig_visible_id(mig: MigPartition, gpu: GpuDevice) -> str:
    """What ``NVIDIA_VISIBLE_DEVICES`` names a MIG device by: its
    ``MIG-<uuid>``, else ``<GPU index>:<MIG device index>`` (the
    container runtime takes either)."""
    return mig.uuid or f"{gpu.index}:{mig.index}"
