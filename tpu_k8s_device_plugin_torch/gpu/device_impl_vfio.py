"""VM-passthrough device implementations (VF and PF).

The port's counterpart of the JAX package's ``tpu/device_impl_vfio.py``:
devices are keyed by IOMMU group, Allocate mounts /dev/vfio/<group> and
/dev/vfio/vfio once per container and announces the passthrough PCI
addresses in ``PCI_RESOURCE_NVIDIA_COM_<RESOURCE>`` for the
virt-launcher (KubeVirt's convention).  A VF's health is its PF's.
There is no topology allocator: a VM takes whole functions, and the
kubelet's default choice serves.
"""

from __future__ import annotations

import logging
import os
from typing import Callable, Dict, List, Optional

from ..allocator import first_fit
from ..proto import deviceplugin_pb2 as pluginapi
from ..types import DeviceImpl, DevicePluginContext, constants
from . import vfio

log = logging.getLogger(__name__)

HealthFn = Callable[[], Dict[str, str]]


class _VfioImplBase(DeviceImpl):
    """Shared VFIO allocation/enumeration shape for VF and PF impls."""

    resource_single = constants.DEVICE_TYPE_GPU
    resource_mixed = constants.DEVICE_TYPE_GPU

    def __init__(
        self,
        resource_naming_strategy: str = constants.RESOURCE_NAMING_STRATEGY_SINGLE,
        sysfs_root: str = "/sys",
        dev_root: str = "/dev",
        health_fn: Optional[HealthFn] = None,
    ):
        self._strategy = resource_naming_strategy
        self._sysfs_root = sysfs_root
        self._dev_root = dev_root
        self._health_fn = health_fn
        # iommu group -> pci address of the passthrough function
        self._group_to_pci: Dict[str, str] = {}
        self._numa: Dict[str, int] = {}
        self._discover()
        if not self._group_to_pci:
            raise RuntimeError(f"no devices found for {type(self).__name__}")

    def _discover(self) -> None:
        raise NotImplementedError

    # -- DeviceImpl ---------------------------------------------------------

    def start(self, ctx: DevicePluginContext) -> None:
        # VFIO passthrough has no topology-aware allocator: VMs take whole
        # functions, and the kubelet's default selection serves
        ctx.set_allocator_error(True)

    def get_resource_names(self) -> List[str]:
        if self._strategy == constants.RESOURCE_NAMING_STRATEGY_MIXED:
            return [self.resource_mixed]
        return [self.resource_single]

    def get_options(self, ctx: DevicePluginContext) -> pluginapi.DevicePluginOptions:
        return pluginapi.DevicePluginOptions()

    def enumerate(self, ctx: DevicePluginContext) -> List[pluginapi.Device]:
        return [
            pluginapi.Device(
                ID=group,
                health=constants.HEALTHY,
                topology=pluginapi.TopologyInfo(
                    nodes=[pluginapi.NUMANode(ID=self._numa.get(group, 0))]
                ),
            )
            for group in sorted(self._group_to_pci, key=_group_key)
        ]

    def allocate(
        self, ctx: DevicePluginContext, req: pluginapi.AllocateRequest
    ) -> pluginapi.AllocateResponse:
        """Mount the VFIO group nodes and announce the PCI addresses."""
        resp = pluginapi.AllocateResponse()
        vfio_dir = os.path.join(self._dev_root, constants.VFIO_DEV_DIR)
        for creq in req.container_requests:
            car = resp.container_responses.add()
            pci_addrs = []
            for group in creq.devices_ids:
                pci = self._group_to_pci.get(group)
                if pci is None:
                    raise RuntimeError(f"allocate for unknown IOMMU group {group}")
                pci_addrs.append(pci)
                spec = car.devices.add()
                spec.host_path = os.path.join(vfio_dir, group)
                spec.container_path = os.path.join(vfio_dir, group)
                spec.permissions = "rw"
            # the VFIO container node, once per container
            spec = car.devices.add()
            spec.host_path = os.path.join(vfio_dir, "vfio")
            spec.container_path = os.path.join(vfio_dir, "vfio")
            spec.permissions = "rw"
            res_suffix = ctx.resource_name().upper().replace("-", "_")
            car.envs[f"{constants.PCI_RESOURCE_PREFIX}_{res_suffix}"] = ",".join(
                pci_addrs
            )
        return resp

    def get_preferred_allocation(
        self, ctx: DevicePluginContext, req: pluginapi.PreferredAllocationRequest
    ) -> pluginapi.PreferredAllocationResponse:
        # Not advertised in options; kubelet shouldn't call it.  Answer
        # defensively with first-fit.
        resp = pluginapi.PreferredAllocationResponse()
        for creq in req.container_requests:
            ids = first_fit(
                list(creq.available_deviceIDs),
                list(creq.must_include_deviceIDs),
                int(creq.allocation_size),
            )
            resp.container_responses.add(deviceIDs=ids)
        return resp

    def update_health(self, ctx: DevicePluginContext) -> List[pluginapi.Device]:
        devs = self.enumerate(ctx)
        node_health = (
            constants.HEALTHY if self._node_healthy() else constants.UNHEALTHY
        )
        per_func: Dict[str, str] = {}
        if self._health_fn is not None:
            try:
                per_func = self._health_fn()
            except Exception as e:
                log.warning("granular health probe failed: %s", e)
        for dev in devs:
            dev.health = per_func.get(self._health_key(dev.ID), node_health)
        return devs

    def _health_key(self, dev_id: str) -> str:
        """PCI address the health map is keyed by for this device."""
        return self._group_to_pci.get(dev_id, "")

    def _node_healthy(self) -> bool:
        raise NotImplementedError


def _group_key(group: str):
    try:
        return (0, int(group))
    except ValueError:
        return (1, group)


class GpuVfImpl(_VfioImplBase):
    """SR-IOV virtual functions of NVIDIA PFs for VMs (vGPU hosts).  A
    VF's health is its parent PF's; the node is healthy while the nvidia
    host driver is bound."""

    resource_single = constants.DEVICE_TYPE_GPU
    resource_mixed = constants.DEVICE_TYPE_GPU_VF

    def _discover(self) -> None:
        self._vf_mapping = vfio.get_vf_mapping(self._sysfs_root)
        for group, info in self._vf_mapping.items():
            self._group_to_pci[group] = info.pci_address
            self._numa[group] = info.numa_node

    def _node_healthy(self) -> bool:
        return os.path.isdir(os.path.join(
            self._sysfs_root, "bus", "pci", "drivers",
            constants.NVIDIA_DRIVER_NAME))

    def _health_key(self, dev_id: str) -> str:
        # a VF inherits its parent PF's health
        info = self._vf_mapping.get(dev_id)
        return info.pf_pci_address if info else ""


class GpuPfImpl(_VfioImplBase):
    """Whole-GPU passthrough through vfio-pci.  The node is healthy
    while the vfio-pci driver is present."""

    resource_single = constants.DEVICE_TYPE_GPU
    resource_mixed = constants.DEVICE_TYPE_GPU_PF

    def _discover(self) -> None:
        for group, info in vfio.get_pf_mapping(self._sysfs_root).items():
            self._group_to_pci[group] = info.pci_address
            self._numa[group] = info.numa_node

    def _node_healthy(self) -> bool:
        return os.path.isdir(os.path.join(
            self._sysfs_root, "bus", "pci", "drivers",
            constants.VFIO_DRIVER_NAME))
