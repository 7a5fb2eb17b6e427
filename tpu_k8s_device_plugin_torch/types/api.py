"""DeviceImpl: the contract between the plugin adapter and a device
implementation, and the per-resource plugin context.

The port's own copy of the JAX package's ``types/api.py``: the same
seven methods and ``rediscover``.  Each kubelet RPC on the plugin
adapter delegates to exactly one DeviceImpl method; one DeviceImpl may
back several resource names, told apart by the context.
"""

from __future__ import annotations

import abc
from typing import TYPE_CHECKING, List, Optional

if TYPE_CHECKING:  # hints only; avoids an import cycle
    from ..allocator.allocator import Policy
    from ..proto import deviceplugin_pb2 as pluginapi


class DevicePluginContext:
    """Per-resource state handed to every DeviceImpl call: the resource
    name this plugin instance serves, the preferred-allocation policy,
    and a sticky flag recording that the policy failed to initialise (in
    which case GetPreferredAllocation degrades to first fit)."""

    def __init__(self, resource_name: str,
                 allocator: Optional["Policy"] = None):
        self._resource_name = resource_name
        self._allocator = allocator
        self._allocator_error = False

    def resource_name(self) -> str:
        return self._resource_name

    def get_allocator(self) -> Optional["Policy"]:
        return self._allocator

    def set_allocator_error(self, err: bool) -> None:
        self._allocator_error = err

    def get_allocator_error(self) -> bool:
        return self._allocator_error


class DeviceImpl(abc.ABC):
    """Device implementation interface.  The port has one:
    ``gpu.device_impl.GpuContainerImpl`` (containers through the nvidia
    driver's ``/dev/nvidia*`` nodes)."""

    @abc.abstractmethod
    def start(self, ctx: DevicePluginContext) -> None:
        """Called after plugin init and before registration."""

    @abc.abstractmethod
    def get_resource_names(self) -> List[str]:
        """Resource names (without namespace) this impl advertises."""

    @abc.abstractmethod
    def get_options(self, ctx: DevicePluginContext
                    ) -> "pluginapi.DevicePluginOptions":
        """Device plugin options for the resource."""

    @abc.abstractmethod
    def enumerate(self, ctx: DevicePluginContext
                  ) -> List["pluginapi.Device"]:
        """Devices of the resource, with their NUMA topology hints."""

    @abc.abstractmethod
    def allocate(self, ctx: DevicePluginContext,
                 req: "pluginapi.AllocateRequest"
                 ) -> "pluginapi.AllocateResponse":
        """Device nodes, mounts and env for each container of a request."""

    @abc.abstractmethod
    def get_preferred_allocation(
        self, ctx: DevicePluginContext,
        req: "pluginapi.PreferredAllocationRequest",
    ) -> "pluginapi.PreferredAllocationResponse":
        """Topology-preferred device subset for an admission request."""

    @abc.abstractmethod
    def update_health(self, ctx: DevicePluginContext
                      ) -> List["pluginapi.Device"]:
        """The device list re-probed, with Healthy/Unhealthy states."""

    def rediscover(self) -> bool:
        """Re-enumerate the hardware; True when the advertised devices or
        resources changed (the manager then re-diffs resources and
        re-inits allocators).  Default: static hardware."""
        return False
