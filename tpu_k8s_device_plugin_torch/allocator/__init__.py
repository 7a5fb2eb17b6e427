"""Topology-aware preferred-allocation policies.

The port's counterpart of the JAX package's ``allocator/``: the same
Policy contract, validation and best-effort pairwise-weight search, with
weights from GPU link levels (NVLink, PCIe switch, host bridge, NUMA)
instead of ICI hops, and "one NVLink clique first" in place of
"contiguous sub-mesh first".
"""

from .allocator import AllocationError, Policy, first_fit
from .besteffort import BestEffortPolicy
from .device import AllocDevice, WeightModel, devices_from_discovery

__all__ = [
    "AllocationError",
    "AllocDevice",
    "BestEffortPolicy",
    "Policy",
    "WeightModel",
    "devices_from_discovery",
    "first_fit",
]
