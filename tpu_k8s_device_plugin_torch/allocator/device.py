"""Allocator device model and the pairwise weights.

The port's counterpart of the JAX package's ``allocator/device.py``.
The weight of a pair is its link level (:mod:`..gpu.topology`) on the
reference's scale: one NVLink costs what one ICI hop costs there, and
PCIe-only pairs cost what the reference's PCIe/NUMA fallback charges,
with a PCIe switch and a host bridge below the same-NUMA figure.
Without topology data the weights are exactly the reference's
PCIe/NUMA ones.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from ..gpu import topology as topo_mod
from ..gpu.topology import GpuTopology

# Same scale as the reference's weights: an NVLink pair costs one ICI
# hop, a PCIe-only pair 2-4x that.
WEIGHT_NVLINK = 10            # NVLink between the two GPUs
WEIGHT_NUMA_PENALTY = 2       # added to an NVLink pair across NUMA nodes
WEIGHT_PCIE_SWITCH = 14       # below one PCIe switch
WEIGHT_HOST_BRIDGE = 17       # one host bridge
WEIGHT_PCIE_SAME_NUMA = 20    # one NUMA node
WEIGHT_PCIE_DIFF_NUMA = 40    # across NUMA nodes

LEVEL_WEIGHTS = {
    topo_mod.LEVEL_NVLINK: WEIGHT_NVLINK,
    topo_mod.LEVEL_PCIE_SWITCH: WEIGHT_PCIE_SWITCH,
    topo_mod.LEVEL_HOST_BRIDGE: WEIGHT_HOST_BRIDGE,
    topo_mod.LEVEL_NUMA: WEIGHT_PCIE_SAME_NUMA,
    topo_mod.LEVEL_SYSTEM: WEIGHT_PCIE_DIFF_NUMA,
}


@dataclass(frozen=True)
class AllocDevice:
    """One allocatable device: a whole GPU (MIG instances come with
    ROADMAP item 8.2, as children of their GPU's ``parent_id``)."""

    id: str                   # kubelet device id
    parent_id: str            # the owning GPU's id
    index: int                # the GPU's discovery order
    numa_node: int = 0

    @property
    def sort_key(self) -> Tuple[int, int]:
        return (self.index, 0)


def devices_from_discovery(gpus) -> List[AllocDevice]:
    """Allocatable devices of discovered GPUs (``{id: GpuDevice}``), in
    index order."""
    ordered = sorted(gpus.values(), key=lambda g: (g.index, g.id))
    return [AllocDevice(id=g.id, parent_id=g.id, index=ordinal,
                        numa_node=g.numa_node)
            for ordinal, g in enumerate(ordered)]


class WeightModel:
    """Precomputed pairwise weights between devices."""

    def __init__(
        self,
        devices: Sequence[AllocDevice],
        topology: Optional[GpuTopology] = None,
    ):
        self.devices = list(devices)
        self.by_id: Dict[str, AllocDevice] = {d.id: d for d in devices}
        self.topology = topology
        self._weights: Dict[Tuple[str, str], int] = {}
        for a, b in itertools.combinations(self.devices, 2):
            w = self._pair_weight(a, b)
            self._weights[(a.id, b.id)] = w
            self._weights[(b.id, a.id)] = w

    def level(self, a: AllocDevice, b: AllocDevice) -> int:
        topo = self.topology
        if topo is not None and a.parent_id in topo.numa \
                and b.parent_id in topo.numa:
            return topo.link_level(a.parent_id, b.parent_id)
        return (topo_mod.LEVEL_NUMA if a.numa_node == b.numa_node
                else topo_mod.LEVEL_SYSTEM)

    def _pair_weight(self, a: AllocDevice, b: AllocDevice) -> int:
        level = self.level(a, b)
        w = LEVEL_WEIGHTS[level]
        if level == topo_mod.LEVEL_NVLINK and a.numa_node != b.numa_node:
            w += WEIGHT_NUMA_PENALTY
        return w

    def weight(self, a_id: str, b_id: str) -> int:
        if a_id == b_id:
            return 0
        return self._weights[(a_id, b_id)]

    def set_weight(self, subset: Iterable[str]) -> int:
        ids = list(subset)
        return sum(
            self.weight(x, y) for x, y in itertools.combinations(ids, 2))


def group_by_parent(
    devices: Iterable[AllocDevice],
) -> Dict[str, List[AllocDevice]]:
    """Devices grouped by owning GPU."""
    out: Dict[str, List[AllocDevice]] = {}
    for d in devices:
        out.setdefault(d.parent_id, []).append(d)
    for devs in out.values():
        devs.sort(key=lambda d: d.sort_key)
    return out
