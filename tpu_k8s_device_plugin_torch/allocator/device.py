"""Allocator device model and the pairwise weights.

The port's counterpart of the JAX package's ``allocator/device.py``.
A MIG-enabled GPU expands into one device per MIG device, as the
reference's core-partitioned chip expands into one per TensorCore; two
MIG devices of one GPU cost what two cores of one chip cost there.
Between GPUs, the weight of a pair is its link level
(:mod:`..gpu.topology`) on the reference's scale: one NVLink costs what one ICI hop costs there, and
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

# Same scale as the reference's weights: two MIG devices of one GPU
# cost what two cores of one chip do, an NVLink pair one ICI hop, a
# PCIe-only pair 2-4x that.
WEIGHT_SAME_GPU = 5           # two MIG devices of one GPU
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
    """One allocatable device: a whole GPU, or one MIG device of it."""

    id: str                   # kubelet device id
    parent_id: str            # the owning GPU's id
    index: int                # the GPU's discovery order
    numa_node: int = 0
    part_index: int = 0       # the MIG device's index (0 for whole)
    partition_type: str = "gpu"  # resource type: gpu or mig-<profile>

    @property
    def sort_key(self) -> Tuple[int, int]:
        return (self.index, self.part_index)


def devices_from_discovery(
    gpus, partitioned: Optional[bool] = None,
) -> List[AllocDevice]:
    """Expand discovered GPUs (``{id: GpuDevice}``) into allocatable
    devices, in index order.

    A MIG-enabled GPU contributes one device per MIG device (ids
    ``<GPU id>#mig<gi>.<ci>``), a whole GPU itself.  When *partitioned*
    is given, only GPUs of that kind are included (mixed naming runs one
    policy per resource), as in the reference."""
    out: List[AllocDevice] = []
    ordered = sorted(gpus.values(), key=lambda g: (g.index, g.id))
    for ordinal, g in enumerate(ordered):
        if partitioned is not None and g.partitioned != partitioned:
            continue
        if not g.partitioned:
            out.append(AllocDevice(id=g.id, parent_id=g.id, index=ordinal,
                                   numa_node=g.numa_node))
            continue
        for m in g.mig:
            out.append(AllocDevice(
                id=m.id, parent_id=g.id, index=ordinal,
                numa_node=g.numa_node, part_index=m.index,
                partition_type=m.partition_type))
    return out


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
        if a.parent_id == b.parent_id:
            return WEIGHT_SAME_GPU
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
