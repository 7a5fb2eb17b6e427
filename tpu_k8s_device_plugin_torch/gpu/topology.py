"""GPU topology: the spec table, link levels between two GPUs, and the
NVLink cliques of a node.

The port's counterpart of the JAX package's ``tpu/topology.py``.  Where
the TPU model reads ICI grid coordinates from host metadata, a GPU node
is described by two graphs: NVLink (from NVML: direct GPU-to-GPU links,
or links into a shared NVSwitch fabric) and the PCI tree (from the sysfs
realpath of each GPU).  Their meeting point is the *link level* of a
pair, the ordering ``nvidia-smi topo -m`` prints:

    NVLINK < PIX (same PCIe switch) < PHB (same host bridge)
           < NODE (same NUMA node) < SYS (across NUMA nodes)

and NVLink *cliques*, the connected components of the NVLink graph, take
the place of ICI sub-meshes: a grant inside one clique runs its
collectives over NVLink.
"""

from __future__ import annotations

import collections
import os
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

_GIB = 1024 ** 3
_TFLOPS = 1e12


@dataclass(frozen=True)
class GpuSpec:
    """Static properties of one product, keyed by PCI device id."""

    product: str              # label-safe product, e.g. H100-SXM5-80GB
    product_name: str         # the driver's model name
    memory_bytes: int         # device memory as sold
    sm_count: int
    compute_capability: str
    peak_bf16_flops: float    # dense bf16 tensor-core peak
    mig_capable: bool
    source: str               # where these numbers come from


# PCI device id -> spec.  Device ids: the PCI ID repository (pci.ids,
# vendor 10de: 2330 "GH100 [H100 SXM5 80GB]", 2331 "GH100 [H100 PCIe]").
# SM counts: NVIDIA H100 Tensor Core GPU Architecture whitepaper (132 SMs
# on SXM5, 114 on PCIe).  Memory and dense bf16 peaks: NVIDIA H100 Tensor
# Core GPU datasheet (989 TFLOP/s SXM5, 756 TFLOP/s PCIe; the sheet's
# larger figures are with sparsity).  Both are MIG-capable (up to 7
# instances).
GPU_SPECS: Dict[str, GpuSpec] = {
    "0x2330": GpuSpec("H100-SXM5-80GB", "NVIDIA H100 80GB HBM3",
                      80 * _GIB, 132, "9.0", 989 * _TFLOPS, True,
                      "pci.ids 10de:2330; H100 whitepaper; H100 datasheet"),
    "0x2331": GpuSpec("H100-PCIe-80GB", "NVIDIA H100 PCIe",
                      80 * _GIB, 114, "9.0", 756 * _TFLOPS, True,
                      "pci.ids 10de:2331; H100 whitepaper; H100 datasheet"),
}


def spec_for_device_id(device_id: str) -> Optional[GpuSpec]:
    return GPU_SPECS.get((device_id or "").lower())


def spec_for_name(name: str) -> Optional[Tuple[str, GpuSpec]]:
    """(device id, spec) whose driver model name is *name*: how a node
    whose PCI ids are hidden (a sandboxed container) finds its spec."""
    for device_id, spec in GPU_SPECS.items():
        if spec.product_name == (name or "").strip():
            return device_id, spec
    return None


# Link levels, closest first (nvidia-smi topo -m's names beside them).
LEVEL_NVLINK = 1       # NV#
LEVEL_PCIE_SWITCH = 2  # PIX / PXB: below one PCIe switch
LEVEL_HOST_BRIDGE = 3  # PHB: one host bridge (root complex)
LEVEL_NUMA = 4         # NODE: one NUMA node
LEVEL_SYSTEM = 5       # SYS: across NUMA nodes


def pci_level(path_a: str, path_b: str) -> Optional[int]:
    """Level of the deepest common PCI ancestor of two PCI functions,
    from their sysfs realpaths (``.../devices/pci0000:10/0000:10:01.0/
    ...``); None when either path is unknown.  Sharing a root port or a
    deeper bridge means one PCIe switch; sharing only the root bus, one
    host bridge."""
    if not path_a or not path_b:
        return None
    a, b = _pci_chain(path_a), _pci_chain(path_b)
    common = 0
    for x, y in zip(a[:-1], b[:-1]):
        if x != y:
            break
        common += 1
    if common >= 2:
        return LEVEL_PCIE_SWITCH
    if common == 1:
        return LEVEL_HOST_BRIDGE
    return None


def _pci_chain(path: str) -> List[str]:
    """The components of a PCI realpath from its root bus (``pci0000:10``)
    down to the function itself."""
    parts = os.path.normpath(path).split(os.sep)
    for i, p in enumerate(parts):
        if p.startswith("pci") and ":" in p:
            return parts[i:]
    return parts


@dataclass
class GpuTopology:
    """The node's GPU topology, keyed by kubelet device id."""

    spec: Optional[GpuSpec] = None
    pci_paths: Dict[str, str] = field(default_factory=dict)
    numa: Dict[str, int] = field(default_factory=dict)
    nvlink_counts: Dict[Tuple[str, str], int] = field(default_factory=dict)
    cliques: List[Tuple[str, ...]] = field(default_factory=list)

    def nvlink_count(self, a: str, b: str) -> int:
        """NVLinks a collective between *a* and *b* can use (0: none)."""
        return self.nvlink_counts.get(_pair(a, b), 0)

    def link_level(self, a: str, b: str) -> int:
        """The closest path between two GPUs of the node."""
        if self.nvlink_count(a, b) > 0:
            return LEVEL_NVLINK
        level = pci_level(self.pci_paths.get(a, ""), self.pci_paths.get(b, ""))
        if level is not None:
            return level
        return (LEVEL_NUMA if self.numa.get(a, 0) == self.numa.get(b, 0)
                else LEVEL_SYSTEM)

    def clique_of(self, gpu_id: str) -> int:
        """Index of the NVLink clique holding *gpu_id* (-1: unknown)."""
        for i, members in enumerate(self.cliques):
            if gpu_id in members:
                return i
        return -1

    @property
    def largest_clique(self) -> int:
        return max((len(c) for c in self.cliques), default=0)

    @property
    def topology_str(self) -> str:
        """NVLink cliques x their size, e.g. ``1x8``, ``2x2``, ``4x1``
        (``1x2_2x1`` when sizes differ, largest first)."""
        sizes = collections.Counter(len(c) for c in self.cliques)
        return "_".join(f"{n}x{size}" for size, n in
                        sorted(sizes.items(), key=lambda kv: -kv[0]))


def _pair(a: str, b: str) -> Tuple[str, str]:
    return (a, b) if a <= b else (b, a)


def nvlink_counts(gpus: Sequence) -> Dict[Tuple[str, str], int]:
    """NVLinks between each pair of *gpus* (objects with ``id``,
    ``pci_address`` and ``nvlinks``): direct GPU-to-GPU links, plus, for
    two GPUs wired into the same NVSwitches, the links each has into
    those switches (the smaller count)."""
    out: Dict[Tuple[str, str], int] = {}
    switches = {g.id: collections.Counter(
        l.remote_bus_id for l in g.nvlinks
        if l.remote_type == "switch" and l.remote_bus_id) for g in gpus}
    for i, a in enumerate(gpus):
        for b in gpus[i + 1:]:
            # a direct link is seen from both ends: count it once
            direct = max(_links_to(a, b), _links_to(b, a))
            shared = set(switches[a.id]) & set(switches[b.id])
            via = min(sum(switches[a.id][s] for s in shared),
                      sum(switches[b.id][s] for s in shared)) if shared else 0
            if direct + via:
                out[_pair(a.id, b.id)] = direct + via
    return out


def _links_to(a, b) -> int:
    """Direct NVLinks from GPU *a* to GPU *b*, as *a*'s NVML reports."""
    return sum(1 for l in a.nvlinks if l.remote_type == "gpu"
               and b.pci_address and l.remote_bus_id == b.pci_address)


def cliques(ids: Iterable[str],
            counts: Dict[Tuple[str, str], int]) -> List[Tuple[str, ...]]:
    """Connected components of the NVLink graph over *ids*, in the order
    of their first member; singletons for GPUs without NVLink."""
    order = list(ids)
    parent = {i: i for i in order}

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for (a, b), n in counts.items():
        if n > 0 and a in parent and b in parent:
            parent[find(a)] = find(b)
    groups: Dict[str, List[str]] = {}
    for i in order:
        groups.setdefault(find(i), []).append(i)
    return [tuple(g) for g in groups.values()]


def build_topology(gpus: Sequence, spec: Optional[GpuSpec] = None
                   ) -> GpuTopology:
    """The topology of *gpus* (discovery's ``GpuDevice`` objects, in
    index order)."""
    gpus = list(gpus)
    counts = nvlink_counts(gpus)
    return GpuTopology(
        spec=spec,
        pci_paths={g.id: g.pci_path for g in gpus if g.pci_path},
        numa={g.id: g.numa_node for g in gpus},
        nvlink_counts=counts,
        cliques=cliques([g.id for g in gpus], counts),
    )
