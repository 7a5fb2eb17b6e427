"""NVIDIA GPU discovery from sysfs, ``/proc/driver/nvidia`` and NVML.

The port's counterpart of the JAX package's ``tpu/discovery.py``.  The
inventory comes from the PCI functions bound to the ``nvidia`` driver
(``/sys/bus/pci/drivers/nvidia/<bus id>``).  Where none is bound, the
raw scan of the PCI bus by vendor (``0x10de``) finds the GPUs bound
elsewhere (``vfio-pci``) as the reference's falls back to its raw scan:
they have no minor and no device node, so the container path skips
them and the passthrough impls (:mod:`.vfio`) serve them.  Each GPU's
minor, UUID, model and VBIOS come from ``/proc/driver/nvidia/gpus/<bus
id>/information`` (parsed by key), its NUMA node from sysfs, and NVML
adds what only the driver knows (memory, NVLinks, MIG mode and MIG
devices) where it is present.  A MIG device's capability minors come
from ``/proc/driver/nvidia-caps/mig-minors``.  A node with no PCI tree
in sysfs at all (a sandboxed container) is inventoried from NVML alone.
Every root is injectable, so the tests run on the fixture trees under
``testdata/nvidia/``.
"""

from __future__ import annotations

import glob
import logging
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..types import constants
from . import sysfs
from .nvml import MigDevice, NvLink, by_bus_id, looks_like_uuid
from .topology import (
    GpuSpec,
    GpuTopology,
    build_topology,
    spec_for_device_id,
    spec_for_name,
)

log = logging.getLogger(__name__)

_BUS_ID_RE = re.compile(r"^[0-9a-f]{4}:[0-9a-f]{2}:[0-9a-f]{2}\.[0-7]$")

# where a GpuDevice's inventory entry came from
SOURCE_SYSFS = "sysfs"  # bound to the nvidia driver in sysfs
SOURCE_NVML = "nvml"    # no PCI tree in sysfs; NVML's inventory
SOURCE_PCI = "pci"      # the raw PCI scan: bound to another driver

# PCI class codes of a GPU function: a VGA or a 3D controller (an
# NVSwitch is a bridge, 0x0680xx, and is not one)
_GPU_CLASSES = ("0x0300", "0x0302")

_MIG_MINOR_RE = re.compile(r"^gpu(\d+)/gi(\d+)(?:/ci(\d+))?/access\s+(\d+)$")


@dataclass(frozen=True)
class MigPartition:
    """One MIG device as the container path serves it: a kubelet device
    of its parent GPU."""

    id: str                   # kubelet device id: <parent id>#mig<gi>.<ci>
    parent_id: str
    index: int                # its index among the parent's MIG devices
    uuid: str = ""            # MIG-...; "" when NVML refused it
    profile: str = ""         # e.g. 1g.10gb
    gpu_instance_id: int = -1
    compute_instance_id: int = -1
    gi_cap_minor: int = -1    # /dev/nvidia-caps/nvidia-cap<minor>
    ci_cap_minor: int = -1

    @property
    def partition_type(self) -> str:
        return constants.DEVICE_TYPE_MIG_PREFIX + self.profile


@dataclass
class GpuDevice:
    """One discovered GPU."""

    id: str                   # kubelet device id: PCI bus id, else nvidia<minor>
    minor: int                # N in /dev/nvidiaN, -1 when unknown
    index: int                # NVML index, else the ordinal by PCI bus id
    pci_address: str = ""     # e.g. 0000:13:00.0; "" when hidden
    device_id: str = ""       # PCI device id, e.g. 0x2330; "" when hidden
    numa_node: int = 0
    uuid: str = ""            # GPU-...; "" when not exposed
    name: str = ""            # the driver's model name
    vbios: str = ""
    memory_bytes: int = 0
    mig_mode: str = ""        # enabled / disabled / "" unsupported
    dev_path: str = ""        # /dev/nvidiaN under the dev root
    pci_path: str = ""        # sysfs realpath of the PCI function
    nvlinks: Tuple[NvLink, ...] = field(default_factory=tuple)
    source: str = SOURCE_SYSFS
    # the MIG devices of a MIG-enabled GPU, in NVML's order
    mig: Tuple[MigPartition, ...] = field(default_factory=tuple)

    @property
    def partitioned(self) -> bool:
        """True for a MIG-enabled GPU: it serves its MIG devices, never
        itself (CUDA cannot use a MIG-enabled GPU whole)."""
        return self.mig_mode == "enabled"

    @property
    def partition_types(self) -> List[str]:
        """The resource type of each device this GPU contributes: "gpu"
        for a whole GPU, ``mig-<profile>`` for each MIG device."""
        if not self.partitioned:
            return [constants.DEVICE_TYPE_GPU]
        return [m.partition_type for m in self.mig]

    @property
    def visible_id(self) -> str:
        """What ``NVIDIA_VISIBLE_DEVICES`` names this GPU by: its UUID,
        else its index (the container runtime takes either)."""
        return self.uuid or str(self.index)

    @property
    def container_path(self) -> str:
        return f"/dev/{constants.NVIDIA_DEV_PREFIX}{self.minor}"


def list_nvidia_bound(sysfs_root: str = "/sys") -> List[Tuple[str, str]]:
    """PCI functions bound to the nvidia driver: [(bus id, realpath)]."""
    drv = os.path.join(sysfs_root, "bus", "pci", "drivers",
                       constants.NVIDIA_DRIVER_NAME)
    out = []
    for entry in sorted(glob.glob(os.path.join(drv, "*"))):
        name = os.path.basename(entry)
        if _BUS_ID_RE.match(name) and os.path.exists(entry):
            out.append((name, os.path.realpath(entry)))
    return out


def list_nvidia_pci(sysfs_root: str = "/sys") -> List[Tuple[str, str]]:
    """The raw scan: NVIDIA GPU functions (vendor 0x10de, a VGA or 3D
    controller class) on the PCI bus whatever their driver, as [(bus id,
    realpath)]."""
    out = []
    pci_dir = os.path.join(sysfs_root, "bus", "pci", "devices")
    for entry in sorted(glob.glob(os.path.join(pci_dir, "*"))):
        if sysfs.read_file(os.path.join(entry, "vendor")) != \
                constants.NVIDIA_VENDOR_ID:
            continue
        if not sysfs.read_file(os.path.join(entry, "class")).startswith(
                _GPU_CLASSES):
            continue
        out.append((os.path.basename(entry), os.path.realpath(entry)))
    return out


def read_mig_minors(proc_root: str = "/proc") -> Dict[Tuple[int, int, int],
                                                       int]:
    """``/proc/driver/nvidia-caps/mig-minors``: {(GPU minor, GPU instance,
    compute instance or -1): capability minor}.  {} when absent."""
    out: Dict[Tuple[int, int, int], int] = {}
    try:
        with open(os.path.join(proc_root, constants.MIG_MINORS_FILE),
                  "r", encoding="utf-8") as f:
            for line in f:
                m = _MIG_MINOR_RE.match(line.strip())
                if m:
                    ci = int(m.group(3)) if m.group(3) is not None else -1
                    out[(int(m.group(1)), int(m.group(2)), ci)] = \
                        int(m.group(4))
    except OSError:
        pass
    return out


def _mig_partitions(gpu_id: str, minor: int, devices: Tuple[MigDevice, ...],
                    minors: Dict[Tuple[int, int, int], int]
                    ) -> Tuple[MigPartition, ...]:
    out = []
    for md in devices:
        gi, ci = md.gpu_instance_id, md.compute_instance_id
        out.append(MigPartition(
            id=f"{gpu_id}#mig{gi}.{ci}",
            parent_id=gpu_id,
            index=md.index,
            uuid=md.uuid if looks_like_uuid(md.uuid) else "",
            profile=md.profile,
            gpu_instance_id=gi,
            compute_instance_id=ci,
            gi_cap_minor=minors.get((minor, gi, -1), -1),
            ci_cap_minor=minors.get((minor, gi, ci), -1)))
    return tuple(out)


def has_pci_tree(sysfs_root: str = "/sys") -> bool:
    return os.path.isdir(os.path.join(sysfs_root, "bus", "pci", "devices"))


def read_information(proc_root: str, bus_id: str) -> Dict[str, str]:
    """``/proc/driver/nvidia/gpus/<bus id>/information``, by key."""
    return sysfs.read_keyed(os.path.join(
        proc_root, "driver", "nvidia", "gpus", bus_id, "information"))


def _int(value: str, default: int = -1) -> int:
    try:
        return int(value)
    except (TypeError, ValueError):
        return default


def get_gpus(
    sysfs_root: str = "/sys",
    dev_root: str = "/dev",
    proc_root: str = "/proc",
    nvml=None,
) -> Tuple[Dict[str, GpuDevice], GpuTopology]:
    """Discover the node's GPUs and their topology.

    Returns ({device id: GpuDevice}, GpuTopology), GPUs in index order.
    Everything downstream (Enumerate, Allocate, health, labels) works
    from this map, so Allocate answers from memory.  *nvml* is an NVML
    source (:mod:`.nvml`) or None.
    """
    nvml_gpus = nvml.gpus() if nvml is not None else []
    nvml_by_bus = by_bus_id(nvml_gpus)
    minors = read_mig_minors(proc_root)
    gpus: List[GpuDevice] = []

    pci = list_nvidia_bound(sysfs_root)
    for ordinal, (bus_id, pci_dir) in enumerate(pci):
        info = read_information(proc_root, bus_id)
        ng = nvml_by_bus.get(bus_id)
        minor = _int(info.get("Device Minor"))
        if minor < 0 and ng is not None:
            minor = ng.minor
        uuid = info.get("GPU UUID", "")
        if not looks_like_uuid(uuid):
            uuid = ng.uuid if ng is not None and looks_like_uuid(ng.uuid) \
                else ""
        gpus.append(GpuDevice(
            id=bus_id,
            minor=minor,
            index=ng.index if ng is not None and ng.index >= 0 else ordinal,
            pci_address=bus_id,
            device_id=sysfs.read_file(os.path.join(pci_dir, "device"))
            or (ng.pci_device_id if ng is not None else ""),
            numa_node=sysfs.numa_node(pci_dir),
            uuid=uuid,
            name=(ng.name if ng is not None and ng.name
                  else info.get("Model", "")),
            vbios=info.get("Video BIOS", "")
            or (ng.vbios if ng is not None else ""),
            memory_bytes=ng.memory_total if ng is not None else 0,
            mig_mode=ng.mig_mode if ng is not None else "",
            dev_path=_dev_path(dev_root, minor),
            pci_path=pci_dir,
            nvlinks=ng.nvlinks if ng is not None else (),
            mig=_mig_partitions(bus_id, minor, ng.mig_devices, minors)
            if ng is not None else (),
        ))

    if not pci:
        # nothing bound to the nvidia driver: the raw scan by vendor
        # finds the GPUs bound elsewhere (vfio-pci on a passthrough
        # host), with no minor and no node, as the reference's raw
        # fallback finds chips off the accel driver
        for ordinal, (bus_id, pci_dir) in enumerate(
                list_nvidia_pci(sysfs_root)):
            gpus.append(GpuDevice(
                id=bus_id,
                minor=-1,
                index=ordinal,
                pci_address=bus_id,
                device_id=sysfs.read_file(os.path.join(pci_dir, "device")),
                numa_node=sysfs.numa_node(pci_dir),
                pci_path=pci_dir,
                source=SOURCE_PCI,
            ))

    if not pci and not has_pci_tree(sysfs_root):
        # no PCI tree at all (a sandboxed container): NVML's inventory is
        # the driver's, so every GPU in it is bound to the nvidia driver
        for ng in nvml_gpus:
            gpus.append(GpuDevice(
                id=ng.bus_id or f"{constants.NVIDIA_DEV_PREFIX}{ng.minor}",
                minor=ng.minor,
                index=ng.index,
                pci_address=ng.bus_id,
                device_id=ng.pci_device_id,
                uuid=ng.uuid if looks_like_uuid(ng.uuid) else "",
                name=ng.name,
                vbios=ng.vbios,
                memory_bytes=ng.memory_total,
                mig_mode=ng.mig_mode,
                dev_path=_dev_path(dev_root, ng.minor),
                nvlinks=ng.nvlinks,
                source=SOURCE_NVML,
                mig=_mig_partitions(
                    ng.bus_id or f"{constants.NVIDIA_DEV_PREFIX}{ng.minor}",
                    ng.minor, ng.mig_devices, minors),
            ))

    gpus.sort(key=lambda g: (g.index, g.id))
    spec = node_spec(gpus)
    for g in gpus:
        if not g.memory_bytes and spec is not None:
            g.memory_bytes = spec.memory_bytes
    return {g.id: g for g in gpus}, build_topology(gpus, spec)


def _dev_path(dev_root: str, minor: int) -> str:
    if minor < 0:
        return ""
    return os.path.join(dev_root, f"{constants.NVIDIA_DEV_PREFIX}{minor}")


def node_spec(gpus) -> Optional[GpuSpec]:
    """The spec-table entry of the node's first GPU: by PCI device id,
    else by the driver's model name (where the ids are hidden)."""
    for g in gpus:
        spec = spec_for_device_id(g.device_id)
        if spec is None:
            hit = spec_for_name(g.name)
            spec = hit[1] if hit else None
        if spec is not None:
            return spec
    return None


def is_homogeneous(gpus: Dict[str, GpuDevice]) -> bool:
    """True when every device the GPUs contribute is of one type: all
    whole GPUs, or MIG devices of one profile (the reference's
    ``is_homogeneous`` over partition modes)."""
    return len(unique_partition_config_count(gpus)) <= 1


def unique_partition_config_count(gpus: Dict[str, GpuDevice]
                                  ) -> Dict[str, int]:
    """GPU count per resource type ("gpu", ``mig-<profile>``), as the
    reference counts chips per partition type: what the mixed naming
    strategy advertises."""
    out: Dict[str, int] = {}
    for g in gpus.values():
        for kind in set(g.partition_types):
            out[kind] = out.get(kind, 0) + 1
    return out


def cap_node(dev_root: str, minor: int) -> str:
    """``/dev/nvidia-caps/nvidia-cap<minor>`` under *dev_root*; "" for
    an unknown minor."""
    if minor < 0:
        return ""
    return os.path.join(dev_root, constants.NVIDIA_CAPS_DIR,
                        f"{constants.NVIDIA_CAP_PREFIX}{minor}")


def control_nodes(dev_root: str = "/dev") -> List[Tuple[str, str]]:
    """The control nodes present under *dev_root*, as (host path,
    container path) pairs: every CUDA container opens them once."""
    out = []
    for name in constants.CONTROL_DEVICE_NODES:
        path = os.path.join(dev_root, name)
        if os.path.exists(path):
            out.append((path, f"/dev/{name}"))
    return out


def get_driver_version(sysfs_root: str = "/sys", proc_root: str = "/proc",
                       nvml=None) -> str:
    """The nvidia kernel module's version: ``/sys/module/nvidia/version``,
    else NVML's, else ``/proc/driver/nvidia/version``."""
    ver = sysfs.read_file(os.path.join(sysfs_root, "module",
                                       constants.NVIDIA_DRIVER_NAME,
                                       "version"))
    if ver:
        return ver
    if nvml is not None:
        ver = nvml.driver_version()
        if ver:
            return ver
    text = sysfs.read_file(os.path.join(proc_root, "driver", "nvidia",
                                        "version"))
    m = re.search(r"Kernel Module\b.*?\s(\d+\.\d+(?:\.\d+)?)\s", text)
    return m.group(1) if m else ""
