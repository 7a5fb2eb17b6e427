"""VFIO discovery for VM-passthrough GPU hosts.

The port's counterpart of the JAX package's ``tpu/vfio.py``: scan
``/sys/bus/pci/devices`` for NVIDIA functions (vendor ``0x10de``),
resolve their driver binding and IOMMU groups, and key devices by IOMMU
group (the unit VFIO hands a VM):

- a PF host binds whole GPUs to ``vfio-pci``;
- a VF host (vGPU with SR-IOV) keeps its PFs on the ``nvidia`` host
  driver and passes their virtual functions (``virtfn*``) through.
"""

from __future__ import annotations

import glob
import logging
import os
from dataclasses import dataclass
from typing import Dict

from ..types import constants
from . import sysfs

log = logging.getLogger(__name__)


@dataclass(frozen=True)
class VfInfo:
    """One virtual function exposed for VM passthrough."""

    pci_address: str      # VF PCI address (DBDF)
    pf_pci_address: str   # parent physical function
    iommu_group: str      # device id reported to kubelet
    numa_node: int = 0


@dataclass(frozen=True)
class PfInfo:
    """One physical function bound to vfio-pci for whole-GPU passthrough."""

    pci_address: str
    iommu_group: str
    numa_node: int = 0


def _nvidia_functions(sysfs_root: str):
    pci_dir = os.path.join(sysfs_root, "bus", "pci", "devices")
    for dev_dir in sorted(glob.glob(os.path.join(pci_dir, "*"))):
        if sysfs.read_file(os.path.join(dev_dir, "vendor")) \
                == constants.NVIDIA_VENDOR_ID:
            yield dev_dir


def get_vf_mapping(sysfs_root: str = "/sys") -> Dict[str, VfInfo]:
    """IOMMU group -> VfInfo for every VF of an NVIDIA PF bound to the
    nvidia host driver."""
    out: Dict[str, VfInfo] = {}
    for pf_dir in _nvidia_functions(sysfs_root):
        if sysfs.driver_name(pf_dir) != constants.NVIDIA_DRIVER_NAME:
            continue
        pf_addr = os.path.basename(os.path.realpath(pf_dir))
        for vf_link in sorted(glob.glob(os.path.join(pf_dir, "virtfn*"))):
            vf_dir = os.path.realpath(vf_link)
            vf_addr = os.path.basename(vf_dir)
            group = sysfs.iommu_group(vf_dir)
            if not group:
                log.warning("VF %s has no IOMMU group; skipping", vf_addr)
                continue
            out[group] = VfInfo(
                pci_address=vf_addr,
                pf_pci_address=pf_addr,
                iommu_group=group,
                numa_node=sysfs.numa_node(vf_dir),
            )
    return out


def get_pf_mapping(sysfs_root: str = "/sys") -> Dict[str, PfInfo]:
    """IOMMU group -> PfInfo for every NVIDIA PF bound to vfio-pci."""
    out: Dict[str, PfInfo] = {}
    for dev_dir in _nvidia_functions(sysfs_root):
        if sysfs.driver_name(dev_dir) != constants.VFIO_DRIVER_NAME:
            continue
        addr = os.path.basename(os.path.realpath(dev_dir))
        group = sysfs.iommu_group(dev_dir)
        if not group:
            log.warning("PF %s has no IOMMU group; skipping", addr)
            continue
        out[group] = PfInfo(pci_address=addr, iommu_group=group,
                            numa_node=sysfs.numa_node(dev_dir))
    return out


def get_nvidia_module_versions(sysfs_root: str = "/sys") -> Dict[str, str]:
    """The nvidia host driver's module version and srcversion."""
    out: Dict[str, str] = {}
    base = os.path.join(sysfs_root, "module", constants.NVIDIA_DRIVER_NAME)
    ver = sysfs.read_file(os.path.join(base, "version"))
    src = sysfs.read_file(os.path.join(base, "srcversion"))
    if ver:
        out["version"] = ver
    if src:
        out["srcversion"] = src
    return out
