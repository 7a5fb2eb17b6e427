#!/usr/bin/env python3
"""Generate the NVIDIA fixture trees under testdata/nvidia/.

Each tree models one host as the port's node agents read it: the PCI
functions in sysfs (real directories down the bridge chain, with the
``device``-style links of a real sysfs as relative symlinks), the
nvidia driver's binding and module version, ``/proc/driver/nvidia``,
the ``/dev/nvidia*`` nodes (regular files standing in for char
devices), and, where the tree has one, ``nvml.json``: the answers the
tests' fake NVML gives.  README.md beside this script gives the
provenance of each attribute.

Run from the repo root:  python testdata/nvidia/make_fixtures.py
"""

import hashlib
import json
import os
import shutil
import sys
import uuid

HERE = os.path.dirname(os.path.abspath(__file__))
# the JAX package's fixture trees, which the passthrough trees are made from
TESTDATA = os.path.dirname(HERE)

DRIVER_VERSION = "550.54.15"
H100_SXM = dict(device="0x2330", name="NVIDIA H100 80GB HBM3",
                vbios="96.00.99.00.0D", subsystem="0x16c1")
H100_PCIE = dict(device="0x2331", name="NVIDIA H100 PCIe",
                 vbios="96.00.30.00.01", subsystem="0x1626")
# NVML's total for an 80GB H100 (81559 MiB)
MEMORY_TOTAL = 85520809984
NVSWITCH_DEVICE = "0x22a3"

AER_FATAL = ("Undefined", "DLP", "SDES", "TLP", "FCP", "CmpltTO",
             "CmpltAbrt", "UnxCmplt", "RxOF", "MalfTLP", "ECRC", "UnsupReq",
             "ACSViol", "UncorrIntErr", "BlockedTLP", "AtomicOpBlocked",
             "TLPBlockedErr", "PoisonTLPBlocked", "TOTAL_ERR_FATAL")
AER_NONFATAL = AER_FATAL[:-1] + ("TOTAL_ERR_NONFATAL",)
AER_CORRECTABLE = ("RxErr", "BadTLP", "BadDLLP", "Rollover", "Timeout",
                   "NonFatalErr", "CorrIntErr", "HeaderOF",
                   "TOTAL_ERR_COR")


def w(path, content):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        f.write(content if content.endswith("\n") else content + "\n")


def ln(link, target):
    """Relative symlink *link* -> *target* (both absolute here)."""
    os.makedirs(os.path.dirname(link), exist_ok=True)
    if os.path.lexists(link):
        os.remove(link)
    os.symlink(os.path.relpath(target, os.path.dirname(link)), link)


def gpu_uuid(tree, i):
    return "GPU-" + str(uuid.UUID(hashlib.md5(
        f"{tree}/{i}".encode()).hexdigest()))


def pci_function(sys_root, chain, vendor, device, klass, numa,
                 subsystem="0x0000"):
    """Create the PCI function at the end of *chain* (root bus first,
    every bridge a real directory) and its bus/pci/devices link."""
    d = os.path.join(sys_root, "devices", *chain)
    for i in range(1, len(chain) - 1):  # the bridges on the way down
        bridge = os.path.join(sys_root, "devices", *chain[:i + 1])
        w(os.path.join(bridge, "class"), "0x060400")
    w(os.path.join(d, "vendor"), vendor)
    w(os.path.join(d, "device"), device)
    w(os.path.join(d, "class"), klass)
    w(os.path.join(d, "subsystem_vendor"), vendor)
    w(os.path.join(d, "subsystem_device"), subsystem)
    w(os.path.join(d, "numa_node"), str(numa))
    ln(os.path.join(sys_root, "bus", "pci", "devices", chain[-1]), d)
    return d


def make_host(name, gpus, switches=(), nvlinks=None, with_nvml=True,
              mig=None):
    """*gpus*: [(chain, numa, product)] in PCI bus order; *nvlinks*:
    {gpu index: [(link, remote bus id, remote type)]}; *mig*: {gpu index:
    [(gpu instance id, compute instance id, gpu slices, memory MiB)]}, the
    MIG devices of the GPUs with MIG enabled."""
    root = os.path.join(HERE, name)
    if os.path.isdir(root):
        shutil.rmtree(root)
    sys_root = os.path.join(root, "sys")
    drv = os.path.join(sys_root, "bus", "pci", "drivers", "nvidia")
    os.makedirs(drv)
    w(os.path.join(sys_root, "module", "nvidia", "version"), DRIVER_VERSION)
    w(os.path.join(root, "proc", "driver", "nvidia", "version"),
      f"NVRM version: NVIDIA UNIX Open Kernel Module for x86_64  "
      f"{DRIVER_VERSION}  Release Build  (dvs-builder@U16-I3-B03-4-3)  "
      "Tue Mar  5 22:15:33 UTC 2024\n"
      "GCC version:  gcc version 12.3.0 (Ubuntu 12.3.0-1ubuntu1~22.04)")
    for node in ("nvidiactl", "nvidia-uvm", "nvidia-uvm-tools"):
        w(os.path.join(root, "dev", node), "")
    for chain in switches:
        pci_function(sys_root, chain, "0x10de", NVSWITCH_DEVICE, "0x068000",
                     0)
    devices = []
    for i, (chain, numa, product) in enumerate(gpus):
        bus_id = chain[-1]
        d = pci_function(sys_root, chain, "0x10de", product["device"],
                         "0x030200", numa, product["subsystem"])
        for fname, names in (("aer_dev_fatal", AER_FATAL),
                             ("aer_dev_nonfatal", AER_NONFATAL),
                             ("aer_dev_correctable", AER_CORRECTABLE)):
            w(os.path.join(d, fname), "\n".join(f"{n} 0" for n in names))
        group = str(40 + i)
        w(os.path.join(sys_root, "kernel", "iommu_groups", group, "type"),
          "DMA")
        ln(os.path.join(d, "iommu_group"),
           os.path.join(sys_root, "kernel", "iommu_groups", group))
        ln(os.path.join(d, "driver"), drv)
        ln(os.path.join(drv, bus_id), d)
        w(os.path.join(root, "proc", "driver", "nvidia", "gpus", bus_id,
                       "information"),
          f"Model: \t\t {product['name']}\n"
          f"IRQ:   \t\t {180 + i}\n"
          f"GPU UUID: \t {gpu_uuid(name, i)}\n"
          f"Video BIOS: \t {product['vbios']}\n"
          "Bus Type: \t PCIe\n"
          "DMA Size: \t 52 bits\n"
          "DMA Mask: \t 0xfffffffffffff\n"
          f"Bus Location: \t {bus_id}\n"
          f"Device Minor: \t {i}\n"
          "GPU Excluded:\t No")
        w(os.path.join(root, "dev", f"nvidia{i}"), "")
        devices.append({
            "index": i, "minor": i, "bus_id": "0000" + bus_id,
            "uuid": gpu_uuid(name, i), "name": product["name"],
            "memory_total": MEMORY_TOTAL, "vbios": product["vbios"],
            "pci_device_id": product["device"],
            "mig_mode": "enabled" if i in (mig or {}) else "disabled",
            "remapped_rows_failure": False,
            "nvlinks": [{"link": link, "remote": "0000" + remote,
                         "remote_type": kind}
                        for link, remote, kind in (nvlinks or {}).get(i, [])],
        })
        if i in (mig or {}):
            devices[-1]["mig_devices"] = [
                {"index": k, "uuid": "MIG-" + gpu_uuid(name, f"{i}/{gi}/{ci}")
                 [len("GPU-"):], "gpu_instance_id": gi,
                 "compute_instance_id": ci, "gpu_slices": slices,
                 "compute_slices": slices, "memory_mb": memory_mb}
                for k, (gi, ci, slices, memory_mb) in enumerate(mig[i])]
    if mig:
        write_mig_minors(root, len(gpus), mig)
    if with_nvml:
        with open(os.path.join(root, "nvml.json"), "w",
                  encoding="utf-8") as f:
            json.dump({"driver_version": DRIVER_VERSION,
                       "devices": devices}, f, indent=1)
            f.write("\n")
    return root


def h100_sxm_8():
    """An HGX H100 board: 8 SXM5 GPUs, 2 NUMA nodes of 4, 4 PCIe switches
    of 2 GPUs (switches 0 and 1 under one host bridge), 4 NVSwitches that
    every GPU reaches with 18 links (the link map of an HGX H100 GPU)."""
    gpus = []
    layout = (("10", "01", "1", 0), ("10", "02", "2", 0),
              ("90", "01", "9", 1), ("c0", "01", "c", 1))
    for s, (root_bus, port, hi, numa) in enumerate(layout):
        rp = f"0000:{root_bus}:{port}.0"
        up = f"0000:{hi}1:00.0"
        for k in range(2):
            down = f"0000:{hi}2:0{k}.0"
            gpu = f"0000:{hi}{3 + k}:00.0"
            gpus.append(([f"pci0000:{root_bus}", rp, up, down, gpu], numa,
                         H100_SXM))
    switches = [["pci0000:00", "0000:00:02.0", f"0000:0{5 + n}:00.0"]
                for n in range(4)]
    link_switch = {0: "07", 1: "07", 4: "07", 5: "07", 10: "07",
                   2: "06", 3: "06", 6: "06", 7: "06", 11: "06",
                   8: "05", 9: "05", 14: "05", 15: "05",
                   12: "08", 13: "08", 16: "08", 17: "08"}
    links = [(link, f"0000:{sw}:00.0", "switch")
             for link, sw in sorted(link_switch.items())]
    return make_host("h100-sxm-8", gpus, switches,
                     {i: links for i in range(8)})


def h100_pcie_4():
    """Four H100 PCIe cards, 2 per NUMA node (one host bridge each), with
    NVLink bridges on cards 0-1 and 2-3 (12 links a pair)."""
    gpus = []
    for i, (root_bus, numa) in enumerate((("30", 0), ("30", 0),
                                          ("b0", 1), ("b0", 1))):
        rp = f"0000:{root_bus}:0{1 + i % 2}.0"
        gpu = f"0000:{root_bus[0]}{1 + i % 2}:00.0"
        gpus.append(([f"pci0000:{root_bus}", rp, gpu], numa, H100_PCIE))
    bus = [chain[-1] for chain, _, _ in gpus]
    nvlinks = {}
    for a, b in ((0, 1), (2, 3)):
        nvlinks[a] = [(link, bus[b], "gpu") for link in range(12)]
        nvlinks[b] = [(link, bus[a], "gpu") for link in range(12)]
    return make_host("h100-pcie-4", gpus, nvlinks=nvlinks)


def h100_sxm_1():
    """One SXM5 GPU and no NVML: a node whose driver library is absent."""
    gpus = [(["pci0000:10", "0000:10:01.0", "0000:18:00.0"], 0, H100_SXM)]
    return make_host("h100-sxm-1", gpus, with_nvml=False)


def mig_minor(gpu, gi, ci=-1):
    """The capability minor the driver gives a GPU instance (ci -1) or a
    compute instance: numbered in order from 3 (after "config" 1 and
    "monitor" 2), 15 GPU instances a GPU, each followed by its 8
    compute instances."""
    return 3 + gpu * 15 * 9 + gi * 9 + (ci + 1)


def write_mig_minors(root, n_gpus, mig):
    """``/proc/driver/nvidia-caps/mig-minors`` for *n_gpus* GPUs, and the
    ``/dev/nvidia-caps`` nodes of the MIG devices made."""
    lines = ["config 1", "monitor 2"]
    for g in range(n_gpus):
        for gi in range(15):
            lines.append(f"gpu{g}/gi{gi}/access {mig_minor(g, gi)}")
            lines += [f"gpu{g}/gi{gi}/ci{ci}/access {mig_minor(g, gi, ci)}"
                      for ci in range(8)]
    w(os.path.join(root, "proc", "driver", "nvidia-caps", "mig-minors"),
      "\n".join(lines))
    for g, devs in mig.items():
        for gi, ci, _, _ in devs:
            for minor in (mig_minor(g, gi), mig_minor(g, gi, ci)):
                w(os.path.join(root, "dev", "nvidia-caps",
                               f"nvidia-cap{minor}"), "")


def h100_mig_4():
    """The h100-pcie-4 layout with MIG on two cards: 0 and 1 whole, 2
    split into seven 1g.10gb devices (GPU instances 7-13), 3 into two
    3g.40gb (GPU instances 1 and 2), each with compute instance 0 over
    its whole GPU instance.  Memory: 9.75 and 39.25 GiB, as NVML reports
    these profiles on an H100 80GB."""
    gpus = []
    for i, (root_bus, numa) in enumerate((("30", 0), ("30", 0),
                                          ("b0", 1), ("b0", 1))):
        rp = f"0000:{root_bus}:0{1 + i % 2}.0"
        gpu = f"0000:{root_bus[0]}{1 + i % 2}:00.0"
        gpus.append(([f"pci0000:{root_bus}", rp, gpu], numa, H100_PCIE))
    mig = {2: [(gi, 0, 1, 9984) for gi in range(7, 14)],
           3: [(gi, 0, 3, 40192) for gi in (1, 2)]}
    return make_host("h100-mig-4", gpus, mig=mig)


# the JAX package's passthrough trees, and what changes in them: the
# vendor and device ids, the host driver (tpu-vf -> nvidia) and its
# module, and the class of a GPU (a 3D controller); the TPU-only chip
# attributes are dropped
_SWAP_NAMES = {"tpu-vf": "nvidia", "tpu_vf": "nvidia", "tpu": "nvidia"}
_DROP = {"chip_state", "firmware_version", "uncorrectable_errors"}


def from_reference(ref_name, name):
    """``testdata/nvidia/<name>`` made from the JAX package's
    ``testdata/<ref_name>`` with NVIDIA's vendor, device and driver."""
    src = os.path.join(TESTDATA, ref_name)
    root = os.path.join(HERE, name)
    if os.path.isdir(root):
        shutil.rmtree(root)
    for dirpath, dirnames, filenames in os.walk(src):
        rel = os.path.relpath(dirpath, src)
        parts = [] if rel == "." else rel.split(os.sep)
        out_dir = os.path.join(root, *[_SWAP_NAMES.get(p, p) for p in parts])
        os.makedirs(out_dir, exist_ok=True)
        for entry in dirnames + filenames:
            path = os.path.join(dirpath, entry)
            out = os.path.join(out_dir, _SWAP_NAMES.get(entry, entry))
            if os.path.islink(path):
                target = "/".join(_SWAP_NAMES.get(p, p)
                                  for p in os.readlink(path).split("/"))
                os.symlink(target, out)
            elif os.path.isfile(path) and entry not in _DROP:
                with open(path, encoding="utf-8") as f:
                    value = f.read().strip()
                if entry == "vendor":
                    value = "0x10de"
                elif entry == "device":
                    value = H100_SXM["device"]
                elif entry == "class":
                    value = "0x030200"
                elif entry == "version" and "module" in parts:
                    value = DRIVER_VERSION
                elif entry == "srcversion":
                    value = "5B1A9F3C7E2D8A6B4C0E1F2"
                w(out, value)
    return root


def vfio_pf():
    """Four H100s bound to vfio-pci (IOMMU groups 8-11): the JAX
    package's vfio-pf tree with NVIDIA's ids."""
    return from_reference("vfio-pf", "vfio-pf")


def sriov_vf():
    """Two H100 PFs on the nvidia host driver with two SR-IOV VFs each
    (IOMMU groups 100, 101, 108, 109), a vGPU host: the JAX package's
    vfio-vf tree with NVIDIA's ids and driver."""
    return from_reference("vfio-vf", "sriov-vf")


def main():
    for make in (h100_sxm_8, h100_pcie_4, h100_sxm_1, h100_mig_4, vfio_pf,
                 sriov_vf):
        make()
    print("fixtures written under", HERE)


if __name__ == "__main__":
    sys.exit(main())
