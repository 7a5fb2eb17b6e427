"""NVML: the NVIDIA driver's management library, as an optional overlay.

A ctypes binding to ``libnvidia-ml.so.1`` (:class:`Nvml`) and a stand-in
that answers from a JSON file (:class:`NvmlFixture`, the tests'
``testdata/nvidia/*/nvml.json``), behind one small interface: the driver
version, and per GPU its index, minor, PCI bus id, UUID, name, memory,
VBIOS, MIG mode, active NVLinks with their remote ends, and whether row
remapping has failed.  NVML plays the part libdrm and hwloc play in the
AMD plugin the reference was modelled on; it is not a kernel library,
and it creates no CUDA context.

Discovery, health and the labeller take the source as an argument, so a
test substitutes the fixture; :func:`load` gives the real library, or
None (logged once) where it is absent.  A sandbox may answer some calls
and refuse others (PCI information, the real UUID): every field is
optional, and a refused call leaves it empty.
"""

from __future__ import annotations

import ctypes
import json
import logging
import re
import threading
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple

log = logging.getLogger(__name__)

LIBRARY = "libnvidia-ml.so.1"
NVML_SUCCESS = 0
NVLINK_MAX_LINKS = 18
_BUFFER = 96
# nvmlIntNvLinkDeviceType_t
_REMOTE_TYPES = {0: "gpu", 1: "ibmnpu", 2: "switch"}

_UUID_RE = re.compile(
    r"^(GPU|MIG)-[0-9a-fA-F]{8}(-[0-9a-fA-F]{4}){3}-[0-9a-fA-F]{12}$")


def looks_like_uuid(value: str) -> bool:
    """True for a well-formed ``GPU-xxxxxxxx-...`` identifier (a sandbox's
    NVML may answer a placeholder such as ``GPU-REDACTED``)."""
    return bool(_UUID_RE.match(value or ""))


def normalize_bus_id(bus_id: str) -> str:
    """``00000000:3B:00.0`` (NVML's spelling) -> ``0000:3b:00.0`` (sysfs's).
    "" stays ""."""
    s = (bus_id or "").strip().lower()
    if not s:
        return ""
    domain, sep, rest = s.partition(":")
    if not sep:
        return s
    if len(domain) > 4:
        domain = domain[-4:]
    return f"{domain.zfill(4)}:{rest}"


@dataclass(frozen=True)
class NvLink:
    """One active NVLink and what is at its other end."""

    link: int
    remote_bus_id: str          # normalized PCI bus id of the remote end
    remote_type: str = "gpu"    # "gpu", "switch" or "unknown"


@dataclass(frozen=True)
class NvmlGpu:
    """What NVML says of one GPU.  Empty fields: NVML refused the call."""

    index: int
    minor: int = -1
    bus_id: str = ""
    uuid: str = ""
    name: str = ""
    memory_total: int = 0
    vbios: str = ""
    pci_device_id: str = ""     # e.g. "0x2330"
    mig_mode: str = ""          # "enabled", "disabled", "" unsupported
    nvlinks: Tuple[NvLink, ...] = field(default_factory=tuple)
    remapped_rows_failure: bool = False


class NvmlError(RuntimeError):
    pass


class _PciInfo(ctypes.Structure):
    # nvmlPciInfo_t
    _fields_ = [("busIdLegacy", ctypes.c_char * 16),
                ("domain", ctypes.c_uint),
                ("bus", ctypes.c_uint),
                ("device", ctypes.c_uint),
                ("pciDeviceId", ctypes.c_uint),
                ("pciSubSystemId", ctypes.c_uint),
                ("busId", ctypes.c_char * 32)]


class _Memory(ctypes.Structure):
    # nvmlMemory_t
    _fields_ = [("total", ctypes.c_ulonglong),
                ("free", ctypes.c_ulonglong),
                ("used", ctypes.c_ulonglong)]


_P = ctypes.POINTER
_HANDLE = ctypes.c_void_p
_UINT = ctypes.c_uint
# every NVML call the binding makes, with its argument types (each
# returns an nvmlReturn_t, an int)
_SIGNATURES = {
    "nvmlInit_v2": [],
    "nvmlSystemGetDriverVersion": [ctypes.c_char_p, _UINT],
    "nvmlDeviceGetCount_v2": [_P(_UINT)],
    "nvmlDeviceGetHandleByIndex_v2": [_UINT, _P(_HANDLE)],
    "nvmlDeviceGetHandleByPciBusId_v2": [ctypes.c_char_p, _P(_HANDLE)],
    "nvmlDeviceGetIndex": [_HANDLE, _P(_UINT)],
    "nvmlDeviceGetMinorNumber": [_HANDLE, _P(_UINT)],
    "nvmlDeviceGetPciInfo_v3": [_HANDLE, _P(_PciInfo)],
    "nvmlDeviceGetUUID": [_HANDLE, ctypes.c_char_p, _UINT],
    "nvmlDeviceGetName": [_HANDLE, ctypes.c_char_p, _UINT],
    "nvmlDeviceGetVbiosVersion": [_HANDLE, ctypes.c_char_p, _UINT],
    "nvmlDeviceGetMemoryInfo": [_HANDLE, _P(_Memory)],
    "nvmlDeviceGetMigMode": [_HANDLE, _P(_UINT), _P(_UINT)],
    "nvmlDeviceGetNvLinkState": [_HANDLE, _UINT, _P(_UINT)],
    "nvmlDeviceGetNvLinkRemotePciInfo_v2": [_HANDLE, _UINT, _P(_PciInfo)],
    "nvmlDeviceGetNvLinkRemoteDeviceType": [_HANDLE, _UINT,
                                            _P(ctypes.c_int)],
    "nvmlDeviceGetRemappedRows": [_HANDLE] + [_P(_UINT)] * 4,
}


class Nvml:
    """ctypes binding to the driver's NVML library (initialised once)."""

    def __init__(self, library: str = LIBRARY):
        try:
            self._lib = ctypes.CDLL(library)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(self._lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        except (OSError, AttributeError) as e:
            raise NvmlError(f"cannot load {library}: {e}") from e
        rc = self._lib.nvmlInit_v2()
        if rc != NVML_SUCCESS:
            raise NvmlError(f"nvmlInit_v2 returned {rc}")

    # -- plumbing -----------------------------------------------------------

    def _string(self, fn, *args) -> str:
        buf = ctypes.create_string_buffer(_BUFFER)
        if fn(*args, buf, _BUFFER) != NVML_SUCCESS:
            return ""
        return buf.value.decode(errors="replace")

    def _uint(self, fn, *args) -> Optional[int]:
        out = ctypes.c_uint()
        if fn(*args, ctypes.byref(out)) != NVML_SUCCESS:
            return None
        return out.value

    # -- the interface ------------------------------------------------------

    def driver_version(self) -> str:
        return self._string(self._lib.nvmlSystemGetDriverVersion)

    def count(self) -> int:
        n = self._uint(self._lib.nvmlDeviceGetCount_v2)
        return n or 0

    def gpus(self) -> List[NvmlGpu]:
        """Every GPU NVML sees, by index."""
        out = []
        for index in range(self.count()):
            handle = ctypes.c_void_p()
            if self._lib.nvmlDeviceGetHandleByIndex_v2(
                    ctypes.c_uint(index),
                    ctypes.byref(handle)) == NVML_SUCCESS:
                out.append(self._describe(handle, index))
        return out

    def gpu_by_bus_id(self, bus_id: str) -> Optional[NvmlGpu]:
        """The GPU at a PCI bus id, or None when NVML does not know it."""
        handle = ctypes.c_void_p()
        if self._lib.nvmlDeviceGetHandleByPciBusId_v2(
                bus_id.encode(), ctypes.byref(handle)) != NVML_SUCCESS:
            return None
        index = self._uint(self._lib.nvmlDeviceGetIndex, handle)
        gpu = self._describe(handle, -1 if index is None else index)
        if not gpu.bus_id:
            gpu = replace(gpu, bus_id=normalize_bus_id(bus_id))
        return gpu

    def _describe(self, handle, index: int) -> NvmlGpu:
        lib = self._lib
        minor = self._uint(lib.nvmlDeviceGetMinorNumber, handle)
        pci = _PciInfo()
        bus_id = dev_id = ""
        if lib.nvmlDeviceGetPciInfo_v3(handle,
                                       ctypes.byref(pci)) == NVML_SUCCESS:
            bus_id = normalize_bus_id(pci.busId.decode())
            dev_id = f"0x{pci.pciDeviceId >> 16:04x}"
        mem = _Memory()
        total = (mem.total if lib.nvmlDeviceGetMemoryInfo(
            handle, ctypes.byref(mem)) == NVML_SUCCESS else 0)
        current, pending = ctypes.c_uint(), ctypes.c_uint()
        mig = ""
        if lib.nvmlDeviceGetMigMode(handle, ctypes.byref(current),
                                    ctypes.byref(pending)) == NVML_SUCCESS:
            mig = "enabled" if current.value else "disabled"
        links = []
        for link in range(NVLINK_MAX_LINKS):
            state = self._uint(lib.nvmlDeviceGetNvLinkState, handle,
                               ctypes.c_uint(link))
            if not state:
                continue
            remote = _PciInfo()
            rc = lib.nvmlDeviceGetNvLinkRemotePciInfo_v2(
                handle, ctypes.c_uint(link), ctypes.byref(remote))
            kind = ctypes.c_int(-1)
            lib.nvmlDeviceGetNvLinkRemoteDeviceType(
                handle, ctypes.c_uint(link), ctypes.byref(kind))
            links.append(NvLink(
                link=link,
                remote_bus_id=(normalize_bus_id(remote.busId.decode())
                               if rc == NVML_SUCCESS else ""),
                remote_type=_REMOTE_TYPES.get(kind.value, "unknown")))
        corr, unc, pend, failed = (ctypes.c_uint() for _ in range(4))
        remap_failed = (lib.nvmlDeviceGetRemappedRows(
            handle, ctypes.byref(corr), ctypes.byref(unc),
            ctypes.byref(pend), ctypes.byref(failed)) == NVML_SUCCESS
            and failed.value != 0)
        return NvmlGpu(
            index=index,
            minor=-1 if minor is None else minor,
            bus_id=bus_id,
            uuid=self._string(lib.nvmlDeviceGetUUID, handle),
            name=self._string(lib.nvmlDeviceGetName, handle),
            memory_total=total,
            vbios=self._string(lib.nvmlDeviceGetVbiosVersion, handle),
            pci_device_id=dev_id,
            mig_mode=mig,
            nvlinks=tuple(links),
            remapped_rows_failure=remap_failed,
        )


class NvmlFixture:
    """NVML's answers read from a JSON file: ``{"driver_version": ...,
    "devices": [{"index", "minor", "bus_id", "uuid", "name",
    "memory_total", "vbios", "pci_device_id", "mig_mode",
    "remapped_rows_failure", "nvlinks": [{"link", "remote",
    "remote_type"}]}]}``.  Re-read on every call, so a test can edit it
    to model a failing GPU."""

    def __init__(self, path: str):
        self.path = path
        self._read()  # fail now on a bad file

    def _read(self) -> dict:
        with open(self.path, "r", encoding="utf-8") as f:
            return json.load(f)

    def driver_version(self) -> str:
        return self._read().get("driver_version", "")

    def gpus(self) -> List[NvmlGpu]:
        return [_gpu_from_json(d) for d in self._read().get("devices", [])]

    def gpu_by_bus_id(self, bus_id: str) -> Optional[NvmlGpu]:
        want = normalize_bus_id(bus_id)
        for gpu in self.gpus():
            if gpu.bus_id == want:
                return gpu
        return None


def _gpu_from_json(d: dict) -> NvmlGpu:
    return NvmlGpu(
        index=int(d.get("index", -1)),
        minor=int(d.get("minor", -1)),
        bus_id=normalize_bus_id(d.get("bus_id", "")),
        uuid=d.get("uuid", ""),
        name=d.get("name", ""),
        memory_total=int(d.get("memory_total", 0)),
        vbios=d.get("vbios", ""),
        pci_device_id=d.get("pci_device_id", ""),
        mig_mode=d.get("mig_mode", ""),
        nvlinks=tuple(
            NvLink(link=int(x["link"]),
                   remote_bus_id=normalize_bus_id(x.get("remote", "")),
                   remote_type=x.get("remote_type", "gpu"))
            for x in d.get("nvlinks", [])),
        remapped_rows_failure=bool(d.get("remapped_rows_failure", False)),
    )


_warned_absent = False
_warn_lock = threading.Lock()


def load(fixture_path: str = "", library: str = LIBRARY):
    """The NVML source for an agent: the fixture at *fixture_path* when
    one is given, else the driver's library, else None, logged once per
    process (discovery then works from sysfs and ``/proc`` alone, and the
    exporter publishes ``tpu_exporter_nvml_available 0``)."""
    global _warned_absent
    if fixture_path:
        return NvmlFixture(fixture_path)
    try:
        return Nvml(library)
    except NvmlError as e:
        with _warn_lock:
            if not _warned_absent:
                _warned_absent = True
                log.warning("NVML unavailable (%s): no NVLink topology, "
                            "MIG mode or remapped-row health", e)
        return None


def by_bus_id(gpus: List[NvmlGpu]) -> Dict[str, NvmlGpu]:
    return {g.bus_id: g for g in gpus if g.bus_id}
