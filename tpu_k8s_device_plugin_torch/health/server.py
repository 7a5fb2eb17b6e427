"""gpu-metrics-exporter: the probe daemon the plugin's health client
talks to.

The port's counterpart of the JAX package's ``health/server.py``,
serving the same ``tpuhealth.TpuHealthService`` (either package's client
reads it).  Each probe re-runs discovery, then per GPU:

1. the granular fault reason: a nonzero ``TOTAL_ERR_FATAL`` in the PCI
   function's ``aer_dev_fatal`` (PCIe advanced error reporting), or,
   where NVML is present, a failed row remapping;
2. the device node: a stat-only check of ``/dev/nvidia<minor>``.

It never opens the node and never creates a CUDA context: a probe must
not add driver state to a GPU a workload owns, nor take device memory.
"""

from __future__ import annotations

import concurrent.futures
import errno
import logging
import os
from typing import Dict, Optional

import grpc

from ..gpu import discovery, sysfs
from ..proto import tpuhealth_pb2 as hpb, tpuhealth_pb2_grpc as hpb_grpc
from ..resilience import faults
from ..types import constants

log = logging.getLogger(__name__)

# Probe errnos that mean "the GPU is gone or the driver is broken".  Any
# other error is not a health verdict: EACCES/EPERM say the probe lacks
# privilege, which says nothing about the silicon, and EBUSY would mean
# a workload holds the node.
_DEMOTE_ERRNOS = frozenset({errno.ENOENT, errno.ENXIO, errno.ENODEV,
                            errno.EIO})

_NATIVE = False


def _gpuprobe():
    """The gpuprobe shim, or None (cached; the first call may build it)."""
    global _NATIVE
    if _NATIVE is False:
        try:
            from ..hostinfo import gpuprobe
            gpuprobe.load()
            _NATIVE = gpuprobe
        except ImportError as e:
            log.warning("native gpuprobe unavailable (%s); the health probe "
                        "degrades to access(2) checks", e)
            _NATIVE = None
    return _NATIVE


def _node_present(path: str) -> bool:
    """Does the device node exist for a workload to open?  Stat-only."""
    probe = _gpuprobe()
    if probe is not None:
        rc = probe.probe_device_node(path)
        if rc != -errno.ENOTSUP:
            return rc == 0 or -rc not in _DEMOTE_ERRNOS
        # exists but not a chardev: fixture trees model the nodes as
        # regular files; fall through to the portable check
    return os.path.exists(path) and os.access(path, os.R_OK | os.W_OK)


def read_aer_fatal(pci_path: str) -> Optional[int]:
    """``TOTAL_ERR_FATAL`` of a PCI function's ``aer_dev_fatal``, or None
    when the attribute is absent (AER not enabled) or unparseable."""
    if not pci_path:
        return None
    raw = sysfs.read_file(os.path.join(pci_path,
                                       constants.SYSFS_AER_DEV_FATAL))
    for line in raw.splitlines():
        name, _, count = line.strip().rpartition(" ")
        if name == constants.AER_TOTAL_FATAL:
            try:
                return int(count)
            except ValueError:
                return None
    return None


def granular_health_available(gpus) -> bool:
    """Does any GPU expose ``aer_dev_fatal``?  Without it the fatal-error
    check is off (no sysfs PCI, AER disabled); probe_gpu_states warns once
    per tree and the exporter publishes ``tpu_exporter_granular_health``."""
    return any(read_aer_fatal(g.pci_path) is not None
               for g in gpus.values())


_warned_no_granular: set = set()


def gpu_fault(gpu, nvml_gpu=None) -> Optional[str]:
    """The granular fault reason of a GPU, or None when healthy or when
    the signals are absent (absence is not a verdict)."""
    fatal = read_aer_fatal(gpu.pci_path)
    if fatal:
        return f"{constants.SYSFS_AER_DEV_FATAL} {constants.AER_TOTAL_FATAL}={fatal}"
    if nvml_gpu is not None and nvml_gpu.remapped_rows_failure:
        return "NVML: row remapping failed"
    return None


def probe_gpu_states(
    sysfs_root: str = "/sys", dev_root: str = "/dev",
    proc_root: str = "/proc", nvml=None, gpus=None,
) -> Dict[str, hpb.TpuState]:
    """Probe every GPU: the granular fault reason first (sees a GPU whose
    node is still there), then the device node.  *gpus* skips the
    discovery walk when the caller already ran one."""
    # the chaos hook of the probe itself: `probe:hang:N` models a wedged
    # driver read, `probe:error:p` a probe crash
    if faults.ACTIVE is not None:
        faults.ACTIVE.fire("probe")
    if gpus is None:
        gpus, _ = discovery.get_gpus(sysfs_root, dev_root, proc_root, nvml)
    nvml_by = {}
    if nvml is not None:
        nvml_by = {(g.bus_id or f"{constants.NVIDIA_DEV_PREFIX}{g.minor}"): g
                   for g in nvml.gpus()}
    if (gpus and not granular_health_available(gpus)
            and sysfs_root not in _warned_no_granular):
        _warned_no_granular.add(sysfs_root)
        log.warning(
            "granular health unavailable: no GPU under %s exposes %s; the "
            "fatal-error check is off and health rests on device nodes%s",
            sysfs_root, constants.SYSFS_AER_DEV_FATAL,
            "" if nvml is not None else " (and NVML is absent)")
    states: Dict[str, hpb.TpuState] = {}
    for gpu in gpus.values():
        if gpu.minor < 0:
            # no node to probe: leave it out rather than mask the
            # plugin's own node check
            continue
        fault = gpu_fault(gpu, nvml_by.get(gpu.id))
        if fault is not None:
            log.warning("GPU %s unhealthy: %s", gpu.id, fault)
            healthy = False
        else:
            healthy = _node_present(gpu.dev_path)
        states[gpu.id] = hpb.TpuState(
            id=gpu.id,
            accel_index=gpu.minor,
            health=constants.HEALTHY if healthy else constants.UNHEALTHY,
            device=gpu.dev_path,
        )
    return states


class _Servicer(hpb_grpc.TpuHealthServiceServicer):
    def __init__(self, roots, nvml):
        self._roots = roots
        self._nvml = nvml

    def _probe(self):
        return probe_gpu_states(*self._roots, nvml=self._nvml)

    def GetTpuState(self, request, context):
        state = self._probe().get(request.id)
        if state is None:
            context.abort(grpc.StatusCode.NOT_FOUND,
                          f"unknown GPU {request.id}")
        return hpb.GetTpuStateResponse(state=state)

    def List(self, request, context):
        states = self._probe()
        return hpb.ListTpuStateResponse(
            states=[states[k] for k in sorted(states)])


class GpuHealthServer:
    """Serves the health service on a unix socket."""

    def __init__(
        self,
        socket_path: str = constants.METRICS_EXPORTER_SOCKET,
        sysfs_root: str = "/sys",
        dev_root: str = "/dev",
        proc_root: str = "/proc",
        nvml=None,
    ):
        self.socket_path = socket_path
        self._roots = (sysfs_root, dev_root, proc_root)
        self._nvml = nvml
        self._server: Optional[grpc.Server] = None

    def start(self) -> "GpuHealthServer":
        os.makedirs(os.path.dirname(self.socket_path), exist_ok=True)
        if os.path.exists(self.socket_path):
            os.remove(self.socket_path)
        self._server = grpc.server(
            concurrent.futures.ThreadPoolExecutor(max_workers=4))
        hpb_grpc.add_TpuHealthServiceServicer_to_server(
            _Servicer(self._roots, self._nvml), self._server)
        self._server.add_insecure_port(f"unix://{self.socket_path}")
        self._server.start()
        log.info("gpu-metrics-exporter serving on %s", self.socket_path)
        return self

    def wait(self) -> None:
        if self._server is not None:
            self._server.wait_for_termination()

    def stop(self) -> None:
        if self._server is not None:
            self._server.stop(grace=1.0).wait()
            self._server = None
        if os.path.exists(self.socket_path):
            try:
                os.remove(self.socket_path)
            except OSError:
                pass
