"""NVIDIA GPU discovery, topology and the container device
implementation: the port's counterpart of the JAX package's ``tpu/``.

The agents read sysfs, ``/proc/driver/nvidia``, ``/dev`` and NVML; none
of them imports torch, so no agent ever creates a CUDA context (one on
every node would take device memory from workloads).
"""

from .discovery import GpuDevice, get_driver_version, get_gpus
from .topology import GPU_SPECS, GpuSpec, GpuTopology

__all__ = [
    "GPU_SPECS",
    "GpuDevice",
    "GpuSpec",
    "GpuTopology",
    "get_driver_version",
    "get_gpus",
]
