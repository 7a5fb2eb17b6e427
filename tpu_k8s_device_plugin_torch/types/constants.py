"""The port's constants: the slice names its workloads share with the
JAX package's agents, and the NVIDIA node agents' resource names, paths,
environment and labels.

The two slice names keep the reference's values: the slice membership
file and the generation variable are the slice agent's contract with a
workload, so the port reads what the agent writes.  The device-plugin
names follow the JAX package's ``types/constants.py`` with NVIDIA
values where they name the hardware.
"""

# ---------------------------------------------------------------------------
# Slice names shared with the reference's slice agent.
# ---------------------------------------------------------------------------

# Membership generation a container's slice identity belongs to; a
# workload compares it with the live membership file
# (workloads.checkpoint.ReshapeSignal) to see that the slice reshaped
# under it and a checkpoint-restart is due.
ENV_TPU_SLICE_GENERATION = "TPU_SLICE_GENERATION"

# Crash-safe membership file the slice agent keeps current on the host.
SLICE_STATE_FILE = "/var/lib/tpu-slice/membership.json"

# ---------------------------------------------------------------------------
# Node labels (one bool flag per entry in the labeller CLI).
# ---------------------------------------------------------------------------
SUPPORTED_LABELS = [
    "mode",                    # container (passthrough modes: item 8.2)
    "product",                 # spec-table product, e.g. H100-SXM5-80GB
    "product-name",            # the driver's model name, e.g. NVIDIA-H100-80GB-HBM3
    "device-id",               # PCI device id, e.g. 0x2330
    "count",                   # GPUs on the node
    "memory",                  # device memory per GPU, MiB
    "sm-count",                # streaming multiprocessors per GPU
    "compute-capability",      # e.g. 9.0
    "firmware",                # VBIOS version
    "driver-version",          # nvidia kernel module version
    "nvlink-topology",         # NVLink cliques x size, e.g. 1x8, 2x2, 4x1
    "partitioning-supported",  # MIG-capable
    "mig-mode",                # enabled / disabled / mixed
]

# Each label of the JAX package's labeller and its counterpart here, or
# the ROADMAP item that brings it (queue 1, item 8).
REFERENCE_LABELS = {
    "mode": "mode",
    "accelerator-type": "product",
    "topology": "nvlink-topology",
    "chips-per-host": "count",
    "cores-per-chip": "sm-count",
    "worker-id": "later item 8.3 (slice coordination)",
    "num-workers": "later item 8.3 (slice coordination)",
    "firmware": "firmware",
    "driver-version": "driver-version",
    "device-id": "device-id",
    "product-name": "product-name",
    "hbm": "memory",
    "partitioning-supported": "partitioning-supported",
    "core-partition": "mig-mode",
    "slice-id": "later item 8.3 (slice coordination)",
    "slice-rank": "later item 8.3 (slice coordination)",
    "slice-generation": "later item 8.3 (slice coordination)",
    "slice-workers": "later item 8.3 (slice coordination)",
    "slice-degraded": "later item 8.3 (slice coordination)",
}

# Label prefixes, mirroring the reference's primary and legacy beta
# prefixes.
LABEL_PREFIX = "nvidia.com/gpu"
LABEL_PREFIX_BETA = "beta.nvidia.com/gpu"

# ---------------------------------------------------------------------------
# Command-line values.
# ---------------------------------------------------------------------------
RESOURCE_NAMING_STRATEGY_SINGLE = "single"
RESOURCE_NAMING_STRATEGY_MIXED = "mixed"

CONTAINER = "container"
VF_PASSTHROUGH = "vf-passthrough"
PF_PASSTHROUGH = "pf-passthrough"

# ROADMAP items (queue 1) that bring what the port's agents refuse today.
ITEM_PASSTHROUGH = "8.2"
ITEM_SLICE = "8.3"

# ---------------------------------------------------------------------------
# NVIDIA hardware.
# ---------------------------------------------------------------------------

# NVIDIA's PCI vendor id.
NVIDIA_VENDOR_ID = "0x10de"

# The kernel driver: its PCI binding is /sys/bus/pci/drivers/nvidia, its
# module /sys/module/nvidia, its per-GPU information
# /proc/driver/nvidia/gpus/<bus id>/information.
NVIDIA_DRIVER_NAME = "nvidia"

# Device nodes: /dev/nvidia<minor> (char major 195) per GPU, and the
# control nodes every CUDA container opens once.
NVIDIA_DEV_PREFIX = "nvidia"
NVIDIA_CHAR_MAJOR = 195
CONTROL_DEVICE_NODES = ("nvidiactl", "nvidia-uvm", "nvidia-uvm-tools")

# PCIe advanced error reporting: the fatal-error counters of a device
# (one "NAME count" line each, TOTAL_ERR_FATAL last).
SYSFS_AER_DEV_FATAL = "aer_dev_fatal"
AER_TOTAL_FATAL = "TOTAL_ERR_FATAL"

# Resource namespace and device type reported to the kubelet.
RESOURCE_NAMESPACE = "nvidia.com"
DEVICE_TYPE_GPU = "gpu"

# Environment the container runtime reads to expose the allocated GPUs
# (UUIDs, else NVML indices).  CUDA_VISIBLE_DEVICES is not set: inside
# the container CUDA numbers only the nodes it can open.
ENV_NVIDIA_VISIBLE_DEVICES = "NVIDIA_VISIBLE_DEVICES"
ENV_CUDA_VISIBLE_DEVICES = "CUDA_VISIBLE_DEVICES"

# Exporter health check timeout, seconds.
EXPORTER_HEALTH_CHECK_TIMEOUT_S = 10.0

# Watchdog deadline for one whole granular health probe: a probe wedged
# past this is abandoned and the impl demotes every device until a
# probe succeeds again.  Exceeds EXPORTER_HEALTH_CHECK_TIMEOUT_S.
PROBE_WATCHDOG_TIMEOUT_S = 15.0

# Unix socket of the companion gpu-metrics-exporter daemon.  It serves
# the reference's health service (tpuhealth.TpuHealthService), so either
# package's client reads either package's exporter.
METRICS_EXPORTER_SOCKET = (
    "/var/lib/gpu-metrics-exporter/gpu_device_metrics_exporter_grpc.socket"
)

# TCP port of the exporter's Prometheus /metrics endpoint (0 disables).
METRICS_HTTP_PORT = 9400

# ---------------------------------------------------------------------------
# Kubelet device-plugin API (k8s.io/kubelet/pkg/apis/deviceplugin/v1beta1).
# ---------------------------------------------------------------------------
KUBELET_DP_VERSION = "v1beta1"
DEVICE_PLUGIN_PATH = "/var/lib/kubelet/device-plugins/"
HEALTHY = "Healthy"
UNHEALTHY = "Unhealthy"

# ---------------------------------------------------------------------------
# Operations: env overrides of the CLI flags, shared with the reference.
# ---------------------------------------------------------------------------
ENV_SLICE_RENDEZVOUS = "TPU_DP_SLICE_RENDEZVOUS"
ENV_SLICE_WORKERS = "TPU_DP_SLICE_WORKERS"

# Flight recorder: the directory the event journal is dumped to on
# exit/SIGTERM (off unless set).
ENV_FLIGHT_RECORD_DIR = "TPU_DP_FLIGHT_RECORD_DIR"

# Incident bundles written when a page-severity alert fires (off unless
# set).
ENV_INCIDENT_DIR = "TPU_DP_INCIDENT_DIR"
