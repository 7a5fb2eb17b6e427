"""The port's constants: the slice names its workloads share with the
JAX package's agents, and the NVIDIA node agents' resource names, paths,
environment and labels.

The slice membership file, the generation variable and the rendezvous
port keep the reference's values: the membership file is the slice
agent's contract with a workload and with the labeller, so either
package reads what the other writes.  The rest of the container's slice
env is ``torch.distributed``'s (``REFERENCE_SLICE_ENV``).  The
device-plugin names follow the JAX package's ``types/constants.py`` with
NVIDIA values where they name the hardware.
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

# gRPC port of the slice rendezvous (the reference's, so one coordinator
# serves members of either package).
SLICE_RENDEZVOUS_PORT = 8475

# Port of the workload's torch.distributed store on rank 0's host: the
# coordinator address is ``<rank 0's hostname>:<port>``, as the
# reference's is with its JAX coordinator port (8476); 29500 is
# torch.distributed's and torchrun's default MASTER_PORT.
SLICE_MASTER_PORT = 29500

# Heartbeat period of each member, and the silence after which the
# coordinator counts a member unhealthy (the reference's values).
SLICE_HEARTBEAT_PERIOD_S = 5.0
SLICE_HEARTBEAT_TIMEOUT_S = 30.0

# Degraded-mode reshape grace: 0 keeps demote-all (an unhealthy member
# demotes every member until it recovers); > 0 evicts members still
# unhealthy after that many seconds and re-forms the survivors under
# the next generation.
SLICE_RESHAPE_GRACE_S = 0.0

# The slice env a full-host grant carries: the names torch.distributed's
# env:// initialisation and torchrun read (Kubeflow's PyTorchJob sets
# the same), one process a host as in the reference.
ENV_MASTER_ADDR = "MASTER_ADDR"
ENV_MASTER_PORT = "MASTER_PORT"
ENV_WORLD_SIZE = "WORLD_SIZE"
ENV_RANK = "RANK"
ENV_PET_NNODES = "PET_NNODES"
ENV_PET_NODE_RANK = "PET_NODE_RANK"
# every member's hostname by rank, comma-separated
ENV_SLICE_WORKER_HOSTNAMES = "SLICE_WORKER_HOSTNAMES"

# Each variable of the reference's slice env (its ``SliceClient.
# slice_env``) and the port's variables that carry the same value.
REFERENCE_SLICE_ENV = {
    "JAX_COORDINATOR_ADDRESS": (ENV_MASTER_ADDR, ENV_MASTER_PORT),
    "JAX_NUM_PROCESSES": (ENV_WORLD_SIZE, ENV_PET_NNODES),
    "JAX_PROCESS_ID": (ENV_RANK, ENV_PET_NODE_RANK),
    "TPU_WORKER_ID": (ENV_RANK, ENV_PET_NODE_RANK),
    "TPU_WORKER_HOSTNAMES": (ENV_SLICE_WORKER_HOSTNAMES,),
    "TPU_SLICE_GENERATION": (ENV_TPU_SLICE_GENERATION,),
}

# ---------------------------------------------------------------------------
# Node labels (one bool flag per entry in the labeller CLI).
# ---------------------------------------------------------------------------
SUPPORTED_LABELS = [
    "mode",                    # container, vf-passthrough or pf-passthrough
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
    "worker-id",               # this host's rank in the slice
    "num-workers",             # hosts in the slice
    "slice-id",                # the slice's content hash
    "slice-rank",              # this host's rank in the slice
    "slice-generation",        # the membership generation
    "slice-workers",           # hosts in the current generation
    "slice-degraded",          # true while the slice runs short of hosts
]

# Each label of the JAX package's labeller and its counterpart here.
REFERENCE_LABELS = {
    "mode": "mode",
    "accelerator-type": "product",
    "topology": "nvlink-topology",
    "chips-per-host": "count",
    "cores-per-chip": "sm-count",
    "worker-id": "worker-id",
    "num-workers": "num-workers",
    "firmware": "firmware",
    "driver-version": "driver-version",
    "device-id": "device-id",
    "product-name": "product-name",
    "hbm": "memory",
    "partitioning-supported": "partitioning-supported",
    "core-partition": "mig-mode",
    "slice-id": "slice-id",
    "slice-rank": "slice-rank",
    "slice-generation": "slice-generation",
    "slice-workers": "slice-workers",
    "slice-degraded": "slice-degraded",
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

# Resource names: whole GPUs are "gpu"; under the mixed strategy a MIG
# device is "mig-<profile>" (e.g. mig-1g.10gb) and a passthrough
# function "gpu_vf" / "gpu_pf", as the reference's tpu_vf / tpu_pf.
DEVICE_TYPE_MIG_PREFIX = "mig-"
DEVICE_TYPE_GPU_VF = "gpu_vf"
DEVICE_TYPE_GPU_PF = "gpu_pf"

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

# MIG: a MIG device's node is its parent GPU's /dev/nvidia<minor> plus
# the capability nodes of its GPU instance and compute instance,
# /dev/nvidia-caps/nvidia-cap<minor>, whose minors the driver lists in
# /proc/driver/nvidia-caps/mig-minors ("gpu<G>/gi<I>/access <minor>",
# "gpu<G>/gi<I>/ci<C>/access <minor>").
NVIDIA_CAPS_DIR = "nvidia-caps"
NVIDIA_CAP_PREFIX = "nvidia-cap"
MIG_MINORS_FILE = "driver/nvidia-caps/mig-minors"

# VM passthrough: PFs bound to vfio-pci, or the SR-IOV VFs of PFs the
# nvidia host driver keeps (vGPU hosts), keyed by IOMMU group; a VM's
# container gets /dev/vfio/<group> and /dev/vfio/vfio, and the PCI
# addresses in PCI_RESOURCE_NVIDIA_COM_<RESOURCE> (KubeVirt's
# convention, the reference's PCI_RESOURCE_GOOGLE_COM).
VFIO_DRIVER_NAME = "vfio-pci"
VFIO_DEV_DIR = "vfio"
PCI_RESOURCE_PREFIX = "PCI_RESOURCE_NVIDIA_COM"

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
ENV_SLICE_RESHAPE_GRACE = "TPU_DP_SLICE_RESHAPE_GRACE_S"

# Flight recorder: the directory the event journal is dumped to on
# exit/SIGTERM (off unless set).
ENV_FLIGHT_RECORD_DIR = "TPU_DP_FLIGHT_RECORD_DIR"

# Incident bundles written when a page-severity alert fires (off unless
# set).
ENV_INCIDENT_DIR = "TPU_DP_INCIDENT_DIR"
