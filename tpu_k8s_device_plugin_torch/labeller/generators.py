"""Label generators: one small function per label key.

The port's counterpart of the JAX package's ``labeller/generators.py``:
the same generator map, validation and dual prefixes, with NVIDIA
content read once per reconcile by discovery (sysfs, ``/proc``, NVML)
and the spec table, and the slice labels from the membership file the
plugin's slice client keeps (:mod:`..slice.state`), as the reference's
are.  ``types/constants.REFERENCE_LABELS`` maps each of the reference's
labels to its counterpart here.
"""

from __future__ import annotations

import logging
import re
import socket
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ..gpu import discovery
from ..gpu.discovery import GpuDevice
from ..slice.state import Membership, load_membership
from ..gpu.topology import GpuTopology
from ..types import constants

# k8s label value rules: <= 63 chars, alphanumeric ends, [-A-Za-z0-9_.]
# in between.
MAX_LABEL_VALUE_LEN = 63
_LABEL_VALUE_RE = re.compile(r"^[A-Za-z0-9]([-A-Za-z0-9_.]*[A-Za-z0-9])?$")


def is_valid_label_value(val: str) -> bool:
    return len(val) <= MAX_LABEL_VALUE_LEN and bool(_LABEL_VALUE_RE.match(val))


log = logging.getLogger(__name__)


def slug(name: str) -> str:
    """A product name as a label value: spaces to ``-``, parentheses
    dropped."""
    return "-".join(name.replace("(", "").replace(")", "").split())


@dataclass
class LabelContext:
    """Inputs every generator works from (one discovery pass)."""

    driver_type: str
    gpus: Dict[str, GpuDevice] = field(default_factory=dict)
    topology: Optional[GpuTopology] = None
    driver_version: str = ""
    # formed multi-host slice membership, from the crash-safe state file
    # the plugin's slice client maintains (absent on single-host nodes)
    slice_membership: Optional[Membership] = None
    hostname: str = ""

    @classmethod
    def collect(
        cls,
        driver_type: str = constants.CONTAINER,
        sysfs_root: str = "/sys",
        dev_root: str = "/dev",
        proc_root: str = "/proc",
        nvml=None,
        slice_state_path: str = constants.SLICE_STATE_FILE,
    ) -> "LabelContext":
        # discovery lists what the nvidia driver drives (a GPU bound to
        # vfio-pci is not this node's container capacity), and only
        # where nothing is bound to it the GPUs the raw PCI scan finds
        # (a passthrough host's)
        gpus, topo = discovery.get_gpus(sysfs_root, dev_root, proc_root,
                                        nvml)
        return cls(
            driver_type=driver_type,
            gpus=gpus,
            topology=topo,
            driver_version=discovery.get_driver_version(
                sysfs_root, proc_root, nvml),
            slice_membership=load_membership(slice_state_path),
            hostname=socket.gethostname(),
        )

    @property
    def first(self) -> Optional[GpuDevice]:
        return next(iter(self.gpus.values()), None)

    @property
    def spec(self):
        return self.topology.spec if self.topology else None


def _mode(ctx: LabelContext) -> str:
    return ctx.driver_type


def _product(ctx: LabelContext) -> str:
    return ctx.spec.product if ctx.spec else ""


def _product_name(ctx: LabelContext) -> str:
    name = ctx.first.name if ctx.first else ""
    if not name and ctx.spec:
        name = ctx.spec.product_name
    return slug(name)


def _device_id(ctx: LabelContext) -> str:
    # "_" separator: "," is not legal in a label value, and one bad value
    # would get the whole merge patch rejected.  Many distinct ids could
    # also blow the 63-char limit, so the join is capped.
    ids = sorted({g.device_id for g in ctx.gpus.values() if g.device_id})
    if len(ids) == 1:
        return ids[0]
    joined = "_".join(ids)
    if len(joined) <= MAX_LABEL_VALUE_LEN:
        return joined
    kept: List[str] = []
    for i in ids:
        tail = f"_and-{len(ids) - len(kept)}-more"
        if len("_".join(kept + [i])) + len(tail) > MAX_LABEL_VALUE_LEN:
            break
        kept.append(i)
    if not kept:
        return f"{len(ids)}-device-ids"
    return "_".join(kept) + f"_and-{len(ids) - len(kept)}-more"


def _count(ctx: LabelContext) -> str:
    return str(len(ctx.gpus)) if ctx.gpus else ""


def _memory(ctx: LabelContext) -> str:
    first = ctx.first
    if first is None or not first.memory_bytes:
        return ""
    return f"{first.memory_bytes // 2 ** 20}Mi"


def _sm_count(ctx: LabelContext) -> str:
    return str(ctx.spec.sm_count) if ctx.spec else ""


def _compute_capability(ctx: LabelContext) -> str:
    return ctx.spec.compute_capability if ctx.spec else ""


def _firmware(ctx: LabelContext) -> str:
    for g in ctx.gpus.values():
        if g.vbios:
            return g.vbios
    return ""


def _driver_version(ctx: LabelContext) -> str:
    return ctx.driver_version


def _nvlink_topology(ctx: LabelContext) -> str:
    return ctx.topology.topology_str if ctx.topology and ctx.gpus else ""


def _partitioning_supported(ctx: LabelContext) -> str:
    if ctx.spec is None:
        return ""
    return "true" if ctx.spec.mig_capable else "false"


def _mig_mode(ctx: LabelContext) -> str:
    modes = {g.mig_mode for g in ctx.gpus.values() if g.mig_mode}
    if not modes:
        return ""
    return "mixed" if len(modes) > 1 else next(iter(modes))


def _slice_rank(ctx: LabelContext) -> str:
    m = ctx.slice_membership
    if m is None:
        return ""
    rank = m.rank_of(ctx.hostname)
    return str(rank) if rank is not None else ""


def _slice_workers(ctx: LabelContext) -> str:
    """Hosts in the current generation: shrinks when a reshape evicts a
    member, the real remaining shape schedulers should place against."""
    m = ctx.slice_membership
    return str(m.num_workers) if m is not None else ""


def _slice_id(ctx: LabelContext) -> str:
    """Rendezvous slice identity: the pod-affinity key that pins a
    multi-host job's pods onto hosts of the same formed slice."""
    m = ctx.slice_membership
    return m.slice_id if m is not None else ""


def _slice_generation(ctx: LabelContext) -> str:
    """Membership generation: bumps whenever the member set changes
    (degraded-mode reshape, evicted member returning)."""
    m = ctx.slice_membership
    return str(m.generation) if m is not None else ""


def _slice_degraded(ctx: LabelContext) -> str:
    """'true' while the slice runs below its configured worker count,
    'false' on a whole slice."""
    m = ctx.slice_membership
    if m is None:
        return ""
    return "true" if m.degraded else "false"


# key -> generator; keys are the SUPPORTED_LABELS flag names
LABEL_GENERATORS: Dict[str, Callable[[LabelContext], str]] = {
    "mode": _mode,
    "product": _product,
    "product-name": _product_name,
    "device-id": _device_id,
    "count": _count,
    "memory": _memory,
    "sm-count": _sm_count,
    "compute-capability": _compute_capability,
    "firmware": _firmware,
    "driver-version": _driver_version,
    "nvlink-topology": _nvlink_topology,
    "partitioning-supported": _partitioning_supported,
    "mig-mode": _mig_mode,
    # the reference reads worker-id and num-workers from its TPU
    # metadata; a GPU node has none, so both come from the membership
    # file, as its slice-* labels do
    "worker-id": _slice_rank,
    "num-workers": _slice_workers,
    "slice-id": _slice_id,
    "slice-rank": _slice_rank,
    "slice-generation": _slice_generation,
    "slice-workers": _slice_workers,
    "slice-degraded": _slice_degraded,
}

assert set(LABEL_GENERATORS) == set(constants.SUPPORTED_LABELS)


def generate_labels(
    ctx: LabelContext, enabled: Optional[List[str]] = None
) -> Dict[str, str]:
    """Fully-qualified label map for the enabled generators, under both
    the primary and the legacy prefix.  Empty values are dropped (absent
    data must not become an empty label), and an invalid value is dropped
    and logged (one would reject the whole merge patch)."""
    keys = enabled if enabled is not None else list(LABEL_GENERATORS)
    out: Dict[str, str] = {}
    for key in keys:
        gen = LABEL_GENERATORS.get(key)
        if gen is None:
            log.warning("unknown label %s; skipping", key)
            continue
        try:
            val = gen(ctx)
        except Exception as e:
            log.error("label generator %s failed: %s", key, e)
            continue
        if not val:
            continue
        if not is_valid_label_value(val):
            log.error("label %s value %r is not a valid k8s label value; "
                      "dropping", key, val)
            continue
        out[f"{constants.LABEL_PREFIX}.{key}"] = val
        out[f"{constants.LABEL_PREFIX_BETA}.{key}"] = val
    return out
