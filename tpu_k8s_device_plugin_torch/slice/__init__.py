"""Multi-host slice coordination: rendezvous, rank assignment, health.

The port's counterpart of the JAX package's ``slice/``.  A training job
that spans hosts needs every worker to agree on ranks, hostnames and a
coordinator address before ``torch.distributed`` can initialise
(``proto/slice.proto``), and one faulty GPU stalls the collectives of
every rank, so health must reach every member's kubelet, not just the
faulty host's.

Three layers:

- :mod:`.state` — the pure rendezvous state machine (deterministic ranks,
  crash-safe membership file, degraded-mode reshape with a bounded grace
  window and ``reshaped_from`` lineage across generations), fuzzable
  without gRPC or a clock; the fleet reconciler and
  ``workloads.checkpoint.ReshapeSignal`` read its membership files;
- :mod:`.server` — the coordinator, serving ``SliceRendezvous`` for the
  whole slice from one member;
- :mod:`.client` — per-host join (retries + exponential backoff),
  heartbeat, eviction and rejoin across reshapes, and the
  ``torch.distributed`` env contract Allocate gives containers.

None of them imports torch: they run inside the node agents.
"""

from .client import SliceClient
from .metrics import SliceMetrics
from .server import SliceCoordinator
from .state import (
    Membership,
    SliceState,
    load_membership,
    save_membership,
)

__all__ = [
    "Membership",
    "SliceClient",
    "SliceCoordinator",
    "SliceMetrics",
    "SliceState",
    "load_membership",
    "save_membership",
]
