"""The slice-membership record and its reader: what the fleet
reconciler needs of the JAX package's ``slice/`` (``fleet.
capacity_from_membership`` reads membership state files through it).
The rendezvous state machine, the coordinator and the client stay with
the device-plugin side of the port (ROADMAP.md, queue 1, item 8)."""

from .state import Membership, load_membership

__all__ = ["Membership", "load_membership"]
