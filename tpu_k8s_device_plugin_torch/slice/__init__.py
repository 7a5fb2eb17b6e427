"""The slice-membership record and its reader: what the fleet
reconciler needs of the JAX package's ``slice/`` (``fleet.
capacity_from_membership`` reads membership state files through it).
The rendezvous state machine, the coordinator and the client come with
the slice coordination of the device-plugin side (ROADMAP.md, queue 1,
item 8.3)."""

from .state import Membership, load_membership

__all__ = ["Membership", "load_membership"]
