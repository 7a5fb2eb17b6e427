"""Crash-safe slice membership, the reading half: the ``Membership``
record and ``load_membership``.

The port's own minimal copy of the JAX package's ``slice/state.py``
(the port imports nothing of that package): the record with the fields,
``to_dict`` / ``from_dict`` and the version check of the reference, so
that a state file the slice agent wrote reads here as it reads there.
The writer, the rendezvous state machine and its reshape logic are not
copied: the fleet reconciler only reads membership files.
"""

from __future__ import annotations

import json
import logging
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

log = logging.getLogger(__name__)

_STATE_VERSION = 1


@dataclass(frozen=True)
class Membership:
    """The agreed slice: hostnames indexed by rank + coordinator address.

    ``reshaped_from`` is the degraded-mode lineage: the slice_ids of the
    generations this one was reshaped (or re-grown) from, oldest first —
    empty for a first formation.  ``degraded`` is true while the slice
    runs below its configured worker count."""

    slice_id: str
    generation: int
    hostnames: Tuple[str, ...]
    coordinator_address: str
    reshaped_from: Tuple[str, ...] = ()
    degraded: bool = False

    @property
    def num_workers(self) -> int:
        return len(self.hostnames)

    def rank_of(self, hostname: str) -> Optional[int]:
        try:
            return self.hostnames.index(hostname)
        except ValueError:
            return None

    def to_dict(self) -> Dict[str, Any]:
        return {
            "version": _STATE_VERSION,
            "slice_id": self.slice_id,
            "generation": self.generation,
            "hostnames": list(self.hostnames),
            "coordinator_address": self.coordinator_address,
            "reshaped_from": list(self.reshaped_from),
            "degraded": self.degraded,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Membership":
        return cls(
            slice_id=str(d["slice_id"]),
            generation=int(d["generation"]),
            hostnames=tuple(str(h) for h in d["hostnames"]),
            coordinator_address=str(d.get("coordinator_address", "")),
            # absent in pre-reshape state files: loads as a first formation
            reshaped_from=tuple(
                str(s) for s in d.get("reshaped_from", ())),
            degraded=bool(d.get("degraded", False)),
        )


def load_membership(path: str) -> Optional[Membership]:
    """Load a persisted membership; None when absent or unreadable (a
    corrupt file means re-forming, not crashing the plugin)."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            d = json.load(f)
    except OSError:
        return None
    except ValueError as e:
        log.warning("corrupt slice state file %s (%s); ignoring", path, e)
        return None
    try:
        if int(d.get("version", 0)) != _STATE_VERSION:
            log.warning("slice state file %s has unknown version %r",
                        path, d.get("version"))
            return None
        return Membership.from_dict(d)
    except (KeyError, TypeError, ValueError) as e:
        log.warning("malformed slice state file %s (%s); ignoring", path, e)
        return None
