"""Policy interface and the kubelet-default selection (the port's copy of
the JAX package's ``allocator/allocator.py``)."""

from __future__ import annotations

import abc
from typing import TYPE_CHECKING, List, Optional, Sequence

if TYPE_CHECKING:
    from ..gpu.topology import GpuTopology
    from .device import AllocDevice


class AllocationError(Exception):
    """Raised when a preferred allocation cannot be computed; the plugin
    surfaces it to the kubelet, which falls back to default allocation."""


def first_fit(
    available_ids: Sequence[str],
    required_ids: Sequence[str],
    size: int,
) -> List[str]:
    """Kubelet-default selection: required ids first, then available ones
    in order until *size*.  The degraded answer when no topology-aware
    policy is usable."""
    ids = list(required_ids)
    for dev_id in available_ids:
        if len(ids) >= size:
            break
        if dev_id not in ids:
            ids.append(dev_id)
    return ids[:size]


class Policy(abc.ABC):
    """Preferred-allocation policy: precompute weights at init, answer
    admission-time subset queries from memory only."""

    @abc.abstractmethod
    def init(
        self,
        devices: Sequence["AllocDevice"],
        topology: Optional["GpuTopology"] = None,
    ) -> None:
        """Build the pairwise weight table for *devices*."""

    @abc.abstractmethod
    def allocate(
        self,
        available_ids: Sequence[str],
        required_ids: Sequence[str],
        size: int,
    ) -> List[str]:
        """Pick *size* device ids from *available_ids* including all
        *required_ids*, minimising total pairwise weight."""
