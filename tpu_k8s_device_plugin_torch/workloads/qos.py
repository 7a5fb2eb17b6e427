# tpulint: deterministic-path -- WFQ/quota decisions are replayed by the QoS suites; D1 bans bare random here (time.monotonic is the bucket clock by design)
"""Tenant QoS primitives shared by the serving replica AND the router.

``TenantQuota`` (a token bucket over estimated tokens plus a WFQ
weight) started life inside ``workloads.server``; the router tier
needs the identical bucket semantics for GLOBAL quota enforcement —
a tenant spread evenly over N replicas used to get RATE x N because
each replica's bucket was its own little world.  The router cannot
import ``server`` (that module pulls in torch at import time; the
router runs on 1-vCPU sidecars), so the primitives live here:
stdlib + nothing, importable from both sides, mypy --strict.

The grammar is shared too: ``name=rate[:burst[:weight]]``, repeatable,
with ``*`` as the template for unknown tenants (each unknown tenant
gets its OWN bucket cloned from the template — shared state would let
one tenant drain another's budget).

The port's own copy of the JAX package's ``workloads/qos.py`` (the port
imports nothing of that package): the same calls give the same
results.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, Optional

__all__ = ["TenantQuota", "parse_tenant_quotas", "resolve_quota"]


class TenantQuota:
    """Per-tenant QoS config: a token-rate budget (token bucket over
    ESTIMATED tokens — prompt + requested budget — charged at
    admission) and a WFQ weight.  ``rate <= 0`` disables the bucket
    (weight-only tenants); ``weight`` scales the tenant's share of
    the admission heap under contention."""

    __slots__ = ("rate", "burst", "weight", "tokens", "stamp",
                 "_last_vft")

    def __init__(self, rate: float, burst: Optional[float] = None,
                 weight: float = 1.0):
        if weight <= 0:
            raise ValueError("tenant weight must be > 0")
        self.rate = float(rate)
        self.burst = float(burst if burst is not None
                           else max(rate, 1.0))
        self.weight = float(weight)
        self.tokens = self.burst       # bucket starts full
        self.stamp = time.monotonic()
        self._last_vft = 0.0           # WFQ backlog marker

    def try_charge(self, cost: float) -> bool:
        """Refill-then-charge; False = over quota (shed with 429)."""
        if self.rate <= 0:
            return True
        now = time.monotonic()
        self.tokens = min(self.burst,
                          self.tokens + (now - self.stamp) * self.rate)
        self.stamp = now
        if self.tokens < cost:
            return False
        self.tokens -= cost
        return True


def parse_tenant_quotas(
        specs: Optional[Iterable[str]]) -> Dict[str, TenantQuota]:
    """``name=rate[:burst[:weight]]`` (repeatable; name ``*`` is the
    default for unknown tenants) -> {name: TenantQuota}."""
    out: Dict[str, TenantQuota] = {}
    for spec in specs or ():
        name, _, rest = spec.partition("=")
        if not name or not rest:
            raise ValueError(
                f"bad --tenant-quota {spec!r} (want "
                "name=rate[:burst[:weight]])")
        parts = rest.split(":")
        if len(parts) > 3:
            raise ValueError(f"bad --tenant-quota {spec!r}")
        rate = float(parts[0])
        burst = float(parts[1]) if len(parts) > 1 else None
        weight = float(parts[2]) if len(parts) > 2 else 1.0
        out[name] = TenantQuota(rate, burst, weight)
    return out


def resolve_quota(quotas: Dict[str, TenantQuota],
                  tenant: str) -> Optional[TenantQuota]:
    """Per-tenant QoS state out of *quotas*; the ``*`` spec is a
    TEMPLATE — each unknown tenant gets its own bucket and WFQ chain
    cloned from it.  The caller holds whatever lock guards *quotas*
    (both the server's admission path and the router's route path
    call this under their own lock)."""
    q = quotas.get(tenant)
    if q is None:
        d = quotas.get("*")
        if d is None:
            return None
        q = TenantQuota(d.rate, d.burst, d.weight)
        quotas[tenant] = q
    return q
