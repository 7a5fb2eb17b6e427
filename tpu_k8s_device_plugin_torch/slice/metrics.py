"""Slice observability: the metrics set for multi-host coordination.

The port's copy of the JAX package's ``slice/metrics.py``, with the
same family names, so one dashboard reads either package's slice.  Both
halves (coordinator and per-host client) record into it; on the
rendezvous host the two share the plugin manager's registry, so the one
debug ``/metrics`` scrape answers all of it.

Series:

- ``tpu_slice_join_seconds`` — histogram, client-side: first Join poll
  to adopted membership.
- ``tpu_slice_heartbeat_age_seconds{hostname}`` — gauge, refreshed at
  scrape time: seconds since each member was last heard from
  (coordinator view) / since this host's last successful heartbeat
  (client view).
- ``tpu_slice_membership_transitions_total{kind}`` — counter:
  ``formed``, ``member_unhealthy``, ``member_recovered``,
  ``slice_demoted``, ``slice_recovered`` (coordinator) and
  ``verdict_demoted`` / ``verdict_recovered`` / ``reshape_adopted`` /
  ``evicted`` (client's learned view).
- ``tpu_slice_demotion_propagation_seconds`` — histogram,
  coordinator-side: slice verdict flipping unhealthy -> each member's
  next heartbeat delivering it.
- ``tpu_slice_heartbeats_total`` — heartbeats the coordinator served.
- ``tpu_slice_reshape_total{outcome}`` — counter, coordinator-side:
  ``reshaped``, ``cancelled``, ``grown``, ``no_survivors``.
- ``tpu_slice_reshape_seconds`` — histogram, coordinator-side: reshape
  window opening -> reshaped membership formed.

Both halves accept ``metrics=None`` and stay zero-cost when unmetered.
"""

from __future__ import annotations

from typing import Optional

from .. import obs


class SliceMetrics:
    """The slice instrument set on one registry (see module docstring)."""

    def __init__(self, registry: Optional[obs.Registry] = None) -> None:
        reg = registry if registry is not None else obs.Registry()
        self.registry = reg
        self.join_seconds = reg.histogram(
            "tpu_slice_join_seconds",
            "Time from this host's first Join poll to adopted "
            "membership.", buckets=obs.SLOW_BUCKETS_S)
        self.heartbeat_age = reg.gauge(
            "tpu_slice_heartbeat_age_seconds",
            "Seconds since each slice member was last heard from "
            "(refreshed at scrape time).", ("hostname",))
        self.transitions = reg.counter(
            "tpu_slice_membership_transitions_total",
            "Slice membership and health transitions, by kind.",
            ("kind",))
        self.demotion_propagation = reg.histogram(
            "tpu_slice_demotion_propagation_seconds",
            "Unhealthy slice verdict -> delivery to each member's "
            "next heartbeat.", buckets=obs.LATENCY_BUCKETS_S)
        self.heartbeats = reg.counter(
            "tpu_slice_heartbeats_total",
            "Heartbeats the coordinator has served.")
        self.reshapes = reg.counter(
            "tpu_slice_reshape_total",
            "Degraded-mode reshape window outcomes, by kind.",
            ("outcome",))
        self.reshape_seconds = reg.histogram(
            "tpu_slice_reshape_seconds",
            "Reshape window opening (unhealthy verdict) -> reshaped "
            "membership formed.", buckets=obs.SLOW_BUCKETS_S)

    def transition(self, kind: str) -> None:
        self.transitions.labels(kind=kind).inc()

    def reshape_outcome(self, outcome: str) -> None:
        self.reshapes.labels(outcome=outcome).inc()
