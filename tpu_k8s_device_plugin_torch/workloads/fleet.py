# tpulint: deterministic-path
"""Autoscaling fleet control plane: the reconciler that closes the loop
between the node agents' capacity labels and the serving tier.

The device plugin advertises chips, the labeller advertises slice shape
(``slice-generation`` / ``slice-workers`` / ``slice-degraded``), replicas
self-register with the router, and the router aggregates per-class
goodput and pressure at ``/fleet/statz`` — but none of those components
*acts*.  This module is the missing controller: a labeller-idiom
observe→decide→act loop that

- **observes** the router's fleet snapshot (queue/KV pressure, per-class
  goodput ratio + burn rate, shed counts) and node capacity (slice
  labels read from membership state files, or a ``--capacity-spec``
  JSON file for environments without a coordinator);
- **decides** through a pure, seeded state machine
  (:class:`FleetPlanner`) with hysteresis and cooldown so the loop
  cannot flap: scale out on sustained pressure or a burning SLO, scale
  in on sustained calm, scale to zero on sustained idle, replace dead
  replicas immediately, and drain + re-register replicas whose slice
  reshaped to a new generation;
- **acts** by driving real replica CLI subprocesses
  (``workloads.server --register-with …``, warmed through the
  persistent compile cache) and the router's ``POST /drain`` eviction
  surface.

Every transition is journaled through the flight recorder and counted
on the ``tpu_fleet_*`` families; the spawn/drain boundaries carry
``fleet.spawn`` / ``fleet.drain`` fault hooks plus retry/breaker
coverage so chaos runs can provoke every failure path.

The decision core never reads a clock or an unseeded RNG — time is
injected by the caller (``FleetObservation.now_s``), which is what makes
the unit suite's seeded statz sequences replay to byte-identical action
sequences.

The port's own copy of the JAX package's ``workloads/fleet.py`` (the
port imports nothing of that package): the same observation sequence
gives the same plans.  It reads membership files through the port's own
``slice/state.py`` and spawns the port's server CLI, on CUDA unless
``ServerSpec.device`` (``--device``) names another device.
"""

from __future__ import annotations

import argparse
import http.client
import json
import logging
import os
import signal
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field, replace
from typing import (
    Any,
    Callable,
    Dict,
    List,
    Mapping,
    Optional,
    Sequence,
    Tuple,
)

from .. import obs, resilience
from ..resilience import faults
from ..slice import state as slice_state
from . import loadclient

log = logging.getLogger("tpu.fleet")

# replica lifecycle states (controller-side; the router only ever sees
# registered-or-not plus the draining flag)
STATE_STARTING = "starting"
STATE_READY = "ready"
STATE_DRAINING = "draining"

# action kinds — the bounded label set of tpu_fleet_decisions_total
ACTION_SPAWN = "spawn"
ACTION_DRAIN = "drain"
ACTION_STOP = "stop"
ACTION_HOLD = "hold"
ACTIONS = (ACTION_SPAWN, ACTION_DRAIN, ACTION_STOP, ACTION_HOLD)

# scale-event reasons — bounded label set of tpu_fleet_scale_events_total
REASON_PRESSURE = "pressure"
REASON_GOODPUT = "goodput"
REASON_IDLE = "idle"
REASON_DEGRADED = "degraded"
REASON_FAILURE = "failure"
REASON_FLOOR = "floor"
# a firing page-severity burn-rate alert (the router's fleet-level
# evaluator or any replica's local one, via the /fleet/statz
# firing_alerts roll-up) — the alerting loop closed back into scaling
REASON_ALERT = "alert"
REASONS = (REASON_PRESSURE, REASON_GOODPUT, REASON_IDLE,
           REASON_DEGRADED, REASON_FAILURE, REASON_FLOOR,
           REASON_ALERT)

DIRECTIONS = ("up", "down")

ROLE_MIXED = "mixed"
ROLE_PREFILL = "prefill"
ROLE_DECODE = "decode"


# -- capacity ---------------------------------------------------------------


@dataclass(frozen=True)
class SliceCapacity:
    """One slice's advertised shape — the reconciler's unit of
    placement.  ``slots`` is how many replicas the slice hosts
    (defaults to ``workers``: one replica per worker host, the
    gang-placement the labeller's ``slice-workers`` label implies)."""

    slice_id: str
    generation: int
    workers: int
    degraded: bool = False
    max_replicas: int = 0

    @property
    def slots(self) -> int:
        return self.max_replicas if self.max_replicas > 0 \
            else self.workers


def load_capacity_spec(path: str) -> Tuple[SliceCapacity, ...]:
    """Parse a ``--capacity-spec`` JSON file::

        {"slices": [{"slice_id": "s0", "generation": 1, "workers": 2,
                     "degraded": false, "max_replicas": 2}]}

    Raises ValueError on a malformed document — capacity is the
    scale-out ceiling, and a silently-empty spec would read as "no
    capacity anywhere" and drain the world."""
    with open(path, "r", encoding="utf-8") as fh:
        doc = json.load(fh)
    if not isinstance(doc, dict) or not isinstance(
            doc.get("slices"), list):
        raise ValueError(
            f"capacity spec {path!r}: want {{'slices': [...]}}")
    out: List[SliceCapacity] = []
    for i, row in enumerate(doc["slices"]):
        if not isinstance(row, dict):
            raise ValueError(
                f"capacity spec {path!r}: slices[{i}] not an object")
        try:
            out.append(SliceCapacity(
                slice_id=str(row["slice_id"]),
                generation=int(row["generation"]),
                workers=int(row.get("workers", 1)),
                degraded=bool(row.get("degraded", False)),
                max_replicas=int(row.get("max_replicas", 0))))
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(
                f"capacity spec {path!r}: slices[{i}]: {e}")
    return tuple(out)


def capacity_from_membership(
        paths: Sequence[str]) -> Tuple[SliceCapacity, ...]:
    """Capacity the labeller's way: each path is a slice-agent
    membership state file (``slice.state.save_membership``), yielding
    exactly the ``slice-generation``/``slice-workers``/
    ``slice-degraded`` label values the node carries.  An absent or
    corrupt file contributes nothing — same degraded-open posture as
    the label generators."""
    out: List[SliceCapacity] = []
    for path in paths:
        m = slice_state.load_membership(path)
        if m is None:
            continue
        out.append(SliceCapacity(
            slice_id=m.slice_id, generation=m.generation,
            workers=m.num_workers, degraded=m.degraded))
    return tuple(out)


# -- observation ------------------------------------------------------------


@dataclass(frozen=True)
class ReplicaView:
    """One managed replica as the planner sees it: controller process
    state joined with the router's cached statz row."""

    rid: str
    role: str
    state: str
    slice_id: str
    generation: int
    alive: bool
    healthy: bool
    queue_depth: int
    in_flight: int
    capacity: int
    started_at_s: float
    drain_started_at_s: float = 0.0
    drain_reason: str = ""


@dataclass(frozen=True)
class FleetObservation:
    """One observe() snapshot — everything plan() may consult.  Pure
    data: the planner must stay replayable from a recorded sequence of
    these."""

    now_s: float
    replicas: Tuple[ReplicaView, ...]
    slices: Tuple[SliceCapacity, ...]
    queue_depth: int = 0
    in_flight: int = 0
    capacity: int = 0
    requests_served: int = 0
    no_replica_total: int = 0
    kv_pages: int = 0
    kv_pages_free: int = 0
    shed_total: int = 0
    # class -> {"goodput_ratio": r, "burn_rate_max": b,
    #           "window_total": n}
    goodput: Mapping[str, Mapping[str, float]] = \
        field(default_factory=dict)
    # the /fleet/statz firing_alerts roll-up: each entry carries at
    # least {"source", "name", "severity"} — page severity is a
    # scale-up signal (reason=alert)
    firing_alerts: Tuple[Mapping[str, str], ...] = ()


@dataclass(frozen=True)
class Action:
    """One planned transition.  ``rid`` names the subject for
    drain/stop; spawn carries placement (slice, generation, role)."""

    kind: str
    reason: str
    rid: str = ""
    role: str = ROLE_MIXED
    slice_id: str = ""
    generation: int = 0


@dataclass(frozen=True)
class Plan:
    """plan()'s full verdict: the actions plus the bookkeeping the
    controller exports (desired gauge, the pressure that drove it)."""

    actions: Tuple[Action, ...]
    desired: int
    pressure: float


# -- decision core ----------------------------------------------------------


@dataclass(frozen=True)
class PlannerConfig:
    """The control knobs (docs/user-guide/fleet.md documents each).
    Watermarks are normalized pressure: (queue_depth + in_flight) /
    fleet capacity."""

    min_replicas: int = 1
    max_replicas: int = 4
    high_watermark: float = 1.5
    low_watermark: float = 0.25
    goodput_floor: float = 0.7
    burn_rate_high: float = 2.0
    up_stable_s: float = 1.0
    down_stable_s: float = 10.0
    idle_to_zero_s: float = 60.0
    cooldown_s: float = 5.0
    drain_timeout_s: float = 30.0
    # the statz snapshot a drain verdict reads can be one scrape
    # interval stale: a just-drained replica may still be finishing a
    # stream the cached counters no longer show.  Never trust
    # queue==0 before the drain has aged past this dwell.
    drain_min_s: float = 1.0
    start_grace_s: float = 120.0
    disagg: bool = False

    def __post_init__(self) -> None:
        if self.min_replicas < 0 or self.max_replicas < 1:
            raise ValueError("replica bounds out of range")
        if self.min_replicas > self.max_replicas:
            raise ValueError("min_replicas > max_replicas")
        if self.low_watermark >= self.high_watermark:
            raise ValueError("low watermark must sit below high")
        if not 0.0 <= self.goodput_floor <= 1.0:
            raise ValueError("goodput_floor is a ratio in [0, 1]")


class FleetPlanner:
    """The pure decision core.  Feed it a sequence of
    :class:`FleetObservation` snapshots; it returns the same
    :class:`Plan` sequence every time — no clocks, no RNG, no I/O.

    Decision order per cycle (first match wins a given replica, all
    rules run every cycle):

    1. **reap + replace**: a dead process is stopped and — if it was
       starting/ready — replaced immediately, cooldown bypassed
       (failure healing must not wait out a scale event).
    2. **drain completion**: a draining replica whose queue emptied
       (or whose drain timed out) is stopped; a degraded-drain gets
       its 1:1 replacement spawned onto the slice's current
       generation.
    3. **degraded rolling drain**: one ready replica whose slice
       generation no longer matches advertised capacity is drained
       (at most one in flight at a time — a reshape must roll, not
       thundering-herd the fleet).
    4. **floor**: below ``min_replicas``, spawn (no cooldown — the
       floor is an invariant, not a preference).
    5. **scale up**: pressure above the high watermark (or a class
       burning its SLO) sustained for ``up_stable_s``, cooldown
       passed, capacity available.
    6. **scale to zero / scale in**: sustained idle (to zero, only
       when ``min_replicas == 0``) or pressure below the low
       watermark for ``down_stable_s``, cooldown passed — drains the
       newest safe victim rather than killing it.
    """

    def __init__(self, config: PlannerConfig) -> None:
        self.config = config
        self._high_since: Optional[float] = None
        self._low_since: Optional[float] = None
        self._idle_since: Optional[float] = None
        self._last_scale_s: Optional[float] = None
        self._last_served: Optional[int] = None
        self._last_norep: Optional[int] = None
        self._spawn_seq = 0

    # -- helpers ------------------------------------------------------------

    @staticmethod
    def _stale(r: ReplicaView,
               by_slice: Mapping[str, SliceCapacity]) -> bool:
        """Does *r* run on a shape capacity no longer advertises?
        Generation mismatch is THE trigger: a degraded reshape always
        bumps the generation (slice.state), and keying on the flag
        alone would drain the replacement too, forever."""
        if not r.slice_id:
            return False  # placeless replica (no capacity source)
        s = by_slice.get(r.slice_id)
        return s is None or s.generation != r.generation

    @staticmethod
    def _slots(s: SliceCapacity) -> int:
        return s.slots

    def _effective_max(self, slices: Sequence[SliceCapacity]) -> int:
        cap = sum(self._slots(s) for s in slices)
        if not slices:
            cap = self.config.max_replicas
        return min(self.config.max_replicas, cap)

    def _place(self, occupied: Mapping[str, int],
               slices: Sequence[SliceCapacity]
               ) -> Optional[Tuple[str, int]]:
        """The slice for one new replica: most free slots first,
        healthy generations before degraded ones, slice_id as the
        deterministic tie-break.  None when every slot is taken (the
        spawn is capacity-bound, not config-bound)."""
        if not slices:
            return ("", 0)
        best: Optional[SliceCapacity] = None
        best_key: Tuple[int, int, str] = (0, 0, "")
        for s in sorted(slices, key=lambda s: s.slice_id):
            free = self._slots(s) - occupied.get(s.slice_id, 0)
            if free <= 0:
                continue
            key = (0 if not s.degraded else 1, -free, s.slice_id)
            if best is None or key < best_key:
                best, best_key = s, key
        if best is None:
            return None
        return (best.slice_id, best.generation)

    def _choose_role(self, active: Sequence[ReplicaView]) -> str:
        """The live disagg knob: a homogeneous fleet spawns mixed;
        a disagg fleet keeps one of each phase alive, then feeds
        whichever phase queues deeper (prefill-vs-decode pressure)."""
        if not self.config.disagg:
            return ROLE_MIXED
        by_role: Dict[str, List[ReplicaView]] = {}
        for r in active:
            by_role.setdefault(r.role, []).append(r)
        if not by_role.get(ROLE_PREFILL):
            return ROLE_PREFILL
        if not by_role.get(ROLE_DECODE):
            return ROLE_DECODE

        def role_pressure(role: str) -> float:
            rs = by_role.get(role, [])
            depth = sum(r.queue_depth + r.in_flight for r in rs)
            cap = sum(max(r.capacity, 1) for r in rs)
            return depth / max(cap, 1)

        return ROLE_PREFILL \
            if role_pressure(ROLE_PREFILL) >= role_pressure(ROLE_DECODE) \
            else ROLE_DECODE

    def _scale_down_victim(self, active: Sequence[ReplicaView]
                           ) -> Optional[ReplicaView]:
        """Newest ready replica whose removal keeps every live role
        populated (a disagg fleet must not drain its last prefill
        while decode replicas still depend on it)."""
        ready = [r for r in active if r.state == STATE_READY]
        roles = {r.role for r in active}
        for r in sorted(ready, key=lambda r: (-r.started_at_s, r.rid)):
            remaining = [x for x in active if x.rid != r.rid]
            if self.config.disagg and len(roles) > 1:
                if r.role not in {x.role for x in remaining}:
                    continue
            return r
        return None

    # -- the loop body ------------------------------------------------------

    def plan(self, o: FleetObservation) -> Plan:
        cfg = self.config
        now = o.now_s
        by_slice = {s.slice_id: s for s in o.slices}
        actions: List[Action] = []

        alive = [r for r in o.replicas if r.alive]
        dead = [r for r in o.replicas if not r.alive]
        active = [r for r in alive
                  if r.state in (STATE_STARTING, STATE_READY)]
        draining = [r for r in alive if r.state == STATE_DRAINING]

        # deltas for idle / scale-from-zero detection (cumulative
        # counters; a replica death shrinks the served sum, so clamp)
        served_delta = 0 if self._last_served is None else max(
            0, o.requests_served - self._last_served)
        self._last_served = o.requests_served
        norep_delta = 0 if self._last_norep is None else max(
            0, o.no_replica_total - self._last_norep)
        self._last_norep = o.no_replica_total

        # 1. reap dead processes; replace the ones that were carrying
        # traffic (cooldown deliberately bypassed: failover speed is
        # the point of running a controller at all)
        spawns = 0
        drains = 0
        occupied: Dict[str, int] = {}
        for r in active + draining:
            if r.slice_id:
                occupied[r.slice_id] = occupied.get(r.slice_id, 0) + 1
        eff_max = self._effective_max(o.slices)
        for r in dead:
            actions.append(Action(ACTION_STOP, REASON_FAILURE,
                                  rid=r.rid, role=r.role,
                                  slice_id=r.slice_id,
                                  generation=r.generation))
            if r.state in (STATE_STARTING, STATE_READY) \
                    and len(active) + spawns < eff_max:
                placed = self._place(occupied, o.slices)
                if placed is not None:
                    sid, gen = placed
                    actions.append(Action(
                        ACTION_SPAWN, REASON_FAILURE, role=r.role,
                        slice_id=sid, generation=gen))
                    spawns += 1
                    if sid:
                        occupied[sid] = occupied.get(sid, 0) + 1

        # a replica stuck starting past the grace window is a failure
        # too (hung backend init): stop it, let the floor/pressure
        # rules re-spawn next cycle with fresh state
        for r in list(active):
            if r.state == STATE_STARTING \
                    and now - r.started_at_s >= cfg.start_grace_s:
                actions.append(Action(ACTION_STOP, REASON_FAILURE,
                                      rid=r.rid, role=r.role,
                                      slice_id=r.slice_id,
                                      generation=r.generation))
                active.remove(r)
                if r.slice_id:
                    occupied[r.slice_id] = max(
                        0, occupied.get(r.slice_id, 1) - 1)

        # 2. drain completion: queue empty (or timeout) -> stop; a
        # degraded drain re-registers 1:1 onto the current generation
        for r in draining:
            age = now - r.drain_started_at_s
            done = (age >= cfg.drain_min_s
                    and (r.queue_depth + r.in_flight) == 0) \
                or age >= cfg.drain_timeout_s
            if not done:
                continue
            actions.append(Action(ACTION_STOP,
                                  r.drain_reason or REASON_IDLE,
                                  rid=r.rid, role=r.role,
                                  slice_id=r.slice_id,
                                  generation=r.generation))
            if r.slice_id:
                occupied[r.slice_id] = max(
                    0, occupied.get(r.slice_id, 1) - 1)
            if r.drain_reason == REASON_DEGRADED \
                    and len(active) + spawns < eff_max:
                placed = self._place(occupied, o.slices)
                if placed is not None:
                    sid, gen = placed
                    actions.append(Action(
                        ACTION_SPAWN, REASON_DEGRADED, role=r.role,
                        slice_id=sid, generation=gen))
                    spawns += 1
                    if sid:
                        occupied[sid] = occupied.get(sid, 0) + 1

        # 3. degraded rolling drain — one at a time, oldest first
        if not draining:
            stale = sorted(
                (r for r in active
                 if r.state == STATE_READY
                 and self._stale(r, by_slice)),
                key=lambda r: (r.started_at_s, r.rid))
            if stale:
                v = stale[0]
                actions.append(Action(ACTION_DRAIN, REASON_DEGRADED,
                                      rid=v.rid, role=v.role,
                                      slice_id=v.slice_id,
                                      generation=v.generation))
                drains += 1
                active.remove(v)

        n = len(active)

        # pressure + goodput signals
        pressure = ((o.queue_depth + o.in_flight)
                    / max(o.capacity, 1)) if o.capacity else 0.0
        goodput_bad = False
        for row in o.goodput.values():
            if float(row.get("window_total", 0.0)) <= 0:
                continue
            if float(row.get("goodput_ratio", 1.0)) < cfg.goodput_floor \
                    or float(row.get("burn_rate_max", 0.0)) \
                    >= cfg.burn_rate_high:
                goodput_bad = True
                break
        # a firing page-severity alert is the alert engine's
        # pre-chewed verdict — multi-window burn already confirmed it,
        # so it drives scale-up even when the raw-threshold signals
        # above haven't tripped (and keeps working as a fallback when
        # the fleet runs without the evaluator)
        alert_hot = any(
            str(f.get("severity", "")) == "page"
            for f in o.firing_alerts if isinstance(f, Mapping))
        high = (n > 0 and pressure >= cfg.high_watermark) \
            or (n > 0 and goodput_bad) \
            or (n > 0 and alert_hot) \
            or (n == 0 and norep_delta > 0)
        low = n > 0 and pressure <= cfg.low_watermark \
            and not goodput_bad and not alert_hot
        idle = n > 0 and o.queue_depth == 0 and o.in_flight == 0 \
            and served_delta == 0

        if high and self._high_since is None:
            self._high_since = now
        if not high:
            self._high_since = None
        if low and self._low_since is None:
            self._low_since = now
        if not low:
            self._low_since = None
        if idle and self._idle_since is None:
            self._idle_since = now
        if not idle:
            self._idle_since = None

        cooldown_ok = self._last_scale_s is None \
            or now - self._last_scale_s >= cfg.cooldown_s

        # 4. the floor invariant (also the scale-from-zero path once
        # norep pressure flips `high` with an empty fleet)
        if n + spawns < cfg.min_replicas \
                or (n == 0 and spawns == 0 and high):
            placed = self._place(occupied, o.slices)
            if placed is not None and n + spawns < eff_max:
                sid, gen = placed
                actions.append(Action(
                    ACTION_SPAWN,
                    REASON_FLOOR if n + spawns < cfg.min_replicas
                    else REASON_PRESSURE,
                    role=self._choose_role(active),
                    slice_id=sid, generation=gen))
                spawns += 1
                if sid:
                    occupied[sid] = occupied.get(sid, 0) + 1

        # 5. scale up on sustained pressure / burning SLO
        elif self._high_since is not None \
                and now - self._high_since >= cfg.up_stable_s \
                and cooldown_ok and n + spawns < eff_max:
            placed = self._place(occupied, o.slices)
            if placed is not None:
                sid, gen = placed
                actions.append(Action(
                    ACTION_SPAWN,
                    REASON_ALERT if alert_hot
                    else REASON_GOODPUT if goodput_bad
                    else REASON_PRESSURE,
                    role=self._choose_role(active),
                    slice_id=sid, generation=gen))
                spawns += 1
                self._last_scale_s = now
                self._high_since = None

        # 6. scale to zero / scale in (drain, never kill)
        elif not draining and drains == 0 and cooldown_ok:
            to_zero = cfg.min_replicas == 0 \
                and self._idle_since is not None \
                and now - self._idle_since >= cfg.idle_to_zero_s
            shrink = self._low_since is not None \
                and now - self._low_since >= cfg.down_stable_s \
                and n > cfg.min_replicas
            if to_zero or shrink:
                v = self._scale_down_victim(active)
                if v is not None:
                    actions.append(Action(
                        ACTION_DRAIN,
                        REASON_IDLE if to_zero else REASON_PRESSURE,
                        rid=v.rid, role=v.role, slice_id=v.slice_id,
                        generation=v.generation))
                    drains += 1
                    self._last_scale_s = now
                    self._low_since = None
                    self._idle_since = None

        desired = max(0, n + spawns - drains)
        return Plan(actions=tuple(actions), desired=desired,
                    pressure=round(pressure, 4))


# -- metrics ----------------------------------------------------------------


class FleetMetrics:
    """The tpu_fleet_* families — every decision the planner makes is
    visible here and in the journal, never only in logs."""

    def __init__(self, registry: obs.Registry) -> None:
        self.registry = registry
        self.replicas = registry.gauge(
            "tpu_fleet_replicas",
            "Live managed replicas (starting + ready + draining).")
        self.desired = registry.gauge(
            "tpu_fleet_desired_replicas",
            "The planner's current target replica count.")
        self.scale_events = registry.counter(
            "tpu_fleet_scale_events_total",
            "Fleet size transitions by direction and trigger "
            "(pressure/goodput watermarks, idle scale-to-zero, "
            "degraded-slice re-registration, failure replacement, "
            "min-replica floor).", ("direction", "reason"))
        self.decisions = registry.counter(
            "tpu_fleet_decisions_total",
            "Planner verdicts per reconcile cycle, by action kind "
            "(hold = an observe cycle that changed nothing).",
            ("action",))
        self.drain_seconds = registry.histogram(
            "tpu_fleet_drain_seconds",
            "Drain start (router eviction) to replica stop: how long "
            "in-flight work took to leave a condemned replica.",
            buckets=obs.SLOW_BUCKETS_S)
        for d in DIRECTIONS:
            for r in REASONS:
                self.scale_events.labels(direction=d, reason=r).inc(0)
        for a in ACTIONS:
            self.decisions.labels(action=a).inc(0)


# -- controller (the act layer) ---------------------------------------------


@dataclass(frozen=True)
class ServerSpec:
    """How to launch one replica CLI — the knobs the reconciler passes
    straight through to ``workloads.server``."""

    config: str = "tiny"
    slots: int = 4
    max_len: int = 2048
    max_new_tokens: int = 256
    window: int = 4
    prefix_chunk: int = 0
    slo: Tuple[str, ...] = ()
    compile_cache_dir: str = ""
    kv_paging: bool = False
    # replica-local alert engine: 0 keeps the replica's CLI
    # defaults; set both to shrink the burn-rate windows and tighten
    # the evaluation tick so soak episodes see alerts fire in seconds
    alert_interval_s: float = 0.0
    alert_window_scale: float = 0.0
    extra_args: Tuple[str, ...] = ()
    # the replica's torch device ("": CUDA, which the CLI requires)
    device: str = ""


@dataclass
class _Managed:
    """Controller-side record of one spawned replica process."""

    rid: str
    proc: "subprocess.Popen[bytes]"
    port: int
    role: str
    slice_id: str
    generation: int
    state: str
    started_at_s: float
    drain_started_at_s: float = 0.0
    drain_reason: str = ""


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))


class FleetController:
    """observe → plan → act against a live router.

    The controller owns the subprocess table and the router client;
    every boundary (spawn, drain POST, statz GET) runs under the
    resilience layer (seeded RetryPolicy + breaker) and fires a fault
    hook (``fleet.spawn`` / ``fleet.drain``) so the chaos harness can
    break it on purpose.  All controller clocks are monotonic."""

    def __init__(self, router_url: str, *,
                 planner: Optional[FleetPlanner] = None,
                 config: Optional[PlannerConfig] = None,
                 server: Optional[ServerSpec] = None,
                 capacity_spec: str = "",
                 membership_paths: Sequence[str] = (),
                 interval_s: float = 1.0,
                 seed: int = 0,
                 registry: Optional[obs.Registry] = None,
                 recorder: Optional[obs.FlightRecorder] = None,
                 spawn_env: Optional[Dict[str, str]] = None) -> None:
        self.router_url = router_url.rstrip("/")
        host, _, port_s = self.router_url.rpartition("//")[-1] \
            .rpartition(":")
        self.router_host = host or "127.0.0.1"
        self.router_port = int(port_s)
        self.planner = planner or FleetPlanner(
            config or PlannerConfig())
        self.server = server or ServerSpec()
        self.capacity_spec = capacity_spec
        self.membership_paths = tuple(membership_paths)
        self.interval_s = interval_s
        self.seed = seed
        self.registry = registry or obs.Registry()
        self.recorder = recorder or obs.FlightRecorder(
            registry=self.registry)
        self.metrics = FleetMetrics(self.registry)
        self._rmetrics = resilience.ResilienceMetrics(self.registry)
        self._retry = resilience.RetryPolicy(
            max_attempts=3, initial_backoff_s=0.1, max_backoff_s=1.0,
            seed=seed)
        self._breaker = resilience.CircuitBreaker(
            op="fleet.router", failure_threshold=5,
            reset_timeout_s=2.0, metrics=self._rmetrics,
            recorder=self.recorder)
        self._procs: Dict[str, _Managed] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._seq = 0
        self._spawn_env = dict(spawn_env or {})
        self.max_observed = 0
        self.cycles = 0

    # -- observe ------------------------------------------------------------

    def _fetch_json(self, path: str) -> Dict[str, Any]:
        def get() -> Dict[str, Any]:
            conn = http.client.HTTPConnection(
                self.router_host, self.router_port, timeout=5.0)
            try:
                conn.request("GET", path)
                resp = conn.getresponse()
                body = resp.read()
                if resp.status != 200:
                    raise OSError(
                        f"GET {path} -> {resp.status}")
            finally:
                conn.close()
            out = json.loads(body)
            if not isinstance(out, dict):
                raise ValueError(f"GET {path}: non-object body")
            return out

        def attempt() -> Dict[str, Any]:
            return self._breaker.call(get)

        return self._retry.call(
            attempt, op="fleet.statz",
            retry_on=(OSError, ValueError,
                      http.client.HTTPException),
            metrics=self._rmetrics, stop=self._stop)

    def capacity(self) -> Tuple[SliceCapacity, ...]:
        """Re-read capacity every cycle — slice reshape lands as a
        file change, exactly like the labeller re-reading membership
        on its poll."""
        if self.capacity_spec:
            try:
                return load_capacity_spec(self.capacity_spec)
            except (OSError, ValueError) as e:
                resilience.suppressed("fleet.capacity_spec", e,
                                      logger=log,
                                      metrics=self._rmetrics)
                return ()
        return capacity_from_membership(self.membership_paths)

    def observe(self) -> Optional[FleetObservation]:
        """One fleet snapshot, or None when the router is unreachable
        (the loop holds rather than act blind)."""
        now = time.monotonic()
        try:
            statz = self._fetch_json("/fleet/statz")
        except (OSError, ValueError, http.client.HTTPException,
                resilience.CircuitOpenError) as e:
            resilience.suppressed("fleet.observe", e, logger=log,
                                  metrics=self._rmetrics)
            return None
        per_replica = statz.get("per_replica")
        per_replica = per_replica if isinstance(per_replica, dict) \
            else {}
        fleet = statz.get("fleet")
        fleet = fleet if isinstance(fleet, dict) else {}
        router_row = statz.get("router")
        router_row = router_row if isinstance(router_row, dict) else {}
        views: List[ReplicaView] = []
        with self._lock:
            managed = list(self._procs.values())
        for m in managed:
            row = per_replica.get(m.rid)
            row = row if isinstance(row, dict) else {}
            rstatz = row.get("statz")
            rstatz = rstatz if isinstance(rstatz, dict) else {}
            healthy = bool(row.get("healthy"))
            alive = m.proc.poll() is None
            if m.state == STATE_STARTING and healthy:
                m.state = STATE_READY
                self.recorder.record("tpu_fleet_replica_ready",
                                     replica=m.rid, role=m.role,
                                     slice_id=m.slice_id,
                                     generation=m.generation)
            views.append(ReplicaView(
                rid=m.rid, role=m.role, state=m.state,
                slice_id=m.slice_id, generation=m.generation,
                alive=alive, healthy=healthy,
                queue_depth=int(rstatz.get("queue_depth", 0) or 0),
                in_flight=int(rstatz.get("in_flight", 0) or 0),
                capacity=int(rstatz.get("capacity", 0) or 0),
                started_at_s=m.started_at_s,
                drain_started_at_s=m.drain_started_at_s,
                drain_reason=m.drain_reason))
        goodput_raw = fleet.get("goodput")
        goodput: Dict[str, Dict[str, float]] = {}
        if isinstance(goodput_raw, dict):
            for name, row in goodput_raw.items():
                if isinstance(row, dict):
                    goodput[str(name)] = {
                        k: float(v) for k, v in row.items()
                        if isinstance(v, (int, float))}
        shed = fleet.get("shed")
        shed_total = sum(
            int(v) for v in shed.values()
            if isinstance(v, (int, float))) \
            if isinstance(shed, dict) else 0
        firing_raw = fleet.get("firing_alerts")
        firing: List[Dict[str, str]] = []
        if isinstance(firing_raw, list):
            for f in firing_raw:
                if isinstance(f, dict) and f.get("name"):
                    firing.append({
                        "source": str(f.get("source", "")),
                        "name": str(f["name"]),
                        "severity": str(f.get("severity", ""))})
        return FleetObservation(
            now_s=now, replicas=tuple(views),
            slices=self.capacity(),
            queue_depth=int(fleet.get("queue_depth", 0) or 0),
            in_flight=int(fleet.get("in_flight", 0) or 0),
            capacity=int(fleet.get("capacity", 0) or 0),
            requests_served=int(
                fleet.get("requests_served", 0) or 0),
            no_replica_total=int(
                router_row.get("no_replica_total", 0) or 0),
            kv_pages=int(fleet.get("kv_pages", 0) or 0),
            kv_pages_free=int(fleet.get("kv_pages_free", 0) or 0),
            shed_total=shed_total, goodput=goodput,
            firing_alerts=tuple(firing))

    # -- act ----------------------------------------------------------------

    def _spawn_cmd(self, rid: str, port: int,
                   role: str) -> List[str]:
        s = self.server
        cmd = loadclient.server_cmd(
            s.device,
            "--config", s.config, "--n-slots", str(s.slots),
            "--max-len", str(s.max_len),
            "--max-new-tokens", str(s.max_new_tokens),
            "--window", str(s.window),
            "--host", "127.0.0.1", "--port", str(port),
            "--register-with",
            f"http://{self.router_host}:{self.router_port}",
            "--replica-id", rid,
            "--register-interval", "0.3")
        if s.prefix_chunk > 0:
            cmd += ["--prefix-chunk", str(s.prefix_chunk)]
        for spec in s.slo:
            cmd += ["--slo", spec]
        if s.compile_cache_dir:
            cmd += ["--compile-cache-dir", s.compile_cache_dir]
        if s.alert_interval_s > 0:
            cmd += ["--alert-interval", str(s.alert_interval_s)]
        if s.alert_window_scale > 0:
            cmd += ["--alert-window-scale",
                    str(s.alert_window_scale)]
        if role != ROLE_MIXED:
            cmd += ["--replica-role", role]
            if not s.kv_paging:
                cmd += ["--kv-paging"]
        if s.kv_paging:
            cmd += ["--kv-paging"]
        cmd += list(s.extra_args)
        return cmd

    def _spawn(self, action: Action) -> Optional[str]:
        if faults.ACTIVE is not None:
            try:
                faults.ACTIVE.fire("fleet.spawn")
            except faults.InjectedFault as e:
                resilience.suppressed("fleet.spawn", e, logger=log,
                                      metrics=self._rmetrics)
                return None
        self._seq += 1
        rid = f"fleet-{self._seq}"
        port = loadclient.free_port()
        env = dict(os.environ)
        env["PYTHONPATH"] = _repo_root() + os.pathsep \
            + env.get("PYTHONPATH", "")
        env.update(self._spawn_env)

        def popen() -> "subprocess.Popen[bytes]":
            return loadclient.spawn_replica(
                self._spawn_cmd(rid, port, action.role), rid, env=env)

        try:
            proc = self._retry.call(
                popen, op="fleet.spawn", retry_on=(OSError,),
                metrics=self._rmetrics, stop=self._stop)
        except OSError as e:
            resilience.suppressed("fleet.spawn", e, logger=log,
                                  metrics=self._rmetrics)
            return None
        with self._lock:
            self._procs[rid] = _Managed(
                rid=rid, proc=proc, port=port, role=action.role,
                slice_id=action.slice_id,
                generation=action.generation,
                state=STATE_STARTING,
                started_at_s=time.monotonic())
        self.recorder.record("tpu_fleet_replica_spawned",
                             replica=rid, role=action.role,
                             slice_id=action.slice_id,
                             generation=action.generation,
                             reason=action.reason, port=port)
        self.metrics.scale_events.labels(
            direction="up", reason=action.reason).inc()
        log.info("spawned %s (role=%s slice=%s gen=%d reason=%s)",
                 rid, action.role, action.slice_id,
                 action.generation, action.reason)
        return rid

    def _drain(self, action: Action) -> None:
        if faults.ACTIVE is not None:
            try:
                faults.ACTIVE.fire("fleet.drain")
            except faults.InjectedFault as e:
                resilience.suppressed("fleet.drain", e, logger=log,
                                      metrics=self._rmetrics)
                return
        body = json.dumps({"replica_id": action.rid}).encode()

        def post() -> None:
            conn = http.client.HTTPConnection(
                self.router_host, self.router_port, timeout=5.0)
            try:
                conn.request("POST", "/drain", body=body, headers={
                    "Content-Type": "application/json"})
                resp = conn.getresponse()
                resp.read()
                # 404 = the router already evicted it (TTL beat us);
                # the drain goal is met either way
                if resp.status not in (200, 404):
                    raise OSError(f"POST /drain -> {resp.status}")
            finally:
                conn.close()

        try:
            self._retry.call(post, op="fleet.drain",
                             retry_on=(OSError,
                                       http.client.HTTPException),
                             metrics=self._rmetrics, stop=self._stop)
        except (OSError, http.client.HTTPException) as e:
            resilience.suppressed("fleet.drain", e, logger=log,
                                  metrics=self._rmetrics)
            return
        with self._lock:
            m = self._procs.get(action.rid)
            if m is not None:
                m.state = STATE_DRAINING
                m.drain_started_at_s = time.monotonic()
                m.drain_reason = action.reason
        self.recorder.record("tpu_fleet_replica_draining",
                             replica=action.rid,
                             reason=action.reason)
        self.metrics.scale_events.labels(
            direction="down", reason=action.reason).inc()
        log.info("draining %s (reason=%s)", action.rid,
                 action.reason)

    def _stop_replica(self, action: Action) -> None:
        with self._lock:
            m = self._procs.pop(action.rid, None)
        if m is None:
            return
        drained_s = 0.0
        if m.drain_started_at_s:
            drained_s = time.monotonic() - m.drain_started_at_s
            self.metrics.drain_seconds.observe(drained_s)
        if m.proc.poll() is None:
            m.proc.send_signal(signal.SIGTERM)
            try:
                m.proc.wait(timeout=10.0)
            except subprocess.TimeoutExpired:
                m.proc.kill()
                try:
                    m.proc.wait(timeout=10.0)
                except subprocess.TimeoutExpired:
                    log.warning("replica %s pid %d did not exit",
                                m.rid, m.proc.pid)
        else:
            m.proc.wait()
        self.recorder.record("tpu_fleet_replica_stopped",
                             replica=m.rid, reason=action.reason,
                             drain_s=round(drained_s, 3))
        log.info("stopped %s (reason=%s, drained %.1fs)", m.rid,
                 action.reason, drained_s)

    def act(self, plan: Plan) -> None:
        if not plan.actions:
            self.metrics.decisions.labels(action=ACTION_HOLD).inc()
            return
        for a in plan.actions:
            self.metrics.decisions.labels(action=a.kind).inc()
            self.recorder.record("tpu_fleet_decision",
                                 action=a.kind, reason=a.reason,
                                 replica=a.rid, role=a.role,
                                 slice_id=a.slice_id,
                                 generation=a.generation)
            if a.kind == ACTION_SPAWN:
                self._spawn(a)
            elif a.kind == ACTION_DRAIN:
                self._drain(a)
            elif a.kind == ACTION_STOP:
                self._stop_replica(a)

    # -- the loop -----------------------------------------------------------

    def replica_count(self) -> int:
        with self._lock:
            return len(self._procs)

    def managed(self) -> List[Tuple[str, "subprocess.Popen[bytes]"]]:
        """(rid, process) pairs — the chaos harness's kill surface."""
        with self._lock:
            return [(m.rid, m.proc) for m in self._procs.values()]

    def kill_serving(self) -> Optional[str]:
        """SIGKILL one ready replica that no drain will take: not
        draining, and on its slice's advertised generation (the degraded
        rolling drain takes the others).  A replica that a drain stops
        journals no failure replacement, so its death tests no failover.
        Returns the victim's rid, or None when there is none."""
        gens = {c.slice_id: c.generation for c in self.capacity()}
        with self._lock:
            for m in self._procs.values():
                if m.state == STATE_READY and m.proc.poll() is None \
                        and gens.get(m.slice_id) == m.generation:
                    m.proc.kill()
                    return m.rid
        return None

    def step(self) -> Optional[Plan]:
        """One reconcile cycle.  Returns the plan (None when the
        router was unobservable and the loop held)."""
        o = self.observe()
        if o is None:
            return None
        plan = self.planner.plan(o)
        self.act(plan)
        self.cycles += 1
        n = self.replica_count()
        self.max_observed = max(self.max_observed, n)
        self.metrics.replicas.set(float(n))
        self.metrics.desired.set(float(plan.desired))
        return plan

    def run(self, duration_s: float = 0.0) -> None:
        """The reconcile loop: step every ``interval_s`` until
        ``shutdown()`` (or *duration_s* elapses)."""
        deadline = time.monotonic() + duration_s if duration_s else None
        while not self._stop.is_set():
            if deadline is not None and time.monotonic() >= deadline:
                break
            self.step()
            self._stop.wait(self.interval_s)

    def shutdown(self, kill_replicas: bool = True) -> None:
        self._stop.set()
        if not kill_replicas:
            return
        with self._lock:
            managed = list(self._procs.values())
            self._procs.clear()
        for m in managed:
            m.proc.kill()
        for m in managed:
            try:
                m.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                log.warning("replica %s pid %d did not exit",
                            m.rid, m.proc.pid)


# -- the trace-replay episode (the fleet gate) ------------------------------


def build_ramp_trace(seed: int, *, calm_requests: int = 16,
                     peak_requests: int = 72,
                     tail_requests: int = 20,
                     calm_rate: float = 2.0,
                     peak_rate: float = 10.0,
                     tail_rate: float = 1.5,
                     prefix_chunk: int = 16,
                     tenants: Tuple[str, ...] = ("default",),
                     tenant_weights: Optional[Tuple[float, ...]] = None
                     ) -> Tuple[Dict[str, object], List[Any]]:
    """A diurnal ramp from the seeded MMPP generator: calm → peak →
    calm, three deterministic segments concatenated on the virtual
    clock.  Same-seed-same-bytes, like every trace in this repo.

    The peak segment is HEAVY (long generations near the budget cap),
    not just frequent: arrival rate alone cannot raise queue pressure
    against a fast small model, and the whole point of the ramp is to
    make a correctly-tuned planner scale out BEFORE the chaos hooks
    fire — a fleet still at the floor when the SIGKILL lands drops to
    zero replicas and the episode can only fail its goodput floors."""
    from .trafficgen import TraceConfig, generate

    def seg(n: int, rate: float, sub: int, heavy: bool) -> List[Any]:
        # heavy bursts are tempered (2x, not 3x): the point of the
        # peak is sustained queue growth the planner can see through
        # up_stable_s, not a spike that saturates the floor replica
        # before any scale-out could possibly land.  Eight prefix
        # keys (not 4) so the router's affinity ring actually spreads
        # across a 2-3 replica fleet instead of pinning one.
        cfg = TraceConfig(
            n_requests=n, base_rate_rps=rate,
            burst_rate_rps=rate * (2.0 if heavy else 3.0),
            p_enter_burst=0.10, p_exit_burst=0.3,
            prefix_chunk=prefix_chunk, n_prefixes=8,
            max_prefix_chunks=2, prompt_median=24.0, prompt_max=48,
            output_median=100.0 if heavy else 20.0,
            output_max=128 if heavy else 48, vocab=256,
            tenants=tenants, tenant_weights=tenant_weights,
            unary_frac=0.25, slow_reader_frac=0.0, abandon_frac=0.0)
        return generate(cfg, seed + sub)

    requests: List[Any] = []
    t_off = 0.0
    for sub, (n, rate) in enumerate(
            ((calm_requests, calm_rate), (peak_requests, peak_rate),
             (tail_requests, tail_rate))):
        segment = seg(n, rate, sub, heavy=sub == 1)
        for r in segment:
            requests.append(replace(
                r, rid=f"r{len(requests):05d}",
                t_ms=r.t_ms + t_off))
        if segment:
            t_off = requests[-1].t_ms
    header: Dict[str, object] = {
        "schema": "tpu-trace/v1", "seed": seed,
        "requests": len(requests),
        "config": {"ramp": {
            "calm": {"requests": calm_requests, "rate": calm_rate},
            "peak": {"requests": peak_requests, "rate": peak_rate},
            "tail": {"requests": tail_requests, "rate": tail_rate},
        }}}
    return header, requests


def run_episode(args: argparse.Namespace) -> Tuple[
        Dict[str, Any], int]:
    """The fleet gate: an in-process router + the reconciler + a
    seeded diurnal ramp replayed open-loop, with a mid-ramp replica
    SIGKILL and a degraded-slice reshape.  Returns (report, exit
    code); every asserted fact comes from the replay report JSON, the
    ``tpu_fleet_*`` metrics, or the journals — never log text."""
    from . import replay
    from .router import RouterServer

    registry = obs.Registry()
    recorder = obs.FlightRecorder(registry=registry)
    policies = obs.parse_slo_specs(args.slo) if args.slo \
        else obs.default_slo_policies()
    metrics = replay.ReplayMetrics(registry, policies)
    header, requests = build_ramp_trace(
        args.seed, calm_requests=args.calm_requests,
        peak_requests=args.peak_requests,
        tail_requests=args.tail_requests,
        calm_rate=args.calm_rate, peak_rate=args.peak_rate,
        prefix_chunk=args.prefix_chunk)
    peak_start_ms = requests[args.calm_requests].t_ms \
        if len(requests) > args.calm_requests else 0.0
    trace_end_ms = requests[-1].t_ms if requests else 0.0
    # the kill lands mid-peak but PAST the pressure scale-out window
    # (up_stable_s + spawn + ready), so the death tests failover onto
    # a live fleet, not a fleet still booting its second replica; the
    # degraded reshape follows late-peak while load is still real.
    # Trace time alone cannot guarantee that ordering on a slow
    # machine (replica boot competes with serving for the same CPUs),
    # so each hook ALSO gates on the router reporting a second
    # routable replica before it fires — the trace offset is the
    # earliest the chaos may land, not a promise of fleet state.
    kill_at_ms = args.kill_at_ms if args.kill_at_ms is not None \
        else peak_start_ms + (trace_end_ms - peak_start_ms) * 0.5
    degrade_at_ms = args.degrade_at_ms \
        if args.degrade_at_ms is not None \
        else peak_start_ms + (trace_end_ms - peak_start_ms) * 0.8

    capacity_path = args.capacity_spec
    if not capacity_path:
        capacity_path = os.path.join(
            args.workdir, "fleet-capacity.json")
        with open(capacity_path, "w", encoding="utf-8") as fh:
            json.dump({"slices": [{
                "slice_id": "episode-slice", "generation": 1,
                "workers": args.max_replicas}]}, fh)

    # the router's fleet-level alert engine runs with shrunk burn-rate
    # windows so a mid-episode collapse traverses
    # inactive->pending->firing->resolved within the episode's wall
    # time (old Namespaces without the flags keep the CLI defaults)
    alert_interval = float(getattr(args, "alert_interval", 0.5))
    alert_scale = float(getattr(args, "alert_window_scale", 0.01))
    rt = RouterServer(statz_interval_s=0.3, replica_ttl_s=5.0,
                      breaker_reset_s=0.5, seed=args.seed,
                      registry=registry, slo_policies=policies,
                      alert_interval_s=alert_interval,
                      alert_window_scale=alert_scale,
                      # a mid-episode page then writes the fleet-level
                      # incident bundle (hand-built Namespaces without
                      # the flag keep the subscriber disarmed)
                      incident_dir=getattr(args, "incident_dir", None))
    rt.start(host="127.0.0.1", port=0)
    cache_dir = args.compile_cache_dir or os.path.join(
        args.workdir, "fleet-compile-cache")
    controller = FleetController(
        f"http://127.0.0.1:{rt.port}",
        config=PlannerConfig(
            min_replicas=1, max_replicas=args.max_replicas,
            high_watermark=args.high_watermark,
            low_watermark=args.low_watermark,
            up_stable_s=args.up_stable_s,
            down_stable_s=args.down_stable_s,
            cooldown_s=args.cooldown_s,
            drain_timeout_s=args.drain_timeout_s,
            start_grace_s=600.0),
        server=ServerSpec(
            config=args.config, slots=args.slots,
            max_len=args.max_len,
            max_new_tokens=args.max_new_tokens,
            prefix_chunk=args.prefix_chunk,
            slo=tuple(args.slo or ()),
            compile_cache_dir=cache_dir,
            alert_interval_s=alert_interval,
            alert_window_scale=alert_scale,
            extra_args=tuple(
                getattr(args, "server_extra_args", ()) or ()),
            device=getattr(args, "device", None) or ""),
        capacity_spec=capacity_path, interval_s=0.25,
        seed=args.seed, registry=registry, recorder=recorder)
    if args.fault_spec:
        faults.install(args.fault_spec, seed=args.seed,
                       recorder=recorder)
    loop = threading.Thread(target=controller.run,
                            name="fleet-reconcile", daemon=True)
    t0 = time.monotonic()
    killed: Dict[str, str] = {}
    try:
        loop.start()
        # the reconciler itself brings up the floor replica — wait for
        # the router to report it routable before traffic starts
        loadclient.wait_http_ok(rt.port, "/healthz", 600.0)
        baseline_replicas = controller.replica_count()

        def routable_now() -> int:
            try:
                rows = loadclient.fetch_json(
                    rt.port, "/replicas").get("replicas")
                if not isinstance(rows, list):
                    return 0
                return sum(1 for row in rows
                           if isinstance(row, dict)
                           and row.get("healthy"))
            except Exception as e:
                resilience.suppressed("fleet.chaos_probe", e,
                                      logger=log)
                return 0

        def await_live_fleet(label: str,
                             bound_s: float = 90.0) -> None:
            # each hook runs on its own replay thread, so blocking
            # here never stalls the open-loop dispatcher.  If the
            # fleet never scales, fire anyway at the bound — the gate
            # then fails on its scale-out evidence, which is the
            # honest verdict.
            deadline = time.monotonic() + bound_s
            while time.monotonic() < deadline \
                    and routable_now() < 2:
                time.sleep(0.25)
            log.info("chaos: %s fires with %d routable replicas",
                     label, routable_now())

        degrade_first = not args.no_degrade \
            and degrade_at_ms <= kill_at_ms
        degrade_fired: Dict[str, Optional[float]] = {}

        def kill_one() -> None:
            await_live_fleet("SIGKILL")
            # both hooks can wake on the same routable fleet: the victim
            # is a serving replica, chosen after an earlier reshape has
            # landed, never one its rolling drain is taking.  With none
            # within the bound nothing dies, and the gate fails on it.
            deadline = time.monotonic() + 90.0
            while time.monotonic() < deadline:
                if not degrade_first or "t" in degrade_fired:
                    rid = controller.kill_serving()
                    if rid is not None:
                        killed["rid"] = rid
                        log.info("chaos: SIGKILL %s at trace t=%.0fms",
                                 rid, kill_at_ms)
                        return
                time.sleep(0.25)

        def degrade_slice() -> None:
            await_live_fleet("degraded reshape", bound_s=120.0)
            log.info("chaos: slice reshapes degraded at trace "
                     "t=%.0fms", degrade_at_ms)
            with open(capacity_path, "w", encoding="utf-8") as fh:
                json.dump({"slices": [{
                    "slice_id": "episode-slice", "generation": 2,
                    "degraded": True,
                    "workers": args.max_replicas}]}, fh)
            degrade_fired["t"] = time.monotonic()

        hooks: List[Tuple[float, Callable[[], None]]] = []
        if not args.no_kill:
            hooks.append((kill_at_ms / 1000.0 / args.time_scale,
                          kill_one))
        if not args.no_degrade:
            hooks.append((degrade_at_ms / 1000.0 / args.time_scale,
                          degrade_slice))

        results = replay.replay_trace(
            requests, "127.0.0.1", rt.port, policies=policies,
            metrics=metrics, time_scale=args.time_scale,
            late_ms=args.late_ms, timeout_s=args.timeout_s,
            hooks=hooks)

        # idle tail: the ramp is over — the reconciler must scale back
        # to the floor on sustained calm.  The routable-fleet gate on
        # the chaos hooks means the degraded reshape may fire AFTER
        # the last trace request on a slow box, so settle also waits
        # for it (and extends its deadline once it lands, giving the
        # rolling drain a full window to finish).
        settle_deadline = time.monotonic() + args.settle_s
        # alert-centric episodes (chaos soak ep. 15) additionally hold
        # the settle open until the router's evaluator reports no
        # firing alerts, so the firing -> resolved transition lands in
        # the journal BEFORE the harvest below reads it
        wait_alerts = bool(getattr(args, "settle_on_alerts", False))
        while time.monotonic() < settle_deadline:
            pending = not args.no_degrade \
                and "t" not in degrade_fired
            if degrade_fired.get("t") is not None:
                settle_deadline = max(
                    settle_deadline,
                    float(degrade_fired["t"]) + args.settle_s)
                degrade_fired["t"] = None
            if controller.replica_count() <= 1 and not pending \
                    and not (wait_alerts
                             and rt.alerts.brief()["firing"]):
                break
            time.sleep(0.25)
        scaled_back = controller.replica_count() <= max(
            1, baseline_replicas)

        report = replay.build_report(
            results, policies, trace_header=header,
            target=f"fleet:127.0.0.1:{rt.port} "
                   f"(reconciled, max {args.max_replicas})",
            time_scale=args.time_scale, late_ms=args.late_ms,
            debug_port=rt.port, top_missed=args.top_missed)

        # -- evidence: metrics + journals, never logs -------------------
        fleet_events = recorder.events()
        spawned = [e for e in fleet_events
                   if e.get("name") == "tpu_fleet_replica_spawned"]
        stopped = [e for e in fleet_events
                   if e.get("name") == "tpu_fleet_replica_stopped"]
        drains = [e for e in fleet_events
                  if e.get("name") == "tpu_fleet_replica_draining"]

        def _attr(e: Dict[str, object], key: str) -> object:
            a = e.get("attrs")
            return a.get(key) if isinstance(a, dict) else None

        samples = obs.parse_exposition(registry.render())
        fleet_metrics: Dict[str, float] = {}
        scale_up = scale_down = 0.0
        for name, labels, value in samples:
            if name == "tpu_fleet_scale_events_total":
                if labels.get("direction") == "up":
                    scale_up += value
                else:
                    scale_down += value
            if name.startswith("tpu_fleet_") and "seconds" not in name:
                key = name + ("{" + ",".join(
                    f"{k}={v}" for k, v in sorted(labels.items()))
                    + "}" if labels else "")
                fleet_metrics[key] = value
        replaced = any(_attr(e, "reason") == REASON_FAILURE
                       for e in spawned)
        degraded_drained = any(
            _attr(e, "reason") == REASON_DEGRADED for e in drains)
        regen_spawn = any(
            _attr(e, "reason") == REASON_DEGRADED
            and _attr(e, "generation") == 2 for e in spawned)
        # demand-driven scale-out specifically: floor/failure/degraded
        # spawns keep the fleet ALIVE, but the ramp's acceptance claim
        # is that load moved the replica count — only pressure/goodput
        # spawns prove that
        demand_spawns = sum(
            1 for e in spawned
            if _attr(e, "reason") in (REASON_PRESSURE, REASON_GOODPUT,
                                      REASON_ALERT))
        # alert evidence: the state-machine transitions the
        # router's evaluator journaled, and any spawn the pre-chewed
        # alert verdict (rather than the raw thresholds) drove
        alert_transitions = [
            {"alert": _attr(e, "alert"),
             "severity": _attr(e, "severity"),
             "from": _attr(e, "state_from"),
             "to": _attr(e, "state_to")}
            for e in rt.recorder.events(
                name=obs.ALERT_TRANSITION_EVENT)]
        alert_spawns = sum(1 for e in spawned
                           if _attr(e, "reason") == REASON_ALERT)
        report["fleet"] = {
            "max_replicas_observed": controller.max_observed,
            "final_replicas": controller.replica_count(),
            "reconcile_cycles": controller.cycles,
            "scale_up_events": scale_up,
            "demand_scale_up_events": demand_spawns,
            "scale_down_events": scale_down,
            "scaled_back_to_floor": scaled_back,
            "replicas_spawned": len(spawned),
            "replicas_stopped": len(stopped),
            "replaced_after_kill": replaced,
            "degraded_drained": degraded_drained,
            "respawned_on_new_generation": regen_spawn,
            "alert_scale_up_events": alert_spawns,
            "alert_transitions": alert_transitions,
            "metrics": fleet_metrics,
            "journal": [
                {"name": str(e.get("name")), "attrs": e.get("attrs")}
                for e in fleet_events
                if str(e.get("name")).startswith("tpu_fleet_")],
        }
        aborts = 0.0
        for name, labels, value in samples:
            if name == "tpu_router_requests_total" \
                    and labels.get("outcome") == "stream_abort":
                aborts += value
        evicted = [e for e in rt.recorder.events(
            name="tpu_router_replica_evicted")]
        report["chaos"] = {
            "killed_replica": killed.get("rid"),
            "kill_at_trace_ms": None if args.no_kill else kill_at_ms,
            "degrade_at_trace_ms":
                None if args.no_degrade else degrade_at_ms,
            "replica_evicted": bool(evicted),
            "stream_aborts": aborts,
            "replaced_after_kill": replaced,
            "degraded_drained": degraded_drained,
            # malformed = the client saw a torn stream (transport
            # error) or the router aborted mid-frame.  A well-formed
            # 502/503 terminal frame is the fleet answering HONESTLY
            # while short a replica — it costs goodput (gated
            # separately), it is not a framing violation.
            "frame_errors": (report["outcomes"].get(
                loadclient.OUTCOME_TRANSPORT, 0)
                if isinstance(report["outcomes"], dict) else 0)
            + int(aborts),
            "error_responses": report["outcomes"].get(
                loadclient.OUTCOME_ERROR, 0)
            if isinstance(report["outcomes"], dict) else 0,
            "attainment_windows": {
                name: {
                    "pre_kill": replay._attainment_window(
                        results, name, 0.0, kill_at_ms),
                    "kill_window": replay._attainment_window(
                        results, name, kill_at_ms,
                        kill_at_ms + replay.CHAOS_SETTLE_MS),
                    "post_kill": replay._attainment_window(
                        results, name,
                        kill_at_ms + replay.CHAOS_SETTLE_MS,
                        float("inf")),
                } for name in policies} if not args.no_kill else {},
        }
        rc = _gate(args, report)
        if args.metrics_out:
            with open(args.metrics_out, "w",
                      encoding="utf-8") as fh:
                fh.write(registry.render())
        if args.report:
            with open(args.report, "w", encoding="utf-8") as fh:
                json.dump(report, fh, indent=2, sort_keys=True)
                fh.write("\n")
        print(json.dumps({
            "target": report["target"],
            "classes": report["classes"],
            "outcomes": report["outcomes"],
            "fleet": {k: v for k, v in report["fleet"].items()
                      if k != "journal"},
            "chaos": {k: v for k, v in report["chaos"].items()
                      if k != "attainment_windows"},
            "elapsed_s": round(time.monotonic() - t0, 1),
        }, indent=2, sort_keys=True))
        return report, rc
    finally:
        faults.uninstall()
        controller.shutdown()
        rt.stop()


def _gate(args: argparse.Namespace, report: Dict[str, Any]) -> int:
    """The gate verdict from the report document alone."""
    rc = 0
    from .replay import _parse_goodput_specs

    classes = report.get("classes")
    classes = classes if isinstance(classes, dict) else {}
    tenants = report.get("tenants")
    tenants = tenants if isinstance(tenants, dict) else {}
    for name, floor in _parse_goodput_specs(
            args.assert_goodput or []).items():
        if name.startswith("tenant:"):
            row = tenants.get(name.partition(":")[2], {})
        else:
            row = classes.get(name, {})
        got = row.get("attainment") if isinstance(row, dict) else None
        if got is None or float(got) < floor:
            print(f"FLEET GATE FAIL: {name} attainment {got} < "
                  f"{floor}", file=sys.stderr)
            rc = 1
        else:
            print(f"fleet gate ok: {name} attainment {got} >= "
                  f"{floor}")
    if not args.assert_fleet:
        return rc
    fleet = report.get("fleet")
    fleet = fleet if isinstance(fleet, dict) else {}
    chaos = report.get("chaos")
    chaos = chaos if isinstance(chaos, dict) else {}
    checks: List[Tuple[str, bool]] = [
        ("scaled out past the floor",
         int(fleet.get("max_replicas_observed", 0)) >= 2),
        ("scale-up events counted on tpu_fleet_scale_events_total",
         float(fleet.get("scale_up_events", 0)) >= 1),
        ("ramp drove a demand scale-up (reason=pressure|goodput)",
         int(fleet.get("demand_scale_up_events", 0)) >= 1),
        ("scaled back to the floor on idle",
         bool(fleet.get("scaled_back_to_floor"))),
        ("zero malformed client frames",
         int(chaos.get("frame_errors", 0)) == 0),
    ]
    if not args.no_kill:
        checks.append(("killed replica replaced (spawn "
                       "reason=failure journaled)",
                       bool(fleet.get("replaced_after_kill"))))
    if not args.no_degrade:
        checks.append(("degraded slice drained (drain "
                       "reason=degraded journaled)",
                       bool(fleet.get("degraded_drained"))))
        checks.append(("replacement re-registered on the new "
                       "generation",
                       bool(fleet.get("respawned_on_new_generation"))))
    for what, ok in checks:
        if ok:
            print(f"fleet gate ok: {what}")
        else:
            print(f"FLEET GATE FAIL: {what}", file=sys.stderr)
            rc = 1
    return rc


# -- CLI --------------------------------------------------------------------


def _add_server_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--config", default="tiny",
                   help="model config for spawned replicas")
    p.add_argument("--slots", type=int, default=2)
    p.add_argument("--max-len", type=int, default=512)
    p.add_argument("--max-new-tokens", type=int, default=128)
    p.add_argument("--prefix-chunk", type=int, default=16)
    p.add_argument("--slo", action="append", default=None,
                   metavar="CLASS=ttft_ms[:deadline_ms]")
    p.add_argument("--compile-cache-dir", default="",
                   help="persistent compile cache to warm replica "
                        "cold starts (TPU_DP_COMPILE_CACHE_DIR)")
    p.add_argument("--device", default="",
                   help="torch device of spawned replicas (default: "
                        "cuda, required)")


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        description="Fleet control plane: the reconciler tying slice "
                    "labels to replica lifecycle")
    sub = p.add_subparsers(dest="mode", required=True)

    runp = sub.add_parser(
        "run", help="reconcile against a live router until SIGINT")
    runp.add_argument("--router", required=True, metavar="URL",
                      help="router base URL (http://host:port)")
    runp.add_argument("--capacity-spec", default="", metavar="FILE",
                      help="slice capacity JSON (re-read every cycle)")
    runp.add_argument("--membership", action="append", default=None,
                      metavar="FILE",
                      help="slice membership state file (repeatable; "
                           "the labeller-idiom capacity source)")
    runp.add_argument("--min-replicas", type=int, default=1)
    runp.add_argument("--max-replicas", type=int, default=4)
    runp.add_argument("--high-watermark", type=float, default=1.5)
    runp.add_argument("--low-watermark", type=float, default=0.25)
    runp.add_argument("--goodput-floor", type=float, default=0.7)
    runp.add_argument("--burn-rate-high", type=float, default=2.0)
    runp.add_argument("--up-stable", type=float, default=1.0)
    runp.add_argument("--down-stable", type=float, default=10.0)
    runp.add_argument("--idle-to-zero", type=float, default=60.0)
    runp.add_argument("--cooldown", type=float, default=5.0)
    runp.add_argument("--drain-timeout", type=float, default=30.0)
    runp.add_argument("--drain-min", type=float, default=1.0)
    runp.add_argument("--start-grace", type=float, default=120.0)
    runp.add_argument("--disagg", action="store_true",
                      help="spawn prefill/decode role replicas "
                           "driven by per-phase queue pressure")
    runp.add_argument("--interval", type=float, default=1.0)
    runp.add_argument("--duration", type=float, default=0.0,
                      help="stop after this many seconds (0 = run "
                           "until interrupted)")
    runp.add_argument("--seed", type=int, default=0)
    runp.add_argument("--fault-spec", default=None, metavar="SPEC")
    runp.add_argument("--metrics-out", default=None, metavar="FILE")
    _add_server_flags(runp)

    epp = sub.add_parser(
        "episode",
        help="the fleet gate: diurnal ramp + SIGKILL + degraded "
             "reshape against an in-process router")
    epp.add_argument("--seed", type=int, default=0)
    epp.add_argument("--max-replicas", type=int, default=3)
    epp.add_argument("--calm-requests", type=int, default=16)
    epp.add_argument("--peak-requests", type=int, default=72)
    epp.add_argument("--tail-requests", type=int, default=20)
    epp.add_argument("--calm-rate", type=float, default=2.0)
    epp.add_argument("--peak-rate", type=float, default=10.0)
    epp.add_argument("--high-watermark", type=float, default=1.0)
    epp.add_argument("--low-watermark", type=float, default=0.25)
    epp.add_argument("--up-stable-s", type=float, default=0.5)
    epp.add_argument("--down-stable-s", type=float, default=2.0)
    epp.add_argument("--cooldown-s", type=float, default=2.0)
    epp.add_argument("--drain-timeout-s", type=float, default=20.0)
    epp.add_argument("--kill-at-ms", type=float, default=None,
                     help="SIGKILL a managed replica at this trace "
                          "time (default: mid-peak)")
    epp.add_argument("--degrade-at-ms", type=float, default=None,
                     help="reshape the slice degraded at this trace "
                          "time (default: late-peak)")
    epp.add_argument("--no-kill", action="store_true")
    epp.add_argument("--no-degrade", action="store_true")
    epp.add_argument("--capacity-spec", default="", metavar="FILE")
    epp.add_argument("--workdir", default=".", metavar="DIR")
    epp.add_argument("--time-scale", type=float, default=1.0)
    epp.add_argument("--late-ms", type=float, default=100.0)
    epp.add_argument("--timeout-s", type=float, default=120.0)
    epp.add_argument("--settle-s", type=float, default=30.0,
                     help="post-trace window for the idle scale-in")
    epp.add_argument("--top-missed", type=int, default=3)
    epp.add_argument("--report", default=None, metavar="FILE")
    epp.add_argument("--metrics-out", default=None, metavar="FILE")
    epp.add_argument("--assert-goodput", action="append",
                     default=None,
                     metavar="CLASS=RATIO|tenant:NAME=RATIO")
    epp.add_argument("--assert-fleet", action="store_true",
                     help="fail unless the report proves scale-out, "
                          "failure replacement, degraded drain, and "
                          "idle scale-in")
    epp.add_argument("--fault-spec", default=None, metavar="SPEC")
    epp.add_argument("--incident-dir", default=None, metavar="DIR",
                     help="arm the episode router's incident "
                          "subscriber: a firing page writes one "
                          "fleet-level bundle (with per-replica "
                          "fragments) under DIR")
    _add_server_flags(epp)

    args = p.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")

    if args.mode == "episode":
        _, rc = run_episode(args)
        return rc

    registry = obs.Registry()
    recorder = obs.FlightRecorder(registry=registry)
    if args.fault_spec:
        faults.install(args.fault_spec, seed=args.seed,
                       recorder=recorder)
    controller = FleetController(
        args.router,
        config=PlannerConfig(
            min_replicas=args.min_replicas,
            max_replicas=args.max_replicas,
            high_watermark=args.high_watermark,
            low_watermark=args.low_watermark,
            goodput_floor=args.goodput_floor,
            burn_rate_high=args.burn_rate_high,
            up_stable_s=args.up_stable,
            down_stable_s=args.down_stable,
            idle_to_zero_s=args.idle_to_zero,
            cooldown_s=args.cooldown,
            drain_timeout_s=args.drain_timeout,
            drain_min_s=args.drain_min,
            start_grace_s=args.start_grace,
            disagg=args.disagg),
        server=ServerSpec(
            config=args.config, slots=args.slots,
            max_len=args.max_len,
            max_new_tokens=args.max_new_tokens,
            prefix_chunk=args.prefix_chunk,
            slo=tuple(args.slo or ()),
            compile_cache_dir=args.compile_cache_dir,
            device=args.device),
        capacity_spec=args.capacity_spec,
        membership_paths=tuple(args.membership or ()),
        interval_s=args.interval, seed=args.seed,
        registry=registry, recorder=recorder)
    try:
        controller.run(duration_s=args.duration)
    except KeyboardInterrupt:
        log.info("interrupted; draining managed replicas")
    finally:
        controller.shutdown()
        faults.uninstall()
        if args.metrics_out:
            with open(args.metrics_out, "w",
                      encoding="utf-8") as fh:
                fh.write(registry.render())
    return 0


if __name__ == "__main__":
    sys.exit(main())
