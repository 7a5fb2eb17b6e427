"""Rendezvous state machine + crash-safe membership persistence.

The port's copy of the JAX package's ``slice/state.py`` (the port
imports nothing of that package), decision for decision: the same
ranks, generations, slice ids, reshape lineage and membership file, so
a file either package writes loads in the other to an equal
``Membership``.  The one difference is the coordinator address: rank
0's hostname with the workload's ``torch.distributed`` port
(``constants.SLICE_MASTER_PORT``) where the reference puts its JAX
coordinator port; the port is a parameter either way.

Pure logic layer: no gRPC, no wall clock (callers inject ``now``), so a
fuzz sweep can drive random join/leave/restart orderings directly and
assert the invariants that matter:

- ranks are a pure function of the member set (sorted by the stated
  coordinates, then hostname), never of join order;
- a restarted coordinator or worker recovers the formed membership from
  the state file without re-forming the slice (same ranks, same
  generation);
- slice health is the conjunction of every member's reported health and
  heartbeat freshness.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import tempfile
from dataclasses import dataclass, field
from typing import (
    TYPE_CHECKING,
    Any,
    Dict,
    List,
    Optional,
    Set,
    Tuple,
)

if TYPE_CHECKING:  # typing only: this layer stays pure/metrics-free
    from .metrics import SliceMetrics

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


def save_membership(
    path: str,
    membership: Membership,
    member_coords: Optional[Dict[str, Tuple[int, ...]]] = None,
    evicted: Optional[Set[str]] = None,
) -> None:
    """Atomic write (tmp + rename in the target dir): a crash mid-write
    must leave either the old file or the new one, never a torn JSON —
    the whole point of the state file is surviving exactly such crashes.

    *member_coords* (coordinator only) additionally persists each
    member's stated coordinate so a re-form AFTER a coordinator crash
    still ranks by physical order instead of falling back to hostname
    sort; *evicted* (coordinator only) persists the reshape-evicted set
    so a revived coordinator still recognizes returnees.  Callers that
    omit them (clients) PRESERVE whatever the file already holds — on
    the rendezvous host the coordinator and the local client share one
    state file, and a client-side save must not clobber the
    coordinator's crash-recovery keys."""
    payload = membership.to_dict()
    prior: Optional[Dict[str, Any]] = None
    if member_coords is None or evicted is None:
        try:
            with open(path, "r", encoding="utf-8") as f:
                loaded = json.load(f)
            prior = loaded if isinstance(loaded, dict) else None
        except (OSError, ValueError):
            prior = None
    if member_coords is not None:
        payload["member_coords"] = {
            h: list(c) for h, c in sorted(member_coords.items())}
    elif prior is not None and "member_coords" in prior:
        payload["member_coords"] = prior["member_coords"]
    if evicted is not None:
        payload["evicted"] = sorted(str(h) for h in evicted)
    elif prior is not None and "evicted" in prior:
        payload["evicted"] = prior["evicted"]
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".membership-")
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            json.dump(payload, f, indent=1)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def load_member_coords(path: str) -> Dict[str, Tuple[int, ...]]:
    """The persisted per-member coordinates ({} when absent or
    unreadable) — the coordinator's crash-recovery complement to
    :func:`load_membership`."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            d = json.load(f)
        raw = d.get("member_coords", {})
        return {str(h): tuple(int(x) for x in c)
                for h, c in raw.items()}
    except (OSError, ValueError, TypeError, AttributeError):
        return {}


def load_evicted(path: str) -> Set[str]:
    """The persisted reshape-evicted hostnames (empty when absent or
    unreadable) — lets a revived coordinator keep recognizing returnees
    instead of treating them as strangers."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            d = json.load(f)
        return {str(h) for h in d.get("evicted", ())}
    except (OSError, ValueError, TypeError, AttributeError):
        return set()


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


@dataclass
class _Member:
    hostname: str
    coords: Tuple[int, ...] = ()
    chip_count: int = 0
    session: str = ""
    healthy: bool = True
    reason: str = ""
    # None = not heard from since this coordinator incarnation started;
    # freshness is then measured from the incarnation epoch, so a restart
    # doesn't instantly declare every member stale.
    last_seen: Optional[float] = None
    departed: bool = False


def _slice_id(hostnames: List[str]) -> str:
    h = hashlib.sha256("\n".join(hostnames).encode("utf-8"))
    return h.hexdigest()[:12]


@dataclass
class JoinResult:
    formed: bool
    rank: int = -1
    joined: int = 0
    expected: int = 0
    membership: Optional[Membership] = None
    error: str = ""


@dataclass
class HealthView:
    slice_healthy: bool = True
    unhealthy_hostnames: List[str] = field(default_factory=list)
    membership: Optional[Membership] = None


class SliceState:
    """Rendezvous + health bookkeeping for one slice.

    Not thread-safe by itself — the gRPC servicer wraps calls in a lock;
    the fuzz harness drives it single-threaded.
    """

    def __init__(
        self,
        expected_workers: int,
        master_port: int,
        state_path: Optional[str] = None,
        heartbeat_timeout_s: float = 0.0,
        epoch: float = 0.0,
        metrics: Optional["SliceMetrics"] = None,
        reshape_grace_s: float = 0.0,
    ) -> None:
        if expected_workers < 1:
            raise ValueError(f"expected_workers must be >= 1, got "
                             f"{expected_workers}")
        self.expected = expected_workers
        self.master_port = master_port
        self.state_path = state_path
        # 0 disables staleness demotion (tests drive heartbeats manually)
        self.heartbeat_timeout_s = heartbeat_timeout_s
        # 0 disables degraded-mode reshaping: the slice stays demoted
        # until every member recovers (the pre-reshape contract).  > 0:
        # a member's first unhealthy observation opens its own reshape
        # window; members still unhealthy at their window's expiry are
        # evicted and the survivors re-form under the next generation.
        self.reshape_grace_s = reshape_grace_s
        # per-member window clocks: hostname -> first time it was seen
        # unhealthy in the current incident.  Per-member (not one global
        # window) so a member that blips just before another member's
        # window expires still gets its full grace period.
        self._unhealthy_since: Dict[str, float] = {}
        # hosts evicted by a reshape: a returning one is re-admitted
        # into the NEXT generation (never resurrects the old one)
        self._evicted: Set[str] = set()
        self._epoch = epoch
        self._members: Dict[str, _Member] = {}
        self._membership: Optional[Membership] = None
        self._generation = 0
        # optional SliceMetrics (slice.metrics): transition counters,
        # demotion-propagation histogram, heartbeat-age refresh.  None
        # keeps this layer pure in the fuzz harness.
        self._metrics = metrics
        # propagation tracking: when the slice verdict flips unhealthy
        # at time T, each member's NEXT heartbeat response delivers the
        # demotion — observing (delivery - T) per member is the window
        # in which that member still advertised Healthy devices
        self._last_verdict: Optional[bool] = None
        self._demoted_at: float = 0.0
        self._awaiting_delivery: Set[str] = set()
        if state_path:
            prior = load_membership(state_path)
            if prior is not None:
                # Crash recovery: adopt the persisted slice as-is.  Members
                # exist from the start (ranks already assigned); they
                # refresh their sessions as they heartbeat/rejoin.  Their
                # persisted coordinates come back too, so a LATER
                # re-form (reshape/regrow) still ranks by physical
                # order.
                prior_coords = load_member_coords(state_path)
                self._membership = prior
                self._generation = prior.generation
                # the evicted set survives the crash too: returnees are
                # recognized as such, not treated as strangers
                self._evicted = (load_evicted(state_path)
                                 - set(prior.hostnames))
                for hostname in prior.hostnames:
                    self._members[hostname] = _Member(
                        hostname=hostname,
                        coords=prior_coords.get(hostname, ()))
                log.info(
                    "recovered slice %s gen %d (%d workers) from %s",
                    prior.slice_id, prior.generation,
                    prior.num_workers, state_path,
                )

    # -- rendezvous ---------------------------------------------------------

    def join(
        self,
        hostname: str,
        coords: Tuple[int, ...] = (),
        chip_count: int = 0,
        session: str = "",
        now: float = 0.0,
    ) -> JoinResult:
        """Idempotent join/poll.  Workers call this until ``formed``."""
        if not hostname:
            return JoinResult(formed=False, error="empty hostname")
        member = self._members.get(hostname)
        if member is None:
            if self._membership is not None:
                # Readmission requires an OPEN SEAT: re-forming past
                # expected_workers would hand out more ranks than the
                # physical topology holds (WORLD_SIZE > hosts),
                # and a full healthy slice must never be generation-
                # bumped (checkpoint-restarting every workload) by a
                # returnee whose seat was already refilled.
                if (self.reshape_grace_s > 0
                        and len(self._members) < self.expected
                        and (
                            hostname in self._evicted
                            # a coordinator revived from a pre-eviction-
                            # persistence state file (or whose persist
                            # failed) forgets who it evicted: while the
                            # slice runs degraded below its configured
                            # size, an unknown joiner is treated as a
                            # returning member (repair), never on a
                            # full healthy slice
                            or self._membership.degraded
                        )):
                    # A member evicted by a reshape is returning: it joins
                    # the NEXT generation — survivors + returnee re-form
                    # immediately (rank contract changes, workloads
                    # checkpoint-restart) — never the generation it was
                    # evicted from.
                    return self._readmit(
                        hostname, coords=coords, chip_count=chip_count,
                        session=session, now=now)
                # Formed slice, unknown host: ranks are already handed to
                # running containers — admitting a stranger would silently
                # change the contract under them.
                return JoinResult(
                    formed=True,
                    membership=self._membership,
                    joined=len(self._members),
                    expected=self.expected,
                    error=(
                        f"slice {self._membership.slice_id} is formed and "
                        f"{hostname!r} is not a member"
                    ),
                )
            if len(self._members) >= self.expected:
                return JoinResult(
                    formed=False,
                    joined=len(self._members),
                    expected=self.expected,
                    error=f"slice already has {self.expected} joiners",
                )
            member = _Member(hostname=hostname)
            self._members[hostname] = member
        elif member.session and session and member.session != session:
            log.info("worker %s restarted (session %s -> %s)",
                     hostname, member.session[:8], session[:8])
        member.coords = tuple(coords)
        member.chip_count = chip_count
        member.session = session
        member.departed = False
        member.last_seen = now
        if self._membership is None and len(self._members) == self.expected:
            self._form()
        m = self._membership
        rank = m.rank_of(hostname) if m is not None else -1
        return JoinResult(
            formed=m is not None,
            rank=rank if rank is not None else -1,
            joined=len(self._members),
            expected=self.expected,
            membership=m,
        )

    def _form(self, lineage: Tuple[str, ...] = ()) -> None:
        """Assign deterministic ranks: members WITH stated coordinates
        sort first by coordinate (rank order then follows the physical
        layout the operator stated), coordinate-less members after them
        by hostname.  Join order never matters.
        *lineage* carries the reshape ancestry into the new generation."""
        ordered = sorted(
            self._members.values(),
            key=lambda mb: (0, mb.coords, mb.hostname) if mb.coords
            else (1, (), mb.hostname),
        )
        counts = {mb.chip_count for mb in ordered if mb.chip_count}
        if len(counts) > 1:
            log.warning(
                "heterogeneous GPU counts across slice members: %s",
                {mb.hostname: mb.chip_count for mb in ordered},
            )
        hostnames = [mb.hostname for mb in ordered]
        self._generation += 1
        self._membership = Membership(
            slice_id=_slice_id(hostnames),
            generation=self._generation,
            hostnames=tuple(hostnames),
            coordinator_address=f"{hostnames[0]}:{self.master_port}",
            reshaped_from=lineage,
            degraded=len(hostnames) < self.expected,
        )
        log.info("slice %s formed (gen %d%s): ranks %s, coordinator %s",
                 self._membership.slice_id, self._generation,
                 ", degraded" if self._membership.degraded else "",
                 hostnames, self._membership.coordinator_address)
        if self._metrics is not None:
            self._metrics.transition("formed")
        if self.state_path:
            try:
                save_membership(
                    self.state_path, self._membership,
                    member_coords={mb.hostname: mb.coords
                                   for mb in ordered},
                    evicted=set(self._evicted))
            except OSError as e:
                # Keep serving: persistence failing degrades crash
                # recovery, not the live slice.
                log.error("cannot persist slice state to %s: %s",
                          self.state_path, e)

    def _readmit(
        self,
        hostname: str,
        coords: Tuple[int, ...],
        chip_count: int,
        session: str,
        now: float,
    ) -> JoinResult:
        """Re-admit a reshape-evicted host: survivors + returnee re-form
        into the next generation (lineage extended with the generation
        being left behind)."""
        old = self._membership
        assert old is not None
        self._evicted.discard(hostname)
        self._members[hostname] = _Member(
            hostname=hostname, coords=tuple(coords),
            chip_count=chip_count, session=session, last_seen=now,
        )
        log.info("evicted member %s returned; re-forming slice %s into "
                 "the next generation", hostname, old.slice_id)
        self._form(lineage=old.reshaped_from + (old.slice_id,))
        if self._metrics is not None:
            self._metrics.reshape_outcome("grown")
        m = self._membership
        assert m is not None
        rank = m.rank_of(hostname)
        return JoinResult(
            formed=True,
            rank=rank if rank is not None else -1,
            joined=len(self._members),
            expected=self.expected,
            membership=m,
        )

    def leave(self, hostname: str) -> None:
        """Explicit departure.  Before formation the seat frees up; after,
        the member set (and every rank) is immutable — the host is marked
        departed, which drags slice health down until it rejoins."""
        member = self._members.get(hostname)
        if member is None:
            return
        if self._membership is None:
            del self._members[hostname]
        else:
            member.departed = True
            member.session = ""

    # -- health -------------------------------------------------------------

    def heartbeat(
        self,
        hostname: str,
        healthy: bool,
        reason: str = "",
        now: float = 0.0,
    ) -> HealthView:
        member = self._members.get(hostname)
        if member is not None:
            was = (member.healthy, member.departed)
            member.healthy = healthy
            member.reason = reason
            member.last_seen = now
            member.departed = False
            if (healthy, False) != was:
                log.info("slice member %s -> %s%s", hostname,
                         "healthy" if healthy else "UNHEALTHY",
                         f" ({reason})" if reason else "")
                if self._metrics is not None:
                    self._metrics.transition(
                        "member_recovered" if healthy
                        else "member_unhealthy")
        if self._metrics is not None:
            self._metrics.heartbeats.inc()
        view = self.health(now)
        if (self._metrics is not None and not view.slice_healthy
                and hostname in self._awaiting_delivery):
            # this response carries the demoted verdict to *hostname*
            # for the first time since the flip: the propagation window
            # for this member closes here
            self._awaiting_delivery.discard(hostname)
            self._metrics.demotion_propagation.observe(
                max(0.0, now - self._demoted_at))
        return view

    def _unhealthy(self, now: float) -> List[str]:
        """Members currently dragging the verdict down: reported
        unhealthy, departed, or (when a timeout is configured) silent."""
        unhealthy: List[str] = []
        for mb in self._members.values():
            if not mb.healthy or mb.departed:
                unhealthy.append(mb.hostname)
                continue
            if self.heartbeat_timeout_s > 0:
                seen = mb.last_seen if mb.last_seen is not None else self._epoch
                if now - seen > self.heartbeat_timeout_s:
                    unhealthy.append(mb.hostname)
        return unhealthy

    def _reshape_tick(self, unhealthy: List[str], now: float) -> List[str]:
        """Degraded-mode reshape windows (reshape_grace_s > 0, formed
        slice).  Each member's FIRST unhealthy observation opens that
        member's own grace window (a single global window would evict a
        member that blips just before another member's expiry with
        near-zero individual grace); recovery inside the window cancels
        that member's clock (the original generation holds, demote-all
        semantics meanwhile); a member still unhealthy when its own
        window expires is evicted and the survivors — including members
        whose windows are still running — re-form into a smaller slice
        under the next generation.  Returns the (possibly recomputed)
        unhealthy set."""
        current = set(unhealthy)
        recovered = [h for h in self._unhealthy_since if h not in current]
        for h in recovered:
            # recovered inside its window: this member's clock cancels
            del self._unhealthy_since[h]
        if not current:
            if recovered:
                # every member recovered inside its grace window: no
                # reshape, the original generation holds
                log.info("reshape window cancelled: all members of slice "
                         "%s recovered within the grace period",
                         self._membership.slice_id
                         if self._membership else "?")
                if self._metrics is not None:
                    self._metrics.reshape_outcome("cancelled")
            return unhealthy
        fresh = sorted(h for h in current
                       if h not in self._unhealthy_since)
        for h in fresh:
            self._unhealthy_since[h] = now
        if fresh:
            log.warning(
                "reshape window opened for members %s; evicting in "
                "%.1fs unless they recover", fresh, self.reshape_grace_s)
        evict = {h for h in current
                 if now - self._unhealthy_since[h] >= self.reshape_grace_s}
        if not evict:
            return unhealthy
        survivors = [h for h in self._members if h not in evict]
        if not survivors:
            # no valid smaller topology to re-form onto; stay demoted
            # and keep watching (fresh windows restart the clocks)
            self._unhealthy_since.clear()
            if self._metrics is not None:
                self._metrics.reshape_outcome("no_survivors")
            return unhealthy
        old = self._membership
        assert old is not None
        # incident duration: from the oldest evicted member's window
        incident_started = min(self._unhealthy_since[h] for h in evict)
        for h in sorted(evict):
            self._members.pop(h, None)
            self._evicted.add(h)
            del self._unhealthy_since[h]
        log.warning(
            "reshaping slice %s: evicted %s after %.1fs grace; "
            "re-forming over survivors %s", old.slice_id, sorted(evict),
            now - incident_started, sorted(survivors))
        self._form(lineage=old.reshaped_from + (old.slice_id,))
        if self._metrics is not None:
            self._metrics.reshape_outcome("reshaped")
            self._metrics.reshape_seconds.observe(
                max(0.0, now - incident_started))
        # evicted members owe no verdict deliveries anymore
        self._awaiting_delivery -= evict
        return self._unhealthy(now)

    def health(self, now: float = 0.0) -> HealthView:
        """Slice-wide verdict: every member healthy, present, and (when a
        timeout is configured) recently heard from.  With a reshape grace
        configured, a persistently-unhealthy member set is evicted here
        (see :meth:`_reshape_tick`) instead of demoting forever."""
        unhealthy = self._unhealthy(now)
        if self._membership is not None and self.reshape_grace_s > 0:
            unhealthy = self._reshape_tick(unhealthy, now)
        formed = self._membership is not None
        verdict = formed and not unhealthy
        if formed and verdict != self._last_verdict:
            if self._last_verdict is not None or not verdict:
                if self._metrics is not None:
                    self._metrics.transition(
                        "slice_recovered" if verdict
                        else "slice_demoted")
            if not verdict:
                # start the propagation clock: every member owes a
                # delivery of this verdict on its next heartbeat
                self._demoted_at = now
                self._awaiting_delivery = set(self._members)
            else:
                self._awaiting_delivery = set()
            self._last_verdict = verdict
        return HealthView(
            slice_healthy=verdict,
            unhealthy_hostnames=sorted(unhealthy),
            membership=self._membership,
        )

    # -- introspection ------------------------------------------------------

    def refresh_ages(self, now: float) -> None:
        """Refresh the per-member heartbeat-age gauge (scrape-time
        collector: ages are derived, not stored).  Members never heard
        from this incarnation age from the coordinator epoch, matching
        the staleness rule in :meth:`health`."""
        if self._metrics is None:
            return
        gauge = self._metrics.heartbeat_age
        gauge.clear()
        for mb in self._members.values():
            seen = mb.last_seen if mb.last_seen is not None else self._epoch
            gauge.labels(hostname=mb.hostname).set(max(0.0, now - seen))

    @property
    def membership(self) -> Optional[Membership]:
        return self._membership

    @property
    def joined(self) -> int:
        return len(self._members)
