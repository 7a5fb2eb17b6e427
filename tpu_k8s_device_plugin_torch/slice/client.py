"""Per-host slice client: join with backoff, heartbeat, env contract.

The port's copy of the JAX package's ``slice/client.py``.  Every member
of the slice (the coordinator's own host included) runs one of these
inside its device plugin.  The client owns three things:

- **join**: polls the rendezvous service until the slice forms, with
  exponential backoff, and persists the learned membership to a local
  crash-safe state file so a restarted plugin knows its rank at once
  (and the node labeller can emit slice labels without talking gRPC);
- **heartbeat**: reports local GPU health each pulse and learns the
  slice-wide verdict from the response — the channel through which one
  host's faulty GPU flips every member's devices Unhealthy;
- **env contract**: what Allocate gives every container of a full-host
  grant.  This is the one deliberate change from the reference: its
  consumer is ``torch.distributed``, so the env carries the names its
  ``env://`` initialisation and ``torchrun`` read (``MASTER_ADDR``,
  ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``PET_NNODES``,
  ``PET_NODE_RANK``) where the reference's carries JAX's;
  ``constants.REFERENCE_SLICE_ENV`` maps one onto the other.
"""

from __future__ import annotations

import logging
import socket
import threading
import time
import uuid
from typing import Any, Callable, Dict, List, Optional, Tuple

import grpc

from .. import obs, resilience
from ..proto import (
    slice_pb2 as slicepb,
    slice_pb2_grpc as slicepb_grpc,
)
from ..resilience import faults
from ..types import constants
from .metrics import SliceMetrics
from .state import Membership, load_membership, save_membership

log = logging.getLogger(__name__)

# (healthy, reason) probe of this host's own GPUs; injected by the device
# impl so the client carries fresh local state in every heartbeat.
LocalHealthFn = Callable[[], Tuple[bool, str]]

_JOIN_BACKOFF_INITIAL_S = 0.5
_JOIN_BACKOFF_MAX_S = 15.0
_RPC_TIMEOUT_S = 10.0
# heartbeat circuit breaker: after this many consecutive failed
# heartbeats the client stops burning a full RPC timeout per pulse and
# fails fast until the reset window admits one probe heartbeat
_HB_BREAKER_THRESHOLD = 3
_HB_BREAKER_RESET_S = 30.0
# the RPC faults the retry/breaker machinery treats as transient
_TRANSIENT = (grpc.RpcError, faults.InjectedFault)


def _trace_metadata(trace: Optional[obs.TraceContext]
                    ) -> Tuple[Tuple[str, str], ...]:
    """gRPC metadata carrying the W3C traceparent (the HTTP header's
    metadata analog), or () when the caller runs untraced."""
    if trace is None:
        return ()
    return (("traceparent", trace.to_traceparent()),)


def _rpc_status_code(e: BaseException) -> Optional[Any]:
    """The grpc status code of an RpcError, or None for non-RPC faults
    (an InjectedFault carries no code)."""
    code = getattr(e, "code", None)
    return code() if callable(code) else None


def _membership_from_msg(m: Any) -> Optional[Membership]:
    if not m.hostnames:
        return None
    return Membership(
        slice_id=m.slice_id,
        generation=m.generation,
        hostnames=tuple(m.hostnames),
        coordinator_address=m.coordinator_address,
        reshaped_from=tuple(m.reshaped_from),
        degraded=m.degraded,
    )


class SliceClient:
    """One host's view of the slice."""

    def __init__(
        self,
        rendezvous_address: str,
        hostname: Optional[str] = None,
        coords: Tuple[int, ...] = (),
        chip_count: int = 0,
        state_path: Optional[str] = constants.SLICE_STATE_FILE,
        local_health_fn: Optional[LocalHealthFn] = None,
        registry: Optional[obs.Registry] = None,
        recorder: Optional[obs.FlightRecorder] = None,
        join_backoff_initial_s: float = _JOIN_BACKOFF_INITIAL_S,
        join_backoff_max_s: float = _JOIN_BACKOFF_MAX_S,
        rpc_timeout_s: float = _RPC_TIMEOUT_S,
        breaker_reset_s: float = _HB_BREAKER_RESET_S,
        seed: int = 0,
    ) -> None:
        self._address = rendezvous_address
        self.hostname = hostname or socket.gethostname()
        self._rpc_timeout_s = rpc_timeout_s
        # jittered-backoff schedule shared with every other boundary
        # in the repo (resilience.RetryPolicy); seeded so a chaos run
        # replays the same join timing
        self._join_policy = resilience.RetryPolicy(
            max_attempts=1 << 30,
            initial_backoff_s=join_backoff_initial_s,
            max_backoff_s=join_backoff_max_s,
            seed=seed,
        )
        # flight recorder: membership transitions and learned
        # verdicts journal here with the trace that delivered them
        self._recorder = recorder
        # slice metrics: join duration, learned-verdict
        # transitions, and this host's own heartbeat age (refreshed at
        # scrape time).  On the rendezvous host the coordinator shares
        # the registry, so instrument families dedupe onto one set.
        self.metrics: Optional[SliceMetrics] = None
        self._last_beat: Optional[float] = None
        self._join_started: Optional[float] = None
        self._res_metrics: Optional[resilience.ResilienceMetrics] = None
        if registry is not None:
            self.metrics = SliceMetrics(registry)
            self._res_metrics = resilience.ResilienceMetrics(registry)
            registry.on_collect(self._refresh_age)
        # a dead coordinator must not cost every pulse a full RPC
        # timeout: the breaker fails heartbeats fast once it opens and
        # admits one probe per reset window.  Verdict semantics are
        # unchanged — a failed (or skipped) heartbeat keeps the last
        # learned verdict, exactly like an unreachable coordinator.
        self._hb_breaker = resilience.CircuitBreaker(
            "slice.heartbeat",
            failure_threshold=_HB_BREAKER_THRESHOLD,
            reset_timeout_s=breaker_reset_s,
            metrics=self._res_metrics,
            recorder=recorder,
            logger=log,
        )
        self._coords = tuple(coords)
        self._chip_count = chip_count
        self._state_path = state_path
        self._local_health_fn = local_health_fn
        # fresh per process start: lets the coordinator tell a worker
        # restart apart from a duplicate hostname
        self._session = uuid.uuid4().hex
        # rising-edge guard so an eviction journals/counts once, not
        # once per pulse while we wait to rejoin
        self._evicted_flag = False
        self._lock = threading.Lock()
        self._membership: Optional[Membership] = None
        # reshape hook: called (old_membership, new_membership) whenever a
        # NEW generation is adopted over a previous one — the workload
        # layer (workloads.checkpoint.ReshapeSignal) and tests hang
        # checkpoint triggers here.
        # Exceptions are suppressed-but-accounted: a broken callback must
        # not break heartbeats.
        self._on_reshape: Optional[
            Callable[[Optional[Membership], Membership], None]] = None
        # None until the first heartbeat answer: "no verdict yet" must not
        # flip devices Unhealthy while the slice is still forming
        self._slice_healthy: Optional[bool] = None
        self._unhealthy_hosts: List[str] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # ONE channel for the client's lifetime (gRPC reconnects a
        # broken channel itself); the old fresh-channel-per-attempt
        # pattern leaked a socket + connect handshake per backoff poll
        self._ch: Optional[grpc.Channel] = None
        self._ch_lock = threading.Lock()
        if state_path:
            prior = load_membership(state_path)
            if prior is not None and prior.rank_of(self.hostname) is not None:
                # restarted worker: rank recovered without re-forming
                self._membership = prior
                log.info(
                    "recovered slice %s rank %d from %s",
                    prior.slice_id, prior.rank_of(self.hostname), state_path,
                )

    # -- join ---------------------------------------------------------------

    def _channel(self) -> grpc.Channel:
        """The client's one long-lived channel (created on first use,
        closed by stop()); stopped clients get a fresh one so a
        restarted client keeps working."""
        with self._ch_lock:
            if self._ch is None:
                self._ch = grpc.insecure_channel(self._address)
            return self._ch

    def _close_channel(self) -> None:
        with self._ch_lock:
            ch, self._ch = self._ch, None
        if ch is not None:
            try:
                ch.close()
            except Exception as e:
                resilience.suppressed("slice.channel_close", e,
                                      logger=log,
                                      metrics=self._res_metrics)

    def _join_once(self, trace: Optional[obs.TraceContext] = None
                   ) -> Optional[Membership]:
        """One Join poll; returns the membership when formed.  *trace*
        rides the gRPC metadata as a ``traceparent`` entry so the
        coordinator's join span shares this member's trace."""
        if faults.ACTIVE is not None:
            faults.ACTIVE.fire("slice.join")
        stub = slicepb_grpc.SliceRendezvousStub(self._channel())
        resp = stub.Join(
            slicepb.JoinRequest(
                hostname=self.hostname,
                coords=list(self._coords),
                chip_count=self._chip_count,
                session=self._session,
            ),
            timeout=self._rpc_timeout_s,
            metadata=_trace_metadata(trace),
        )
        if not resp.formed:
            log.info(
                "slice forming: %d/%d workers joined",
                resp.joined, resp.expected,
            )
            return None
        return _membership_from_msg(resp.membership)

    def join(self, timeout_s: float = 0.0) -> Membership:
        """Poll Join until the slice forms (exponential backoff, capped).
        ``timeout_s`` 0 means wait forever; on expiry raises TimeoutError.
        Safe to call again after a restart: the coordinator hands back the
        existing rank without re-forming."""
        deadline = time.monotonic() + timeout_s if timeout_s > 0 else None
        attempt = 0
        if self._join_started is None:
            self._join_started = time.monotonic()
        # one root trace covers the whole join (every poll carries it),
        # so the coordinator's view of this host's formation is one
        # /debug/traces query on the rendezvous node
        join_trace = obs.new_trace()
        while not self._stop.is_set():
            try:
                membership = self._join_once(trace=join_trace)
            except _TRANSIENT as e:
                code = _rpc_status_code(e)
                if code == grpc.StatusCode.FAILED_PRECONDITION:
                    # mis-sized slice or hostname drift: retrying cannot
                    # fix it, surface the coordinator's explanation
                    details = getattr(e, "details", None)
                    raise RuntimeError(
                        "slice join rejected: "
                        f"{details() if callable(details) else e}"
                    ) from e
                log.info("rendezvous %s unreachable (%s); retrying",
                         self._address, code if code is not None else e)
                if self._res_metrics is not None:
                    self._res_metrics.retries.labels(
                        op="slice.join").inc()
                membership = None
            if membership is not None:
                self._adopt(membership, trace=join_trace)
                return membership
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError(
                    f"slice did not form within {timeout_s:.0f}s "
                    f"(rendezvous {self._address})"
                )
            attempt += 1
            if self._stop.wait(self._join_policy.backoff_s(attempt)):
                break
        raise RuntimeError("slice client stopped before the slice formed")

    def set_reshape_callback(
        self,
        fn: Optional[Callable[[Optional[Membership], Membership], None]],
    ) -> None:
        """Wire the workload-side reshape hook (e.g.
        ``workloads.checkpoint.ReshapeSignal.fire``): invoked with
        (old_membership, new_membership) when a new generation is
        adopted."""
        self._on_reshape = fn

    def _adopt(self, membership: Membership,
               trace: Optional[obs.TraceContext] = None) -> None:
        with self._lock:
            prior = self._membership
            self._membership = membership
        if prior is None and self.metrics is not None \
                and self._join_started is not None:
            # formation latency as THIS host experienced it (first
            # join attempt to adopted membership)
            self.metrics.join_seconds.observe(
                time.monotonic() - self._join_started)
        if prior is None or prior.generation != membership.generation:
            rank = membership.rank_of(self.hostname)
            if self._recorder is not None:
                self._recorder.record(
                    "tpu_slice_membership_adopted", trace=trace,
                    slice_id=membership.slice_id,
                    generation=membership.generation,
                    rank=rank, workers=membership.num_workers,
                    degraded=membership.degraded,
                    reshaped_from=",".join(membership.reshaped_from)
                    or "-")
            log.info(
                "slice %s gen %d%s: rank %s of %d, coordinator %s",
                membership.slice_id, membership.generation,
                " (degraded)" if membership.degraded else "", rank,
                membership.num_workers, membership.coordinator_address,
            )
            if self._state_path:
                try:
                    save_membership(self._state_path, membership)
                except OSError as e:
                    log.error("cannot persist slice membership to %s: %s",
                              self._state_path, e)
            if prior is not None:
                # the identity contract just CHANGED under this host — a
                # reshape (or regrow) — which is what workloads key
                # checkpoint-restarts off
                if self.metrics is not None:
                    self.metrics.transition("reshape_adopted")
                if self._on_reshape is not None:
                    try:
                        self._on_reshape(prior, membership)
                    except Exception as e:
                        resilience.suppressed(
                            "slice.reshape_callback", e, logger=log,
                            metrics=self._res_metrics)

    # -- heartbeat ----------------------------------------------------------

    def heartbeat_now(self, trace: Optional[obs.TraceContext] = None
                      ) -> None:
        """One synchronous heartbeat: probe local health, report it, learn
        the slice verdict.  Joins first if the slice hasn't formed yet (a
        single non-blocking attempt).  Called from the manager's pulse
        loop (which passes its pulse-round trace, so the coordinator's
        heartbeat span shares it) and from the background thread; errors
        degrade to 'no verdict change', never raise."""
        ctx = trace if trace is not None else obs.new_trace()
        if not self._hb_breaker.allow():
            # circuit open: a dead coordinator already ate
            # failure_threshold RPC timeouts — skip this pulse's
            # heartbeat entirely (same verdict semantics as a failed
            # one) and let the breaker's reset window admit the probe
            log.debug("slice heartbeat skipped: breaker open for %s",
                      self._address)
            return
        try:
            current = self.membership
            if current is None:
                joined = self._join_once(trace=ctx)
                if joined is None:
                    return
                self._adopt(joined, trace=ctx)
                current = joined
            healthy, reason = True, ""
            if self._local_health_fn is not None:
                try:
                    healthy, reason = self._local_health_fn()
                except Exception as e:
                    # a broken probe is a fault report, not a crash: the
                    # peers must still learn this host can't vouch for
                    # its GPUs
                    log.warning("local health probe failed: %s", e)
                    healthy, reason = False, f"local probe error: {e}"
            if faults.ACTIVE is not None:
                faults.ACTIVE.fire("slice.heartbeat")
            stub = slicepb_grpc.SliceRendezvousStub(self._channel())
            resp = stub.Heartbeat(
                slicepb.HeartbeatRequest(
                    hostname=self.hostname,
                    healthy=healthy,
                    reason=reason,
                    generation=current.generation,
                ),
                timeout=self._rpc_timeout_s,
                metadata=_trace_metadata(ctx),
            )
        except _TRANSIENT as e:
            # An unreachable coordinator is NOT a slice-wide Unhealthy
            # verdict by itself (that would let one crashed pod demote
            # every node's devices); keep the last verdict and let the
            # coordinator's own staleness tracking judge us.
            self._hb_breaker.record_failure()
            code = _rpc_status_code(e)
            log.warning("slice heartbeat to %s failed: %s",
                        self._address,
                        code if code is not None else e)
            return
        self._hb_breaker.record_success()
        fresh = _membership_from_msg(resp.membership)
        if fresh is not None:
            self._adopt(fresh, trace=ctx)
            if fresh.rank_of(self.hostname) is None:
                # the slice reshaped WITHOUT us: this host was evicted
                # (grace window expired while it was faulty/silent).
                # Rejoin into the next generation once local GPUs are
                # healthy; the learned verdict below belongs to a slice
                # we are no longer part of, so skip it.
                self._last_beat = time.monotonic()
                self._handle_eviction(healthy, ctx)
                return
        self._evicted_flag = False
        self._last_beat = time.monotonic()
        with self._lock:
            prior = self._slice_healthy
            self._slice_healthy = resp.slice_healthy
            self._unhealthy_hosts = list(resp.unhealthy_hostnames)
        if prior is not None and prior != resp.slice_healthy:
            if self.metrics is not None:
                # the verdict as THIS host learned it (the coordinator
                # counts slice_demoted/slice_recovered at the source)
                self.metrics.transition(
                    "verdict_recovered" if resp.slice_healthy
                    else "verdict_demoted")
            if self._recorder is not None:
                # the learned-verdict flip IS the demotion/recovery
                # moment on this host — journal it with the heartbeat's
                # trace so the post-mortem links it to the pulse round
                self._recorder.record(
                    "tpu_slice_verdict_recovered" if resp.slice_healthy
                    else "tpu_slice_verdict_demoted",
                    trace=ctx,
                    slice_id=(self.membership.slice_id
                              if self.membership else ""),
                    unhealthy=",".join(resp.unhealthy_hostnames) or "-")
            log.warning(
                "slice %s -> %s%s",
                self.membership.slice_id if self.membership else "?",
                "healthy" if resp.slice_healthy else "UNHEALTHY",
                f" (members: {list(resp.unhealthy_hostnames)})"
                if not resp.slice_healthy else "",
            )

    def _handle_eviction(self, healthy: bool,
                         trace: Optional[obs.TraceContext]) -> None:
        """This host learned it is no longer a member (evicted by a
        reshape).  Journal it once, then — as soon as local GPUs are
        healthy — rejoin so the coordinator re-forms the NEXT generation
        around survivors + us.  While evicted, health_overlay() answers
        None: the devices advertise standalone (local) health only."""
        if not self._evicted_flag:
            self._evicted_flag = True
            m = self.membership
            log.warning(
                "evicted from slice %s (gen %d reshape); will rejoin the "
                "next generation when locally healthy",
                m.slice_id if m else "?",
                m.generation if m else -1)
            if self.metrics is not None:
                self.metrics.transition("evicted")
            if self._recorder is not None:
                self._recorder.record(
                    "tpu_slice_evicted", trace=trace,
                    slice_id=m.slice_id if m else "",
                    generation=m.generation if m else -1,
                    hostname=self.hostname)
        if not healthy:
            return
        try:
            rejoined = self._join_once(trace=trace)
        except _TRANSIENT as e:
            code = _rpc_status_code(e)
            log.warning("rejoin after eviction failed: %s",
                        code if code is not None else e)
            return
        if rejoined is not None \
                and rejoined.rank_of(self.hostname) is not None:
            self._evicted_flag = False
            self._adopt(rejoined, trace=trace)

    def start(
        self, period_s: float = constants.SLICE_HEARTBEAT_PERIOD_S
    ) -> "SliceClient":
        """Background join-then-heartbeat loop.  The manager's pulse also
        calls heartbeat_now() directly; both paths are lock-safe."""
        if self._thread is not None:
            return self

        def loop() -> None:
            while not self._stop.is_set():
                self.heartbeat_now()
                if self._stop.wait(period_s):
                    return

        self._thread = threading.Thread(
            target=loop, name="slice-heartbeat", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self._close_channel()

    def _refresh_age(self) -> None:
        """Scrape-time collector: this host's own heartbeat age (how
        stale our view of the slice verdict is)."""
        if self.metrics is None or self._last_beat is None:
            return
        self.metrics.heartbeat_age.labels(hostname=self.hostname).set(
            max(0.0, time.monotonic() - self._last_beat))

    # -- the contract consumed by Allocate / update_health ------------------

    @property
    def membership(self) -> Optional[Membership]:
        with self._lock:
            return self._membership

    @property
    def rank(self) -> Optional[int]:
        m = self.membership
        return m.rank_of(self.hostname) if m is not None else None

    def slice_env(self) -> Dict[str, str]:
        """Env every container of a full-host grant receives — identical
        on all members modulo the rank — for ``torch.distributed``'s
        ``env://`` initialisation and ``torchrun``, one process a host.
        Empty before formation and while this host is evicted."""
        m = self.membership
        if m is None:
            return {}
        rank = m.rank_of(self.hostname)
        if rank is None:
            return {}
        addr, _, port = m.coordinator_address.rpartition(":")
        return {
            constants.ENV_MASTER_ADDR: addr,
            constants.ENV_MASTER_PORT: port,
            constants.ENV_WORLD_SIZE: str(m.num_workers),
            constants.ENV_PET_NNODES: str(m.num_workers),
            constants.ENV_RANK: str(rank),
            constants.ENV_PET_NODE_RANK: str(rank),
            constants.ENV_SLICE_WORKER_HOSTNAMES: ",".join(m.hostnames),
            # generation stamp: workloads compare it against the live
            # membership file (ReshapeSignal) to detect that the slice
            # reshaped under them
            constants.ENV_TPU_SLICE_GENERATION: str(m.generation),
        }

    def health_overlay(self) -> Optional[Tuple[bool, List[str]]]:
        """(slice_healthy, unhealthy hostnames), or None while no verdict
        has arrived yet — ListAndWatch must not flap devices Unhealthy
        just because the slice is still forming.  Also None while this
        host is evicted from a reshaped slice: its devices advertise
        standalone (local) health, not a verdict about a slice it no
        longer belongs to."""
        with self._lock:
            if self._slice_healthy is None:
                return None
            m = self._membership
            if m is not None and m.rank_of(self.hostname) is None:
                return None
            return self._slice_healthy, list(self._unhealthy_hosts)
