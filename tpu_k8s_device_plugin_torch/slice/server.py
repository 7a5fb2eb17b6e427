"""Slice coordinator: serves SliceRendezvous for every member of one slice.

The port's copy of the JAX package's ``slice/server.py``.  Runs inside
the device plugin of the host named by ``--slice-rendezvous`` (the
plugin compares that hostname against its own and serves only when they
match: every member runs identical flags, one of them self-elects).  The
state machine lives in :mod:`.state`; this layer adds the gRPC surface,
locking and the wall clock.
"""

from __future__ import annotations

import concurrent.futures
import logging
import threading
import time
from typing import Any, Optional

import grpc

from .. import obs, resilience
from ..proto import (
    slice_pb2 as slicepb,
    slice_pb2_grpc as slicepb_grpc,
)
from ..types import constants
from .state import Membership, SliceState

log = logging.getLogger(__name__)


def _trace_from_context(context: Any) -> obs.TraceContext:
    """Continue the member's trace from the RPC metadata (the client
    sends a ``traceparent`` entry — the gRPC analog of the HTTP
    header), or open a fresh root for untraced callers."""
    header = None
    try:
        for key, value in context.invocation_metadata():
            if key == "traceparent":
                header = value
                break
    except Exception as e:
        # metadata access is best-effort, never fatal — but the
        # swallow is accounted (tpu_suppressed_errors_total) so a
        # flood of malformed metadata stays visible
        resilience.suppressed("slice.trace_metadata", e, logger=log)
    return obs.trace_from_header(header)


def _membership_msg(m: Optional[Membership]) -> Any:
    if m is None:
        return slicepb.Membership()
    return slicepb.Membership(
        slice_id=m.slice_id,
        generation=m.generation,
        num_workers=m.num_workers,
        hostnames=list(m.hostnames),
        coordinator_address=m.coordinator_address,
        reshaped_from=list(m.reshaped_from),
        degraded=m.degraded,
    )


class _Servicer(slicepb_grpc.SliceRendezvousServicer):
    def __init__(self, state: SliceState, lock: threading.Lock,
                 recorder: Optional[obs.FlightRecorder] = None) -> None:
        self._state = state
        self._lock = lock
        self._recorder = recorder

    def _record_generation_change(
        self,
        before: Optional[Membership],
        after: Optional[Membership],
        trace: obs.TraceContext,
    ) -> None:
        """Journal a reshape/regrow: the locked call just made a NEW
        generation (grace-window eviction or an evicted member
        returning) — the journal entry is the slice-wide evidence the
        chaos episodes assert on.  *before*/*after* are captured inside
        the state lock so concurrent RPCs journal their own transition,
        not each other's."""
        if self._recorder is None:
            return
        if after is None or before is None \
                or after.generation == before.generation:
            return
        self._recorder.record(
            "tpu_slice_reshaped", trace=trace,
            slice_id=after.slice_id,
            generation=after.generation,
            workers=after.num_workers,
            degraded=after.degraded,
            reshaped_from=",".join(after.reshaped_from) or "-",
            previous=before.slice_id)

    def Join(self, request: Any, context: Any) -> Any:
        # the member's trace rides the RPC metadata: the coordinator's
        # join record shares it, so one id greps across both hosts
        trace = _trace_from_context(context)
        with self._lock:
            before = self._state.membership
            res = self._state.join(
                hostname=request.hostname,
                coords=tuple(request.coords),
                chip_count=request.chip_count,
                session=request.session,
                now=time.monotonic(),
            )
            after = self._state.membership
        self._record_generation_change(before, after, trace)
        if self._recorder is not None:
            self._recorder.record(
                "tpu_slice_join", trace=trace,
                hostname=request.hostname, formed=res.formed,
                joined=res.joined, expected=res.expected,
                error=res.error or "")
        log.debug("span=tpu_slice_join trace_id=%s hostname=%s "
                  "formed=%s joined=%d/%d", trace.trace_id,
                  request.hostname, res.formed, res.joined,
                  res.expected)
        if res.error and res.membership is None:
            # a non-member knocking on a full-but-unformed slice, or a
            # malformed request: refuse loudly so the operator sees a
            # mis-sized --slice-workers instead of a hung formation
            context.abort(grpc.StatusCode.FAILED_PRECONDITION, res.error)
        if res.error:
            # formed slice, unknown host: same refusal, but the membership
            # in the details log helps diagnose a hostname drift
            context.abort(
                grpc.StatusCode.FAILED_PRECONDITION,
                f"{res.error} (members: {list(res.membership.hostnames)})",
            )
        return slicepb.JoinResponse(
            formed=res.formed,
            rank=res.rank,
            joined=res.joined,
            expected=res.expected,
            membership=_membership_msg(res.membership),
        )

    def Heartbeat(self, request: Any, context: Any) -> Any:
        trace = _trace_from_context(context)
        with self._lock:
            before = self._state.membership
            view = self._state.heartbeat(
                hostname=request.hostname,
                healthy=request.healthy,
                reason=request.reason,
                now=time.monotonic(),
            )
            after = self._state.membership
        self._record_generation_change(before, after, trace)
        if self._recorder is not None:
            self._recorder.record(
                "tpu_slice_heartbeat", trace=trace,
                hostname=request.hostname, healthy=request.healthy,
                reason=request.reason or "",
                slice_healthy=view.slice_healthy)
        log.debug("span=tpu_slice_heartbeat trace_id=%s hostname=%s "
                  "healthy=%s slice_healthy=%s", trace.trace_id,
                  request.hostname, request.healthy,
                  view.slice_healthy)
        return slicepb.HeartbeatResponse(
            slice_healthy=view.slice_healthy,
            unhealthy_hostnames=view.unhealthy_hostnames,
            membership=_membership_msg(view.membership),
        )


class SliceCoordinator:
    """Owns the rendezvous gRPC server + the slice state machine."""

    def __init__(
        self,
        expected_workers: int,
        bind_address: str = f"[::]:{constants.SLICE_RENDEZVOUS_PORT}",
        master_port: int = constants.SLICE_MASTER_PORT,
        state_path: Optional[str] = constants.SLICE_STATE_FILE,
        heartbeat_timeout_s: float = constants.SLICE_HEARTBEAT_TIMEOUT_S,
        registry: Optional[obs.Registry] = None,
        recorder: Optional[obs.FlightRecorder] = None,
        reshape_grace_s: float = constants.SLICE_RESHAPE_GRACE_S,
    ) -> None:
        self._lock = threading.Lock()
        # flight recorder: join/heartbeat events land here with each
        # MEMBER'S trace-id from the RPC metadata — the coordinator's
        # journal is the slice-wide timeline
        self.recorder = recorder
        # slice metrics: formation/transition counters, the
        # demotion-propagation histogram, and a scrape-time collector
        # refreshing per-member heartbeat ages.  The CLI passes the
        # plugin manager's registry so the debug /metrics scrape on the
        # rendezvous host carries the whole slice's coordination state.
        from .metrics import SliceMetrics

        self.metrics: Optional[SliceMetrics] = None
        if registry is not None:
            self.metrics = SliceMetrics(registry)
        self.state = SliceState(
            expected_workers=expected_workers,
            master_port=master_port,
            state_path=state_path,
            heartbeat_timeout_s=heartbeat_timeout_s,
            epoch=time.monotonic(),
            metrics=self.metrics,
            reshape_grace_s=reshape_grace_s,
        )
        if registry is not None:
            def _refresh() -> None:
                with self._lock:
                    self.state.refresh_ages(time.monotonic())

            registry.on_collect(_refresh)
        self._bind_address = bind_address
        self._server: Optional[grpc.Server] = None
        self.port: int = 0

    def start(self) -> "SliceCoordinator":
        self._server = grpc.server(
            concurrent.futures.ThreadPoolExecutor(max_workers=8)
        )
        slicepb_grpc.add_SliceRendezvousServicer_to_server(
            _Servicer(self.state, self._lock, recorder=self.recorder),
            self._server
        )
        self.port = self._server.add_insecure_port(self._bind_address)
        if self.port == 0:
            raise RuntimeError(
                f"cannot bind slice rendezvous on {self._bind_address}"
            )
        self._server.start()
        log.info(
            "slice rendezvous serving on %s (expecting %d workers)",
            self._bind_address, self.state.expected,
        )
        return self

    def stop(self) -> None:
        if self._server is not None:
            self._server.stop(grace=1.0).wait()
            self._server = None
