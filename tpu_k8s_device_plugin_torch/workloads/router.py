"""Multi-replica serving router: prefix-affinity + least-loaded + failover.

One engine behind one HTTP server is the per-replica throughput
ceiling; this module is the horizontal-scale tier above it — a thin,
dependency-free HTTP router that fronts N ``workloads.server``
replicas and multiplies aggregate tokens/sec while PRESERVING the
prefix-cache hit rates the paged-KV copy-on-write pool makes cheap
(the replica-routing posture of production serving stacks: a shared
prefix is only warm on the replica that decoded it last).

Deliberately torch-free (stdlib + ``obs`` + ``resilience`` only): the
router runs on any box — a 1-vCPU sidecar, the benchmark process, a CI
runner — and never pays an accelerator runtime import for what is
pure socket work.

Replica discovery (slice-coordinator-style registration + heartbeats):
replicas self-register over ``POST /register`` with their address,
model id, and capacity (``workloads.server --register-with`` does this
on a loop); each re-registration is the heartbeat, and a replica that
stops heartbeating AND stops answering the ``/statz`` poll past
``replica_ttl_s`` is evicted.  No config files, no ordering: replicas
may register before or after the router takes traffic, and a restarted
router relearns the fleet from the next heartbeat round.

Routing is two-tier:

1. **Prefix affinity** — a consistent hash (SHA-1 ring, ``vnodes``
   virtual points per replica) over the prompt's leading
   ``prefix_chunk``-aligned tokens.  Repeat and shared-prefix traffic
   lands on the replica whose paged KV pool already holds those pages
   (the engine's APC matches whole admission chunks, so the hash key
   aligns to the same grid).  The ring depends ONLY on the sorted
   replica ids — the same prompt maps to the same replica across
   router restarts and registration orderings.
2. **Least-loaded fallback** — when the affinity target is down,
   breaker-open, or overloaded (queue depth + in-flight past
   ``overload_factor``x its capacity), the request falls back to the
   lowest ``(queue + in_flight) / capacity`` replica.  The load signal
   is each replica's ``/statz`` JSON snapshot (queue depth, in-flight,
   free KV pages, scheduler health), polled on a short cadence and
   cached — the hot path never parses Prometheus text or blocks on a
   health probe.

**Disaggregated prefill/decode (router v2).**  Replicas register a
role (``mixed`` | ``prefill`` | ``decode``); when both specialized
classes are routable, prefill-heavy requests (prompt length >=
``prefill_threshold``, or explicit unary completions) route
phase-aware: the prefill replica runs packed prefill only and answers
with its bit-exact KV checkpoint (``prefill_only`` marker), the
router ships that payload to a decode replica's internal
``POST /migrate``, and the decode replica resumes the slot and takes
over the client stream — outputs byte-identical to single-replica
serving (the DistServe/Splitwise phase split).  Every failure mode
falls back BEFORE any client byte: the request re-routes whole
through the normal path.  Role-filtered ring walks keep phase
affinity deterministic over the id+role set.

**Globally-correct tenant quotas.**  A SECOND hash ring (distinct
salt) pins each tenant to one replica (``tenant_pinning``), making
replica-local buckets/WFQ chains globally coherent per tenant; and
router-level token buckets (``tenant_quotas``, same grammar and
semantics as the serving flag) charge the same prompt+budget
estimate at route time — the arbiter when role routing overrides
pinning.  Either way a tenant's fleet-wide rate is RATE, not
RATE x replicas.

Failover rides the resilience layer: a per-replica
:class:`~tpu_k8s_device_plugin_torch.resilience.CircuitBreaker` plus a
seeded :class:`~tpu_k8s_device_plugin_torch.resilience.RetryPolicy`.  A
connect error or 5xx BEFORE any body byte was forwarded retries on the
next-best replica (the failed one excluded, its breaker recording the
failure); once streaming has started the router never re-frames or
replays — a mid-stream replica death terminates the stream with a
well-formed in-band error frame (JSON-lines or SSE, matching the
response content type) and opens the breaker so the next request
routes around the corpse.

Streaming is passed through BYTE-IDENTICAL: the router de-chunks the
replica's response and re-chunks the same bytes — it never parses,
buffers whole, or re-frames a stream (the equivalence suite pins
router-vs-direct byte equality for JSON-lines and SSE).  ``traceparent``
propagates through the hop as a child context and every response
carries ``X-Replica`` naming the replica that served it.

API:

  POST /generate | /v1/completions | /v1/chat/completions
                     proxied to one replica (affinity -> least-loaded)
  POST /register     replica registration + heartbeat:
                     {"address": "host:port", "replica_id"?, "model"?,
                      "capacity"?} -> {"ok": true, "interval_s": ...}
  GET  /healthz      200 when >= 1 routable replica, else 503
  GET  /replicas     the replica table (id, address, health, load)
  GET  /metrics      tpu_router_* families (Prometheus exposition;
                     OpenMetrics content negotiation like every other
                     surface)
  GET  /fleet/statz  one fleet snapshot: per-replica statz plus
                     aggregated queue/shed/goodput signals (built from
                     the cached statz — no fan-out on the read path)
  GET  /debug/traces[?trace_id=…]  the CROSS-REPLICA stitched span
                     tree: the router's route/proxy events merged with
                     every replica's timeline for the trace-id and
                     re-linked via the traceparent parent chain
                     (index of recent router traces without the param)
  GET  /debug/events the router's flight-recorder journal

Metric families::

    tpu_router_requests_total{replica,outcome}   ok | upstream_error |
                                 stream_abort | client_gone | shed |
                                 client_error | unroutable
    tpu_router_route_seconds         routing decision -> upstream
                                     response headers (per attempt)
    tpu_router_replica_healthy{replica}          1 routable, 0 not
    tpu_router_failovers_total       retries that moved a request to
                                     another replica
    tpu_router_affinity_hits_total   requests served by their
                                     prefix-affinity target
    tpu_router_shed_total{reason}    router-side 429/503 sheds
                                     (connections | no_replicas |
                                      tenant_quota)
    tpu_router_replica_evictions_total   stale replicas dropped
    tpu_router_migrations_total{outcome}   disagg KV migrations
                                     (ok | declined | fallback |
                                      prefill_unavailable |
                                      prefill_error)
    tpu_router_migrate_seconds       checkpoint ship: payload read ->
                                     /migrate response headers
    tpu_router_role_requests_total{role}   phases forwarded per
                                     replica role
    tpu_router_tenant_pins_total     requests served by their
                                     tenant-ring pinned replica

The port's own copy of the JAX package's ``workloads/router.py`` (the
port imports nothing of that package), over the port's ``obs``,
``resilience``, ``migrate`` and ``qos``: the same registrations and
seed give the same routing decisions, and in front of the same
replicas the same reply bytes.
"""

from __future__ import annotations

import argparse
import hashlib
import http.client
import json
import logging
import os
import queue
import threading
import time
from bisect import bisect_left
from collections import OrderedDict
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, HTTPServer
from urllib.parse import parse_qs, quote, urlparse
from typing import (
    Any,
    Dict,
    List,
    Optional,
    Protocol,
    Set,
    Tuple,
    Type,
)

from .. import obs, resilience
from ..resilience import faults

from .migrate import MIGRATE_CONTENT_TYPE
from .qos import TenantQuota, parse_tenant_quotas, resolve_quota

log = logging.getLogger(__name__)

# replica classes for disaggregated prefill/decode serving (the
# DistServe/Splitwise-style phase split): replicas advertise one via
# /register, the router routes phase-aware when both specialized
# classes are present
REPLICA_ROLES = ("mixed", "prefill", "decode")

# default prompt length (tokens) above which a request counts as
# prefill-heavy and rides the disagg path; unary requests qualify
# regardless (their whole latency IS prefill + one batch of decode)
DEFAULT_PREFILL_THRESHOLD = 128

# budget estimate for router-side tenant accounting when the request
# does not carry max_new_tokens/max_tokens (mirrors the serving CLI's
# --max-new-tokens default)
DEFAULT_BUDGET_ESTIMATE = 256

# the engine's default APC admission grid (ServingEngine
# prefix_chunk="auto" lowers to 32 when max_len allows): hashing on
# the same grid means two prompts sharing an APC-matchable prefix
# share an affinity key
DEFAULT_PREFIX_CHUNK = 32

# proxied endpoints (everything else on POST is 404)
PROXY_PATHS = ("/generate", "/v1/completions", "/v1/chat/completions")

# hop-by-hop headers the router owns itself and never copies through
_HOP_HEADERS = frozenset({
    "connection", "keep-alive", "transfer-encoding", "content-length",
    "te", "trailer", "upgrade", "proxy-connection", "server", "date",
})

_STREAM_READ = 65536  # upstream read granularity on the stream path


def _now() -> float:
    return time.monotonic()


def _sha1_int(data: bytes) -> int:
    return int.from_bytes(hashlib.sha1(data).digest()[:8], "big")


def affinity_key(body: Dict[str, Any],
                 prefix_chunk: int) -> Optional[bytes]:
    """The consistent-hash key for one request body, or None when the
    body carries nothing hashable (the replica will 400 it anyway).

    Token prompts hash their leading ``prefix_chunk``-aligned tokens —
    the engine's APC matches whole admission chunks, so requests that
    can share cached KV pages share a key (a sub-chunk prompt hashes
    whole: it can never APC-match, but determinism still holds).
    String prompts / chat messages hash their full text: the router
    cannot tokenize, so string affinity is exact-prefix-by-content —
    still deterministic, still repeat-friendly."""
    tokens = body.get("tokens")
    if tokens is None:
        tokens = body.get("prompt")
    if tokens is None:
        tokens = body.get("messages")
    if isinstance(tokens, list) and tokens and all(
            isinstance(t, int) and not isinstance(t, bool)
            for t in tokens):
        aligned = len(tokens) - len(tokens) % prefix_chunk
        key = tokens[:aligned] if aligned else tokens
        return b",".join(str(int(t)).encode() for t in key)
    if isinstance(tokens, str) and tokens:
        return tokens.encode("utf-8", "surrogatepass")
    if isinstance(tokens, list) and tokens and all(
            isinstance(m, dict) for m in tokens):
        # chat messages: the rendered prompt is the replica's business;
        # the JSON text is a stable stand-in for content affinity
        try:
            return json.dumps(tokens, sort_keys=True).encode()
        except (TypeError, ValueError):
            return None
    return None


@dataclass
class Replica:
    """One registered serving replica and its cached load signal."""

    rid: str
    address: str                      # "host:port"
    model: str = ""
    capacity: int = 0
    role: str = "mixed"               # mixed | prefill | decode
    registered_at: float = 0.0        # wall clock, for /replicas
    last_seen: float = 0.0            # monotonic: heartbeat OR statz
    statz: Dict[str, Any] = field(default_factory=dict)
    statz_at: float = 0.0             # monotonic stamp of the snapshot
    breaker: Optional[resilience.CircuitBreaker] = None
    # administratively out of rotation (POST /drain): heartbeats keep
    # flowing and in-flight streams finish, but pick() skips it — the
    # fleet reconciler's graceful-stop lever
    draining: bool = False

    def host_port(self) -> Tuple[str, int]:
        host, _, port = self.address.rpartition(":")
        return host, int(port)

    def load_score(self) -> float:
        """Normalized queue pressure for least-loaded ordering: lower
        is better.  An unknown snapshot scores a neutral 1.0 so a
        fresh replica takes traffic without being preferred over a
        provably-idle one."""
        if not self.statz:
            return 1.0
        depth = float(self.statz.get("queue_depth", 0)) \
            + float(self.statz.get("in_flight", 0))
        cap = float(self.capacity
                    or self.statz.get("capacity", 0) or 1.0)
        return depth / max(cap, 1.0)

    def overloaded(self, factor: float) -> bool:
        """Past the affinity overload gate?  Only a KNOWN snapshot can
        say yes — affinity is the default, not the exception."""
        if not self.statz:
            return False
        depth = float(self.statz.get("queue_depth", 0)) \
            + float(self.statz.get("in_flight", 0))
        cap = float(self.capacity
                    or self.statz.get("capacity", 0) or 1.0)
        return depth >= factor * max(cap, 1.0)

    def scheduler_alive(self) -> bool:
        if not self.statz:
            return True  # unknown: the breaker is the arbiter
        return bool(self.statz.get("scheduler_alive", True))


class _IncCounter(Protocol):
    """The slice of an obs counter child the pooled server needs."""

    def inc(self, amount: float = 1.0) -> None: ...


class _UpstreamError(Exception):
    """A pre-stream replica failure (connect error or 5xx): safe to
    retry on another replica — no body byte reached the client."""

    def __init__(self, message: str, status: int = 0) -> None:
        super().__init__(message)
        self.status = status


class _PooledRouterHTTPServer(HTTPServer):
    """Fixed-worker HTTP server for the router (the serving server's
    pooled-accept posture without importing its torch-heavy module):
    *workers* connections proxy concurrently, *workers* more wait, and
    overflow is shed 429 on the accept thread."""

    daemon_threads = True
    allow_reuse_address = True
    request_queue_size = 128

    _REJECT_BODY = (json.dumps({"error": {
        "message": "router connection limit reached; retry later",
        "type": "rate_limit_exceeded"}}) + "\n").encode()
    _REJECT = (b"HTTP/1.1 429 Too Many Requests\r\n"
               b"Content-Type: application/json\r\n"
               b"Retry-After: 1\r\n"
               b"Content-Length: %d\r\n"
               b"Connection: close\r\n\r\n" % len(_REJECT_BODY)
               ) + _REJECT_BODY

    def __init__(self, addr: Tuple[str, int],
                 handler: Type[BaseHTTPRequestHandler],
                 workers: int, shed: _IncCounter) -> None:
        super().__init__(addr, handler)
        self._conns: "queue.Queue[Optional[Tuple[Any, Any]]]" = \
            queue.Queue(maxsize=workers)
        self._shed = shed
        self._pool = [
            threading.Thread(target=self._worker,
                             name=f"router-http-{i}", daemon=True)
            for i in range(workers)]
        for t in self._pool:
            t.start()

    def process_request(self, request: Any,
                        client_address: Any) -> None:
        try:
            self._conns.put_nowait((request, client_address))
        except queue.Full:
            self._shed.inc()
            try:
                request.settimeout(0.5)
                request.sendall(self._REJECT)
                try:
                    request.recv(1 << 20)
                except OSError:
                    pass
            except OSError:
                pass
            self.shutdown_request(request)

    def _worker(self) -> None:
        while True:
            item = self._conns.get()
            if item is None:
                return
            request, client_address = item
            try:
                self.finish_request(request, client_address)
            except Exception:
                self.handle_error(request, client_address)
            finally:
                self.shutdown_request(request)

    def server_close(self) -> None:
        super().server_close()
        for _ in self._pool:
            try:
                self._conns.put_nowait(None)
            except queue.Full:
                break
        for t in self._pool:
            t.join(timeout=1)


class RouterServer:
    """The router tier: replica table + consistent-hash ring + proxy.

    >>> rt = RouterServer().start(port=0)
    >>> # replicas: python -m ...workloads.server --register-with \\
    >>> #     http://host:rt.port
    >>> rt.stop()
    """

    def __init__(self,
                 prefix_chunk: int = DEFAULT_PREFIX_CHUNK,
                 replica_ttl_s: float = 10.0,
                 statz_interval_s: float = 0.5,
                 max_connections: int = 64,
                 failover_attempts: int = 3,
                 overload_factor: float = 4.0,
                 vnodes: int = 64,
                 breaker_threshold: int = 2,
                 breaker_reset_s: float = 2.0,
                 connect_timeout_s: float = 5.0,
                 client_timeout_s: float = 600.0,
                 seed: Optional[int] = None,
                 registry: Optional[obs.Registry] = None,
                 flight_record_dir: Optional[str] = None,
                 flight_record_capacity: int = 4096,
                 disagg: bool = True,
                 prefill_threshold: int = DEFAULT_PREFILL_THRESHOLD,
                 tenant_quotas: Optional[
                     Dict[str, TenantQuota]] = None,
                 tenant_pinning: bool = True,
                 session_affinity: bool = True,
                 session_home_max: int = 4096,
                 default_budget: int = DEFAULT_BUDGET_ESTIMATE,
                 slo_policies: Optional[Dict[str, Any]] = None,
                 alert_rules: Optional[List[Any]] = None,
                 alert_interval_s: float = 5.0,
                 alert_window_scale: float = 1.0,
                 incident_dir: Optional[str] = None,
                 profiler_hz: float = 19.0
                 ) -> None:
        if prefix_chunk < 1:
            raise ValueError("prefix_chunk must be >= 1")
        if failover_attempts < 1:
            raise ValueError("failover_attempts must be >= 1")
        if vnodes < 1:
            raise ValueError("vnodes must be >= 1")
        if prefill_threshold < 1:
            raise ValueError("prefill_threshold must be >= 1")
        if default_budget < 1:
            raise ValueError("default_budget must be >= 1")
        self.prefix_chunk = prefix_chunk
        self.replica_ttl_s = replica_ttl_s
        self.statz_interval_s = statz_interval_s
        self.max_connections = max_connections
        self.failover_attempts = failover_attempts
        self.overload_factor = overload_factor
        self.vnodes = vnodes
        self.breaker_threshold = breaker_threshold
        self.breaker_reset_s = breaker_reset_s
        self.connect_timeout_s = connect_timeout_s
        self.client_timeout_s = client_timeout_s
        # disaggregated prefill/decode (router v2): phase-aware
        # routing + KV migration are engaged per request, only when
        # both specialized classes are registered and routable
        self.disagg = bool(disagg)
        self.prefill_threshold = prefill_threshold
        # router-level tenant accounting: the GLOBAL token buckets a
        # replica-local quota cannot be (an evenly-routed tenant got
        # RATE x N before), plus sticky tenant->replica pinning on a
        # SECOND hash ring so replica-local WFQ/quota state stays
        # coherent per tenant even without router buckets configured
        self.tenant_quotas: Dict[str, TenantQuota] = dict(
            tenant_quotas or {})
        self.tenant_pinning = bool(tenant_pinning)
        # session KV tiering: a THIRD hash ring plus a bounded
        # last-served map route a returning conversation back to the
        # replica holding its warm KV; when the pick still lands
        # elsewhere (home sick/overloaded), the router MOVES the
        # parked checkpoint (/session/export -> /session/import)
        # before forwarding, so the session resumes instead of
        # re-prefilling.  Every move failure degrades to plain
        # forwarding — affinity is a latency optimization, never a
        # correctness dependency
        self.session_affinity = bool(session_affinity)
        if session_home_max < 1:
            raise ValueError("session_home_max must be >= 1")
        self.session_home_max = session_home_max
        self._session_home: "OrderedDict[str, str]" = OrderedDict()
        self.default_budget = default_budget
        self._lock = threading.Lock()
        self._replicas: Dict[str, Replica] = {}
        # the ring caches (point -> rid) sorted by point; rebuilt only
        # when the replica-ID SET changes, so lookups are O(log n).
        # _tring is the tenant-pinning ring: same ids, different salt,
        # so one replica's share of tenants is independent of its
        # share of prefix keys
        self._ring: List[Tuple[int, str]] = []
        self._tring: List[Tuple[int, str]] = []
        self._sring: List[Tuple[int, str]] = []
        self._stop = threading.Event()
        self._httpd: Optional[_PooledRouterHTTPServer] = None
        self._poller: Optional[threading.Thread] = None
        # seeded like every other resilience consumer: a chaos run
        # replays the same failover backoff schedule from its seed
        self.retry = resilience.RetryPolicy(
            max_attempts=failover_attempts, initial_backoff_s=0.02,
            max_backoff_s=0.25, seed=seed)
        self.registry = registry if registry is not None \
            else obs.Registry()
        reg = self.registry
        self._rmetrics = resilience.ResilienceMetrics(reg)
        self.recorder = obs.FlightRecorder(
            capacity=flight_record_capacity, registry=reg)
        if flight_record_dir:
            self.recorder.install_dump_handlers(flight_record_dir)
        self._m_requests = reg.counter(
            "tpu_router_requests_total",
            "Requests routed, by serving replica and outcome (ok, "
            "client_error, shed, upstream_error, stream_abort, "
            "client_gone, unroutable).", ("replica", "outcome"))
        self._m_route = reg.histogram(
            "tpu_router_route_seconds",
            "Routing decision through upstream response headers for "
            "one attempt (connect + request write + headers).",
            buckets=obs.FAST_BUCKETS_S)
        self._m_healthy = reg.gauge(
            "tpu_router_replica_healthy",
            "1 when the replica is routable (fresh + breaker not "
            "open + scheduler alive), else 0.", ("replica",))
        self._m_failovers = reg.counter(
            "tpu_router_failovers_total",
            "Pre-stream retries that moved a request onto another "
            "replica after a connect error or 5xx.")
        self._m_affinity = reg.counter(
            "tpu_router_affinity_hits_total",
            "Requests served by their prefix-affinity target replica "
            "(consistent hash over the chunk-aligned prompt prefix).")
        self._m_shed = reg.counter(
            "tpu_router_shed_total",
            "Router-side sheds by reason (connections = worker pool "
            "full at accept, no_replicas = nothing routable).",
            ("reason",))
        self._shed_conns = self._m_shed.labels(reason="connections")
        self._m_evictions = reg.counter(
            "tpu_router_replica_evictions_total",
            "Replicas evicted for staleness (no heartbeat and no "
            "/statz answer within the TTL).")
        # -- disaggregated prefill/decode -------------------------------
        self._m_migrations = reg.counter(
            "tpu_router_migrations_total",
            "KV-state migrations attempted by outcome: ok (prefill "
            "checkpoint resumed on a decode replica), declined (the "
            "prefill replica served the request whole), "
            "prefill_unavailable / prefill_error (fell back to "
            "normal routing before / after prefill), fallback (no "
            "decode replica accepted the checkpoint; the request "
            "re-ran normally).", ("outcome",))
        for oc in ("ok", "declined", "fallback"):
            self._m_migrations.labels(outcome=oc).inc(0)
        self._m_migrate_s = reg.histogram(
            "tpu_router_migrate_seconds",
            "Checkpoint ship time: prefill payload fully read to the "
            "decode replica's /migrate response headers (serialize + "
            "hop + resume admission).", buckets=obs.FAST_BUCKETS_S)
        self._m_role_requests = reg.counter(
            "tpu_router_role_requests_total",
            "Request phases forwarded, by serving-replica role "
            "(mixed = the homogeneous path; prefill + decode = the "
            "two halves of one disagg-routed request).", ("role",))
        for role in REPLICA_ROLES:
            self._m_role_requests.labels(role=role).inc(0)
        self._m_tenant_pins = reg.counter(
            "tpu_router_tenant_pins_total",
            "Requests served by their tenant-ring pinned replica "
            "(sticky tenant->replica placement).")
        self._m_tenant_pins.inc(0)
        self._m_session_moves = reg.counter(
            "tpu_router_session_moves_total",
            "Cross-replica session KV moves attempted when a "
            "returning session routed away from its home replica: "
            "ok (checkpoint exported + imported, warm resume), miss "
            "(home had nothing parked; plain re-prefill), error "
            "(export/import failed; plain re-prefill).", ("outcome",))
        for oc in ("ok", "miss", "error"):
            self._m_session_moves.labels(outcome=oc).inc(0)
        # plain int twin of shed{no_replicas}: fleet_statz surfaces it
        # so the reconciler can see demand arriving at an empty fleet
        # (replica statz cannot carry that signal when there are none)
        self._no_replica_total = 0
        reg.on_collect(self._collect_health)
        # -- fleet-level retention + alerting ----------------------------
        # the cached per-replica goodput blocks aggregate into bridge
        # gauges at collect time (HTTP scrape or TSDB tick), and the
        # router's OWN burn-rate rule pairs evaluate over the fleet
        # aggregate — so one drowning replica masked by an idle one
        # still pages here even when no single replica's local rules
        # fire.  Firing state rides /alerts and the /fleet/statz
        # firing_alerts roll-up the autoscaler reads.
        self._m_fleet_burn = reg.gauge(
            "tpu_router_fleet_burn_rate",
            "Fleet-aggregate error-budget burn rate per SLO class "
            "(max across replicas, from cached statz).", ("class",))
        self._m_fleet_goodput = reg.gauge(
            "tpu_router_fleet_goodput_ratio",
            "Fleet-aggregate goodput ratio per SLO class (window met "
            "over window total, summed across replicas).", ("class",))
        reg.on_collect(self._collect_fleet_goodput)
        self.scrape_meta = obs.ScrapeMeta(reg)
        self.tsdb = obs.TSDB(reg)
        self.alert_interval_s = float(alert_interval_s)
        policies = (dict(slo_policies) if slo_policies
                    else obs.default_slo_policies())
        rules = obs.burn_rate_rules(
            policies, metric="tpu_router_fleet_burn_rate",
            window_scale=alert_window_scale)
        rules.extend(alert_rules or ())
        self.alerts = obs.AlertEvaluator(
            self.tsdb, rules, recorder=self.recorder)
        # -- continuous profiling + fleet incident bundles ---------------
        # the router samples its OWN stacks (proxy workers, poller) and
        # on a fleet-level page additionally pulls every registered
        # replica's bundle fragments (statz / alerts / profile slice)
        # into replicas/<id>/ of ONE fleet bundle — an unreachable
        # replica degrades to an {unreachable: true} marker instead of
        # wedging the subscriber (chaos episode 16 SIGKILLs one to
        # prove it)
        self.profiler = obs.SamplingProfiler(
            reg, hz=profiler_hz,
            active_fn=lambda: len(self._replicas))
        self.incident_dir = incident_dir
        self._incidents: Optional[obs.IncidentManager] = None
        if incident_dir:
            self._incidents = obs.IncidentManager(
                incident_dir, self.alerts, registry=reg,
                recorder=self.recorder, tsdb=self.tsdb,
                profiler=self.profiler,
                collectors={"statz.json": self.fleet_statz},
                extra_files_fn=self._incident_replica_fragments)

    # -- replica table ------------------------------------------------------

    def register(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        """Registration AND heartbeat (idempotent): upsert the replica
        row, refresh its liveness stamp.  Raises ValueError on a
        malformed payload (the HTTP surface answers 400)."""
        address = payload.get("address")
        if not isinstance(address, str) or ":" not in address:
            raise ValueError("'address' must be \"host:port\"")
        host, _, port_s = address.rpartition(":")
        if not host or not port_s.isdigit():
            raise ValueError("'address' must be \"host:port\"")
        rid = str(payload.get("replica_id") or address)
        model = str(payload.get("model") or "")
        capacity = int(payload.get("capacity") or 0)
        role = str(payload.get("role") or "mixed")
        if role not in REPLICA_ROLES:
            raise ValueError(
                f"'role' must be one of {'/'.join(REPLICA_ROLES)}")
        with self._lock:
            rep = self._replicas.get(rid)
            fresh = rep is None
            if rep is None:
                rep = Replica(
                    rid=rid, address=address, model=model,
                    capacity=capacity, role=role,
                    registered_at=time.time(),
                    breaker=resilience.CircuitBreaker(
                        op=f"router.replica.{rid}",
                        failure_threshold=self.breaker_threshold,
                        reset_timeout_s=self.breaker_reset_s,
                        metrics=self._rmetrics,
                        recorder=self.recorder))
                self._replicas[rid] = rep
                self._rebuild_ring_locked()
            rep.address = address
            rep.model = model or rep.model
            rep.capacity = capacity or rep.capacity
            rep.role = role
            rep.last_seen = _now()
            # an inline statz piggybacked on the heartbeat freshens the
            # load signal without waiting for the next poll round
            inline = payload.get("statz")
            if isinstance(inline, dict):
                rep.statz = inline
                rep.statz_at = rep.last_seen
        if fresh:
            log.info("replica registered: %s at %s (model=%s cap=%d "
                     "role=%s)", rid, address, model, capacity, role)
            self.recorder.record("tpu_router_replica_registered",
                                 replica=rid, address=address,
                                 model=model, capacity=capacity,
                                 role=role)
        return {"ok": True, "replica_id": rid,
                "interval_s": max(self.replica_ttl_s / 3.0, 0.2)}

    def drain(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        """POST /drain — take a replica out of rotation without killing
        it: pick() skips a draining replica, its heartbeats keep the
        row fresh, and in-flight streams run to completion on their
        already-open connections.  ``{"draining": false}`` puts it
        back.  Raises ValueError (400) on a malformed body and KeyError
        (404) for an unknown replica — draining a ghost is a caller
        bug, not a no-op."""
        rid = payload.get("replica_id")
        if not isinstance(rid, str) or not rid:
            raise ValueError("'replica_id' must be a non-empty string")
        draining = bool(payload.get("draining", True))
        with self._lock:
            rep = self._replicas.get(rid)
            if rep is None:
                raise KeyError(rid)
            rep.draining = draining
            statz = rep.statz if isinstance(rep.statz, dict) else {}
            queue_depth = int(statz.get("queue_depth", 0) or 0)
            in_flight = int(statz.get("in_flight", 0) or 0)
        self.recorder.record("tpu_router_replica_draining",
                             replica=rid, draining=draining)
        log.info("replica %s %s rotation", rid,
                 "leaving" if draining else "rejoining")
        return {"ok": True, "replica_id": rid, "draining": draining,
                "queue_depth": queue_depth, "in_flight": in_flight}

    def _rebuild_ring_locked(self) -> None:
        """The consistent-hash ring over the CURRENT replica-id set.
        Points depend only on the ids (``sha1(rid#v)``), never on
        registration order or wall time — the property the
        same-prompt-same-replica-across-restarts test pins."""
        ring: List[Tuple[int, str]] = []
        tring: List[Tuple[int, str]] = []
        sring: List[Tuple[int, str]] = []
        for rid in self._replicas:
            for v in range(self.vnodes):
                ring.append((_sha1_int(f"{rid}#{v}".encode()), rid))
                # distinct salt: a replica's share of TENANTS is
                # independent of its share of prefix keys (one
                # unlucky id should not concentrate both)
                tring.append(
                    (_sha1_int(f"tenant|{rid}#{v}".encode()), rid))
                # third salt: SESSION placement independent of both
                # (a session's home should not follow its tenant's
                # pin, or one hot tenant concentrates every tier)
                sring.append(
                    (_sha1_int(f"session|{rid}#{v}".encode()), rid))
        ring.sort()
        tring.sort()
        sring.sort()
        self._ring = ring
        self._tring = tring
        self._sring = sring

    def _evict_stale_locked(self) -> List[str]:
        now = _now()
        dead = [rid for rid, rep in self._replicas.items()
                if now - rep.last_seen > self.replica_ttl_s]
        for rid in dead:
            del self._replicas[rid]
        if dead:
            self._rebuild_ring_locked()
        return dead

    def _routable(self, rep: Replica) -> bool:
        """May traffic go to *rep* right now?  Fresh, breaker closed,
        scheduler alive.  Deliberately side-effect-free: the half-open
        probe slot belongs to the /statz poller (which records the
        probe's outcome), so a health CHECK must never consume it —
        recovery is detected by the poll loop and the breaker closes
        within about one poll interval of the replica coming back."""
        if rep.draining:
            return False
        if _now() - rep.last_seen > self.replica_ttl_s:
            return False
        if not rep.scheduler_alive():
            return False
        assert rep.breaker is not None
        return rep.breaker.state == resilience.BREAKER_CLOSED

    def affinity_target(self, key: Optional[bytes],
                        role: Optional[str] = None) -> Optional[str]:
        """The ring's verdict for *key* over ALL registered replicas
        (health is the pick's business, not the hash's — a temporarily
        sick target must get its traffic back when it recovers, not
        have it re-hashed away forever).  With *role* the walk skips
        replicas of other classes: the first matching id clockwise
        from the hash point — still deterministic over the id+role
        set, so phase-aware affinity keeps the same restart/order
        stability the plain ring has."""
        if key is None:
            return None
        with self._lock:
            ring = self._ring
            roles = ({rid: r.role
                      for rid, r in self._replicas.items()}
                     if role is not None else None)
        return self._ring_walk(ring, _sha1_int(key), roles, role)

    @staticmethod
    def _ring_walk(ring: List[Tuple[int, str]], h: int,
                   roles: Optional[Dict[str, str]],
                   role: Optional[str]) -> Optional[str]:
        if not ring:
            return None
        i = bisect_left(ring, (h, ""))
        n = len(ring)
        for step in range(n):
            rid = ring[(i + step) % n][1]
            if role is None or (roles is not None
                                and roles.get(rid) == role):
                return rid
        return None

    def tenant_target(self, tenant: str) -> Optional[str]:
        """Sticky tenant->replica pinning: the tenant ring's verdict
        (same determinism contract as prefix affinity).  Pinning one
        tenant's traffic to one replica is what makes the replica's
        LOCAL WFQ/quota state globally coherent for that tenant."""
        if not tenant:
            return None
        with self._lock:
            tring = self._tring
        return self._ring_walk(
            tring, _sha1_int(tenant.encode("utf-8", "surrogatepass")),
            None, None)

    # -- session affinity ---------------------------------------------------

    @staticmethod
    def _session_of(parsed: Dict[str, Any]) -> str:
        """The request's conversation key, exactly as the replicas
        resolve it: native ``session_id``/``session``, or the OpenAI
        extension ``session`` scoped under ``user`` (the replica's
        _openai_to_native mapping) — the router must hash the SAME
        string the replica keys its tier store on."""
        sid = parsed.get("session_id")
        if sid is None:
            sid = parsed.get("session")
        if not sid:
            return ""
        sid = str(sid)
        # OpenAI bodies have no session_id key; their session scopes
        # under user.  Native bodies may carry both session_id and
        # tenant — session_id is already fully qualified there.
        if parsed.get("session_id") is None \
                and parsed.get("user") is not None:
            return f"{parsed['user']}/{sid}"
        return sid

    def session_target(self, sid: str) -> Optional[str]:
        """Where a returning session PREFERS to land: its recorded
        home (the replica that last served it, and so holds its
        parked/spilled KV), else the session ring's verdict (same
        determinism contract as the other two rings)."""
        if not sid or not self.session_affinity:
            return None
        with self._lock:
            home = self._session_home.get(sid)
            sring = self._sring
        if home is not None:
            return home
        return self._ring_walk(
            sring, _sha1_int(sid.encode("utf-8", "surrogatepass")),
            None, None)

    def _note_session_home(self, sid: str, rid: str) -> None:
        """Record where *sid* was just served (bounded LRU: an
        abandoned session's row ages out; its DISK state still
        survives on the old home for the ring to find)."""
        if not sid or not self.session_affinity:
            return
        with self._lock:
            self._session_home.pop(sid, None)
            self._session_home[sid] = rid
            while len(self._session_home) > self.session_home_max:
                self._session_home.popitem(last=False)

    def _maybe_move_session(self, sid: str, chosen: Replica,
                            trace: "obs.TraceContext") -> None:
        """A returning session is about to be served by a replica
        that is NOT its home: move the parked checkpoint first
        (POST /session/export on the home -> /session/import on the
        chosen replica) so the request warm-resumes there.  Strictly
        best-effort — any failure (home gone, nothing parked, sick
        disk, import refused) just forwards the request for a plain
        re-prefill.  A tiering failure must never fail the request."""
        if not sid or not self.session_affinity:
            return
        with self._lock:
            home_rid = self._session_home.get(sid)
            home = (self._replicas.get(home_rid)
                    if home_rid is not None else None)
        if home is None or home.rid == chosen.rid \
                or not self._routable(home):
            return
        outcome = "error"
        try:
            payload = self._session_export(home, sid)
            if payload is None:
                outcome = "miss"
                return
            self._session_import(chosen, payload)
            outcome = "ok"
        except Exception as e:
            log.warning("session move %s -> %s failed: %s",
                        home.rid, chosen.rid, e)
        finally:
            self._m_session_moves.labels(outcome=outcome).inc()
            self.recorder.record(
                "tpu_router_session_move", trace=trace,
                session=hashlib.sha1(
                    sid.encode("utf-8", "surrogatepass")
                ).hexdigest()[:20],
                src=home.rid, dst=chosen.rid, outcome=outcome)

    def _session_export(self, rep: Replica,
                        sid: str) -> Optional[bytes]:
        """One export attempt against the session's home replica.
        None = the home has nothing parked under *sid* (404 — a
        plain miss, not an error); raises on transport/5xx."""
        host, port = rep.host_port()
        body = json.dumps({"session_id": sid}).encode()
        conn = http.client.HTTPConnection(
            host, port, timeout=self.connect_timeout_s)
        try:
            conn.request("POST", "/session/export", body=body,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            data = resp.read()
            if resp.status == 404:
                return None
            if resp.status != 200:
                raise OSError(f"export HTTP {resp.status}")
            return data
        finally:
            conn.close()

    def _session_import(self, rep: Replica, payload: bytes) -> None:
        host, port = rep.host_port()
        conn = http.client.HTTPConnection(
            host, port, timeout=self.connect_timeout_s)
        try:
            conn.request("POST", "/session/import", body=payload,
                         headers={
                             "Content-Type": MIGRATE_CONTENT_TYPE})
            resp = conn.getresponse()
            resp.read()
            if resp.status != 200:
                raise OSError(f"import HTTP {resp.status}")
        finally:
            conn.close()

    def _note_evictions(self, dead: List[str]) -> None:
        for rid in dead:
            self._m_evictions.inc()
            self.recorder.record("tpu_router_replica_evicted",
                                 replica=rid)
            log.warning("replica %s evicted (stale past %.1fs)",
                        rid, self.replica_ttl_s)

    def pick(self, key: Optional[bytes],
             exclude: Optional[Set[str]] = None,
             role: Optional[str] = None,
             pin: Optional[str] = None
             ) -> Tuple[Optional[Replica], bool]:
        """Choose the replica for one attempt, in precedence order:
        the *pin* target (sticky tenant placement), the
        prefix-affinity target, then the least-loaded routable
        replica — each gated on routable + not overloaded.  *role*
        restricts every tier to one replica class (the disagg path
        picks prefill- and decode-class replicas separately).
        Returns (replica, affinity_hit); (None, False) when nothing
        is routable."""
        exclude = exclude or set()
        target = self.affinity_target(key, role=role)
        with self._lock:
            dead = self._evict_stale_locked()
            candidates = [r for rid, r in self._replicas.items()
                          if rid not in exclude
                          and (role is None or r.role == role)]
        self._note_evictions(dead)
        for want, is_affinity in ((pin, False), (target, True)):
            if want is None or want in exclude:
                continue
            for rep in candidates:
                if rep.rid == want and self._routable(rep) \
                        and not rep.overloaded(self.overload_factor):
                    if not is_affinity:
                        self._m_tenant_pins.inc()
                    return rep, is_affinity and want == target
        routable = [r for r in candidates if self._routable(r)]
        if not routable:
            return None, False
        routable.sort(key=lambda r: (r.load_score(), r.rid))
        return routable[0], False

    def replicas(self) -> List[Dict[str, Any]]:
        """The /replicas debug view (sorted, JSON-ready)."""
        with self._lock:
            reps = list(self._replicas.values())
        now = _now()
        out = []
        for rep in sorted(reps, key=lambda r: r.rid):
            assert rep.breaker is not None
            out.append({
                "replica_id": rep.rid,
                "address": rep.address,
                "model": rep.model,
                "capacity": rep.capacity,
                "role": rep.role,
                "healthy": self._routable(rep),
                "draining": rep.draining,
                "breaker_state": rep.breaker.state,
                "age_s": round(now - rep.last_seen, 3),
                "load_score": round(rep.load_score(), 4),
                "statz": rep.statz,
            })
        return out

    def fleet_statz(self) -> Dict[str, Any]:
        """One fleet snapshot (GET /fleet/statz): per-replica statz
        plus aggregated load + goodput — the signal the autoscaler
        (ROADMAP fleet control plane) and dashboards read without
        touching N replicas themselves.  Built entirely from the
        CACHED statz the poller/heartbeats keep fresh: serving this is
        O(replicas), no fan-out on the read path."""
        with self._lock:
            reps = list(self._replicas.values())
        now = _now()
        agg = {"queue_depth": 0, "in_flight": 0, "capacity": 0,
               "kv_pages": 0, "kv_pages_free": 0,
               "requests_served": 0}
        shed_agg: Dict[str, int] = {}
        # session-tier occupancy roll-up: parked-conversation
        # pressure per tier, the signal alert rules and the
        # autoscaler read for "the fleet is full of idle sessions"
        tier_agg = {"device": 0, "host": 0, "disk": 0,
                    "host_bytes": 0, "disk_bytes": 0}
        # per-class goodput aggregation: sums of window met/total
        # re-derive the fleet ratio (a mean of ratios would let an
        # idle replica mask a drowning one)
        classes: Dict[str, Dict[str, float]] = {}
        per_replica: Dict[str, Any] = {}
        # firing-alert roll-up: every replica's statz alert
        # brief plus the router's own fleet-level evaluator, tagged
        # by source so the autoscaler can key on page severity
        firing_alerts: List[Dict[str, Any]] = []
        healthy = 0
        for rep in sorted(reps, key=lambda r: r.rid):
            ok = self._routable(rep)
            healthy += 1 if ok else 0
            statz = rep.statz if isinstance(rep.statz, dict) else {}
            per_replica[rep.rid] = {
                "healthy": ok,
                "role": rep.role,
                "draining": rep.draining,
                "age_s": round(now - rep.last_seen, 3),
                "statz": statz,
            }
            for k in agg:
                v = statz.get(k)
                if isinstance(v, (int, float)):
                    agg[k] += int(v)
            shed = statz.get("shed")
            if isinstance(shed, dict):
                for k, v in shed.items():
                    if isinstance(v, (int, float)):
                        shed_agg[k] = shed_agg.get(k, 0) + int(v)
            tiers = statz.get("kv_tiers")
            if isinstance(tiers, dict):
                for k in tier_agg:
                    v = tiers.get(k)
                    if isinstance(v, (int, float)):
                        tier_agg[k] += int(v)
            alerts = statz.get("alerts")
            if isinstance(alerts, dict):
                for f in alerts.get("firing") or []:
                    if isinstance(f, dict):
                        firing_alerts.append(
                            {"source": rep.rid, **f})
            goodput = statz.get("goodput")
            if not isinstance(goodput, dict):
                continue
            gclasses = goodput.get("classes")
            if not isinstance(gclasses, dict):
                continue
            for name, row in gclasses.items():
                if not isinstance(row, dict):
                    continue
                acc = classes.setdefault(name, {
                    "total": 0.0, "met": 0.0, "window_total": 0.0,
                    "window_met": 0.0, "goodput_rps": 0.0,
                    "burn_rate_max": 0.0})
                for src, dst in (("total", "total"), ("met", "met"),
                                 ("window_total", "window_total"),
                                 ("window_met", "window_met"),
                                 ("goodput_rps", "goodput_rps")):
                    v = row.get(src)
                    if isinstance(v, (int, float)):
                        acc[dst] += float(v)
                burn = row.get("burn_rate")
                if isinstance(burn, (int, float)):
                    acc["burn_rate_max"] = max(acc["burn_rate_max"],
                                               float(burn))
        goodput_out: Dict[str, Any] = {}
        for name, acc in sorted(classes.items()):
            wt, wm = acc["window_total"], acc["window_met"]
            goodput_out[name] = {
                "total": int(acc["total"]),
                "met": int(acc["met"]),
                "window_total": int(wt),
                "window_met": int(wm),
                "goodput_ratio": (wm / wt) if wt else 1.0,
                "goodput_rps": acc["goodput_rps"],
                "burn_rate_max": acc["burn_rate_max"],
            }
        with self._lock:
            no_replica_total = self._no_replica_total
        own = self.alerts.brief()
        for f in own["firing"]:
            firing_alerts.append({"source": "router", **f})
        return {
            "replicas": len(reps),
            "healthy": healthy,
            "fleet": {**agg, "shed": shed_agg,
                      "kv_tiers": tier_agg,
                      "goodput": goodput_out,
                      "firing_alerts": firing_alerts},
            "router": {"no_replica_total": no_replica_total,
                       "alerts": own},
            "per_replica": per_replica,
        }

    # -- fleet incident bundles ---------------------------------------------

    def _fetch_replica_json(self, rep: Replica, path: str,
                            timeout_s: float = 2.0) -> Dict[str, Any]:
        """One replica's JSON debug surface for the incident bundle
        fan-out.  Short timeout by design — a dead replica must cost
        the bundle seconds, not minutes — and EVERY failure mode
        returns an ``{"unreachable": true}`` marker instead of
        raising (the bundle records the death, it does not share it)."""
        host, port = rep.host_port()
        conn = http.client.HTTPConnection(host, port,
                                          timeout=timeout_s)
        try:
            conn.request("GET", path)
            resp = conn.getresponse()
            body = resp.read()
            if resp.status != 200:
                return {"unreachable": True,
                        "error": f"HTTP {resp.status}"}
            out = json.loads(body)
            return out if isinstance(out, dict) else {"body": out}
        # tpulint: disable=R2 -- not a swallow: the failure IS the payload — the bundle records the replica as unreachable with the error text (chaos episode 16 asserts exactly this marker)
        except Exception as e:
            return {"unreachable": True,
                    "error": f"{type(e).__name__}: {e}"}
        finally:
            try:
                conn.close()
            # tpulint: disable=R2 -- close() on an already-broken connection during bundle fan-out; nothing to account, the fetch outcome was recorded above
            except Exception:
                pass

    def _incident_replica_fragments(self) -> Dict[str, Any]:
        """The fleet-level bundle's per-replica half: pull each
        registered replica's statz / alerts / continuous-profile slice
        into ``replicas/<id>/``.  Replicas whose breaker is open are
        still ATTEMPTED (the page may be ABOUT them) — unreachable
        ones degrade to their marker file."""
        with self._lock:
            reps = list(self._replicas.values())
        out: Dict[str, Any] = {}
        for rep in reps:
            # replica ids default to "host:port" — keep the path one
            # directory level deep whatever the operator chose
            safe = rep.rid.replace("/", "_").replace("..", "_")
            base = f"replicas/{safe}"
            out[f"{base}/statz.json"] = self._fetch_replica_json(
                rep, "/statz")
            out[f"{base}/alerts.json"] = self._fetch_replica_json(
                rep, "/alerts")
            out[f"{base}/profile.json"] = self._fetch_replica_json(
                rep, "/debug/pprof?seconds=60&format=json")
        return out

    # -- cross-replica trace stitching --------------------------------------

    def _fetch_replica_trace(self, rep: Replica, trace_id: str
                             ) -> List[Dict[str, object]]:
        """One replica's /debug/traces timeline for *trace_id* (the
        stitch fan-out; failures degrade the stitch, never fail it —
        the statz breaker gates obviously-dead replicas out)."""
        assert rep.breaker is not None
        if rep.breaker.state == resilience.BREAKER_OPEN:
            return []
        host, port = rep.host_port()
        conn = http.client.HTTPConnection(
            host, port, timeout=self.connect_timeout_s)
        try:
            conn.request(
                "GET",
                f"/debug/traces?trace_id={quote(trace_id, safe='')}")
            resp = conn.getresponse()
            body = resp.read()
            if resp.status != 200:
                return []
            out = json.loads(body)
        finally:
            conn.close()
        events = out.get("events") if isinstance(out, dict) else None
        if not isinstance(events, list):
            return []
        return [e for e in events if isinstance(e, dict)]

    def stitched_trace(self, trace_id: str) -> Dict[str, Any]:
        """GET /debug/traces?trace_id= — the fleet view: the router's
        own route/proxy events merged with every registered replica's
        timeline for the same trace-id, re-linked into ONE span tree
        via the traceparent parent links (obs.stitch).  A replica that
        cannot answer (dead, evicting) just contributes nothing — its
        flight-recorder DUMP still holds its half for
        tools/obs_query.py."""
        events: List[Dict[str, object]] = []
        for ev in self.recorder.events(trace_id=trace_id):
            ev["source"] = "router"
            events.append(ev)
        with self._lock:
            reps = list(self._replicas.values())
        for rep in sorted(reps, key=lambda r: r.rid):
            try:
                fetched = self._fetch_replica_trace(rep, trace_id)
            except (OSError, ValueError,
                    http.client.HTTPException) as e:
                resilience.suppressed("router.trace_fanout", e,
                                      logger=log,
                                      metrics=self._rmetrics)
                continue
            for ev in fetched:
                ev.setdefault("source", rep.rid)
                events.append(ev)
        return {
            "trace_id": trace_id,
            "events": len(events),
            "tree": obs.stitch(events),
        }

    def _collect_health(self) -> None:
        """Scrape-time refresh of tpu_router_replica_healthy."""
        with self._lock:
            reps = list(self._replicas.values())
        for rep in reps:
            self._m_healthy.labels(replica=rep.rid).set(
                1 if self._routable(rep) else 0)

    def _collect_fleet_goodput(self) -> None:
        """Scrape-time refresh of the fleet-aggregate goodput bridge
        gauges the router's burn-rate alert rules evaluate over.
        Built from the same cached statz rows fleet_statz() reads —
        O(replicas), no fan-out.  Classes rebuild from scratch so a
        class that left the fleet leaves no stale burning series."""
        goodput = self.fleet_statz()["fleet"]["goodput"]
        self._m_fleet_burn.clear()
        self._m_fleet_goodput.clear()
        for name, row in goodput.items():
            self._m_fleet_burn.labels(**{"class": name}).set(
                row["burn_rate_max"])
            self._m_fleet_goodput.labels(**{"class": name}).set(
                row["goodput_ratio"])

    # -- statz poller -------------------------------------------------------

    def _fetch_statz(self, rep: Replica) -> Dict[str, Any]:
        host, port = rep.host_port()
        conn = http.client.HTTPConnection(
            host, port, timeout=self.connect_timeout_s)
        try:
            conn.request("GET", "/statz")
            resp = conn.getresponse()
            body = resp.read()
            if resp.status != 200:
                raise _UpstreamError(
                    f"/statz answered {resp.status}", resp.status)
            out = json.loads(body)
            if not isinstance(out, dict):
                raise _UpstreamError("/statz body is not an object")
            return out
        finally:
            conn.close()

    def _poll_once(self) -> None:
        with self._lock:
            dead = self._evict_stale_locked()
            reps = list(self._replicas.values())
        self._note_evictions(dead)
        for rep in reps:
            if self._stop.is_set():
                return
            assert rep.breaker is not None
            if not rep.breaker.allow():
                continue
            if faults.ACTIVE is not None:
                try:
                    faults.ACTIVE.fire("router.statz")
                except Exception as e:
                    rep.breaker.record_failure()
                    resilience.suppressed(
                        "router.statz_poll", e, logger=log,
                        metrics=self._rmetrics)
                    continue
            try:
                snap = self._fetch_statz(rep)
            # a body torn by a dying replica is an HTTPException, not an
            # OSError: it must fail the poll (and free a half-open probe
            # slot), not end the poller thread
            except (OSError, ValueError, http.client.HTTPException,
                    _UpstreamError) as e:
                rep.breaker.record_failure()
                resilience.suppressed("router.statz_poll", e,
                                      logger=log,
                                      metrics=self._rmetrics)
                continue
            rep.breaker.record_success()
            with self._lock:
                cur = self._replicas.get(rep.rid)
                if cur is not None:
                    cur.statz = snap
                    cur.statz_at = cur.last_seen = _now()

    def _poll_loop(self) -> None:
        while not self._stop.wait(self.statz_interval_s):
            self._poll_once()

    # -- proxy --------------------------------------------------------------

    def _open_upstream(self, rep: Replica, path: str, body: bytes,
                       headers: Dict[str, str]
                       ) -> Tuple[http.client.HTTPConnection,
                                  http.client.HTTPResponse]:
        """One upstream attempt up to response HEADERS; raises
        :class:`_UpstreamError` on anything retryable.  The breaker
        records the outcome (a 5xx is a replica failure; 2xx-4xx
        means the replica is alive and answering)."""
        assert rep.breaker is not None
        if not rep.breaker.allow():
            raise _UpstreamError(f"{rep.rid}: breaker open")
        host, port = rep.host_port()
        if faults.ACTIVE is not None:
            try:
                faults.ACTIVE.fire("router.proxy")
            except Exception as e:
                rep.breaker.record_failure()
                raise _UpstreamError(f"injected: {e}") from e
        conn = http.client.HTTPConnection(
            host, port, timeout=self.client_timeout_s)
        try:
            conn.request("POST", path, body, headers)
            resp = conn.getresponse()
        except (OSError, http.client.HTTPException) as e:
            conn.close()
            rep.breaker.record_failure()
            raise _UpstreamError(f"{rep.rid}: {e}") from e
        if resp.status >= 500:
            # the replica answered but is broken (scheduler dead,
            # shutdown drain): drain the body and fail this attempt so
            # the request can land somewhere healthy
            try:
                detail = resp.read(4096).decode("utf-8", "replace")
            except OSError:
                detail = ""
            conn.close()
            rep.breaker.record_failure()
            raise _UpstreamError(
                f"{rep.rid}: upstream {resp.status}: "
                f"{detail.strip()[:200]}", resp.status)
        rep.breaker.record_success()
        return conn, resp

    @staticmethod
    def _error_frame(content_type: str, message: str,
                     code: int) -> bytes:
        """A WELL-FORMED in-band terminal error for a broken stream,
        in the stream's own framing: a JSON line for the native
        JSON-lines wire, an SSE error event for the OpenAI wire.  A
        client parsing the stream sees a structured error, never a
        silent truncation that looks like success."""
        payload = {"error": message, "code": code}
        if content_type.startswith("text/event-stream"):
            wire = {"error": {"message": message,
                              "type": "server_error"}}
            return ("data: " + json.dumps(wire) + "\n\n").encode()
        return (json.dumps(payload) + "\n").encode()

    @staticmethod
    def _tenant_of(parsed: Dict[str, Any]) -> str:
        """The request's QoS identity: 'tenant' (native) or 'user'
        (OpenAI), exactly the mapping the replicas apply."""
        tenant = parsed.get("tenant")
        if tenant is None:
            tenant = parsed.get("user")
        return str(tenant) if tenant else ""

    def _est_cost(self, parsed: Dict[str, Any]) -> float:
        """The same prompt+budget token estimate the replicas charge
        their local buckets (string prompts approximate at 4 chars
        per token — the router cannot tokenize)."""
        tokens = parsed.get("tokens")
        if isinstance(tokens, list):
            prompt_toks = len(tokens)
        else:
            prompt = parsed.get("prompt")
            if isinstance(prompt, str):
                prompt_toks = max(1, len(prompt) // 4)
            elif isinstance(prompt, list):
                prompt_toks = len(prompt)
            else:
                prompt_toks = 1
        budget = parsed.get("max_new_tokens",
                            parsed.get("max_tokens",
                                       self.default_budget))
        try:
            budget_i = int(budget)
        except (TypeError, ValueError):
            budget_i = self.default_budget
        try:
            n = max(1, int(parsed.get("n", 1)))
        except (TypeError, ValueError):
            n = 1
        return float((prompt_toks + budget_i) * n)

    def _charge_tenant(self, tenant: str, cost: float) -> bool:
        """Fleet-level token bucket: True = admitted.  Only engaged
        when router quotas are configured; the '*' template clones
        per-tenant state exactly like the replica-local buckets."""
        if not tenant or not self.tenant_quotas:
            return True
        with self._lock:
            quota = resolve_quota(self.tenant_quotas, tenant)
            return quota is None or quota.try_charge(cost)

    def _prefill_heavy(self, parsed: Dict[str, Any]) -> bool:
        """Does this request belong on a prefill-class replica?
        Prompt length above the threshold, or a unary completion
        (its whole latency is prefill + batched decode — exactly the
        work that interferes with latency-sensitive decode streams)."""
        if int(parsed.get("n", 1) or 1) != 1:
            return False    # multi-copy requests never migrate
        tokens = parsed.get("tokens")
        prompt = parsed.get("prompt")
        if isinstance(tokens, list):
            prompt_toks = len(tokens)
        elif isinstance(prompt, list):
            prompt_toks = len(prompt)
        elif isinstance(prompt, str):
            prompt_toks = max(1, len(prompt) // 4)
        else:
            return False    # chat messages etc.: length unknowable
        if prompt_toks >= self.prefill_threshold:
            return True
        # default stream semantics differ per wire: native /generate
        # defaults to streaming, OpenAI completions to unary — the
        # router only trusts an EXPLICIT stream flag either way
        return parsed.get("stream") is False

    def _disagg_ready(self) -> bool:
        """Both specialized classes registered and routable?"""
        if not self.disagg:
            return False
        with self._lock:
            reps = list(self._replicas.values())
        has = {"prefill": False, "decode": False}
        for rep in reps:
            if rep.role in has and self._routable(rep):
                has[rep.role] = True
        return has["prefill"] and has["decode"]

    def proxy(self, handler: "BaseHTTPRequestHandler", path: str,
              body: bytes, trace: "obs.TraceContext") -> None:
        """Route one request: pick -> forward -> stream back.  All the
        failover semantics live here; see the module docstring."""
        t_arrival = time.perf_counter()
        parsed: Dict[str, Any] = {}
        try:
            decoded = json.loads(body) if body else {}
            if isinstance(decoded, dict):
                parsed = decoded
            key = affinity_key(parsed, self.prefix_chunk) \
                if parsed else None
        except (ValueError, TypeError):
            key = None
        tenant = self._tenant_of(parsed)
        if not self._charge_tenant(tenant, self._est_cost(parsed)):
            # fleet-level 429: the tenant's GLOBAL rate is spent —
            # same wire shape as a replica quota shed, so clients
            # cannot tell (and need not care) which tier said no
            self._m_shed.labels(reason="tenant_quota").inc()
            self._m_requests.labels(replica="none",
                                    outcome="shed").inc()
            self.recorder.record("tpu_router_tenant_quota_shed",
                                 trace=trace, tenant=tenant)
            out = (json.dumps({
                "error": f"tenant {tenant} over fleet token-rate "
                         "quota; retry later", "code": 429})
                + "\n").encode()
            handler.send_response(429)
            handler.send_header("Content-Type", "application/json")
            handler.send_header("Content-Length", str(len(out)))
            handler.send_header("Retry-After", "1")
            handler.end_headers()
            try:
                handler.wfile.write(out)
            except OSError:
                pass
            return
        if parsed and self._prefill_heavy(parsed) \
                and self._disagg_ready():
            if self._proxy_disagg(handler, path, parsed, key, trace,
                                  t_arrival):
                return
            # every disagg fallback happens BEFORE any client byte:
            # the request re-runs whole through the normal path
        headers = {
            "Content-Type": handler.headers.get(
                "Content-Type", "application/json"),
            "traceparent": trace.to_traceparent(),
        }
        pin = (self.tenant_target(tenant)
               if tenant and self.tenant_pinning else None)
        # session affinity: a returning conversation prefers the
        # replica holding its warm KV.  Tenant pinning still wins
        # (quota coherence beats resume latency) — the session moves
        # its checkpoint to the pinned replica instead.
        sid = self._session_of(parsed) if parsed else ""
        if pin is None and sid:
            pin = self.session_target(sid)
        tried: Set[str] = set()
        conn: Optional[http.client.HTTPConnection] = None
        resp: Optional[http.client.HTTPResponse] = None
        rep: Optional[Replica] = None
        hit = False
        last_err: Optional[_UpstreamError] = None
        for attempt in range(1, self.failover_attempts + 1):
            rep, hit = self.pick(key, exclude=tried, pin=pin)
            if rep is None:
                break
            if attempt > 1:
                # a prior attempt failed and a DIFFERENT replica is
                # taking the request: that handoff is the failover
                self._m_failovers.inc()
                self.recorder.record(
                    "tpu_router_failover", trace=trace,
                    replica=rep.rid, attempt=attempt)
            tried.add(rep.rid)
            if sid:
                # landing away from the session's home: ship its
                # parked KV over BEFORE the request, so admission
                # finds a warm checkpoint (best-effort; see helper)
                self._maybe_move_session(sid, rep, trace)
            t0 = time.perf_counter()
            try:
                conn, resp = self._open_upstream(
                    rep, path, body, headers)
            except _UpstreamError as e:
                last_err = e
                self._m_route.observe(time.perf_counter() - t0)
                self.recorder.record(
                    "tpu_router_attempt_failed", trace=trace,
                    replica=rep.rid, attempt=attempt, error=str(e))
                if attempt < self.failover_attempts:
                    # seeded jitter between failover attempts: brief,
                    # bounded, replayable
                    time.sleep(self.retry.backoff_s(attempt))
                continue
            self._m_route.observe(time.perf_counter() - t0)
            break
        if resp is None or conn is None or rep is None:
            reason = ("no healthy replicas"
                      if not tried else
                      f"all {len(tried)} replica(s) failed: "
                      f"{last_err}")
            self._m_shed.labels(reason="no_replicas").inc()
            with self._lock:
                self._no_replica_total += 1
            self._m_requests.labels(
                replica="none",
                outcome="unroutable" if not tried
                else "upstream_error").inc()
            self.recorder.record("tpu_router_unroutable", trace=trace,
                                 tried=",".join(sorted(tried)),
                                 error=str(last_err) if last_err
                                 else "")
            code = 503
            body_out = (json.dumps(
                {"error": reason, "code": code}) + "\n").encode()
            handler.send_response(code)
            handler.send_header("Content-Type", "application/json")
            handler.send_header("Content-Length", str(len(body_out)))
            handler.send_header("Retry-After", "1")
            handler.end_headers()
            try:
                handler.wfile.write(body_out)
            except OSError:
                pass
            self.recorder.record(
                "tpu_router_proxy", trace=trace, replica="none",
                outcome="unroutable",
                duration_s=time.perf_counter() - t_arrival)
            return
        if sid:
            self._note_session_home(sid, rep.rid)
        self._relay(handler, conn, resp, rep, hit, len(tried), trace,
                    t_arrival)

    def _proxy_disagg(self, handler: "BaseHTTPRequestHandler",
                      path: str, parsed: Dict[str, Any],
                      key: Optional[bytes],
                      trace: "obs.TraceContext",
                      t_arrival: float) -> bool:
        """The phase-disaggregated route for one prefill-heavy
        request: forward it to a prefill-class replica with the
        ``prefill_only`` marker (it runs packed prefill, then
        preempts the fresh slot and answers with the bit-exact
        serialized checkpoint), ship that checkpoint to a
        decode-class replica's ``POST /migrate`` (it resumes the slot
        and takes over the stream), and pass the decode replica's
        response through to the client byte-identically.

        Every failure mode falls back BEFORE any client byte: returns
        False and the caller re-routes the ORIGINAL request through
        the normal path (prefill already freed its pages at export,
        so a re-run recomputes from scratch — slower, never wrong).
        True means the response was fully handled here."""
        body2 = dict(parsed)
        body2["prefill_only"] = True
        raw2 = json.dumps(body2).encode()
        headers = {"Content-Type": "application/json",
                   "traceparent": trace.to_traceparent()}
        tried: Set[str] = set()
        prep: Optional[Replica] = None
        conn: Optional[http.client.HTTPConnection] = None
        resp: Optional[http.client.HTTPResponse] = None
        hit = False
        for attempt in range(1, self.failover_attempts + 1):
            prep, hit = self.pick(key, exclude=tried, role="prefill")
            if prep is None:
                break
            tried.add(prep.rid)
            t0 = time.perf_counter()
            try:
                conn, resp = self._open_upstream(
                    prep, path, raw2, headers)
            except _UpstreamError as e:
                self._m_route.observe(time.perf_counter() - t0)
                self.recorder.record(
                    "tpu_router_attempt_failed", trace=trace,
                    replica=prep.rid, attempt=attempt, error=str(e),
                    phase="prefill")
                if attempt < self.failover_attempts:
                    time.sleep(self.retry.backoff_s(attempt))
                continue
            self._m_route.observe(time.perf_counter() - t0)
            break
        if resp is None or conn is None or prep is None:
            self._m_migrations.labels(
                outcome="prefill_unavailable").inc()
            self.recorder.record("tpu_router_migrate_fallback",
                                 trace=trace, stage="prefill_pick",
                                 tried=",".join(sorted(tried)))
            return False
        ctype = resp.headers.get("Content-Type", "")
        if resp.status != 200 \
                or not ctype.startswith(MIGRATE_CONTENT_TYPE):
            # the prefill replica declined (request finished at its
            # first token, or eligibility said no) or answered a
            # client error: its response IS the response — relay it
            self._m_migrations.labels(outcome="declined").inc()
            self.recorder.record("tpu_router_migrate_declined",
                                 trace=trace, replica=prep.rid,
                                 status=resp.status)
            self._relay(handler, conn, resp, prep, hit, len(tried),
                        trace, t_arrival)
            return True
        try:
            payload = resp.read()
        except (OSError, http.client.HTTPException) as e:
            conn.close()
            assert prep.breaker is not None
            prep.breaker.record_failure()
            self._m_migrations.labels(outcome="prefill_error").inc()
            self.recorder.record("tpu_router_migrate_fallback",
                                 trace=trace, stage="payload_read",
                                 replica=prep.rid, error=str(e))
            return False
        conn.close()
        self._m_role_requests.labels(role="prefill").inc()
        t_ship = time.perf_counter()
        mheaders = {"Content-Type": MIGRATE_CONTENT_TYPE,
                    "traceparent": trace.to_traceparent()}
        dtried: Set[str] = set()
        for attempt in range(1, self.failover_attempts + 1):
            drep, dhit = self.pick(key, exclude=dtried, role="decode")
            if drep is None:
                break
            dtried.add(drep.rid)
            try:
                dconn, dresp = self._open_upstream(
                    drep, "/migrate", payload, mheaders)
            except _UpstreamError as e:
                self.recorder.record(
                    "tpu_router_attempt_failed", trace=trace,
                    replica=drep.rid, attempt=attempt, error=str(e),
                    phase="migrate")
                if attempt < self.failover_attempts:
                    time.sleep(self.retry.backoff_s(attempt))
                continue
            if dresp.status != 200:
                # a 4xx from /migrate is a malformed/unresumable
                # payload, not replica pressure (pressure answers
                # 503 and was retried above): re-running the request
                # whole beats poking other replicas with bad bytes
                dconn.close()
                break
            ship_dt = time.perf_counter() - t_ship
            self._m_migrate_s.observe(ship_dt)
            self._m_migrations.labels(outcome="ok").inc()
            self.recorder.record(
                "tpu_router_migrated", trace=trace,
                prefill=prep.rid, decode=drep.rid,
                bytes=len(payload), ship_s=ship_dt)
            self._relay(handler, dconn, dresp, drep, dhit,
                        len(tried) + len(dtried), trace, t_arrival)
            return True
        self._m_migrations.labels(outcome="fallback").inc()
        self.recorder.record("tpu_router_migrate_fallback",
                             trace=trace, stage="decode_pick",
                             prefill=prep.rid,
                             tried=",".join(sorted(dtried)))
        return False

    def _relay(self, handler: "BaseHTTPRequestHandler",
               conn: http.client.HTTPConnection,
               resp: http.client.HTTPResponse, rep: Replica,
               hit: bool, attempts: int, trace: "obs.TraceContext",
               t_arrival: float) -> None:
        """Stream one upstream response back, byte-identical (the
        shared tail of the normal and disagg proxy paths)."""
        outcome = "ok" if resp.status < 400 else (
            "shed" if resp.status == 429 else "client_error")
        if hit:
            self._m_affinity.inc()
        self._m_role_requests.labels(role=rep.role).inc()
        self.recorder.record(
            "tpu_router_routed", trace=trace, replica=rep.rid,
            status=resp.status, affinity=hit, attempts=attempts,
            duration_s=time.perf_counter() - t_arrival)
        content_type = resp.headers.get("Content-Type",
                                        "application/json")
        chunked = (resp.headers.get("Transfer-Encoding", "")
                   .lower() == "chunked")
        try:
            handler.send_response(resp.status)
            for name, value in resp.headers.items():
                if name.lower() in _HOP_HEADERS:
                    continue
                handler.send_header(name, value)
            handler.send_header("X-Replica", rep.rid)
            if chunked:
                handler.send_header("Transfer-Encoding", "chunked")
                handler.end_headers()
                streamed = self._stream_through(
                    handler, conn, resp, rep, content_type, trace)
                if streamed != "ok":
                    outcome = streamed
                self._m_requests.labels(replica=rep.rid,
                                        outcome=outcome).inc()
                self.recorder.record(
                    "tpu_router_proxy", trace=trace, replica=rep.rid,
                    outcome=outcome,
                    duration_s=time.perf_counter() - t_arrival)
                return
            payload = resp.read()
            handler.send_header("Content-Length", str(len(payload)))
            handler.end_headers()
            handler.wfile.write(payload)
        except OSError as e:
            # body read/send failed: mid-body upstream death on a
            # Content-Length response cannot be patched in-band —
            # the short read IS the client's signal
            outcome = "stream_abort"
            assert rep.breaker is not None
            rep.breaker.record_failure()
            self.recorder.record("tpu_router_stream_abort",
                                 trace=trace, replica=rep.rid,
                                 error=str(e))
        finally:
            conn.close()
        self._m_requests.labels(replica=rep.rid,
                                outcome=outcome).inc()
        self.recorder.record(
            "tpu_router_proxy", trace=trace, replica=rep.rid,
            outcome=outcome,
            duration_s=time.perf_counter() - t_arrival)

    def _stream_through(self, handler: "BaseHTTPRequestHandler",
                        conn: http.client.HTTPConnection,
                        resp: http.client.HTTPResponse, rep: Replica,
                        content_type: str,
                        trace: "obs.TraceContext") -> str:
        """The pass-through loop: de-chunk upstream, re-chunk the SAME
        bytes to the client.  Upstream death mid-stream emits a
        well-formed error frame + terminator and opens the breaker;
        client death just abandons the upstream read.  Returns the
        outcome label ("ok", "stream_abort", "client_gone")."""
        outcome = "ok"
        try:
            while True:
                try:
                    # read1, NOT read: read(n) on a chunked response
                    # blocks until n bytes accumulate — it would turn
                    # the pass-through into a 64 KiB store-and-forward
                    # buffer; read1 hands back each upstream chunk's
                    # available bytes as they arrive
                    chunk = resp.read1(_STREAM_READ)
                except (OSError, http.client.HTTPException) as e:
                    # replica died mid-stream: forward whatever valid
                    # payload the failed read salvaged, then an
                    # in-band structured error + clean chunked
                    # terminator; the breaker opens
                    outcome = "stream_abort"
                    assert rep.breaker is not None
                    rep.breaker.record_failure()
                    self.recorder.record(
                        "tpu_router_stream_abort", trace=trace,
                        replica=rep.rid, error=str(e))
                    partial = getattr(e, "partial", b"") or b""
                    if partial:
                        handler.wfile.write(
                            b"%x\r\n%s\r\n" % (len(partial), partial))
                    frame = self._error_frame(
                        content_type,
                        f"replica {rep.rid} died mid-stream; "
                        "retry the request", 502)
                    handler.wfile.write(
                        b"%x\r\n%s\r\n" % (len(frame), frame))
                    break
                if not chunk:
                    break
                handler.wfile.write(
                    b"%x\r\n%s\r\n" % (len(chunk), chunk))
            handler.wfile.write(b"0\r\n\r\n")
        except OSError:
            # the CLIENT went away: nothing to send an error to
            outcome = "client_gone"
            self.recorder.record("tpu_router_client_gone",
                                 trace=trace, replica=rep.rid)
        return outcome

    def healthy(self) -> bool:
        """>= 1 routable replica."""
        with self._lock:
            reps = list(self._replicas.values())
        return any(self._routable(r) for r in reps)

    # -- lifecycle ----------------------------------------------------------

    def start(self, host: str = "0.0.0.0",
              port: int = 8100) -> "RouterServer":
        router = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            timeout = router.client_timeout_s

            def do_GET(self) -> None:  # noqa: N802 (http.server API)
                if self.path == "/healthz":
                    if router.healthy():
                        self._send(200, "text/plain", b"ok\n")
                    else:
                        self._send(503, "text/plain",
                                   b"no healthy replicas\n")
                elif self.path == "/replicas":
                    body = json.dumps(
                        {"replicas": router.replicas()},
                        indent=2).encode() + b"\n"
                    self._send(200, "application/json", body)
                elif self.path == "/metrics":
                    om = obs.negotiate_openmetrics(
                        self.headers.get("Accept"))
                    try:
                        # ScrapeMeta accounts the exposition itself
                        # (tpu_scrape_*); the fleet bridge gauges
                        # refresh via the registry collect hook
                        body = router.scrape_meta.render(
                            openmetrics=om).encode()
                    except Exception:
                        log.exception("/metrics render failed")
                        self._send(500, "text/plain",
                                   b"internal error\n")
                        return
                    self._send(200, obs.OPENMETRICS_CONTENT_TYPE
                               if om else obs.TEXT_CONTENT_TYPE, body)
                elif self.path == "/alerts":
                    self._send(200, "application/json",
                               (router.alerts.status_json()
                                + "\n").encode())
                elif self.path.startswith("/debug/query"):
                    params = {k: v[0] for k, v in parse_qs(
                        urlparse(self.path).query).items()}
                    try:
                        qbody = router.tsdb.handle_query_json(params)
                    except ValueError as e:
                        self._send(400, "application/json",
                                   (json.dumps({"error": str(e)})
                                    + "\n").encode())
                        return
                    self._send(200, "application/json",
                               (qbody + "\n").encode())
                elif self.path == "/fleet/statz":
                    body = json.dumps(
                        router.fleet_statz(),
                        indent=2).encode() + b"\n"
                    self._send(200, "application/json", body)
                elif self.path.startswith("/debug/traces"):
                    # ?trace_id=… -> the CROSS-REPLICA stitched tree
                    # (router + every replica's timeline re-linked via
                    # traceparent parents); without it, the router's
                    # own recent-trace index
                    q = parse_qs(urlparse(self.path).query)
                    tid = q.get("trace_id", [""])[0]
                    if tid:
                        payload: Dict[str, Any] = \
                            router.stitched_trace(tid)
                    else:
                        payload = {
                            "traces": router.recorder.trace_ids()}
                    body = json.dumps(
                        payload, indent=2).encode() + b"\n"
                    self._send(200, "application/json", body)
                elif self.path.startswith("/debug/events"):
                    body = json.dumps({
                        "dropped": router.recorder.dropped,
                        "events": router.recorder.events(),
                    }, indent=2).encode() + b"\n"
                    self._send(200, "application/json", body)
                elif self.path.startswith("/debug/pprof"):
                    # the router's own continuous-profile ring
                    try:
                        ctype, text = router.profiler.handle_pprof(
                            parse_qs(urlparse(self.path).query))
                    except ValueError as e:
                        self._send(400, "application/json",
                                   (json.dumps({"error": str(e)})
                                    + "\n").encode())
                        return
                    self._send(200, ctype, text.encode())
                else:
                    self._send(404, "text/plain", b"not found\n")

            def do_POST(self) -> None:  # noqa: N802
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length) if length else b""
                if self.path == "/register":
                    try:
                        out = router.register(
                            json.loads(body) if body else {})
                    except (ValueError, TypeError) as e:
                        self._send(400, "application/json",
                                   (json.dumps({"error": str(e)})
                                    + "\n").encode())
                        return
                    self._send(200, "application/json",
                               (json.dumps(out) + "\n").encode())
                    return
                if self.path == "/drain":
                    try:
                        out = router.drain(
                            json.loads(body) if body else {})
                    except (ValueError, TypeError) as e:
                        self._send(400, "application/json",
                                   (json.dumps({"error": str(e)})
                                    + "\n").encode())
                        return
                    except KeyError as e:
                        self._send(404, "application/json",
                                   (json.dumps({"error": "unknown "
                                    f"replica {e.args[0]!r}"})
                                    + "\n").encode())
                        return
                    self._send(200, "application/json",
                               (json.dumps(out) + "\n").encode())
                    return
                if self.path not in PROXY_PATHS:
                    self._send(404, "text/plain", b"not found\n")
                    return
                trace = obs.trace_from_header(
                    self.headers.get("traceparent"))
                try:
                    router.proxy(self, self.path, body, trace)
                except (BrokenPipeError, ConnectionResetError,
                        TimeoutError):
                    pass

            def _send(self, code: int, ctype: str,
                      body: bytes) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                try:
                    self.wfile.write(body)
                except OSError:
                    pass

            def log_message(self, format: str,  # noqa: A002
                            *args: Any) -> None:
                log.debug("router-http: " + format, *args)

        self._httpd = _PooledRouterHTTPServer(
            (host, port), Handler, workers=self.max_connections,
            shed=self._shed_conns)
        threading.Thread(target=self._httpd.serve_forever,
                         name="router-http", daemon=True).start()
        self._poller = threading.Thread(
            target=self._poll_loop, name="router-statz", daemon=True)
        self._poller.start()
        self.tsdb.start(self.alert_interval_s)
        self.profiler.start()
        if self._incidents is not None:
            self._incidents.start()
        log.info("router on http://%s:%d", host, self.port)
        return self

    @property
    def port(self) -> int:
        if self._httpd is None:
            return 0
        return int(self._httpd.server_address[1])

    def stop(self) -> None:
        self.tsdb.stop()
        self.profiler.stop()
        if self._incidents is not None:
            self._incidents.stop()
        self._stop.set()
        if self._poller is not None:
            self._poller.join(timeout=2)
            self._poller = None
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None


def main(argv: Optional[List[str]] = None) -> int:
    """CLI: run the router tier.  Replicas register themselves
    (``workloads.server --register-with http://this-router``); static
    fleets can be pre-seeded with --replica."""
    p = argparse.ArgumentParser(prog="tpu-serve-router")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8100)
    p.add_argument("--replica", action="append", default=None,
                   metavar="HOST:PORT",
                   help="pre-seed a replica (repeatable); replicas "
                        "normally self-register via POST /register")
    p.add_argument("--prefix-chunk", type=int,
                   default=DEFAULT_PREFIX_CHUNK,
                   help="affinity-hash alignment in tokens; match the "
                        "replicas' --prefix-chunk (default 32 = the "
                        "engine's auto grid)")
    p.add_argument("--replica-ttl", type=float, default=10.0,
                   help="seconds without a heartbeat or /statz answer "
                        "before a replica is evicted")
    p.add_argument("--statz-interval", type=float, default=0.5,
                   help="seconds between /statz load-signal polls")
    p.add_argument("--max-connections", type=int, default=64,
                   help="router HTTP worker pool size (429 past 2x)")
    p.add_argument("--failover-attempts", type=int, default=3,
                   help="replicas tried per request before 503")
    p.add_argument("--overload-factor", type=float, default=4.0,
                   help="skip the affinity target when its queue+"
                        "in-flight exceeds this many times its "
                        "capacity (falls back to least-loaded)")
    p.add_argument("--breaker-reset", type=float, default=2.0,
                   help="per-replica circuit-breaker reset timeout")
    p.add_argument("--disagg", default=True,
                   action=argparse.BooleanOptionalAction,
                   help="phase-aware routing (default on, engaged "
                        "only when prefill- AND decode-class "
                        "replicas are registered): prefill-heavy "
                        "requests prefill on a prefill replica, the "
                        "finished KV state migrates to a decode "
                        "replica over POST /migrate, and decode "
                        "streams from there undisturbed")
    p.add_argument("--prefill-threshold", type=int,
                   default=DEFAULT_PREFILL_THRESHOLD, metavar="N",
                   help="prompt length (tokens) at or above which a "
                        "request counts as prefill-heavy; unary "
                        "requests qualify regardless")
    p.add_argument("--tenant-quota", action="append", default=None,
                   metavar="NAME=RATE[:BURST[:WEIGHT]]",
                   help="FLEET-level per-tenant token-rate quota "
                        "(same grammar as the serving flag; '*' is "
                        "the template for unknown tenants): the "
                        "router charges prompt+budget estimates at "
                        "route time and sheds 429 past the rate — "
                        "the globally-correct bucket replica-local "
                        "quotas cannot be")
    p.add_argument("--tenant-pinning", default=True,
                   action=argparse.BooleanOptionalAction,
                   help="sticky tenant->replica placement on a "
                        "second hash ring (default on): one tenant's "
                        "traffic lands on one replica, so the "
                        "replica-local WFQ/quota state is coherent "
                        "per tenant even without router quotas")
    p.add_argument("--session-affinity", default=True,
                   action=argparse.BooleanOptionalAction,
                   help="session KV affinity on a third hash ring "
                        "(default on): requests carrying session_id "
                        "prefer the replica holding their parked KV, "
                        "and when the pick lands elsewhere the router "
                        "moves the checkpoint over /session/export + "
                        "/session/import first (best-effort; any "
                        "failure degrades to plain re-prefill)")
    p.add_argument("--default-budget", type=int,
                   default=DEFAULT_BUDGET_ESTIMATE, metavar="N",
                   help="max-new-tokens estimate for tenant "
                        "accounting when a request does not carry "
                        "one (match the replicas' --max-new-tokens)")
    p.add_argument("--seed", type=int, default=None,
                   help="failover backoff jitter seed (chaos replay)")
    p.add_argument("--fault-spec", default=None, metavar="SPEC",
                   help="arm deterministic fault injection (chaos "
                        "testing ONLY), e.g. 'router.proxy:error:0.1'")
    p.add_argument("--flight-record-dir", default=None, metavar="DIR",
                   help="dump the flight-recorder journal on "
                        "exit/SIGTERM")
    p.add_argument("--slo", action="append", default=None,
                   metavar="CLASS=TTFT_MS[:DEADLINE_MS]",
                   help="SLO classes the fleet-level burn-rate alert "
                        "rules derive from (same grammar as the "
                        "serving flag; default interactive + batch) — "
                        "evaluated over the fleet-aggregate "
                        "tpu_router_fleet_burn_rate bridge gauge")
    p.add_argument("--alert-rules", default=None, metavar="FILE",
                   help="extra JSON alert rules ({\"rules\": [...]}) "
                        "for the router's in-process evaluator")
    p.add_argument("--alert-interval", type=float, default=5.0,
                   metavar="S",
                   help="TSDB sampling / alert evaluation tick "
                        "(seconds)")
    p.add_argument("--alert-window-scale", type=float, default=1.0,
                   metavar="X",
                   help="scale factor on the derived burn-rate rule "
                        "windows (5m/1h/6h * X)")
    p.add_argument("--incident-dir", default=None, metavar="DIR",
                   help="write alert-triggered fleet incident bundles "
                        "under this directory (env TPU_DP_INCIDENT_DIR)")
    p.add_argument("--profiler-hz", type=float, default=19.0,
                   metavar="HZ",
                   help="continuous sampling-profiler tick rate "
                        "(default 19)")
    args = p.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname).1s %(name)s: %(message)s")
    try:
        tenant_quotas = parse_tenant_quotas(args.tenant_quota)
    except ValueError as e:
        p.error(str(e))
    slo_policies = None
    if args.slo:
        try:
            slo_policies = obs.parse_slo_specs(args.slo)
        except ValueError as e:
            p.error(str(e))
    alert_rules = None
    if args.alert_rules:
        try:
            alert_rules = obs.load_alert_rules(args.alert_rules)
        except (OSError, ValueError) as e:
            p.error(f"--alert-rules: {e}")
    if args.alert_interval <= 0:
        p.error("--alert-interval must be > 0")
    if args.alert_window_scale <= 0:
        p.error("--alert-window-scale must be > 0")
    if args.profiler_hz <= 0:
        p.error("--profiler-hz must be > 0")
    incident_dir = (args.incident_dir
                    or os.environ.get("TPU_DP_INCIDENT_DIR") or None)
    rt = RouterServer(
        prefix_chunk=args.prefix_chunk,
        replica_ttl_s=args.replica_ttl,
        statz_interval_s=args.statz_interval,
        max_connections=args.max_connections,
        failover_attempts=args.failover_attempts,
        overload_factor=args.overload_factor,
        breaker_reset_s=args.breaker_reset,
        seed=args.seed,
        flight_record_dir=args.flight_record_dir,
        disagg=args.disagg,
        prefill_threshold=args.prefill_threshold,
        tenant_quotas=tenant_quotas,
        tenant_pinning=args.tenant_pinning,
        session_affinity=args.session_affinity,
        default_budget=args.default_budget,
        slo_policies=slo_policies,
        alert_rules=alert_rules,
        alert_interval_s=args.alert_interval,
        alert_window_scale=args.alert_window_scale,
        incident_dir=incident_dir,
        profiler_hz=args.profiler_hz)
    if args.fault_spec:
        faults.install(args.fault_spec, seed=args.seed or 0,
                       recorder=rt.recorder)
    for addr in args.replica or ():
        rt.register({"address": addr})
    rt.start(host=args.host, port=args.port)
    print(f"router on http://{args.host}:{rt.port}  "
          f"[POST /generate, /v1/completions, /register; "
          f"GET /healthz, /replicas, /metrics]", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        rt.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
