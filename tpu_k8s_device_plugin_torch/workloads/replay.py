# tpulint: deterministic-path
"""Open-loop trace replay with per-class SLO attribution.

The counterpart of :mod:`.trafficgen`: take a ``tpu-trace/v1`` file
and replay it against a serving endpoint (one replica, or a router in
front of a fleet this module spawns itself) the way production
traffic actually arrives — **open loop**.  Requests dispatch at the
trace's timestamps whether or not earlier requests finished; a
replay that falls behind counts its late dispatches (and reports the
lag) but NEVER reschedules them, because a load generator that waits
for the system under test is measuring its own politeness.  Closed
loops self-throttle under overload and hide exactly the tail this
harness exists to expose.

What comes out is not a throughput number but an **SLO-attribution
report** (``tpu-replay-report/v1``): per-class goodput attainment
judged client-side against the same ``--slo`` grammar the server
uses, joined with the server's own ``/metrics`` and ``/statz``
goodput blocks, and — for every SLO-missed request — the stitched
``/debug/traces`` spans bucketed into where the time went:
queue-wait vs prefill vs decode vs stream-write vs router hop.  The
replay's own counters render through obs as ``tpu_replay_*``
families (``--metrics-out``), so a CI gate and a dashboard read the
same schema.

Client misbehavior (slow readers, abandoners, unary/stream mix)
comes from the trace and is executed by :mod:`.loadclient`;
``abandoned`` is a terminal outcome here, excluded from the SLO
denominator (the CLIENT left; the server did nothing wrong), while
sheds and errors count as misses.  With ``--kill-replica-at-ms`` the
harness SIGKILLs one spawned replica mid-trace and the report grows
a ``chaos`` section proving eviction, failover, and post-kill
attainment recovery — the goodput-under-chaos CI gate reads that.

Determinism marker: this module uses only monotonic clocks
(dispatch pacing) — no wall-clock reads, no RNG — so two replays of
one seeded trace differ only by scheduling noise, never by harness
randomness.  Stdlib + obs + sibling workloads modules, mypy
--strict.

The port's own copy of the JAX package's ``workloads/replay.py`` (the
port imports nothing of that package): the same trace against the same
endpoint gives the same per-request outcomes and the same report
schema.  Its fleet mode spawns the port's server CLI, on CUDA unless
``--device`` names another device (``cpu`` in tests).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .. import obs
from ..obs.slo import OTHER_LABEL, SLOPolicy
from . import loadclient
from .loadclient import StreamOutcome
from .trafficgen import TraceRequest, load_trace

log = logging.getLogger("replay")

REPORT_SCHEMA = "tpu-replay-report/v1"

# how long (trace-ms) after the kill the fleet is allowed to be in
# its failover trough before the "recovered" attainment window
# starts.  Kept shorter than the router's replica TTL so CI-scale
# traces (a few seconds of tail past the kill) still land eligible
# requests in the post-kill window.
CHAOS_SETTLE_MS = 2000.0

# server/router span names -> attribution bucket.  These are the
# names the engine journals through _mark()/Span; the report adds
# router_hop (proxy minus serve span) and unattributed (the rest of
# the client-observed latency: network, python, scrape noise).
_EVENT_BUCKETS = {
    "tpu_serve_queue_wait": "queue_wait_ms",
    "tpu_serve_admit": "prefill_ms",
    "tpu_serve_window": "decode_ms",
    "tpu_serve_stream_write": "stream_write_ms",
}
ATTRIBUTION_KEYS = ("queue_wait_ms", "prefill_ms", "decode_ms",
                    "stream_write_ms", "router_hop_ms",
                    "unattributed_ms")


@dataclass
class RequestResult:
    """One replayed request: the trace record, the wire-observed
    outcome, and the dispatcher's lateness accounting."""

    req: TraceRequest
    outcome: StreamOutcome
    lag_s: float
    late: bool
    slo_met: Optional[bool] = None  # None = not SLO-eligible


class ReplayMetrics:
    """The ``tpu_replay_*`` families (all defined HERE), rendered
    through a plain obs registry so promlint/dashboards see the same
    schema as the serving side.  Class labels are bounded to the
    declared policy names plus ``other``."""

    def __init__(self, registry: obs.Registry,
                 policies: Dict[str, SLOPolicy]) -> None:
        self.registry = registry
        self._classes = list(policies) + [OTHER_LABEL]
        self._m_requests = registry.counter(
            "tpu_replay_requests_total",
            "Replayed requests by SLO class and terminal outcome "
            "(ok/abandoned/shed/error/transport_error); class values "
            "are bounded to the declared policy set plus 'other'.",
            ("class", "outcome"))
        self._m_late = registry.counter(
            "tpu_replay_late_dispatches_total",
            "Requests dispatched later than the open-loop lateness "
            "budget allows; counted, never rescheduled.")
        self._h_lag = registry.histogram(
            "tpu_replay_dispatch_lag_seconds",
            "How far behind the trace timestamp each dispatch ran "
            "(open-loop pacing error of the harness itself).",
            buckets=obs.FAST_BUCKETS_S)
        self._h_ttft = registry.histogram(
            "tpu_replay_ttft_seconds",
            "Client-observed time to first streamed token by SLO "
            "class.", ("class",))
        self._h_total = registry.histogram(
            "tpu_replay_request_seconds",
            "Client-observed total request latency by SLO class.",
            ("class",))
        self._g_attain = registry.gauge(
            "tpu_replay_slo_attainment_ratio",
            "Fraction of SLO-eligible replayed requests that met "
            "their class SLO (the replay-side goodput headline).",
            ("class",))
        for name in self._classes:
            self._g_attain.labels(**{"class": name}).set(1.0)

    def bound(self, slo_class: str) -> str:
        return slo_class if slo_class in self._classes[:-1] \
            else OTHER_LABEL

    def observe(self, result: RequestResult) -> None:
        label = self.bound(result.req.slo_class)
        self._m_requests.labels(**{
            "class": label,
            "outcome": result.outcome.outcome}).inc()
        self._h_lag.observe(max(0.0, result.lag_s))
        if result.late:
            self._m_late.inc()
        if result.outcome.ttft_s is not None:
            self._h_ttft.labels(**{"class": label}).observe(
                result.outcome.ttft_s,
                trace_id=result.outcome.trace_id)
        self._h_total.labels(**{"class": label}).observe(
            result.outcome.total_s,
            trace_id=result.outcome.trace_id)

    def set_attainment(self, per_class: Dict[str, float]) -> None:
        for name in self._classes:
            if name in per_class:
                self._g_attain.labels(**{"class": name}).set(
                    per_class[name])


def judge(req: TraceRequest, out: StreamOutcome,
          policies: Dict[str, SLOPolicy]) -> Optional[bool]:
    """Client-side SLO verdict for one replayed request, mirroring
    the server accountant's semantics: unknown classes judge against
    the request-shape fallback, non-ok outcomes never meet an SLO —
    EXCEPT abandonment, which is the client's own doing and returns
    None (not SLO-eligible, excluded from the denominator)."""
    if out.outcome == loadclient.OUTCOME_ABANDONED:
        return None
    fallback = "interactive" if req.behavior.stream else "batch"
    policy = policies.get(req.slo_class) or policies.get(fallback) \
        or next(iter(policies.values()))
    if out.outcome != loadclient.OUTCOME_OK:
        return False
    return policy.met(out.ttft_s, out.total_s)


def replay_trace(requests: Sequence[TraceRequest], host: str,
                 port: int, *, policies: Dict[str, SLOPolicy],
                 metrics: ReplayMetrics, time_scale: float = 1.0,
                 late_ms: float = 100.0, timeout_s: float = 120.0,
                 hooks: Sequence[Tuple[float,
                                       Callable[[], None]]] = (),
                 ) -> List[RequestResult]:
    """Open-loop dispatch of *requests* against ``host:port``.  Each
    request fires at ``t_ms / time_scale`` after start on its own
    thread (an open loop must never queue behind a slow request);
    *hooks* are (real-seconds-after-start, callback) pairs — the
    chaos kill rides one.  Lag beyond *late_ms* marks the dispatch
    late (counted, never rescheduled).  Returns results in trace
    order."""
    if time_scale <= 0:
        raise ValueError("time_scale must be > 0")
    results: List[Optional[RequestResult]] = [None] * len(requests)
    lock = threading.Lock()

    # session continuation: a revisit's prompt is the
    # conversation so far (prior visits' prompts) + the new turn, and
    # the conversation is CLOSED-loop within itself — a user cannot
    # send the follow-up before the reply arrives — while the trace
    # stays open-loop across sessions.  Both are precomputed /
    # coordinated here so replays are deterministic functions of the
    # trace, not of runtime interleaving.
    session_hist: Dict[str, List[int]] = {}
    chained: List[List[int]] = []
    for req in requests:
        if req.session:
            hist = session_hist.setdefault(req.session, [])
            chained.append(hist + req.tokens if req.cont
                           else list(req.tokens))
            hist.extend(req.tokens)
        else:
            chained.append(req.tokens)
    session_prev: Dict[str, threading.Event] = {}

    def one(i: int, req: TraceRequest, lag_s: float,
            tokens: List[int], prev_evt: Optional[threading.Event],
            done_evt: Optional[threading.Event]) -> None:
        if prev_evt is not None:
            # think time already paced the dispatch; this only guards
            # the pathological case where the previous turn is STILL
            # streaming (bounded — a wedged turn must not wedge the
            # whole conversation's accounting)
            prev_evt.wait(timeout_s)
        body: Dict[str, object] = {
            "tokens": tokens,
            "max_new_tokens": req.max_new_tokens,
            "priority": req.priority, "slo_class": req.slo_class,
            "ignore_eos": True,
        }
        if req.session:
            body["session_id"] = req.session
        if req.tenant and req.tenant != "default":
            body["tenant"] = req.tenant
        if req.behavior.stream:
            out = loadclient.stream_request(
                host, port, body, behavior=req.behavior,
                timeout_s=timeout_s)
        else:
            body["stream"] = False
            out = loadclient.unary_request(
                host, port, body, timeout_s=timeout_s)
        res = RequestResult(req=req, outcome=out, lag_s=lag_s,
                            late=lag_s * 1000.0 > late_ms,
                            slo_met=judge(req, out, policies))
        metrics.observe(res)
        with lock:
            results[i] = res
        if done_evt is not None:
            done_evt.set()

    threads: List[threading.Thread] = []
    t0 = time.monotonic()
    hook_threads: List[threading.Thread] = []
    stop = threading.Event()
    for delay_s, fn in hooks:
        def run_hook(d: float = delay_s,
                     f: Callable[[], None] = fn) -> None:
            if not stop.wait(d):
                f()
        ht = threading.Thread(target=run_hook, daemon=True)
        ht.start()
        hook_threads.append(ht)
    try:
        for i, req in enumerate(requests):
            target = t0 + req.t_ms / 1000.0 / time_scale
            now = time.monotonic()
            if target > now:
                time.sleep(target - now)
                now = time.monotonic()
            prev_evt = done_evt = None
            if req.session:
                prev_evt = session_prev.get(req.session)
                done_evt = threading.Event()
                session_prev[req.session] = done_evt
            t = threading.Thread(target=one,
                                 args=(i, req, now - target,
                                       chained[i], prev_evt,
                                       done_evt),
                                 daemon=True)
            t.start()
            threads.append(t)
        for t in threads:
            t.join(timeout=timeout_s + 30.0)
    finally:
        stop.set()
        for ht in hook_threads:
            ht.join(timeout=5.0)
    out: List[RequestResult] = []
    for i, res in enumerate(results):
        if res is None:
            # a worker thread died or overran its join budget: that
            # request's outcome is unknown — report it as a transport
            # error rather than silently shrinking the denominator
            log.warning("request %s never reported a result",
                        requests[i].rid)
            res = RequestResult(
                req=requests[i],
                outcome=StreamOutcome(
                    status=-1,
                    outcome=loadclient.OUTCOME_TRANSPORT,
                    total_s=timeout_s,
                    error="no result (worker timeout)"),
                lag_s=0.0, late=False, slo_met=False)
            metrics.observe(res)
        out.append(res)
    return out


# -- report ----------------------------------------------------------------


def _pct(xs: List[float], q: float) -> Optional[float]:
    if not xs:
        return None
    s = sorted(xs)
    return s[min(len(s) - 1, int(q * (len(s) - 1)))]


def attribute(events: List[Dict[str, object]],
              client_total_s: float) -> Dict[str, float]:
    """Bucket one request's server/router span events into where the
    time went.  ``router_hop_ms`` is the proxy span minus the serve
    span (time the router spent picking/forwarding/relaying);
    ``unattributed_ms`` is whatever remains of the client-observed
    latency (network, harness, scrape gaps) — it is REPORTED, not
    hidden, because an attribution that always sums to 100% is a
    model, not a measurement."""
    out = {k: 0.0 for k in ATTRIBUTION_KEYS}
    proxy_s = 0.0
    serve_s = 0.0
    for ev in events:
        name = ev.get("name")
        attrs = ev.get("attrs")
        if not isinstance(name, str) or not isinstance(attrs, dict):
            continue
        dur = attrs.get("duration_s")
        if not isinstance(dur, (int, float)):
            continue
        bucket = _EVENT_BUCKETS.get(name)
        if bucket is not None:
            out[bucket] += float(dur) * 1000.0
        elif name == "tpu_serve_request":
            serve_s += float(dur)
        elif name == "tpu_router_proxy":
            proxy_s += float(dur)
    if proxy_s > 0.0:
        out["router_hop_ms"] = max(0.0, proxy_s - serve_s) * 1000.0
    accounted = sum(out[k] for k in ATTRIBUTION_KEYS
                    if k != "unattributed_ms")
    out["unattributed_ms"] = max(
        0.0, client_total_s * 1000.0 - accounted)
    return {k: round(v, 3) for k, v in out.items()}


def _result_row(r: RequestResult) -> Dict[str, object]:
    o = r.outcome
    return {
        "rid": r.req.rid, "t_ms": round(r.req.t_ms, 3),
        "class": r.req.slo_class, "tenant": r.req.tenant,
        "status": o.status, "outcome": o.outcome,
        "ttft_ms": None if o.ttft_s is None
        else round(o.ttft_s * 1000.0, 3),
        "total_ms": round(o.total_s * 1000.0, 3),
        "tokens": o.tokens, "done_tokens": o.done_tokens,
        "replica": o.replica, "trace_id": o.trace_id,
        "late": r.late, "lag_ms": round(r.lag_s * 1000.0, 3),
        "slo_met": r.slo_met, "error": o.error,
    }


def build_report(results: Sequence[RequestResult],
                 policies: Dict[str, SLOPolicy], *,
                 trace_header: Dict[str, object], target: str,
                 time_scale: float, late_ms: float,
                 debug_port: Optional[int] = None,
                 debug_host: str = "127.0.0.1",
                 top_missed: int = 5) -> Dict[str, object]:
    """The ``tpu-replay-report/v1`` document: per-class attainment +
    latency tails, per-request rows, and — for SLO-missed requests —
    the span-bucketed attribution (with raw stitched events embedded
    for the slowest *top_missed*, so ``tools/obs_query.py
    --replay-report`` renders their trees offline)."""
    classes: Dict[str, Dict[str, object]] = {}
    attain: Dict[str, float] = {}
    for name, policy in policies.items():
        rs = [r for r in results if r.req.slo_class == name]
        eligible = [r for r in rs if r.slo_met is not None]
        met = [r for r in eligible if r.slo_met]
        outcomes: Dict[str, int] = {}
        for r in rs:
            outcomes[r.outcome.outcome] = outcomes.get(
                r.outcome.outcome, 0) + 1
        ttfts = [r.outcome.ttft_s * 1000.0 for r in rs
                 if r.outcome.ttft_s is not None]
        totals = [r.outcome.total_s * 1000.0 for r in rs]
        ratio = len(met) / len(eligible) if eligible else 1.0
        attain[name] = ratio
        classes[name] = {
            "policy": {"ttft_ms": policy.ttft_ms,
                       "deadline_ms": policy.deadline_ms,
                       "objective": policy.objective},
            "total": len(rs), "eligible": len(eligible),
            "met": len(met), "attainment": round(ratio, 4),
            "outcomes": outcomes,
            "ttft_ms": {"p50": _pct(ttfts, 0.5),
                        "p95": _pct(ttfts, 0.95),
                        "p99": _pct(ttfts, 0.99)},
            "total_ms": {"p50": _pct(totals, 0.5),
                         "p95": _pct(totals, 0.95),
                         "p99": _pct(totals, 0.99)},
        }
    # per-tenant attainment: the quota buckets' report surface, so a
    # multi-tenant gate can assert tenant:NAME=RATIO floors straight
    # from the document
    tenants: Dict[str, Dict[str, object]] = {}
    by_tenant: Dict[str, List[RequestResult]] = {}
    for r in results:
        by_tenant.setdefault(r.req.tenant, []).append(r)
    for tname in sorted(by_tenant):
        rs = by_tenant[tname]
        eligible = [r for r in rs if r.slo_met is not None]
        met = [r for r in eligible if r.slo_met]
        t_outcomes: Dict[str, int] = {}
        for r in rs:
            t_outcomes[r.outcome.outcome] = t_outcomes.get(
                r.outcome.outcome, 0) + 1
        tenants[tname] = {
            "total": len(rs), "eligible": len(eligible),
            "met": len(met),
            "attainment": round(
                len(met) / len(eligible), 4) if eligible else 1.0,
            "outcomes": t_outcomes,
        }
    # session warm-vs-cold split: revisits (cont=True) should
    # warm-resume their parked KV; first visits pay the full prefill.
    # The goodput gate asserts warm p95 TTFT beats cold p95 — the
    # tiering layer's end-to-end latency evidence.
    sessions_block: Optional[Dict[str, object]] = None
    sessioned = [r for r in results if r.req.session]
    if sessioned:
        def _ttft_stats(rs: List[RequestResult]) -> Dict[str, object]:
            ttfts = [r.outcome.ttft_s * 1000.0 for r in rs
                     if r.outcome.ttft_s is not None
                     and r.outcome.outcome == loadclient.OUTCOME_OK]
            return {"total": len(rs), "measured": len(ttfts),
                    "ttft_ms": {"p50": _pct(ttfts, 0.5),
                                "p95": _pct(ttfts, 0.95)}}
        sessions_block = {
            "sessions": len({r.req.session for r in sessioned}),
            "warm": _ttft_stats(
                [r for r in sessioned if r.req.cont]),
            "cold": _ttft_stats(
                [r for r in sessioned if not r.req.cont]),
        }
    missed = sorted(
        (r for r in results if r.slo_met is False),
        key=lambda r: -r.outcome.total_s)
    missed_rows: List[Dict[str, object]] = []
    for rank, r in enumerate(missed):
        row = _result_row(r)
        events: List[Dict[str, object]] = []
        if debug_port is not None and r.outcome.trace_id:
            try:
                events = loadclient.fetch_trace_events(
                    debug_port, r.outcome.trace_id, host=debug_host)
            except (OSError, ValueError) as e:
                log.warning("no trace events for %s: %s",
                            r.req.rid, e)
        row["attribution"] = attribute(events, r.outcome.total_s)
        if rank < top_missed and events:
            # raw spans ride along for the slowest K so obs_query
            # can re-stitch them from the report file alone
            row["events"] = events
        missed_rows.append(row)
    outcome_totals: Dict[str, int] = {}
    for r in results:
        outcome_totals[r.outcome.outcome] = outcome_totals.get(
            r.outcome.outcome, 0) + 1
    return {
        "schema": REPORT_SCHEMA,
        "trace": {"seed": trace_header.get("seed"),
                  "requests": trace_header.get("requests"),
                  "config": trace_header.get("config")},
        "target": target,
        "open_loop": {"time_scale": time_scale, "late_ms": late_ms,
                      "late_dispatches": sum(
                          1 for r in results if r.late),
                      "max_lag_ms": round(max(
                          (r.lag_s for r in results),
                          default=0.0) * 1000.0, 3)},
        "classes": classes,
        "tenants": tenants,
        "sessions": sessions_block,
        "outcomes": outcome_totals,
        "abandoned": outcome_totals.get(
            loadclient.OUTCOME_ABANDONED, 0),
        "requests": [_result_row(r) for r in results],
        "slo_missed": missed_rows,
    }


def _attrs(ev: Dict[str, object]) -> Dict[str, object]:
    a = ev.get("attrs")
    return a if isinstance(a, dict) else {}


def _attainment_window(results: Sequence[RequestResult],
                       slo_class: str, lo_ms: float,
                       hi_ms: float) -> Optional[float]:
    rs = [r for r in results
          if r.req.slo_class == slo_class
          and lo_ms <= r.req.t_ms < hi_ms
          and r.slo_met is not None]
    if not rs:
        return None
    return round(sum(1 for r in rs if r.slo_met) / len(rs), 4)


# -- fleet mode ------------------------------------------------------------


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))


def _spawn_replica(idx: int, port: int, router_port: int,
                   args: argparse.Namespace,
                   session_dir: Optional[str] = None
                   ) -> "subprocess.Popen[bytes]":
    """One REAL replica subprocess — the CLI a pod runs — so a chaos
    kill is a kill (no graceful drain, sockets die mid-chunk).  The
    port's server, on ``args.device`` (none: CUDA)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = _repo_root() + os.pathsep \
        + env.get("PYTHONPATH", "")
    cmd = loadclient.server_cmd(
        getattr(args, "device", None),
        "--config", args.config, "--n-slots", str(args.slots),
        "--max-len", str(args.max_len),
        "--max-new-tokens", str(args.max_new_tokens),
        "--window", "4", "--host", "127.0.0.1",
        "--port", str(port),
        "--register-with", f"http://127.0.0.1:{router_port}",
        "--replica-id", f"replay-{idx}",
        "--register-interval", "0.3")
    if args.prefix_chunk > 0:
        cmd += ["--prefix-chunk", str(args.prefix_chunk)]
    if session_dir is not None:
        cmd += ["--kv-paging", "--session-tier",
                "--session-dir", session_dir,
                "--session-seed", str(args.seed)]
    for spec in args.slo or []:
        cmd += ["--slo", spec]
    cmd += list(getattr(args, "server_extra_args", ()) or ())
    return loadclient.spawn_replica(cmd, f"replay-{idx}", env=env)


def run_fleet(args: argparse.Namespace,
              requests: Sequence[TraceRequest],
              policies: Dict[str, SLOPolicy],
              metrics: ReplayMetrics,
              trace_header: Dict[str, object]) -> Dict[str, object]:
    """Spawn an in-process router + N real replica subprocesses,
    replay the trace through the router, optionally SIGKILL the last
    replica at ``--kill-replica-at-ms`` (trace time), and build the
    report with a journal/metric-proven ``chaos`` section."""
    from .qos import parse_tenant_quotas
    from .router import RouterServer

    rt = RouterServer(statz_interval_s=0.5, replica_ttl_s=5.0,
                      breaker_reset_s=0.5, seed=args.seed,
                      tenant_quotas=parse_tenant_quotas(
                          getattr(args, "tenant_quota", None)))
    rt.start(host="127.0.0.1", port=0)
    procs: List["subprocess.Popen[bytes]"] = []
    victim_idx = args.replicas - 1

    def fleet_healthy(body: Dict[str, object]) -> bool:
        reps = body.get("replicas")
        if not isinstance(reps, list):
            return False
        healthy = sum(1 for r in reps
                      if isinstance(r, dict) and r.get("healthy"))
        return healthy >= args.replicas

    tier_root: Optional[str] = None
    if getattr(args, "session_tier", False):
        # one crash-safe spill dir per replica: exactly what a pod's
        # emptyDir/PVC mount gives the tiering layer in production
        tier_root = tempfile.mkdtemp(prefix="replay-kvs-")
    try:
        ports = [loadclient.free_port() for _ in range(args.replicas)]
        for idx, port in enumerate(ports):
            sdir = None if tier_root is None \
                else os.path.join(tier_root, f"r{idx}")
            procs.append(_spawn_replica(idx, port, rt.port, args,
                                        session_dir=sdir))
        for port in ports:
            loadclient.wait_http_ok(port, "/healthz", 600.0,
                                    procs=procs)
        loadclient.wait_http_ok(rt.port, "/replicas", 60.0,
                                fleet_healthy, procs=procs)
        log.info("fleet up: router :%d, %d replicas", rt.port,
                 args.replicas)

        hooks: List[Tuple[float, Callable[[], None]]] = []
        if args.kill_replica_at_ms is not None:
            def kill_victim() -> None:
                log.info("chaos: SIGKILL replay-%d at trace t=%.0fms",
                         victim_idx, args.kill_replica_at_ms)
                procs[victim_idx].kill()
            hooks.append((args.kill_replica_at_ms / 1000.0
                          / args.time_scale, kill_victim))

        results = replay_trace(
            requests, "127.0.0.1", rt.port, policies=policies,
            metrics=metrics, time_scale=args.time_scale,
            late_ms=args.late_ms, timeout_s=args.timeout_s,
            hooks=hooks)

        # recovery probes: after the trace drains, the router must
        # still serve — through the survivors — before we scrape
        probes_ok = 0
        n_probes = 3
        for _ in range(n_probes):
            probe = loadclient.stream_request(
                "127.0.0.1", rt.port,
                {"tokens": list(requests[0].tokens[:8]) or [1],
                 "max_new_tokens": 4, "ignore_eos": True},
                timeout_s=60.0)
            if probe.outcome == loadclient.OUTCOME_OK:
                probes_ok += 1

        # the router proves the death two ways: the breaker opens on
        # the next request routed at the corpse, and the statz sweep
        # evicts the silent replica after its TTL.  The eviction is
        # clock-bound — on a trace whose tail is shorter than the TTL
        # it lands AFTER the last request, so wait for the journal
        # entry (bounded) before scraping the evidence.
        if args.kill_replica_at_ms is not None:
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline \
                    and not rt.recorder.events(
                        name="tpu_router_replica_evicted"):
                time.sleep(0.2)

        report = build_report(
            results, policies, trace_header=trace_header,
            target=f"router:127.0.0.1:{rt.port} "
                   f"({args.replicas} replicas)",
            time_scale=args.time_scale, late_ms=args.late_ms,
            debug_port=rt.port, top_missed=args.top_missed)

        # server-side join: the router's own goodput surfaces
        try:
            report["fleet_statz"] = loadclient.fetch_json(
                rt.port, "/fleet/statz", timeout_s=30.0)
        except (OSError, ValueError) as e:
            log.warning("fleet statz unavailable: %s", e)
            report["fleet_statz"] = None
        samples = obs.parse_exposition(rt.registry.render())
        counters = {"tpu_router_failovers_total": 0.0,
                    "tpu_router_replica_evictions_total": 0.0}
        aborts = 0.0
        for name, labels, value in samples:
            if name in counters:
                counters[name] += value
            if name == "tpu_router_requests_total" \
                    and labels.get("outcome") == "stream_abort":
                aborts += value
        report["router_metrics"] = dict(counters,
                                        stream_aborts=aborts)

        if args.kill_replica_at_ms is not None:
            kill_ms = args.kill_replica_at_ms
            victim = f"replay-{victim_idx}"
            names = [str(e.get("name", ""))
                     for e in rt.recorder.events()]
            opened = [
                e for e in rt.recorder.events(
                    name="tpu_breaker_transition")
                if str(_attrs(e).get("op", "")).endswith(victim)
                and _attrs(e).get("to") == "open"]
            evicted = [
                e for e in rt.recorder.events(
                    name="tpu_router_replica_evicted")
                if _attrs(e).get("replica") == victim]
            report["chaos"] = {
                "killed_replica": victim,
                "kill_at_trace_ms": kill_ms,
                "breaker_opened": bool(opened),
                "replica_evicted": bool(evicted),
                "stream_aborts": aborts,
                "failovers": counters["tpu_router_failovers_total"],
                "stream_abort_journaled":
                    "tpu_router_stream_abort" in names,
                "recovery_probes_ok": probes_ok,
                "recovery_probes": n_probes,
                # client-side attainment around the kill: the trough
                # and the recovery, per class — the gate's evidence
                "attainment_windows": {
                    name: {
                        "pre_kill": _attainment_window(
                            results, name, 0.0, kill_ms),
                        "kill_window": _attainment_window(
                            results, name, kill_ms,
                            kill_ms + CHAOS_SETTLE_MS),
                        "post_kill": _attainment_window(
                            results, name,
                            kill_ms + CHAOS_SETTLE_MS,
                            float("inf")),
                    } for name in policies},
            }
        return report
    finally:
        for proc in procs:
            proc.kill()
        for proc in procs:
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                log.warning("replica pid %d did not exit", proc.pid)
        rt.stop()
        if tier_root is not None:
            shutil.rmtree(tier_root, ignore_errors=True)


# -- CLI -------------------------------------------------------------------


def _parse_goodput_specs(specs: Sequence[str]
                         ) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for spec in specs:
        name, _, val = spec.partition("=")
        if not name or not val:
            raise ValueError(
                f"bad --assert-goodput {spec!r} (want CLASS=RATIO)")
        floor = float(val)
        if not 0.0 <= floor <= 1.0:
            raise ValueError(
                f"--assert-goodput {spec!r}: attainment is a ratio "
                f"in [0, 1], a floor of {floor} can never pass")
        out[name] = floor
    return out


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        description="Open-loop replay of a tpu-trace/v1 file with "
                    "per-class SLO attribution")
    p.add_argument("--trace", required=True)
    p.add_argument("--target", default=None, metavar="HOST:PORT",
                   help="existing server/router endpoint; mutually "
                        "exclusive with --replicas")
    p.add_argument("--replicas", type=int, default=0,
                   help="spawn this many real replica subprocesses "
                        "behind an in-process router")
    p.add_argument("--config", default="tiny",
                   help="model config for spawned replicas")
    p.add_argument("--device", default=None,
                   help="torch device of spawned replicas (default: "
                        "cuda, required)")
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--max-len", type=int, default=2048)
    p.add_argument("--max-new-tokens", type=int, default=512)
    p.add_argument("--prefix-chunk", type=int, default=0,
                   help="replica APC chunk (match the trace's)")
    p.add_argument("--seed", type=int, default=0,
                   help="router seed in fleet mode")
    p.add_argument("--session-tier", action="store_true",
                   help="spawn replicas with --kv-paging "
                        "--session-tier and a per-replica spill dir "
                        "so sessioned traces warm-resume parked KV "
                        "(the report's sessions block splits warm vs "
                        "cold TTFT)")
    p.add_argument("--kill-replica-at-ms", type=float, default=None,
                   help="SIGKILL the last spawned replica at this "
                        "TRACE time (fleet mode only)")
    p.add_argument("--slo", action="append", default=None,
                   metavar="CLASS=ttft_ms[:deadline_ms]",
                   help="client-side SLO policies (same grammar as "
                        "the server; default interactive+batch)")
    p.add_argument("--time-scale", type=float, default=1.0,
                   help=">1 replays faster than recorded")
    p.add_argument("--late-ms", type=float, default=100.0)
    p.add_argument("--timeout-s", type=float, default=120.0)
    p.add_argument("--report", default=None, metavar="FILE")
    p.add_argument("--metrics-out", default=None, metavar="FILE",
                   help="write the tpu_replay_* exposition here")
    p.add_argument("--tenant-quota", action="append", default=None,
                   metavar="NAME=RATE[:BURST[:WEIGHT]]",
                   help="fleet mode: router-level per-tenant token "
                        "quota (same grammar as the router flag) so "
                        "replayed multi-tenant traffic exercises the "
                        "quota buckets")
    p.add_argument("--assert-goodput", action="append", default=None,
                   metavar="CLASS=RATIO|tenant:NAME=RATIO",
                   help="fail (exit 1) if a class's — or, with the "
                        "tenant: prefix, a tenant's — attainment is "
                        "below RATIO (repeatable)")
    p.add_argument("--assert-warm-resume", nargs="?", const="",
                   default=None, metavar="BASELINE_REPORT",
                   help="gate: revisit (warm) TTFT p95 must come in "
                        "strictly below cold re-prefill p95.  With a "
                        "BASELINE_REPORT (the same trace replayed "
                        "WITHOUT --session-tier) the cold side is "
                        "that report's revisit p95 — the same chains "
                        "re-prefilled from scratch, the honest "
                        "baseline.  Bare, the cold side is this "
                        "run's first-visit p95 (only meaningful when "
                        "chains stay near prompt length)")
    p.add_argument("--top-missed", type=int, default=5,
                   help="embed stitched spans for the slowest K "
                        "SLO-missed requests in the report")
    args = p.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    if bool(args.target) == bool(args.replicas):
        p.error("exactly one of --target / --replicas is required")
    if args.kill_replica_at_ms is not None and not args.replicas:
        p.error("--kill-replica-at-ms needs --replicas (fleet mode)")
    if args.session_tier and not args.replicas:
        p.error("--session-tier needs --replicas (fleet mode): it "
                "configures the spawned replica subprocesses")
    if args.assert_warm_resume is not None and not args.session_tier:
        p.error("--assert-warm-resume needs --session-tier (without "
                "tiering every revisit re-prefills cold)")

    header, requests = load_trace(args.trace)
    policies = obs.parse_slo_specs(args.slo) if args.slo \
        else obs.default_slo_policies()
    registry = obs.Registry()
    metrics = ReplayMetrics(registry, policies)

    if args.replicas:
        report = run_fleet(args, requests, policies, metrics, header)
    else:
        host, _, port_s = args.target.rpartition(":")
        host = host or "127.0.0.1"
        port = int(port_s)
        results = replay_trace(
            requests, host, port, policies=policies,
            metrics=metrics, time_scale=args.time_scale,
            late_ms=args.late_ms, timeout_s=args.timeout_s)
        report = build_report(
            results, policies, trace_header=header,
            target=args.target, time_scale=args.time_scale,
            late_ms=args.late_ms, debug_port=port, debug_host=host,
            top_missed=args.top_missed)
        try:
            report["statz"] = loadclient.fetch_json(
                port, "/statz", timeout_s=30.0, host=host)
        except (OSError, ValueError) as e:
            log.warning("statz unavailable on %s: %s",
                        args.target, e)
            report["statz"] = None

    classes = report["classes"]
    assert isinstance(classes, dict)
    attain = {name: info["attainment"]
              for name, info in classes.items()}
    metrics.set_attainment({k: float(v) for k, v in attain.items()})

    if args.metrics_out:
        with open(args.metrics_out, "w", encoding="utf-8") as fh:
            fh.write(registry.render())
    if args.report:
        with open(args.report, "w", encoding="utf-8") as fh:
            json.dump(report, fh, indent=2, sort_keys=True)
            fh.write("\n")
    print(json.dumps({
        "target": report["target"], "classes": classes,
        "outcomes": report["outcomes"],
        "late_dispatches": report["open_loop"],
        "chaos": report.get("chaos"),
    }, indent=2, sort_keys=True))

    tenants = report.get("tenants")
    tenants = tenants if isinstance(tenants, dict) else {}
    rc = 0
    for name, floor in _parse_goodput_specs(
            args.assert_goodput or []).items():
        if name.startswith("tenant:"):
            row = tenants.get(name.partition(":")[2])
            got = row.get("attainment") \
                if isinstance(row, dict) else None
        else:
            got = attain.get(name)
        if got is None or float(got) < floor:
            print(f"GOODPUT GATE FAIL: class {name} attainment "
                  f"{got} < {floor}", file=sys.stderr)
            rc = 1
        else:
            print(f"goodput gate ok: class {name} attainment "
                  f"{got} >= {floor}")
    if args.assert_warm_resume is not None:
        rc = max(rc, _warm_resume_gate(report,
                                       args.assert_warm_resume))
    return rc


def _revisit_p95(report: Dict[str, object],
                 bucket: str) -> Optional[float]:
    sessions = report.get("sessions")
    if not isinstance(sessions, dict):
        return None
    stats = sessions.get(bucket)
    if not isinstance(stats, dict):
        return None
    ttft = stats.get("ttft_ms")
    if not isinstance(ttft, dict):
        return None
    p95 = ttft.get("p95")
    return float(p95) if isinstance(p95, (int, float)) else None


def _warm_resume_gate(report: Dict[str, object],
                      baseline_path: str) -> int:
    """Warm revisits (tier hits) must beat cold re-prefill on TTFT
    p95.  With a baseline report the cold side is the SAME revisit
    chains replayed without tiering — the honest like-for-like;
    without one it is this run's first-visit p95."""
    w_p95 = _revisit_p95(report, "warm")
    if baseline_path:
        with open(baseline_path, encoding="utf-8") as fh:
            baseline = json.load(fh)
        c_p95 = _revisit_p95(baseline, "warm")
        cold_name = f"re-prefill p95 ({baseline_path})"
    else:
        c_p95 = _revisit_p95(report, "cold")
        cold_name = "first-visit p95"
    if w_p95 is None or c_p95 is None:
        print(f"WARM-RESUME GATE FAIL: missing revisit TTFT stats "
              f"(warm={w_p95}, cold={c_p95}) — did the trace carry "
              f"sessioned requests?", file=sys.stderr)
        return 1
    if w_p95 >= c_p95:
        print(f"WARM-RESUME GATE FAIL: warm revisit TTFT p95 "
              f"{w_p95:.1f}ms not below {cold_name} {c_p95:.1f}ms",
              file=sys.stderr)
        return 1
    print(f"warm-resume gate ok: warm revisit TTFT p95 "
          f"{w_p95:.1f}ms < {cold_name} {c_p95:.1f}ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
