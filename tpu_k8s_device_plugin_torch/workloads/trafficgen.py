# tpulint: deterministic-path
"""Seeded production-shaped trace generation (tpu-trace/v1).

Closed-loop uniform load — bench_serving's historical posture —
structurally cannot exercise the QoS/preemption/disagg/router
machinery the observability plane exists to observe: a closed loop
self-throttles under overload (each client waits for its previous
request), arrivals are never bursty, prompts share no prefixes, and
every request looks the same.  Serving evaluations converge on trace
replay instead (vLLM's ShareGPT traces, Mooncake's overload-oriented
replay): tail behavior only appears under bursty, heavy-tailed,
prefix-skewed, OPEN-loop traffic.

This module generates such traces, fully deterministically:

- **arrivals**: a 2-state Markov-modulated Poisson process — a calm
  state and a burst state, each with its own rate, with geometric
  dwell times — so the replay harness sees genuine bursts (queue
  growth, shedding, preemption) rather than a flat rate,
- **prefixes**: Zipf-distributed shared prefix blocks whose lengths
  are multiples of the engine's ``--prefix-chunk``, so the APC cache
  and the router's prefix-affinity tier have real economics to win,
- **lengths**: lognormal prompt/output lengths (long-tailed, like
  production: most requests short, a heavy tail of huge ones),
- **mix**: tenants, SLO classes and priorities, unary-vs-stream, and
  per-request client behaviors (slow reader at N bytes/s, abandoner
  at T ms) — the misbehaviors :mod:`.loadclient` executes.

Determinism is the contract: one ``random.Random(seed)`` with a fixed
call order, virtual timestamps (no wall clock anywhere), and
canonical JSON encoding — the same seed + config produces a
byte-identical trace file, so a CI goodput gate replays EXACTLY the
traffic a developer replays locally.  Stdlib only, mypy --strict.

The port's own copy of the JAX package's ``workloads/trafficgen.py``
(the port imports nothing of that package): the same seed and config
write the same bytes from either package, and each package's
``load_trace`` reads the other's file.
"""

from __future__ import annotations

import argparse
import bisect
import json
import random
import sys
from dataclasses import asdict, dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

from .loadclient import ClientBehavior

SCHEMA = "tpu-trace/v1"


class TraceError(ValueError):
    """A trace file that cannot be trusted: bad schema/version,
    truncation, count mismatch, malformed record.  Loading NEVER
    skips bad lines — a silently-shortened trace would make every
    downstream goodput number a lie."""


@dataclass(frozen=True)
class TraceConfig:
    """Knobs for one generated trace.  All rates/lengths are virtual:
    the generator never consults a clock."""

    n_requests: int = 200
    # MMPP arrivals: calm/burst rates + per-arrival switch probability
    # (geometric dwell: 1/p arrivals expected per state visit)
    base_rate_rps: float = 4.0
    burst_rate_rps: float = 40.0
    p_enter_burst: float = 0.02
    p_exit_burst: float = 0.10
    # Zipf shared prefixes, aligned to the engine's prefix chunk
    prefix_chunk: int = 32
    n_prefixes: int = 16
    zipf_alpha: float = 1.1
    max_prefix_chunks: int = 4
    # lognormal lengths (natural-log median / sigma), with clamps
    prompt_median: float = 48.0
    prompt_sigma: float = 0.8
    prompt_max: int = 512
    output_median: float = 32.0
    output_sigma: float = 0.7
    output_min: int = 4
    output_max: int = 256
    # mix (vocab default matches the tiny CPU config's 256 — a trace
    # must never emit ids the replayed model rejects as 400s)
    vocab: int = 256
    tenants: Tuple[str, ...] = ("default",)
    # optional per-tenant traffic weights (parallel to `tenants`).
    # None keeps the historical uniform randrange draw — and the
    # historical byte stream, so every existing seed+config pair
    # still produces an identical trace file.
    tenant_weights: Optional[Tuple[float, ...]] = None
    unary_frac: float = 0.25
    slow_reader_frac: float = 0.05
    slow_reader_bytes_per_s: int = 512
    abandon_frac: float = 0.05
    abandon_after_ms: float = 400.0
    # session-revisit dimension: (P, gap_ms) — each request
    # revisits an earlier conversation with probability P after at
    # least gap_ms of think time, exercising the warm-resume path.
    # None (the default) keeps the historical draw sequence — and so
    # the byte stream of every existing seed+config pair.
    session_revisit: Optional[Tuple[float, float]] = None

    def __post_init__(self) -> None:
        if self.n_requests <= 0:
            raise ValueError("n_requests must be > 0")
        if self.base_rate_rps <= 0 or self.burst_rate_rps <= 0:
            raise ValueError("arrival rates must be > 0")
        if not 0 <= self.p_enter_burst <= 1 \
                or not 0 < self.p_exit_burst <= 1:
            raise ValueError("state-switch probabilities out of range")
        if self.prefix_chunk <= 0 or self.n_prefixes <= 0 \
                or self.max_prefix_chunks <= 0:
            raise ValueError("prefix shape must be positive")
        if self.vocab < 4:
            raise ValueError("vocab too small")
        if not self.tenants:
            raise ValueError("need at least one tenant")
        if self.tenant_weights is not None:
            if len(self.tenant_weights) != len(self.tenants):
                raise ValueError(
                    "tenant_weights must parallel tenants")
            if any(w <= 0 for w in self.tenant_weights):
                raise ValueError("tenant weights must be > 0")
        for frac in (self.unary_frac, self.slow_reader_frac,
                     self.abandon_frac):
            if not 0.0 <= frac <= 1.0:
                raise ValueError("fractions must be in [0, 1]")
        if self.session_revisit is not None:
            p_rev, gap_ms = self.session_revisit
            if not 0.0 <= p_rev <= 1.0:
                raise ValueError(
                    "session_revisit probability must be in [0, 1]")
            if gap_ms < 0:
                raise ValueError("session_revisit gap must be >= 0")


@dataclass
class TraceRequest:
    """One trace record: everything replay needs to issue the request
    at ``t_ms`` (virtual ms from trace start) with the right body and
    client behavior."""

    rid: str
    t_ms: float
    tenant: str
    slo_class: str
    priority: int
    prefix_id: int
    tokens: List[int]
    max_new_tokens: int
    behavior: ClientBehavior = field(default_factory=ClientBehavior)
    # session-revisit dimension: the conversation this request
    # belongs to ("" = anonymous) and whether it CONTINUES an
    # earlier visit (the replay harness chains its prompt onto the
    # session's history).  Emitted only when set, so unsessioned
    # traces keep their historical bytes.
    session: str = ""
    cont: bool = False

    def to_record(self) -> Dict[str, object]:
        rec: Dict[str, object] = {
            "rid": self.rid, "t_ms": round(self.t_ms, 3),
            "tenant": self.tenant, "slo_class": self.slo_class,
            "priority": self.priority, "prefix_id": self.prefix_id,
            "tokens": self.tokens,
            "max_new_tokens": self.max_new_tokens,
            "behavior": {
                "stream": self.behavior.stream,
                "read_bytes_per_s": self.behavior.read_bytes_per_s,
                "abandon_after_ms": self.behavior.abandon_after_ms,
            },
        }
        if self.session:
            rec["session"] = self.session
            rec["cont"] = self.cont
        return rec


def _prefix_block(seed: int, config: TraceConfig,
                  prefix_id: int) -> List[int]:
    """The shared prefix for one prefix id: its own derived generator
    (seeded from (seed, prefix_id), independent of draw order in the
    main stream) producing a chunk-aligned token block — so two
    requests with the same prefix_id share EXACTLY the tokens the APC
    cache and affinity key hash over."""
    drng = random.Random((seed << 20) ^ (prefix_id * 2654435761))
    n_chunks = 1 + drng.randrange(config.max_prefix_chunks)
    return [drng.randrange(1, config.vocab)
            for _ in range(n_chunks * config.prefix_chunk)]


def _zipf_cdf(n: int, alpha: float) -> List[float]:
    weights = [1.0 / (rank ** alpha) for rank in range(1, n + 1)]
    total = sum(weights)
    acc = 0.0
    cdf: List[float] = []
    for w in weights:
        acc += w / total
        cdf.append(acc)
    return cdf


def _clamped_lognormal(rng: random.Random, median: float,
                       sigma: float, lo: int, hi: int) -> int:
    import math

    return max(lo, min(hi, int(round(
        rng.lognormvariate(math.log(median), sigma)))))


def generate(config: TraceConfig, seed: int) -> List[TraceRequest]:
    """The trace: one ``random.Random(seed)`` with a FIXED per-request
    draw order (arrival, state switch, prefix, lengths, suffix, mix,
    behavior) — reordering any draw is a schema-visible change, so
    keep new draws at the END of the per-request block."""
    rng = random.Random(seed)
    cdf = _zipf_cdf(config.n_prefixes, config.zipf_alpha)
    tenant_cdf: List[float] = []
    if config.tenant_weights is not None:
        total_w = sum(config.tenant_weights)
        acc = 0.0
        for w in config.tenant_weights:
            acc += w / total_w
            tenant_cdf.append(acc)
    prefixes = [_prefix_block(seed, config, pid)
                for pid in range(config.n_prefixes)]
    rates = {False: config.base_rate_rps, True: config.burst_rate_rps}
    burst = False
    t_s = 0.0
    out: List[TraceRequest] = []
    # session-revisit state (only touched when the dimension is on)
    session_ids: List[str] = []
    session_last_ms: Dict[str, float] = {}
    for i in range(config.n_requests):
        t_s += rng.expovariate(rates[burst])
        switch = rng.random()  # drawn unconditionally: fixed order
        if burst:
            if switch < config.p_exit_burst:
                burst = False
        elif switch < config.p_enter_burst:
            burst = True
        prefix_id = bisect.bisect_left(cdf, rng.random())
        prefix_id = min(prefix_id, config.n_prefixes - 1)
        prompt_len = _clamped_lognormal(
            rng, config.prompt_median, config.prompt_sigma,
            1, config.prompt_max)
        max_new = _clamped_lognormal(
            rng, config.output_median, config.output_sigma,
            config.output_min, config.output_max)
        prefix = prefixes[prefix_id]
        suffix_len = max(1, prompt_len)
        suffix = [rng.randrange(1, config.vocab)
                  for _ in range(suffix_len)]
        # both arms consume exactly one draw, and the unweighted arm
        # keeps the historical randrange call — same seed + same old
        # config still yields a byte-identical trace
        if tenant_cdf:
            ti = bisect.bisect_left(tenant_cdf, rng.random())
            tenant = config.tenants[min(ti, len(config.tenants) - 1)]
        else:
            tenant = config.tenants[rng.randrange(len(config.tenants))]
        stream = rng.random() >= config.unary_frac
        slo_class = "interactive" if stream else "batch"
        priority = 0 if stream else 1
        slow = stream and rng.random() < config.slow_reader_frac
        abandon = stream and rng.random() < config.abandon_frac
        behavior = ClientBehavior(
            stream=stream,
            read_bytes_per_s=config.slow_reader_bytes_per_s
            if slow else 0,
            abandon_after_ms=config.abandon_after_ms
            * (0.5 + rng.random()) if abandon else 0.0)
        # session-revisit draws come LAST in the per-request block
        # and ONLY when the dimension is enabled: a None config
        # consumes zero draws, so every pre-existing seed+config
        # pair still produces a byte-identical trace
        session = ""
        cont = False
        if config.session_revisit is not None:
            p_rev, gap_ms = config.session_revisit
            if session_ids and rng.random() < p_rev:
                session = session_ids[
                    rng.randrange(len(session_ids))]
                cont = True
                # the revisit happens after the conversation's think
                # time; advancing the GLOBAL clock (never rewinding)
                # keeps trace timestamps monotonic for the loader
                t_s = max(t_s,
                          (session_last_ms[session] + gap_ms)
                          / 1000.0)
            else:
                session = f"s{i:05d}"
                session_ids.append(session)
            session_last_ms[session] = t_s * 1000.0
        out.append(TraceRequest(
            rid=f"r{i:05d}", t_ms=t_s * 1000.0, tenant=tenant,
            slo_class=slo_class, priority=priority,
            prefix_id=prefix_id, tokens=prefix + suffix,
            max_new_tokens=max_new, behavior=behavior,
            session=session, cont=cont))
    return out


def _header(config: TraceConfig, seed: int,
            n_requests: int) -> Dict[str, object]:
    return {"schema": SCHEMA, "seed": seed, "requests": n_requests,
            "config": asdict(config)}


def dumps_trace(config: TraceConfig, seed: int,
                requests: Iterable[TraceRequest]) -> str:
    """The canonical byte form: header line + one record per line,
    sorted keys, no whitespace — the determinism tests compare THIS
    string (and files written through :func:`write_trace`) for
    byte-identity."""
    reqs = list(requests)
    lines = [json.dumps(_header(config, seed, len(reqs)),
                        sort_keys=True, separators=(",", ":"))]
    lines.extend(json.dumps(r.to_record(), sort_keys=True,
                            separators=(",", ":")) for r in reqs)
    return "\n".join(lines) + "\n"


def write_trace(path: str, config: TraceConfig, seed: int,
                requests: Iterable[TraceRequest]) -> None:
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(dumps_trace(config, seed, requests))


def _req_field(rec: Dict[str, object], key: str, lineno: int,
               kind: type) -> object:
    if key not in rec:
        raise TraceError(f"line {lineno}: missing field {key!r}")
    val = rec[key]
    if kind is float and isinstance(val, int):
        val = float(val)
    if not isinstance(val, kind) or (kind is int
                                     and isinstance(val, bool)):
        raise TraceError(
            f"line {lineno}: field {key!r} must be {kind.__name__}, "
            f"got {type(val).__name__}")
    return val


def _parse_record(rec: Dict[str, object],
                  lineno: int) -> TraceRequest:
    tokens_raw = _req_field(rec, "tokens", lineno, list)
    assert isinstance(tokens_raw, list)
    tokens: List[int] = []
    for t in tokens_raw:
        if not isinstance(t, int) or isinstance(t, bool):
            raise TraceError(f"line {lineno}: non-int token {t!r}")
        tokens.append(t)
    if not tokens:
        raise TraceError(f"line {lineno}: empty token list")
    beh_raw = _req_field(rec, "behavior", lineno, dict)
    assert isinstance(beh_raw, dict)
    try:
        behavior = ClientBehavior(
            stream=bool(beh_raw.get("stream", True)),
            read_bytes_per_s=int(
                beh_raw.get("read_bytes_per_s", 0) or 0),
            abandon_after_ms=float(
                beh_raw.get("abandon_after_ms", 0.0) or 0.0))
    except (TypeError, ValueError) as e:
        raise TraceError(f"line {lineno}: bad behavior block: {e}")
    max_new = _req_field(rec, "max_new_tokens", lineno, int)
    assert isinstance(max_new, int)
    if max_new <= 0:
        raise TraceError(f"line {lineno}: max_new_tokens must be > 0")
    t_ms = _req_field(rec, "t_ms", lineno, float)
    assert isinstance(t_ms, float)
    if t_ms < 0:
        raise TraceError(f"line {lineno}: negative t_ms")
    rid = _req_field(rec, "rid", lineno, str)
    tenant = _req_field(rec, "tenant", lineno, str)
    slo_class = _req_field(rec, "slo_class", lineno, str)
    priority = _req_field(rec, "priority", lineno, int)
    prefix_id = _req_field(rec, "prefix_id", lineno, int)
    assert isinstance(rid, str) and isinstance(tenant, str)
    assert isinstance(slo_class, str)
    assert isinstance(priority, int) and isinstance(prefix_id, int)
    # optional session fields (absent in unsessioned traces)
    session_raw = rec.get("session", "")
    if not isinstance(session_raw, str):
        raise TraceError(f"line {lineno}: 'session' must be str")
    cont_raw = rec.get("cont", False)
    if not isinstance(cont_raw, bool):
        raise TraceError(f"line {lineno}: 'cont' must be bool")
    return TraceRequest(
        rid=rid, t_ms=t_ms, tenant=tenant, slo_class=slo_class,
        priority=priority, prefix_id=prefix_id, tokens=tokens,
        max_new_tokens=max_new, behavior=behavior,
        session=session_raw, cont=cont_raw)


def loads_trace(text: str
                ) -> Tuple[Dict[str, object], List[TraceRequest]]:
    """Parse + validate one trace (header, records).  Raises
    :class:`TraceError` on any defect: unknown schema version,
    malformed line, record-count mismatch against the header
    (truncation), out-of-order timestamps."""
    lines = text.splitlines()
    if not lines or not lines[0].strip():
        raise TraceError("empty trace")
    try:
        header_raw = json.loads(lines[0])
    except ValueError as e:
        raise TraceError(f"line 1: unparseable header: {e}")
    if not isinstance(header_raw, dict):
        raise TraceError("line 1: header must be a JSON object")
    if header_raw.get("schema") != SCHEMA:
        raise TraceError(
            f"unsupported trace schema {header_raw.get('schema')!r} "
            f"(this reader speaks {SCHEMA})")
    declared = header_raw.get("requests")
    if not isinstance(declared, int) or isinstance(declared, bool) \
            or declared < 0:
        raise TraceError("header 'requests' must be a count")
    records: List[TraceRequest] = []
    prev_t = -1.0
    for lineno, line in enumerate(lines[1:], start=2):
        if not line.strip():
            continue
        try:
            rec_raw = json.loads(line)
        except ValueError as e:
            raise TraceError(f"line {lineno}: malformed record: {e}")
        if not isinstance(rec_raw, dict):
            raise TraceError(
                f"line {lineno}: record must be a JSON object")
        rec = _parse_record(rec_raw, lineno)
        if rec.t_ms < prev_t:
            raise TraceError(
                f"line {lineno}: t_ms goes backwards "
                f"({rec.t_ms} after {prev_t})")
        prev_t = rec.t_ms
        records.append(rec)
    if len(records) != declared:
        raise TraceError(
            f"truncated or padded trace: header declares {declared} "
            f"requests, file holds {len(records)}")
    return header_raw, records


def load_trace(path: str
               ) -> Tuple[Dict[str, object], List[TraceRequest]]:
    with open(path, "r", encoding="utf-8") as fh:
        return loads_trace(fh.read())


def summarize(requests: List[TraceRequest]) -> Dict[str, object]:
    """Shape summary for humans/CI logs: class/tenant/behavior mix,
    span, length tails — a sanity surface, not part of the schema."""
    if not requests:
        return {"requests": 0}
    by_class: Dict[str, int] = {}
    by_tenant: Dict[str, int] = {}
    by_prefix: Dict[str, int] = {}
    slow = abandoners = unary = revisits = 0
    sessions = set()
    for r in requests:
        by_class[r.slo_class] = by_class.get(r.slo_class, 0) + 1
        by_tenant[r.tenant] = by_tenant.get(r.tenant, 0) + 1
        key = f"p{r.prefix_id}"
        by_prefix[key] = by_prefix.get(key, 0) + 1
        if not r.behavior.stream:
            unary += 1
        if r.behavior.read_bytes_per_s > 0:
            slow += 1
        if r.behavior.abandon_after_ms > 0:
            abandoners += 1
        if r.session:
            sessions.add(r.session)
            if r.cont:
                revisits += 1
    lens = sorted(len(r.tokens) for r in requests)
    outs = sorted(r.max_new_tokens for r in requests)

    def pct(xs: List[int], q: float) -> int:
        return xs[min(len(xs) - 1, int(q * (len(xs) - 1)))]

    return {
        "requests": len(requests),
        "span_ms": round(requests[-1].t_ms - requests[0].t_ms, 3),
        "classes": by_class, "tenants": by_tenant,
        "top_prefixes": dict(sorted(
            by_prefix.items(), key=lambda kv: -kv[1])[:5]),
        "unary": unary, "slow_readers": slow,
        "abandoners": abandoners,
        "sessions": len(sessions), "revisits": revisits,
        "prompt_len": {"p50": pct(lens, 0.5), "p95": pct(lens, 0.95),
                       "max": lens[-1]},
        "max_new_tokens": {"p50": pct(outs, 0.5),
                           "p95": pct(outs, 0.95), "max": outs[-1]},
    }


def parse_tenant_mix(
        spec: Optional[str],
        fallback: Tuple[str, ...] = ("default",),
) -> Tuple[Tuple[str, ...], Optional[Tuple[float, ...]]]:
    """Parse a ``--tenants NAME[:WEIGHT],...`` mix.  Weights are
    optional per-entry (absent means 1.0); an all-default mix returns
    ``None`` weights so the unweighted draw — and byte-determinism of
    old traces — is preserved."""
    if not spec:
        return fallback, None
    names: List[str] = []
    weights: List[float] = []
    weighted = False
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, sep, w_s = part.partition(":")
        if not name:
            raise ValueError(f"--tenants: empty name in {spec!r}")
        w = 1.0
        if sep:
            try:
                w = float(w_s)
            except ValueError:
                raise ValueError(
                    f"--tenants: bad weight {w_s!r} for {name!r}")
            weighted = True
        names.append(name)
        weights.append(w)
    if not names:
        raise ValueError(f"--tenants: no tenants in {spec!r}")
    return tuple(names), tuple(weights) if weighted else None


def parse_session_revisit(
        spec: Optional[str]) -> Optional[Tuple[float, float]]:
    """Parse ``--session-revisit P[:GAP_MS]`` (gap defaults to
    1000 ms of think time).  None in, None out — absence keeps the
    unsessioned draw sequence and its byte-identical traces."""
    if not spec:
        return None
    p_s, sep, gap_s = spec.partition(":")
    try:
        p_rev = float(p_s)
        gap_ms = float(gap_s) if sep else 1000.0
    except ValueError:
        raise ValueError(
            f"--session-revisit: bad spec {spec!r} "
            "(want P or P:GAP_MS)")
    if not 0.0 <= p_rev <= 1.0:
        raise ValueError(
            "--session-revisit: P must be in [0, 1]")
    if gap_ms < 0:
        raise ValueError("--session-revisit: GAP_MS must be >= 0")
    return p_rev, gap_ms


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        description="Generate a seeded production-shaped trace "
                    "(tpu-trace/v1 JSON-lines) for workloads.replay")
    p.add_argument("--out", required=True, help="trace file to write")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--requests", type=int, default=200)
    p.add_argument("--base-rate", type=float, default=4.0,
                   help="calm-state arrival rate (req/s)")
    p.add_argument("--burst-rate", type=float, default=40.0,
                   help="burst-state arrival rate (req/s)")
    p.add_argument("--prefix-chunk", type=int, default=32,
                   help="prefix block alignment — match the server's "
                        "--prefix-chunk so APC/affinity engage")
    p.add_argument("--n-prefixes", type=int, default=16)
    p.add_argument("--zipf-alpha", type=float, default=1.1)
    p.add_argument("--prompt-median", type=float, default=48.0)
    p.add_argument("--prompt-max", type=int, default=512)
    p.add_argument("--output-median", type=float, default=32.0)
    p.add_argument("--output-max", type=int, default=256)
    p.add_argument("--vocab", type=int, default=256,
                   help="token-id bound; keep <= the served model's "
                        "vocab or every request 400s")
    p.add_argument("--tenant", action="append", default=None,
                   help="tenant name (repeatable; default: default)")
    p.add_argument("--tenants", default=None,
                   metavar="NAME[:WEIGHT],...",
                   help="tenant mix in one flag, optionally "
                        "weighted (e.g. 'team-a:3,team-b:1' sends "
                        "75%% of traffic as team-a); supersedes "
                        "--tenant")
    p.add_argument("--session-revisit", default=None,
                   metavar="P[:GAP_MS]",
                   help="session dimension: every request carries a "
                        "session id, and with probability P it "
                        "REVISITS an earlier conversation after at "
                        "least GAP_MS (default 1000) of think time — "
                        "replays then exercise the warm-resume "
                        "tiers.  Unset keeps traces unsessioned and "
                        "byte-identical to earlier versions")
    p.add_argument("--unary-frac", type=float, default=0.25)
    p.add_argument("--slow-reader-frac", type=float, default=0.05)
    p.add_argument("--slow-reader-bytes-per-s", type=int, default=512)
    p.add_argument("--abandon-frac", type=float, default=0.05)
    p.add_argument("--abandon-after-ms", type=float, default=400.0)
    args = p.parse_args(argv)
    tenants, tenant_weights = parse_tenant_mix(
        args.tenants, tuple(args.tenant) if args.tenant
        else ("default",))
    try:
        session_revisit = parse_session_revisit(args.session_revisit)
    except ValueError as e:
        p.error(str(e))
    config = TraceConfig(
        n_requests=args.requests, base_rate_rps=args.base_rate,
        burst_rate_rps=args.burst_rate,
        prefix_chunk=args.prefix_chunk, n_prefixes=args.n_prefixes,
        zipf_alpha=args.zipf_alpha, prompt_median=args.prompt_median,
        prompt_max=args.prompt_max,
        output_median=args.output_median,
        output_max=args.output_max, vocab=args.vocab,
        tenants=tenants, tenant_weights=tenant_weights,
        unary_frac=args.unary_frac,
        slow_reader_frac=args.slow_reader_frac,
        slow_reader_bytes_per_s=args.slow_reader_bytes_per_s,
        abandon_frac=args.abandon_frac,
        abandon_after_ms=args.abandon_after_ms,
        session_revisit=session_revisit)
    requests = generate(config, args.seed)
    write_trace(args.out, config, args.seed, requests)
    print(json.dumps({"trace": args.out, "seed": args.seed,
                      "summary": summarize(requests)}, indent=2,
                     sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
