"""Shared HTTP load-generation client: the ONE stream-reading loop.

Before this module, bench_serving.py carried three hand-rolled copies
of the same client code (the single-replica load loop, the router
load loop, the disagg load loop) — each parsing the server's
JSON-lines stream frames, stamping a ``traceparent``, and timing
TTFT/TPOT slightly differently.  The replay harness
(:mod:`.replay`) would have been copy number four.  This module is
the single place for:

- **frame parsing** (:func:`parse_frame`): the hot coalesced window
  frame ``{"tokens":[...]}`` is counted by comma WITHOUT a full json
  parse — on shared CPU the load generator must not steal cycles from
  the engine it is measuring — while terminal ``done``/``error``
  frames (and the legacy per-token shape) parse fully,
- **SSE framing** (:func:`sse_data`): the OpenAI routes' wire shape,
- **traceparent stamping**: every request carries a client-chosen
  W3C trace context so the server-side spans are queryable by an id
  the CLIENT knows,
- **client behaviors** (:class:`ClientBehavior`): slow reading at N
  bytes/s, abandonment after T ms or after K tokens — the
  production-shaped misbehavior trafficgen traces encode and both
  bench and replay must execute identically,
- **terminal outcomes** (:class:`StreamOutcome`): ``ok``,
  ``abandoned`` (the client left — previously invisible on the
  client side), ``shed`` (429), ``error`` (in-band error frame or
  non-200), ``transport_error`` (socket died).

Stdlib + ``obs`` only (no torch): importable on a bare box, mypy
--strict like the router/kv_pool core.

The port's own copy of the JAX package's ``workloads/loadclient.py`` (the port
imports nothing of that package): the same calls give the same
results.
"""
# tpulint: disable-file=R1 -- load-generation CLIENT: its raw HTTP calls MEASURE the serving stack (429s, drops, resets are data points, and the abandon behaviors DELIBERATELY break connections); a retry/breaker wrapper here would hide exactly the outcomes bench/replay exist to report

from __future__ import annotations

import http.client
import json
import os
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .. import obs

# terminal outcome vocabulary (bounded: safe as a metric label value)
OUTCOME_OK = "ok"
OUTCOME_ABANDONED = "abandoned"
OUTCOME_SHED = "shed"
OUTCOME_ERROR = "error"
OUTCOME_TRANSPORT = "transport_error"
OUTCOMES: Tuple[str, ...] = (
    OUTCOME_OK, OUTCOME_ABANDONED, OUTCOME_SHED, OUTCOME_ERROR,
    OUTCOME_TRANSPORT)

_TOKENS_FAST_PREFIX = b'{"tokens":['
_SSE_DATA_PREFIX = b"data: "
_SSE_DONE = b"[DONE]"


def parse_frame(line: bytes
                ) -> Tuple[int, Optional[Dict[str, object]]]:
    """One stripped JSON-lines stream frame -> ``(token_count,
    parsed_event)``.  The hot wire shape — the coalesced n>=1 window
    frame ``{"tokens":[a,b,...]}`` — is counted by comma instead of a
    full json parse and comes back with ``parsed_event=None``; every
    other frame (terminal ``done``/``error``, the legacy per-token
    ``{"token": t}``) parses fully.  Raises ValueError on frames that
    are not JSON objects (a malformed stream must fail loudly, not
    count as zero tokens)."""
    if line.startswith(_TOKENS_FAST_PREFIX) and line[-2:] == b"]}":
        return line.count(b",") + 1, None
    ev = json.loads(line)
    if not isinstance(ev, dict):
        raise ValueError(
            f"stream frame is not a JSON object: {line[:80]!r}")
    if "done" in ev or "error" in ev:
        return 0, ev
    toks = ev.get("tokens")
    if isinstance(toks, list):
        return len(toks), ev
    if "token" in ev:
        return 1, ev
    return 0, ev


def sse_data(line: bytes) -> Optional[bytes]:
    """The JSON payload of one SSE line, or None for non-data framing
    (``event:``/``id:`` fields, comments, blank lines) and the
    ``[DONE]`` sentinel — the OpenAI routes' framing in one place."""
    if not line.startswith(_SSE_DATA_PREFIX):
        return None
    payload = line[len(_SSE_DATA_PREFIX):].strip()
    if not payload or payload == _SSE_DONE:
        return None
    return payload


@dataclass(frozen=True)
class ClientBehavior:
    """How the client consumes its response — the production-shaped
    misbehaviors a trace encodes.  ``read_bytes_per_s`` throttles the
    read loop (a slow reader backs the server's bounded event queue
    up); ``abandon_after_ms`` closes the connection that many ms
    after the request started; ``abandon_after_tokens`` closes it
    after the K-th streamed token (bench's historical
    ``--cancel-every`` posture).  Zero disables each."""

    stream: bool = True
    read_bytes_per_s: int = 0
    abandon_after_ms: float = 0.0
    abandon_after_tokens: int = 0


@dataclass
class StreamOutcome:
    """One request as the wire saw it.  ``outcome`` is one of
    :data:`OUTCOMES`; ``tokens`` counts streamed token frames,
    ``done_tokens`` the terminal frame's full token list (0 unless
    the stream completed).  ``ttft_s``/``tpot_s`` are None when no
    token (or no second token) ever arrived."""

    status: int
    outcome: str
    total_s: float
    ttft_s: Optional[float] = None
    tpot_s: Optional[float] = None
    tokens: int = 0
    done_tokens: int = 0
    error: Optional[str] = None
    replica: Optional[str] = None
    trace_id: Optional[str] = None


def _headers(trace: obs.TraceContext,
             extra: Optional[Dict[str, str]]) -> Dict[str, str]:
    out = {"Content-Type": "application/json",
           "traceparent": trace.to_traceparent()}
    if extra:
        out.update(extra)
    return out


def stream_request(host: str, port: int, body: Dict[str, object], *,
                   path: str = "/generate",
                   behavior: Optional[ClientBehavior] = None,
                   trace: Optional[obs.TraceContext] = None,
                   timeout_s: float = 600.0,
                   headers: Optional[Dict[str, str]] = None,
                   on_line: Optional[Callable[[bytes], None]] = None
                   ) -> StreamOutcome:
    """One streaming POST with the behaviors applied.  Never raises
    on request-level failure: sheds, in-band error frames, transport
    resets, and deliberate abandonment all come back as a terminal
    :class:`StreamOutcome` — clean-looking numbers over a broken run
    would be worse than no numbers.  *on_line* (the port's addition)
    is called with every non-empty stripped frame line a 200 stream
    brings, in order: a caller that needs the ids keeps them."""
    beh = behavior if behavior is not None else ClientBehavior()
    tr = trace if trace is not None else obs.new_trace()
    conn = http.client.HTTPConnection(host, port, timeout=timeout_s)
    t0 = time.perf_counter()
    first: Optional[float] = None
    last: Optional[float] = None
    n_toks = 0
    done_tokens = 0
    abandoned = False
    error: Optional[str] = None
    status = -1
    replica: Optional[str] = None
    saw_done = False
    try:
        conn.request("POST", path, json.dumps(body),
                     _headers(tr, headers))
        resp = conn.getresponse()
        status = resp.status
        replica = resp.headers.get("X-Replica")
        if status != 200:
            payload = resp.read(4096)
            try:
                ev = json.loads(payload)
                if isinstance(ev, dict) and "error" in ev:
                    error = str(ev["error"])
            except ValueError:
                error = f"unparseable {status} body: {payload[:80]!r}"
            return StreamOutcome(
                status=status,
                outcome=OUTCOME_SHED if status == 429
                else OUTCOME_ERROR,
                total_s=time.perf_counter() - t0, error=error,
                replica=replica, trace_id=tr.trace_id)
        bytes_read = 0
        for line in resp:
            s = line.strip()
            if not s:
                continue
            now = time.perf_counter()
            if beh.read_bytes_per_s > 0:
                # slow reader: cap the cumulative drain rate — sleep
                # until the bytes read so far fit under the budget
                bytes_read += len(line)
                floor = bytes_read / beh.read_bytes_per_s
                if floor > now - t0:
                    time.sleep(floor - (now - t0))
                    now = time.perf_counter()
            if beh.abandon_after_ms > 0 \
                    and (now - t0) * 1000.0 >= beh.abandon_after_ms:
                abandoned = True
                break
            if on_line is not None:
                on_line(s)
            k, ev = parse_frame(s)
            if k:
                n_toks += k
                last = now
                if first is None:
                    first = now
                if beh.abandon_after_tokens \
                        and n_toks >= beh.abandon_after_tokens:
                    abandoned = True
                    break
            elif ev is not None and "error" in ev:
                error = str(ev["error"])
                break
            elif ev is not None and "done" in ev:
                toks = ev.get("tokens")
                done_tokens = len(toks) if isinstance(toks, list) \
                    else n_toks
                saw_done = True
    except OSError as e:
        return StreamOutcome(
            status=status, outcome=OUTCOME_TRANSPORT,
            total_s=time.perf_counter() - t0, tokens=n_toks,
            ttft_s=None if first is None else first - t0,
            error=str(e), replica=replica, trace_id=tr.trace_id)
    finally:
        conn.close()
    total_s = time.perf_counter() - t0
    ttft_s = None if first is None else first - t0
    tpot_s = None
    if first is not None and last is not None and n_toks > 1 \
            and last > first:
        tpot_s = (last - first) / (n_toks - 1)
    if abandoned:
        outcome = OUTCOME_ABANDONED
    elif error is not None:
        outcome = OUTCOME_ERROR
    elif saw_done:
        outcome = OUTCOME_OK
    else:
        # headers + frames but no terminal frame: a truncated stream
        # (e.g. the upstream replica died without an error frame)
        outcome = OUTCOME_ERROR
        error = "stream ended without a terminal frame"
    return StreamOutcome(
        status=status, outcome=outcome, total_s=total_s,
        ttft_s=ttft_s, tpot_s=tpot_s, tokens=n_toks,
        done_tokens=done_tokens, error=error, replica=replica,
        trace_id=tr.trace_id)


def unary_request(host: str, port: int, body: Dict[str, object], *,
                  path: str = "/generate",
                  trace: Optional[obs.TraceContext] = None,
                  timeout_s: float = 600.0,
                  headers: Optional[Dict[str, str]] = None
                  ) -> StreamOutcome:
    """One unary (``stream: false``) POST: single JSON body back.
    Same terminal-outcome contract as :func:`stream_request`; TTFT is
    None (nothing streams), the deadline-class SLO judges total_s."""
    tr = trace if trace is not None else obs.new_trace()
    conn = http.client.HTTPConnection(host, port, timeout=timeout_s)
    t0 = time.perf_counter()
    status = -1
    replica: Optional[str] = None
    try:
        conn.request("POST", path, json.dumps(body),
                     _headers(tr, headers))
        resp = conn.getresponse()
        status = resp.status
        replica = resp.headers.get("X-Replica")
        payload = resp.read()
    except OSError as e:
        return StreamOutcome(
            status=status, outcome=OUTCOME_TRANSPORT,
            total_s=time.perf_counter() - t0, error=str(e),
            replica=replica, trace_id=tr.trace_id)
    finally:
        conn.close()
    total_s = time.perf_counter() - t0
    error: Optional[str] = None
    done_tokens = 0
    try:
        ev = json.loads(payload)
    except ValueError:
        ev = None
        error = f"unparseable body: {payload[:80]!r}"
    if isinstance(ev, dict):
        if "error" in ev:
            error = str(ev["error"])
        else:
            toks = ev.get("tokens")
            done_tokens = len(toks) if isinstance(toks, list) else 0
    if status == 429:
        outcome = OUTCOME_SHED
    elif status == 200 and error is None:
        outcome = OUTCOME_OK
    else:
        outcome = OUTCOME_ERROR
    return StreamOutcome(
        status=status, outcome=outcome, total_s=total_s,
        done_tokens=done_tokens, error=error, replica=replica,
        trace_id=tr.trace_id)


# the port's replica CLI, which every spawn helper of the fleet tier
# starts (router benchmark, replay, fleet reconciler, cold start)
SERVER_MODULE = "tpu_k8s_device_plugin_torch.workloads.server"
# where spawned replicas write their stdout and stderr (unset: nowhere)
REPLICA_LOG_DIR_ENV = "TPU_DP_REPLICA_LOG_DIR"


def server_cmd(device: Optional[str], *args: str) -> List[str]:
    """The command line of one replica process: the port's server CLI
    with *args*, and ``--device`` when *device* is given (none: the
    replica serves on CUDA and raises without it)."""
    cmd = [sys.executable, "-m", SERVER_MODULE, *args]
    if device:
        cmd += ["--device", str(device)]
    return cmd


def spawn_replica(cmd: Sequence[str], name: str,
                  env: Optional[Dict[str, str]] = None
                  ) -> "subprocess.Popen[bytes]":
    """Start one replica process.  Its stdout and stderr go to a fresh
    ``<name>-*.log`` under ``$TPU_DP_REPLICA_LOG_DIR`` when that is
    set, else to DEVNULL as the reference's helpers send them: a
    replica that dies at boot then leaves its traceback where the
    caller can read it."""
    log_dir = os.environ.get(REPLICA_LOG_DIR_ENV)
    if not log_dir:
        return subprocess.Popen(list(cmd), env=env,
                                stdout=subprocess.DEVNULL,
                                stderr=subprocess.DEVNULL)
    os.makedirs(log_dir, exist_ok=True)
    fd, _ = tempfile.mkstemp(prefix=f"{name}-", suffix=".log",
                             dir=log_dir)
    with os.fdopen(fd, "wb") as out:
        return subprocess.Popen(list(cmd), env=env, stdout=out,
                                stderr=subprocess.STDOUT)


def free_port(host: str = "127.0.0.1") -> int:
    """An OS-assigned free TCP port (the bench/replay spawn helper)."""
    import socket

    s = socket.socket()
    s.bind((host, 0))
    port = int(s.getsockname()[1])
    s.close()
    return port


def wait_http_ok(port: int, path: str, timeout_s: float,
                 predicate: Optional[
                     Callable[[Dict[str, object]], bool]] = None,
                 host: str = "127.0.0.1",
                 procs: Sequence[Any] = ()) -> bool:
    """Poll ``GET path`` until 200 (and *predicate*(parsed JSON body)
    when given).  Raises RuntimeError with the last status on
    timeout — a replica that never came up must fail the run, not
    hang it.  *procs* (the port's addition) are the spawned processes
    the wait is for: as soon as one of them has exited, the wait
    raises with its exit code instead of polling a dead replica to the
    deadline."""
    deadline = time.monotonic() + timeout_s
    last: Optional[Tuple[int, bytes]] = None
    while time.monotonic() < deadline:
        for proc in procs:
            rc = proc.poll()
            if rc is not None:
                raise RuntimeError(
                    f"replica pid {proc.pid} exited with code {rc} "
                    f"before {path} on :{port} was ready")
        try:
            conn = http.client.HTTPConnection(host, port, timeout=5)
            conn.request("GET", path)
            resp = conn.getresponse()
            payload = resp.read()
            conn.close()
            last = (resp.status, payload[:120])
            if resp.status == 200:
                if predicate is None:
                    return True
                parsed = json.loads(payload)
                if isinstance(parsed, dict) and predicate(parsed):
                    return True
        except (OSError, ValueError):
            # boot races: connection refused / partial JSON while the
            # server is still coming up — the loop IS the handling
            # (the deadline raises below), nothing to account per poll
            pass
        time.sleep(0.25)
    raise RuntimeError(f"{path} on :{port} not ready within "
                       f"{timeout_s}s (last: {last})")


def fetch_json(port: int, path: str, timeout_s: float = 30.0,
               host: str = "127.0.0.1") -> Dict[str, object]:
    """One GET returning a parsed JSON object (raises on non-dict /
    transport failure: callers want the surface or an error, never a
    silent empty)."""
    conn = http.client.HTTPConnection(host, port, timeout=timeout_s)
    try:
        conn.request("GET", path)
        payload = conn.getresponse().read()
    finally:
        conn.close()
    out = json.loads(payload)
    if not isinstance(out, dict):
        raise ValueError(f"{path} returned non-object JSON")
    return out


def fetch_trace_events(port: int, trace_id: str,
                       timeout_s: float = 30.0,
                       host: str = "127.0.0.1"
                       ) -> List[Dict[str, object]]:
    """One trace's server-side events from ``/debug/traces`` — flat
    for a single replica, flattened from the stitched ``tree`` shape
    when the endpoint is a router."""
    from urllib.parse import quote

    body = fetch_json(
        port, f"/debug/traces?trace_id={quote(trace_id, safe='')}",
        timeout_s=timeout_s, host=host)
    events = body.get("events")
    if isinstance(events, list):
        return [e for e in events if isinstance(e, dict)]
    tree = body.get("tree")
    if isinstance(tree, list):
        return obs.flatten(tree)
    return []
