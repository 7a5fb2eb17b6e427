"""HTTP front door for the port's continuous-batching engine.

The port's own copy of the JAX package's ``workloads/server.py`` (the
port imports nothing of that package): the same endpoints, wire shapes,
metrics and policies, in front of the port's ``serving.ServingEngine``
and ``scheduler.IterationScheduler``.  The server never touches a
tensor: handler threads stay on Python ints and bytes, and the
scheduler thread alone calls the engine, so every CUDA call of the
process (graph captures included) is made on that one thread.  Where
the JAX server reaches jax, the port differs: ``/debug/profile``
captures with ``torch.profiler`` (CPU and CUDA activities; a chrome
trace lands in ``--profile-dir``), ``enable_compile_cache`` returns
False (the port has no persistent cache for its CUDA graphs), and
``main`` builds the model with the port's ``bench_serving`` on CUDA
unless ``--device cpu`` is given.  Launch on the CPU:

    python -m tpu_k8s_device_plugin_torch.workloads.server \
        --config tiny --device cpu --port 0

Design: ONE scheduler thread owns the engine (admission, decode,
harvest — the engine is not thread-safe and never needs to be); HTTP
handler threads only enqueue requests and drain per-request event
queues.  The loop drives ``scheduler.IterationScheduler`` —
iteration-level continuous batching: decode runs as ``run_scan``
windows (one compiled scan per window, no per-token host round-trip)
whose dispatch/harvest seam the scheduler uses to slide admission work
INSIDE the open window — prefill chunks, new arrivals, and admission
finishes all overlap in-flight decode, a request arriving mid-window
starts prefilling before that window closes, and its first token
streams the moment its splice lands.  Windows grow adaptively
(quantized multiples of ``--window``; see docs §Continuous batching)
when every running request still needs the steps.

API (JSON over HTTP/1.1):

  POST /generate   {"tokens": [int...], "max_new_tokens": N?,
                    "temperature": f?, "top_k": k?, "top_p": p?,
                    "min_p": m?, "presence_penalty": f?,
                    "frequency_penalty": f?, "repetition_penalty": r?,
                    "adapter": a?, "stop": [int...]?,
                    "ignore_eos": bool?, "seed": s?, "logprobs": k?,
                    "prompt_logprobs": k?, "n": c?, "priority": p?,
                    "guided_regex": pattern?, "guided_json": true|schema?,
                    "guided_choice": [str...]?, "stream": true?}
                   guided_regex / guided_json constrain the output to
                   a regex / JSON (vLLM's guided decoding): the server
                   lowers the constraint to a token-level DFA riding
                   the compiled decode scan.  Constrained requests
                   decode via run_scan; a draft-loaded engine's spec
                   rounds resume once no constrained slot is active.
                   n > 1 returns c completions: token events carry
                   "index", the final event has "choices" (copies
                   admit incrementally and share the prompt via the
                   automatic prefix cache).
                   stream=true (default): chunked body, one JSON line
                   per event — coalesced window frames
                   {"tokens": [t, ...]} (one per run_scan window, the
                   engine-rate hot path) ... then
                   {"done": true, "tokens": [...], "finish_reason": r}
                   per_token=true restores the legacy per-token shape
                   {"token": t} (one line per token; logprobs requests
                   use it implicitly — the per-token stats need it).
                   stream=false: single JSON body (the final event).
  POST /v1/completions   OpenAI-compatible text completions (needs
                   --tokenizer): string or token-array "prompt",
                   max_tokens/temperature/top_p/n/seed/penalties/
                   logprobs/stop/echo, "response_format" {"type":
                   "json_object" | "json_schema"} and "guided_regex"
                   for guided decoding, "stream": true = SSE data:
                   chunks ending in [DONE] (stream_options
                   include_usage appends a usage-only chunk); usage
                   token accounting.
  POST /v1/chat/completions   chat variant: "messages" rendered by
                   the tokenizer's chat template; responses carry
                   message/delta objects in the chat wire shape.
  POST /migrate    INTERNAL (replica-to-replica via the router tier):
                   resume a prefill-class replica's bit-exact KV
                   checkpoint into a slot here and serve the
                   request's stream from where prefill left off —
                   the decode half of disaggregated serving.  The
                   body is the migrate codec's binary payload; a
                   ``prefill_only`` marker on the generate/OpenAI
                   endpoints produces it (see --replica-role).
  GET  /healthz    liveness ("ok").
  GET  /stats      engine + server counters (JSON).
  GET  /statz      one CHEAP load snapshot for the router tier
                   (queue depth, in-flight, free/total KV pages, shed
                   counts, scheduler health, replica role, migration
                   ledger) — fixed small schema, no Prometheus text
                   on the routing hot path.
  GET  /metrics    the same counters in Prometheus exposition format
                   (Accept: application/openmetrics-text adds trace-id
                   exemplars on the latency histograms).
  GET  /debug/traces[?trace_id=…]   per-request event timelines from
                   the flight recorder (index view without the param).
  GET  /debug/events[?since=…]      the raw journal after a wall-time
                   stamp (429 sheds, drops, grammar rejections, spans).

Tracing: requests may carry a W3C ``traceparent`` header; the server
continues that trace (or opens a fresh root) through admission, queue
wait, run_scan windows, and stream writes, echoes the id back in
``X-Trace-Id``/``traceparent`` response headers and OpenAI ``id``s,
and journals every hop in the flight recorder (dumped to
``--flight-record-dir`` on exit/SIGTERM).

Token ids in, token ids out by default: tokenization is the caller's
business and the engine's contract stays exact and model-agnostic.
``--tokenizer`` opts into the text surface server-side ("prompt"
strings, stop STRINGS with streaming holdback, "text" deltas) without
touching the compiled decode path.

Load shedding (vLLM's admission-control posture): HTTP traffic is
served by a FIXED worker pool (``--max-connections``) instead of a
thread per connection, the admission heap is bounded
(``--max-queue``), and overflow on either answers 429 +
``Retry-After`` instead of growing threads or heap without bound.
Per-request event queues are bounded too: a client that stops reading
its stream is disconnected (its events dropped, its slot released)
rather than buffering tokens forever — the documented slow-client
policy.
"""

from __future__ import annotations

import argparse
import bisect
import heapq
import itertools
import json
import logging
import queue
import sys
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, HTTPServer
from typing import List, Optional
from urllib.parse import parse_qs, urlparse

from .. import obs, resilience
from ..resilience import faults
from ..resilience.policy import (
    ResilienceMetrics,
    suppressed,
)

from .grammar import (
    json_value_regex,
    regex_to_dfa,
    schema_to_regex,
    token_bytes_of,
    token_dfa,
)
from .scheduler import (
    ADAPTIVE_WINDOW_FACTOR,
    DEFAULT_MAX_PACK,
    DEFAULT_PREFILL_BUDGET,
    IterationScheduler,
)
from .kv_pool import PagePoolExhausted
from .kv_tier import SessionStore, empty_tier_stats, sid_hash
from .migrate import (
    MIGRATE_CONTENT_TYPE,
    MigrateError,
    dump_payload,
    load_payload,
)
# TenantQuota moved to the jax-free qos module (the router enforces
# the same bucket semantics fleet-wide); re-exported here because
# embedders and the QoS suite import it from server
from .qos import TenantQuota, parse_tenant_quotas, resolve_quota
from .serving import ServingEngine

log = logging.getLogger(__name__)

# stats() keys that describe CURRENT state; everything else in stats()
# is monotonic and bridges to /metrics as a counter (``_total`` names)
_GAUGE_STATS = frozenset({
    "n_slots", "active_slots", "free_slots", "reserved_slots",
    "registered_prefixes", "pending_requests",
    "running_requests", "running_copies", "admitting_copies",
    "window", "http_workers", "connections_waiting", "max_queue",
    "grammar_patterns",
    "kv_pages", "kv_pages_free", "kv_pages_shared",
    "kv_page_size",
})

# scheduler knobs: a window is one compiled run_scan; shorter windows
# lower time-to-first-token for requests waiting in the admission
# queue, longer ones amortize host round-trips harder
DEFAULT_WINDOW = 8
_IDLE_POLL_S = 0.05

# scheduler crash containment: the supervisor restarts a crashed
# scheduler loop with capped exponential backoff; this many crashes in
# a row (no _SCHED_CRASH_RESET_S of clean running between them) and
# the server stops pretending — every in-flight AND future request
# answers 503 and /healthz fails, so an orchestrator restarts the pod
_SCHED_MAX_RESTARTS = 8
_SCHED_CRASH_RESET_S = 60.0
_SCHED_BACKOFF_MAX_S = 2.0

# client-supplied guided_regex length bound: pattern text
# is attacker-controlled on the HTTP surface, and subset construction
# is super-linear in it; server-lowered patterns (guided_json /
# guided_choice) are bounded by --max-grammar-states instead
_MAX_REGEX_LEN = 4096

# pre-encoded JSON-lines skeletons for the hot streaming path: one
# frame per run_scan window, built by byte concatenation — no dict, no
# json.dumps, no per-token work on either thread
_FRAME_PRE = b'{"tokens":['
_FRAME_POST = b']}\n'

# request-id source for the tracing spans; next() is atomic under the
# GIL, so handler threads draw ids without a lock
_RID_COUNTER = itertools.count(1)


def _tokens_frame(new, idx: int, n: int) -> bytes:
    """One pre-serialized coalesced window frame: the JSON line
    ``{"tokens": [...]}`` (index-tagged for n>1) as wire-ready bytes."""
    body = ",".join(map(str, new)).encode()
    if n > 1:
        return b'{"tokens":[%s],"index":%d}\n' % (body, idx)
    return _FRAME_PRE + body + _FRAME_POST


def _holdback(text: str, stop_strs) -> int:
    """How many trailing chars of *text* could still become a stop
    string (the longest proper stop-prefix *text* ends with) — the
    stream withholds them so a stop spanning two chunks never leaks."""
    h = 0
    for s in stop_strs:
        for k in range(min(len(s) - 1, len(text)), 0, -1):
            if text.endswith(s[:k]):
                h = max(h, k)
                break
    return h


class _DetokState:
    """Incremental detokenization for one stream copy (vLLM's
    prefix/read-offset scheme): each committed token decodes a BOUNDED
    trailing window — decode(ids[prefix:t]) minus the already-read
    decode(ids[prefix:read]) — so total tokenizer work is O(T · window)
    instead of the O(T^2) full-prefix re-decodes that used to run on
    the scheduler thread.  Offsets advance only when the
    tail is UTF-8 stable (no trailing U+FFFD), so a char split across
    tokens (BPE byte fallback) commits once its last byte arrives.

    ``text`` is the committed text; ``cum[t]`` is its length after
    token t committed — the token<->char map stop scanning needs."""

    __slots__ = ("prefix_off", "read_off", "text", "cum")

    def __init__(self):
        self.prefix_off = 0
        self.read_off = 0
        self.text = ""
        self.cum = [0]

    def feed(self, tok, ids, n: int) -> None:
        """Commit tokens up to count *n* (monotonic)."""
        while len(self.cum) - 1 < n:
            t = len(self.cum)
            full = tok.decode([int(i) for i in ids[self.prefix_off:t]])
            prefix = (tok.decode(
                [int(i) for i in ids[self.prefix_off:self.read_off]])
                if self.read_off > self.prefix_off else "")
            delta = full[len(prefix):]
            if delta and not delta.endswith("�"):
                self.text += delta
                self.prefix_off = self.read_off
                self.read_off = t
            self.cum.append(len(self.text))


def _find_stop(st: _DetokState, stop_strs, scanned_from: int):
    """Earliest-completing NEW stop match in the committed text past
    char offset *scanned_from* (earlier chars were proven match-free;
    the window re-covers max(len)-1 overlap chars so a stop spanning
    the boundary is still seen).  Returns (kept token count, truncated
    text) or (None, None): the kept tokens include the token that
    completed the match, the TEXT stops at the earliest start of any
    match visible by then (vLLM's default, stop string excluded)."""
    lo = max(0, scanned_from - (max(len(s) for s in stop_strs) - 1))
    best = None  # (end, pos) of the first COMPLETED new match
    for s in stop_strs:
        p = st.text.find(s, lo)
        while p >= 0:
            if p + len(s) > scanned_from:
                # first NEW completion of this stop; earlier (stale)
                # occurrences in the overlap window must not shadow it
                e = (p + len(s), p)
                if best is None or e < best:
                    best = e
                break
            p = st.text.find(s, p + 1)
    if best is None:
        return None, None
    end, pos = best
    # the text cut is the earliest START among matches completed by
    # *end* (a longer stop beginning earlier but ending later is not
    # yet complete and does not count — same rule as prefix scanning)
    for s in stop_strs:
        p = st.text.find(s, lo)
        while p >= 0 and p + len(s) <= end:
            pos = min(pos, p)
            p = st.text.find(s, p + 1)
    keep = bisect.bisect_left(st.cum, end)
    return keep, st.text[:pos]


def _usage(prompt_tokens: int, completion_tokens: int) -> dict:
    """The ONE usage object (streamed final chunk and unary response
    share it, so the two surfaces cannot drift)."""
    return {
        "prompt_tokens": prompt_tokens,
        "completion_tokens": completion_tokens,
        "total_tokens": prompt_tokens + completion_tokens,
    }


def _sse_envelope(rid: str, model_name: str, chat: bool, choices,
                  **extra) -> dict:
    """The one SSE chunk envelope (id/object/model/created) — every
    chunk shape (role, echo, deltas, final, usage) builds on it so the
    wire format cannot drift between sites."""
    return {
        "id": rid,
        "object": "chat.completion.chunk" if chat else "text_completion",
        "model": model_name,
        "created": int(time.time()),
        "choices": choices,
        **extra,
    }


def _openai_chunk(rid: str, model_name: str, ev: dict, sent: dict,
                  chat: bool = False, include_usage: bool = False):
    """One SSE chunk for a native event, or None for events the OpenAI
    stream does not carry (raw token ids).  *sent* accumulates the text
    streamed per choice index so the final chunk can flush whatever the
    deltas withheld — the native done event's "text" is authoritative
    (BPE holdback / rewritten-history cases deliberately under-stream;
    see _emit).  *chat* switches to the chat.completion.chunk shape
    (delta objects instead of text fields)."""
    def choice(idx, text, reason):
        if chat:
            delta = {"content": text} if text else {}
            return {"index": idx, "delta": delta,
                    "finish_reason": reason}
        return {"index": idx, "text": text, "finish_reason": reason}

    if "text" in ev and "done" not in ev:
        idx = ev.get("index", 0)
        sent[idx] = sent.get(idx, "") + ev["text"]
        return _sse_envelope(
            rid, model_name, chat,
            [choice(idx, ev["text"], None)],
            # OpenAI's include_usage contract: every chunk BEFORE the
            # final usage-only one carries "usage": null
            **({"usage": None} if include_usage else {}))
    if "done" in ev:
        chs = (ev["choices"] if "choices" in ev
               else [{**ev, "index": 0}])
        choices = []
        for c in chs:
            final = c.get("text", "")
            prev = sent.get(c["index"], "")
            if final.startswith(prev):
                tail = final[len(prev):]
            else:
                # a decode merge rewrote streamed history (rare, BPE):
                # resend the full authoritative text — duplicated
                # beats silently wrong
                tail = final
            choices.append(
                choice(c["index"], tail, c["finish_reason"]))
        return _sse_envelope(
            rid, model_name, chat, choices,
            **({"usage": None} if include_usage else {}))
    return None


def _openai_response(rid: str, model_name: str, req: "_Request",
                     done: dict, chat: bool = False,
                     echo_text: Optional[str] = None) -> dict:
    chs = done["choices"] if "choices" in done else [{**done, "index": 0}]
    choices = []
    completion_tokens = 0
    for c in sorted(chs, key=lambda c: c["index"]):
        completion_tokens += len(c["tokens"])
        lp = None
        if c.get("logprobs"):
            # trim the engine's top list to the OpenAI-requested count
            # (0 = chosen only; the engine always computes >= 1)
            n = req.openai_logprobs or 0
            if chat:
                # the chat wire shape: content list of per-token
                # records with nested top_logprobs objects
                lp = {"content": [
                    {"token": str(t), "logprob": r["logprob"],
                     "top_logprobs": [
                         {"token": str(i), "logprob": p}
                         for i, p in r["top_logprobs"][:n]]}
                    for t, r in zip(c["tokens"], c["logprobs"])]}
            else:
                lp = {
                    "token_logprobs": [
                        r["logprob"] for r in c["logprobs"]],
                    "top_logprobs": [
                        {str(i): p for i, p in r["top_logprobs"][:n]}
                        for r in c["logprobs"]],
                    "tokens": [str(t) for t in c["tokens"]],
                    "text_offset": None,
                }
                prec = (c.get("prompt_logprobs")
                        or done.get("prompt_logprobs"))
                if echo_text is not None and prec:
                    # echo+logprobs: prompt entries lead (first null),
                    # aligning the arrays with the echoed text
                    lp["tokens"] = [str(t) for t in req.tokens]                         + lp["tokens"]
                    lp["token_logprobs"] = [
                        None if r is None else r["logprob"]
                        for r in prec] + lp["token_logprobs"]
                    lp["top_logprobs"] = [
                        None if r is None else
                        {str(i): pr
                         for i, pr in r["top_logprobs"][:n]}
                        for r in prec] + lp["top_logprobs"]
        if chat:
            choices.append({
                "index": c["index"],
                "message": {"role": "assistant",
                            "content": c.get("text", "")},
                "finish_reason": c["finish_reason"],
                "logprobs": lp,
            })
        else:
            choices.append({
                "index": c["index"],
                # echo (OpenAI completions): the prompt text leads the
                # completion in every choice
                "text": (echo_text or "") + c.get("text", ""),
                "finish_reason": c["finish_reason"],
                "logprobs": lp,
            })
    return {
        "id": rid,
        "object": "chat.completion" if chat else "text_completion",
        "model": model_name,
        "created": int(time.time()),
        "choices": choices,
        "usage": _usage(len(req.tokens), completion_tokens),
    }


@dataclass
class _Request:
    tokens: List[int]
    max_new_tokens: int
    temperature: float = 0.0
    top_k: Optional[int] = None
    top_p: float = 1.0
    min_p: float = 0.0
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    repetition_penalty: float = 1.0
    adapter: Optional[int] = None
    stop: Optional[List[int]] = None
    ignore_eos: bool = False
    seed: Optional[int] = None
    priority: int = 0                 # higher admits first
    _seq: int = 0                     # enqueue order (FIFO in a level)
    tenant: str = ""                  # QoS accounting identity
    _vft: float = 0.0                 # WFQ virtual finish time
    # preemption-by-page-eviction: copy idx -> engine checkpoint; the
    # scheduler resumes these before admitting anything new of ours
    preempted: dict = field(default_factory=dict)
    logprobs: Optional[int] = None
    prompt_logprobs: Optional[int] = None
    n: int = 1
    events: "queue.Queue" = field(default_factory=queue.Queue)
    cancelled: bool = False
    stream: bool = True               # streaming response requested
    per_token: bool = False           # legacy {"token": t} event shape
    openai: bool = False              # OpenAI route: text deltas only
    dropped: bool = False             # slow-client disconnect fired
    admitted: int = 0                 # copies admitted so far (of n)
    emitted: dict = field(default_factory=dict)   # copy index -> count
    choices: list = field(default_factory=list)   # finished copies
    budget_capped: bool = False
    # tokenizer-level surface (server-side; the engine stays ids-only):
    stop_strs: Optional[List[str]] = None
    detokenize: bool = False          # emit "text" deltas + final text
    text_sent: dict = field(default_factory=dict)  # idx -> emitted str
    detok: dict = field(default_factory=dict)  # idx -> _DetokState
    stop_scanned: dict = field(default_factory=dict)  # idx -> char off
    openai_logprobs: Optional[int] = None  # client-requested count
    echo: bool = False                # OpenAI completions echo
    echo_text: str = ""               # the ORIGINAL prompt text
    include_usage: bool = False       # stream_options.include_usage
    logit_bias: Optional[dict] = None      # {token id: bias}
    min_tokens: int = 0                    # eos/stop floor (vLLM)
    # guided decoding (vLLM's guided_regex / OpenAI response_format):
    # the handler thread compiles the pattern to a TokenDfa (cached by
    # pattern); the scheduler registers it with the engine at admit
    grammar_key: Optional[str] = None      # cache key (the pattern)
    grammar_tdfa: object = None            # compiled, pre-registration
    # request tracing: the span observes
    # tpu_serve_request_seconds{outcome} exactly once per request and
    # leaves a request_id-tagged log line; t_arrival anchors the
    # queue-wait and TTFT histograms.  trace is the request's
    # TraceContext (continued from the caller's traceparent header or a
    # fresh root): it tags every span log line, flight-recorder event,
    # and OpenMetrics exemplar this request produces, and is echoed in
    # the response headers / OpenAI ids
    rid: str = ""
    t_arrival: float = 0.0
    span: object = None
    ttft_observed: bool = False
    trace: object = None
    # SLO/goodput accounting: the request-supplied class name
    # (bounded to the declared policy set at record time — unknown
    # names land under the "other" label) and the observed TTFT the
    # terminal record is judged against
    slo_class: str = ""
    ttft_s: float = -1.0
    # disaggregated prefill/decode (router v2): prefill_only requests
    # run packed prefill, then the scheduler preempts the fresh slot
    # and the handler answers with the serialized checkpoint instead
    # of a token stream (the router ships it to a decode replica);
    # migrated marks a /migrate-resumed request on the decode side
    # (its quota was charged at the prefill replica — never twice)
    prefill_only: bool = False
    migrated: bool = False
    # session KV tiering: the conversation key.  The scheduler
    # warm-promotes the session's parked KV before admission and parks
    # the finished slot back under it; session_tier records which tier
    # (if any) served the warm hit, so admission only trusts the
    # session donor when the store vouched for it
    session: str = ""
    session_tier: str = ""


class _PooledHTTPServer(HTTPServer):
    """HTTP server with a FIXED worker pool and a bounded accept
    queue, replacing ThreadingHTTPServer's thread-per-connection:
    *workers* connections are served concurrently, up to *workers*
    more wait in the hand-off queue, and anything beyond that is
    answered 429 + Retry-After immediately on the accept thread (one
    small pre-built response into a fresh socket's send buffer — it
    cannot block on the client).  Thread count is a constant whatever
    the burst, which is the point: the old thread-per-connection model
    grew without bound exactly when the server was least able to
    afford it."""

    daemon_threads = True
    allow_reuse_address = True
    request_queue_size = 128  # TCP accept backlog

    _REJECT_BODY = (json.dumps({"error": {
        "message": "connection limit reached; retry later",
        "type": "rate_limit_exceeded"}}) + "\n").encode()
    _REJECT = (b"HTTP/1.1 429 Too Many Requests\r\n"
               b"Content-Type: application/json\r\n"
               b"Retry-After: 1\r\n"
               b"Content-Length: %d\r\n"
               b"Connection: close\r\n\r\n" % len(_REJECT_BODY)
               ) + _REJECT_BODY

    def __init__(self, addr, handler, workers: int, shed_counter=None,
                 recorder=None):
        super().__init__(addr, handler)
        self._conns: "queue.Queue" = queue.Queue(maxsize=workers)
        # 429s shed at accept: an obs counter child when the owning
        # EngineServer wires one (tpu_serve_shed_total{reason=
        # "connections"}), a plain int for standalone embedders
        self._shed = shed_counter
        self._recorder = recorder
        self._rejected_fallback = 0
        self._pool = [
            threading.Thread(target=self._worker,
                             name=f"serve-http-{i}", daemon=True)
            for i in range(workers)]
        for t in self._pool:
            t.start()

    def process_request(self, request, client_address):
        """Accept thread: hand the connection to the pool or shed it."""
        try:
            self._conns.put_nowait((request, client_address))
        except queue.Full:
            if self._shed is not None:
                self._shed.inc()
            else:
                self._rejected_fallback += 1
            if self._recorder is not None:
                # no request (and so no trace) exists yet at accept
                # time: the shed is still a journal-worthy lifecycle
                # event for the post-mortem timeline
                self._recorder.record("tpu_serve_shed",
                                      reason="connections",
                                      peer=str(client_address[0]))
            try:
                request.settimeout(0.5)
                request.sendall(self._REJECT)
                # drain whatever request bytes already arrived so the
                # close does not RST the 429 out of the peer's buffer
                try:
                    request.recv(1 << 20)
                except OSError:
                    pass
            except OSError:
                pass
            self.shutdown_request(request)

    def _worker(self):
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

    @property
    def connections_rejected(self) -> int:
        return (int(self._shed.value) if self._shed is not None
                else self._rejected_fallback)

    def pool_stats(self) -> dict:
        return {
            "http_workers": len(self._pool),
            "connections_waiting": self._conns.qsize(),
            "connections_rejected": self.connections_rejected,
        }

    def server_close(self):
        super().server_close()
        # best-effort pool drain: workers mid-stream see the
        # scheduler's shutdown 503 and exit their connection; the
        # sentinels release the idle ones (daemon threads back-stop)
        for _ in self._pool:
            try:
                self._conns.put_nowait(None)
            except queue.Full:
                break
        for t in self._pool:
            t.join(timeout=1)


class EngineServer:
    """Scheduler + HTTP surface around one ServingEngine.

    >>> srv = EngineServer(engine, max_new_tokens=64).start(port=0)
    >>> # curl -N -d '{"tokens":[1,2,3]}' http://host:port/generate
    >>> srv.stop()
    """

    def __init__(self, engine: ServingEngine,
                 max_new_tokens: int = 64,
                 window: int = DEFAULT_WINDOW,
                 tokenizer=None,
                 token_bytes: Optional[List[bytes]] = None,
                 max_grammars: int = 64,
                 max_queue: int = 1024,
                 max_connections: int = 64,
                 max_events: int = 256,
                 max_grammar_states: int = 8192,
                 client_timeout: float = 120.0,
                 flight_record_dir: Optional[str] = None,
                 flight_record_capacity: int = 4096,
                 interleave: bool = True,
                 prefill_chunks: int = DEFAULT_PREFILL_BUDGET,
                 schedule_watchdog_s: float = 0.0,
                 tenant_quotas: Optional[dict] = None,
                 packed_prefill: bool = True,
                 overlap_dispatch: bool = True,
                 max_pack: int = DEFAULT_MAX_PACK,
                 slo_policies: Optional[dict] = None,
                 slo_window_s: float = 60.0,
                 profile_dir: Optional[str] = None,
                 flight_dump_keep: int = 20,
                 replica_role: str = "mixed",
                 alert_rules: Optional[list] = None,
                 alert_interval_s: float = 5.0,
                 alert_window_scale: float = 1.0,
                 incident_dir: Optional[str] = None,
                 profiler_hz: float = 19.0,
                 session_tier: bool = False,
                 session_dir: Optional[str] = None,
                 session_host_mb: int = 256,
                 session_disk_keep: int = 512,
                 session_idle_s: float = 30.0,
                 session_host_idle_s: float = 120.0,
                 session_seed: int = 0):
        """*tokenizer* (anything with ``encode(str) -> List[int]`` and
        ``decode(List[int]) -> str``, e.g. a transformers tokenizer)
        unlocks the text-level surface: ``"prompt"`` strings, STRING
        entries in ``"stop"`` (vLLM's stop strings — matched against
        the detokenized stream, held back across chunk boundaries),
        and ``"text"`` deltas in the response.  Without it the server
        speaks token ids only, as before.

        *max_queue* bounds the admission heap and *max_connections*
        the HTTP worker pool (each overflow answers 429 +
        Retry-After); *max_events* bounds each request's event queue
        (a client that stops draining is disconnected and its slot
        released); *max_grammar_states* rejects guided-decoding
        patterns whose char-DFA exceeds that many states BEFORE the
        [N, V] token table is built; *client_timeout* is the
        per-connection socket timeout so a stuck peer frees its pool
        worker."""
        if engine.max_new_tokens is not None:
            raise ValueError(
                "pass per-request budgets to EngineServer, not the "
                "engine: an engine-wide max_new_tokens would retire "
                "slots behind the scheduler's back at the wrong budget")
        if window < 1:
            raise ValueError("window must be >= 1")
        self.engine = engine
        self.default_max_new = max_new_tokens
        self.window = window
        self.tokenizer = tokenizer
        # guided decoding: per-token byte strings let the server lower
        # per-request regex/JSON constraints to the engine's TokenDfa.
        # Explicit *token_bytes* wins; otherwise derived lazily from
        # the tokenizer on the first grammar request.  The pattern ->
        # TokenDfa cache is bounded (max_grammars) because each
        # distinct pattern also occupies rows in the engine's combined
        # grammar table for the engine's lifetime.
        self._token_bytes = token_bytes
        self.max_grammars = max_grammars
        if max_queue < 1 or max_connections < 1 or max_events < 8:
            raise ValueError(
                "max_queue/max_connections must be >= 1 and "
                "max_events >= 8")
        self.max_queue = max_queue
        self.max_connections = max_connections
        self.max_events = max_events
        self.max_grammar_states = max_grammar_states
        self.client_timeout = client_timeout
        # disaggregated serving role (router v2): advertised through
        # /register and /statz so the router routes phase-aware.
        # prefill/decode classes need the paged pool — migration IS
        # preempt-on-A/resume-on-B, and only paged slots checkpoint
        if replica_role not in ("mixed", "prefill", "decode"):
            raise ValueError(
                f"replica_role {replica_role!r} must be mixed, "
                "prefill, or decode")
        if replica_role != "mixed" and not getattr(
                engine, "kv_paging", False):
            raise ValueError(
                f"replica_role={replica_role!r} needs a paged engine "
                "(kv_paging=True): KV migration is preempt/resume, "
                "which only the paged pool checkpoints")
        self.replica_role = replica_role
        self._grammar_tdfas: dict = {}    # pattern -> TokenDfa
        self._grammar_gids: dict = {}     # pattern -> engine gid
        self._glock = threading.Lock()
        # priority heap (vLLM's priority scheduling): higher-priority
        # requests admit first, FIFO within a priority level (the
        # monotonic sequence number breaks ties).  Guarded by _lock —
        # handler threads push, only the scheduler pops.
        self._pending: list = []
        self._pending_seq = 0
        self._lock = threading.Lock()
        self._work = threading.Event()    # set on every enqueue
        self._running: dict = {}          # slot -> (_Request, copy idx)
        self._head: Optional[_Request] = None  # partially admitted n>1
        self._stop = threading.Event()
        self._httpd: Optional["_PooledHTTPServer"] = None
        self._scheduler: Optional[threading.Thread] = None
        self._requests_served = 0
        self._requests_rejected = 0
        # -- observability: the serving registry -------------------
        # request spans + latency histograms; /metrics renders THIS via
        # the shared obs renderer (the old hand-rolled loop is gone).
        # The 429-shed and slow-client-drop ad-hoc ints are promoted to
        # real counters; stats() reads the counters back so the JSON
        # and Prometheus surfaces cannot drift.
        self.registry = obs.Registry()
        reg = self.registry
        self._m_ttft = reg.histogram(
            "tpu_serve_ttft_seconds",
            "Time from request arrival to its first generated token "
            "(queue wait + prefill + first window included).",
            buckets=obs.LATENCY_BUCKETS_S)
        self._m_token = reg.histogram(
            "tpu_serve_token_seconds",
            "Per-token decode latency: each run_scan window observes "
            "window_time/tokens once per token per stream.",
            buckets=obs.FAST_BUCKETS_S)
        self._m_request = reg.histogram(
            "tpu_serve_request_seconds",
            "End-to-end request latency by outcome (ok, rejected, "
            "throttled, dropped, cancelled, shutdown).",
            ("outcome",), buckets=obs.LATENCY_BUCKETS_S)
        self._m_queue_wait = reg.histogram(
            "tpu_serve_queue_wait_seconds",
            "Time a request waited in the admission heap before its "
            "first copy was admitted.", buckets=obs.LATENCY_BUCKETS_S)
        self._m_admit = reg.histogram(
            "tpu_serve_admit_seconds",
            "One engine admit (prompt prefill / prefix-cache splice).",
            buckets=obs.LATENCY_BUCKETS_S)
        self._m_stream_write = reg.histogram(
            "tpu_serve_stream_write_seconds",
            "One chunked stream write (>= 1 coalesced window frames).",
            buckets=obs.FAST_BUCKETS_S)
        self._m_shed = reg.counter(
            "tpu_serve_shed_total",
            "Load shed with 429 + Retry-After, by admission surface.",
            ("reason",))
        self._shed_conns = self._m_shed.labels(reason="connections")
        self._shed_queue = self._m_shed.labels(reason="queue")
        self._shed_quota = self._m_shed.labels(reason="quota")
        self._m_dropped = reg.counter(
            "tpu_serve_slow_client_drops_total",
            "Clients disconnected for not draining their stream "
            "(bounded event queue overflowed).")
        self._m_abandons = reg.counter(
            "tpu_serve_client_abandons_total",
            "Requests whose CLIENT disconnected mid-request (reset "
            "or broken pipe seen by the handler) — the client-side "
            "mirror of the slow-client drops the server initiates.")
        # -- paged KV pool + multi-tenant QoS -----------------------------
        # Pool occupancy/sharing gauges and the preemption/CoW/eviction
        # counters refresh from engine stats at scrape time; they render
        # (as zeros) on contiguous engines too, so dashboards see one
        # schema.  Tenant quotas: token buckets over estimated tokens,
        # weighted fair queueing in the admission heap (vft ordering
        # WITHIN a priority level), preemption-by-page-eviction when the
        # paged pool runs dry — 429s become per-tenant policy instead of
        # the global --max-queue constant.
        self._m_kv_pages_free = reg.gauge(
            "tpu_serve_kv_pages_free",
            "Free physical pages in the paged KV pool (0 when paging "
            "is off).")
        self._m_kv_pages_shared = reg.gauge(
            "tpu_serve_kv_pages_shared",
            "Physical KV pages referenced by more than one slot "
            "(copy-on-write prefix sharing).")
        self._m_kv_preempt = reg.counter(
            "tpu_serve_kv_preemptions_total",
            "Slots preempted by page eviction (KV checkpointed to "
            "host, pages freed, request re-queued).")
        self._m_kv_cow = reg.counter(
            "tpu_serve_kv_cow_copies_total",
            "Copy-on-write page copies (an append into a shared "
            "prefix page).")
        self._m_prefix_evict = reg.counter(
            "tpu_serve_prefix_evictions_total",
            "Prefix-registry/parked-donor records evicted by the LRU "
            "cap or pool-pressure reclaim.")
        # -- disaggregated prefill/decode migration -----------------------
        # out = prefill-only requests exported as a checkpoint (this
        # replica ran packed prefill, the router shipped the KV state
        # on); in = /migrate checkpoints resumed here.  Both children
        # materialize at boot so /statz and the family stay lock-step
        # from the first scrape, role notwithstanding
        self._m_migrations = reg.counter(
            "tpu_serve_migrations_total",
            "KV-state migrations by direction: out = prefill-only "
            "admissions preempted and exported to the router, in = "
            "/migrate checkpoints resumed on this replica.",
            ("direction",))
        self._mig_out = self._m_migrations.labels(direction="out")
        self._mig_in = self._m_migrations.labels(direction="in")
        self._mig_out.inc(0)
        self._mig_in.inc(0)
        # -- ragged packed prefill + warmup -------------------------------
        self._m_packed_reqs = reg.counter(
            "tpu_serve_packed_prefill_requests_total",
            "Admissions whose prefill rode at least one ragged packed "
            "(batched) extend dispatch.")
        self._m_packed_pad = reg.counter(
            "tpu_serve_packed_prefill_pad_tokens_total",
            "Zero-pad token rows computed by packed prefill dispatches "
            "(tail-chunk grid padding — the packing waste metric).")
        # -- fused decode loop ------------------------------------
        # harvest-side visibility for the fused window path: how many
        # windows ran with the on-device boundary carry, and how many
        # post-finish steps those windows burned (the adaptive-window
        # headroom signal).  Rendered from boot on unfused engines too
        # (zeros), so the dashboard schema is mode-independent.
        self._m_fused_windows = reg.counter(
            "tpu_serve_fused_windows_total",
            "Decode windows dispatched with the fused on-device "
            "boundary carry (eos/stop/budget detected in-scan).")
        self._m_fused_trunc = reg.counter(
            "tpu_serve_fused_truncated_tokens_total",
            "Tokens computed after a slot's on-device finish boundary "
            "and discarded at harvest (post-finish window burn).")
        self._m_warmup = reg.gauge(
            "tpu_serve_warmup_seconds",
            "Wall seconds warm_scheduler spent pre-compiling, by "
            "phase (scan = adaptive-window variants, packed_prefill = "
            "the packed shape set, total = everything).  With a warm "
            "--compile-cache-dir these collapse to cache-hit loads.",
            ("phase",))
        reg.on_collect(self._collect_kv)
        self.tenant_quotas = dict(tenant_quotas or {})
        self._qos = bool(self.tenant_quotas)
        self._vtime = 0.0              # WFQ virtual clock (under _lock)
        # -- SLO / goodput accounting -----------------------------
        # every terminal request lands in tpu_slo_requests_total{class,
        # tenant,met}; the rolling-window goodput/burn-rate gauges and
        # the /statz goodput block come from the same accountant, so
        # the router tier and the dashboards read one truth.  Always
        # on: without --slo the default interactive/batch policies
        # classify (generously) rather than nothing being measured
        self._slo = obs.SLOAccountant(
            reg, policies=slo_policies,
            tenants=self.tenant_quotas.keys(),
            window_s=slo_window_s)
        # -- continuous profiling hook ----------------------------
        # GET /debug/profile?seconds=N dumps a torch.profiler trace to
        # --profile-dir; single-flight guarded (a second request while
        # one is capturing answers 409 instead of corrupting the trace)
        self.profile_dir = profile_dir
        self._profile_lock = threading.Lock()
        self._m_profile = reg.counter(
            "tpu_serve_profile_captures_total",
            "Profiler traces captured via /debug/profile (dumped to "
            "--profile-dir).")
        self._m_profile.inc(0)  # render from boot: one schema
        # crash containment: a scheduler-thread death is
        # counted, journaled, and survived (supervised restart) —
        # never a silent hang with clients blocked on event queues
        self._m_sched_crashes = reg.counter(
            "tpu_serve_scheduler_crashes_total",
            "Engine-scheduler loop crashes caught by the supervisor.")
        self._m_sched_restarts = reg.counter(
            "tpu_serve_scheduler_restarts_total",
            "Engine-scheduler restarts after a crash (crashes past "
            "the restart budget kill the server instead).")
        self._sched_dead = False
        # -- tracing + flight recorder -----------------------------
        # every span end and lifecycle event (sheds, drops, grammar
        # rejections) lands in this bounded ring, stamped with the
        # request's trace-id; /debug/traces and /debug/events read it,
        # and --flight-record-dir dumps it on exit/SIGTERM
        self.recorder = obs.FlightRecorder(
            capacity=flight_record_capacity, registry=reg,
            dump_keep=flight_dump_keep)
        self.flight_record_dir = flight_record_dir
        if flight_record_dir:
            self.recorder.install_dump_handlers(flight_record_dir)
        # -- in-process retention + alerting ----------------------
        # a bounded TSDB samples this registry on a background tick
        # (GET /debug/query reads it back), and the evaluator derives
        # the SRE multi-window multi-burn-rate rules from every SLO
        # class above — page at 14.4x over the short+long window pair,
        # ticket at 1x over six hours — plus whatever --alert-rules
        # hand-writes.  Firing pages surface on /alerts and in statz(),
        # which is how the fleet autoscaler learns reason=alert.
        reg.on_collect(self._bridge_stats)
        self.scrape_meta = obs.ScrapeMeta(reg)
        self.tsdb = obs.TSDB(reg)
        self.alert_interval_s = float(alert_interval_s)
        _rules = obs.burn_rate_rules(
            self._slo.policies, window_scale=alert_window_scale)
        _rules.extend(alert_rules or ())
        self.alerts = obs.AlertEvaluator(
            self.tsdb, _rules, recorder=self.recorder)
        # -- continuous profiling + incident bundles --------------
        # the always-on sampler (GET /debug/pprof) tags every stack
        # sample with the scheduler's live phase and the in-flight
        # count; when a page-severity alert fires, the incident
        # manager snapshots everything (journal, TSDB, profile ring,
        # statz, slowest SLO-missed traces) into one atomic directory
        # under --incident-dir — the post-mortem writes itself
        self.profiler = obs.SamplingProfiler(
            reg, hz=profiler_hz,
            phase_fn=lambda: self._sched.phase,
            active_fn=lambda: len(self._running))
        self.incident_dir = incident_dir
        self._incidents: Optional[obs.IncidentManager] = None
        if incident_dir:
            self._incidents = obs.IncidentManager(
                incident_dir, self.alerts, registry=reg,
                recorder=self.recorder, tsdb=self.tsdb,
                profiler=self.profiler,
                collectors={"statz.json": self.statz,
                            "traces.json": self.slo_miss_traces})
        # -- iteration scheduler (continuous batching) --------------------
        # the engine's sole caller: a unified work queue of decode
        # windows and prefill chunks.  With interleave on (default),
        # prefill chunks, new admissions, and admission finishes are
        # dispatched while a decode window runs on the device — a
        # request admitted mid-window starts prefilling before that
        # window closes, and admission no longer stalls running
        # streams.  interleave=False reproduces the old
        # admit-fully-then-scan cadence (outputs are bit-identical
        # either way — the equivalence tests pin it).
        self.interleave = bool(interleave)
        # ragged packed prefill + dispatch-ahead overlap (both default
        # on; outputs are byte-identical either way — the packed/
        # overlap equivalence suites pin it): packing batches
        # concurrent admissions' chunks into one extend, overlap keeps
        # window N+1 on the device while this thread streams window N
        self.packed_prefill = bool(packed_prefill)
        self.overlap_dispatch = bool(overlap_dispatch)
        self._sched = IterationScheduler(
            engine, window=window, interleave=interleave,
            prefill_budget=prefill_chunks, pull=self._pull_ticket,
            on_admit=self._bind_admitted,
            budget_hint=self._budget_hint,
            packed_prefill=packed_prefill, max_pack=max_pack,
            overlap=overlap_dispatch, registry=reg,
            recorder=self.recorder)
        self._tickets: dict = {}   # Ticket -> (_Request, copy idx)
        # optional hang containment for the scheduler loop: a watchdog
        # fails an iteration stuck past the deadline (WatchdogTimeout
        # -> the crash supervisor 503s in-flight requests and
        # restarts).  Off by default: a first-window compile can
        # legitimately take tens of seconds, so the knob is for
        # operators (and the chaos harness) who know their steady
        # state.
        self._sched_watchdog = None
        if schedule_watchdog_s > 0:
            self._sched_watchdog = resilience.Watchdog(
                op="serve.schedule", timeout_s=schedule_watchdog_s,
                metrics=resilience.ResilienceMetrics(reg),
                recorder=self.recorder)
        # -- session KV tiering -----------------------------------
        # device-parked conversations demote to host RAM and a
        # crash-safe spill dir on idleness and pressure, and promote
        # back when the session returns; every transition degrades to
        # re-prefill, never a failed request
        self._session_store: Optional[SessionStore] = None
        if session_tier:
            if not getattr(engine, "kv_paging", False):
                raise ValueError(
                    "session tiering needs a paged engine "
                    "(kv_paging=True): tier transitions are the paged "
                    "checkpoint/restore path")
            if not getattr(engine, "auto_prefix", False):
                raise ValueError(
                    "session tiering needs auto_prefix=True: warm "
                    "resume rides the automatic prefix match")
            self._session_store = SessionStore(
                engine, spill_dir=session_dir,
                host_cap_bytes=session_host_mb * 1024 * 1024,
                disk_keep=session_disk_keep,
                device_idle_s=session_idle_s,
                host_idle_s=session_host_idle_s,
                seed=session_seed, registry=reg,
                recorder=self.recorder,
                rmetrics=ResilienceMetrics(reg))
        # preemption-by-page-eviction: the paged engine escalates a
        # failed page allocation to this policy (scheduler thread) —
        # demote an idle parked session first (its pages are the
        # cheapest to reclaim), then checkpoint the lowest-priority
        # running slot to host, free its pages, re-queue its request
        # for later resume
        if getattr(engine, "kv_paging", False):
            engine.set_preempt_cb(self._page_pressure)

    def _page_pressure(self, exclude_slot: int = -1) -> bool:
        """Page-pressure escalation order: parked sessions yield
        before running requests are preempted."""
        if self._session_store is not None and \
                self._session_store.demote_for_pages(time.monotonic()):
            return True
        return self._preempt_for_pages(exclude_slot)

    def _collect_kv(self) -> None:
        """Scrape-time refresh of the KV-pool/QoS/packed-prefill
        families from engine stats (counters _set to the engine's
        monotonic values)."""
        st = self.engine.stats()
        self._m_kv_pages_free.set(st.get("kv_pages_free", 0))
        self._m_kv_pages_shared.set(st.get("kv_pages_shared", 0))
        self._m_kv_preempt._set(st.get("kv_preemptions", 0))
        self._m_kv_cow._set(st.get("kv_cow_copies", 0))
        self._m_prefix_evict._set(st.get("prefix_evictions", 0))
        self._m_packed_reqs._set(st.get("packed_prefill_requests", 0))
        self._m_packed_pad._set(st.get("packed_prefill_pad_tokens", 0))
        self._m_fused_windows._set(st.get("fused_windows", 0))
        self._m_fused_trunc._set(st.get("fused_truncated_tokens", 0))

    def _resolve_quota(self, tenant: str) -> Optional["TenantQuota"]:
        """Per-tenant QoS state; the ``*`` spec is a TEMPLATE — each
        unknown tenant gets its own bucket and WFQ chain cloned from
        it (shared state would let one tenant drain another's
        budget).  Caller holds ``_lock``."""
        return resolve_quota(self.tenant_quotas, tenant)

    def _preempt_for_pages(self, exclude_slot: int = -1) -> bool:
        """The engine's page-pressure escalation (scheduler thread):
        preempt the lowest-priority, most-recently-admitted running
        copy (never *exclude_slot* — the slot the engine is trying to
        grow).  The evicted copy's checkpoint rides its request back
        into the admission heap; the pull path resumes it when pages
        free up.  Returns False when nothing is preemptible."""
        cands = [
            (req.priority, i, slot, req, idx)
            for i, (slot, (req, idx)) in
            enumerate(self._running.items())
            if slot != exclude_slot and not req.cancelled
        ]
        if not cands:
            return False
        cands.sort(key=lambda c: (c[0], -c[1]))
        _, _, slot, req, idx = cands[0]
        try:
            state = self.engine.preempt(slot)
        except (RuntimeError, ValueError):
            return False
        del self._running[slot]
        req.preempted[idx] = state
        self.recorder.record("tpu_serve_kv_preempt", trace=req.trace,
                             rid=req.rid, slot=slot, copy=idx,
                             tenant=req.tenant)
        with self._lock:
            self._pending_seq += 1
            heapq.heappush(
                self._pending,
                (-req.priority, req._vft, self._pending_seq, req))
        self._work.set()
        return True

    def _mark(self, req: "_Request", name: str, duration_s: float,
              **attrs) -> None:
        """One traced sub-operation (queue wait, admit, window, stream
        write): a flight-recorder event plus a span-style log line, both
        carrying the request's trace-id — the breadcrumbs /debug/traces
        stitches into a per-request timeline.  The matching histogram
        observation stays at the call site (it may be a bulk observe)."""
        self.recorder.record(name, trace=req.trace, rid=req.rid,
                             duration_s=duration_s, **attrs)
        if log.isEnabledFor(logging.DEBUG):
            tid = req.trace.trace_id if req.trace is not None else ""
            extra = " ".join(f"{k}={v}" for k, v in attrs.items())
            log.debug("span=%s request_id=%s trace_id=%s "
                      "duration_s=%.6f%s", name, req.rid, tid,
                      duration_s, f" {extra}" if extra else "")

    # promoted ad-hoc ints: reads must keep working (tests, embedders)
    # while the obs counters are the single source of truth
    @property
    def _requests_throttled(self) -> int:
        return int(self._shed_queue.value)

    @property
    def _requests_dropped(self) -> int:
        return int(self._m_dropped.value)

    def _finish_request(self, req: _Request, outcome: str) -> None:
        """Terminal accounting: end the request span exactly once
        (observes tpu_serve_request_seconds{outcome} and logs the
        request-id line) and record the SLO verdict — goodput counts
        every terminal request, and a shed/dropped/crashed one never
        meets its SLO.  Safe to race — Span.end is idempotent, and
        handler threads (cancel paths) may race the scheduler."""
        sp = req.span
        if sp is not None:
            req.span = None
            total_s = sp.end(outcome=outcome)
            if outcome == "migrated":
                # the request is still IN FLIGHT fleet-wise: the
                # decode replica that resumed the checkpoint records
                # the one true SLO verdict when the stream terminates
                return
            # requests that never declared a class derive one from
            # their shape: streaming callers care about TTFT
            # (interactive), unary callers about the deadline (batch)
            met = self._slo.record(
                req.slo_class or None, req.tenant,
                ttft_s=req.ttft_s if req.ttft_s >= 0 else None,
                total_s=total_s, ok=outcome == "ok",
                fallback="interactive" if req.stream else "batch")
            if not met:
                # per-miss journal marker: the incident
                # bundler joins these against the trace ring to stitch
                # "the slowest requests that missed their SLO" without
                # re-deriving policy verdicts offline
                self.recorder.record(
                    "tpu_serve_slo_miss", trace=req.trace,
                    rid=req.rid, duration_s=total_s, outcome=outcome,
                    slo_class=req.slo_class or "")

    def _note_client_abandon(self, req: _Request) -> None:
        """The CLIENT vanished mid-request (reset / broken pipe on
        its connection).  Count + journal it so a bench/replay
        ``abandoned`` outcome has a server-side record to join
        against — distinct from the slow-client drop, which is the
        SERVER's decision (this path was previously invisible: the
        request finished as a bare ``cancelled`` with no way to tell
        a user Ctrl-C from an operator cancel)."""
        self._m_abandons.inc()
        self.recorder.record("tpu_serve_client_abandon",
                             trace=req.trace, rid=req.rid)

    # -- scheduler (sole owner of the engine) -------------------------------

    def _pull_ticket(self):
        """The iteration scheduler's intake: pop the next request copy
        off the priority heap and hand it over as an admission ticket
        (``begin_admit`` under the hood — validation errors 400 here,
        prefill runs later, interleaved with decode).  A request with
        n > 1 admits one ticket per copy, INCREMENTALLY as slots free
        (continuous batching, not gang scheduling) — sibling copies
        share the prompt, so the automatic prefix cache turns every
        copy after the first into a tail-only prefill.  Returns None
        when nothing is waiting."""
        eng = self.engine
        while True:
            with self._lock:
                head = self._head
                top = self._pending[0] if self._pending else None
                if (head is not None and top is not None
                        and -top[0] > head.priority):
                    # a strictly higher-priority arrival preempts the
                    # remaining copies of a partially-admitted n>1
                    # request — the head goes back into the heap at
                    # its ORIGINAL position within its level
                    req = heapq.heappop(self._pending)[-1]
                    heapq.heappush(
                        self._pending,
                        (-head.priority, head._vft, head._seq, head))
                    self._head = None
                elif head is not None:
                    req, self._head = head, None
                elif top is not None:
                    req = heapq.heappop(self._pending)[-1]
                else:
                    return None
                # WFQ virtual clock follows the served frontier
                if self._qos and req._vft > self._vtime:
                    self._vtime = req._vft
            if req.cancelled:
                # preempted checkpoints of a cancelled request are
                # dropped (their pages were freed at preemption)
                req.preempted.clear()
                continue
            if req.preempted:
                # resume an evicted copy before admitting anything
                # new of this request: the checkpoint already holds
                # its tokens — re-queueing it behind fresh work would
                # strand a half-finished stream
                idx = next(iter(req.preempted))
                state = req.preempted[idx]
                if state.get("gstate_rel", False):
                    # a MIGRATED checkpoint carries grammar state in
                    # grammar-local form (absolute table offsets are
                    # per-engine): register the pattern here (cached)
                    # and re-home the state onto our combined table
                    try:
                        rel = int(state["gstate"])
                        if rel >= 0:
                            if req.grammar_key is None:
                                raise ValueError(
                                    "migrated checkpoint carries "
                                    "grammar state but the request "
                                    "declares no grammar")
                            state["gstate"] = eng.grammar_abs(
                                int(self._ensure_grammar(req)), rel)
                        state.pop("gstate_rel", None)
                    except ValueError as e:
                        req.preempted.clear()
                        self._requests_rejected += 1
                        self._push(req, {"error": str(e), "code": 400})
                        self._finish_request(req, "rejected")
                        continue
                try:
                    slot = eng.resume(state)
                except PagePoolExhausted:
                    # still no capacity: back on the heap, stop
                    # pulling this round (decode progress frees pages)
                    with self._lock:
                        self._pending_seq += 1
                        heapq.heappush(
                            self._pending,
                            (-req.priority, req._vft,
                             self._pending_seq, req))
                    return None
                except RuntimeError:
                    # no free slot this round: requeue, stop pulling
                    with self._lock:
                        self._pending_seq += 1
                        heapq.heappush(
                            self._pending,
                            (-req.priority, req._vft,
                             self._pending_seq, req))
                    return None
                except (ValueError, TypeError, KeyError) as e:
                    # cross-process payloads can be arbitrarily wrong
                    # (shape/dtype skew between replica builds): a
                    # bad one must 400 its own request, not take the
                    # scheduler thread down with it
                    req.preempted.clear()
                    self._requests_rejected += 1
                    self._push(req, {
                        "error": "migrated checkpoint failed to "
                                 f"resume: {e}", "code": 400})
                    self._finish_request(req, "rejected")
                    continue
                del req.preempted[idx]
                self._running[slot] = (req, idx)
                self.recorder.record(
                    "tpu_serve_kv_resume", trace=req.trace,
                    rid=req.rid, slot=slot, copy=idx,
                    tenant=req.tenant)
                if req.preempted:
                    with self._lock:
                        self._pending_seq += 1
                        heapq.heappush(
                            self._pending,
                            (-req.priority, req._vft,
                             self._pending_seq, req))
                continue
            if self._sched.packing_conflict(req.tokens):
                # an in-flight packed admission shares this prompt's
                # leading chunk: beginning NOW would forfeit the APC
                # match a serial admission gets (the donor has not
                # spliced yet).  Defer — the pending ticket lands
                # within a few iterations and the re-pull hits the
                # warm donor.  Sibling copies of an n>1 request defer
                # the same way (copy 0 is the in-flight conflict), so
                # their tail-only prefill economics are unchanged by
                # packing.
                if req.admitted > 0:
                    self._head = req    # partially-admitted n>1 head
                else:
                    with self._lock:
                        heapq.heappush(
                            self._pending,
                            (-req.priority, req._vft, req._seq, req))
                return None
            try:
                if not req.budget_capped:
                    # cap the admission budget so prompt + generation
                    # fits the cache; the per-request budget applies
                    if (len(req.tokens) + req.max_new_tokens
                            > eng.model.max_len):
                        budget = eng.model.max_len - len(req.tokens)
                        if budget < 1:
                            raise ValueError(
                                f"prompt ({len(req.tokens)} tokens) "
                                f"leaves no room to generate within "
                                f"max_len {eng.model.max_len}")
                        req.max_new_tokens = budget
                    req.budget_capped = True
                gid: object = False
                if req.grammar_key is not None:
                    # engine-side registration happens HERE because the
                    # scheduler is the engine's sole owner; the pattern
                    # cache makes it once-per-pattern, so the steady
                    # state is a dict lookup
                    gid = self._ensure_grammar(req)
                if req.admitted == 0 and req.t_arrival:
                    wait_dt = time.perf_counter() - req.t_arrival
                    self._m_queue_wait.observe(wait_dt)
                    self._mark(req, "tpu_serve_queue_wait", wait_dt)
                if (req.session and req.admitted == 0 and req.n == 1
                        and not req.migrated and not req.prefill_only
                        and self._session_store is not None):
                    # warm-promote the conversation's parked KV ahead
                    # of admission; a host/disk restore lands in its
                    # own parked slot, so one must stay free for THIS
                    # admission.  Any failure leaves session_tier
                    # empty and the request re-prefills — tiering
                    # never fails a request.
                    req.session_tier = self._session_store.prepare(
                        req.session, time.monotonic(),
                        can_restore=len(eng.free_slots()) >= 2)
                ticket = self._sched.begin(
                    req.tokens, temperature=req.temperature,
                    top_k=req.top_k, top_p=req.top_p,
                    min_p=req.min_p,
                    presence_penalty=req.presence_penalty,
                    frequency_penalty=req.frequency_penalty,
                    repetition_penalty=req.repetition_penalty,
                    adapter=req.adapter, stop=req.stop,
                    ignore_eos=req.ignore_eos,
                    # each sampled copy diverges via the engine's
                    # SECOND fold level (seed_stream = copy index), so
                    # "seed s copy 1" never aliases "seed s+1 copy 0";
                    # copy-varying args are the one exception to the
                    # identical-args-per-copy rule the except clause
                    # below leans on (the engine validates neither)
                    seed=req.seed, seed_stream=req.admitted,
                    logprobs=req.logprobs,
                    # the records are deterministic and identical per
                    # copy: only copy 0 pays the full-prefill cost
                    # (copies 1..n-1 keep their APC tail-only prefill)
                    prompt_logprobs=(req.prompt_logprobs
                                     if req.admitted == 0 else None),
                    logit_bias=req.logit_bias,
                    min_tokens=req.min_tokens,
                    grammar=gid,
                    # the store vouched for the donor: only a
                    # warm-promoted session may match its own parked
                    # record (a cold pass must re-prefill, not half-
                    # trust whatever is resident)
                    session=(req.session if req.session_tier
                             else None))
            except PagePoolExhausted:
                # page pressure, not a bad request: demote an idle
                # parked session first (cheapest pages in the pool),
                # then preempt a STRICTLY lower-priority running copy
                # and retry this one (re-entering via _head keeps its
                # heap position); nothing yieldable means the pool is
                # honestly full — the request waits its turn
                if (self._session_store is not None
                        and self._session_store.demote_for_pages(
                            time.monotonic())):
                    self._head = req
                    continue
                if (min((r.priority for r, _ in
                         self._running.values()), default=req.priority)
                        < req.priority and self._preempt_for_pages()):
                    self._head = req
                    continue
                with self._lock:
                    self._pending_seq += 1
                    heapq.heappush(
                        self._pending,
                        (-req.priority, req._vft,
                         self._pending_seq, req))
                return None
            except (ValueError, RuntimeError) as e:
                # identical args per copy, so only the FIRST begin can
                # fail on validation (the scheduler pulls only with a
                # free slot, ruling out engine-full) — no
                # partially-errored requests
                self._requests_rejected += 1
                self._push(req, {"error": str(e), "code": 400})
                self._finish_request(req, "rejected")
                continue
            idx = req.admitted
            req.admitted += 1
            req.emitted[idx] = 0
            self._tickets[ticket] = (req, idx)
            if req.admitted < req.n:
                self._head = req  # the next pull continues this req
            return ticket

    def _ensure_grammar(self, req: _Request) -> int:
        """Engine-side grammar registration for *req*'s pattern
        (scheduler thread — the engine's sole owner); the gid cache
        makes it once-per-pattern, so the steady state is a dict
        lookup."""
        with self._glock:
            gid = self._grammar_gids.get(req.grammar_key)
        if gid is None:
            gid = self.engine.register_grammar(req.grammar_tdfa)
            with self._glock:
                # one critical section for the registered/pending
                # handoff: handler threads read BOTH maps for the
                # max_grammars bound and the compile-skip check, so
                # the insert and the pop must land atomically.
                # Dropping the standalone TokenDfa matters too:
                # keeping it would pin a second full [N, V] host copy
                # per pattern for the server's lifetime
                self._grammar_gids[req.grammar_key] = gid
                self._grammar_tdfas.pop(req.grammar_key, None)
        req.grammar_tdfa = None  # registered; drop the ref
        return gid

    def _push(self, req: _Request, ev) -> bool:
        """Queue *ev* for *req*'s connection without ever blocking the
        scheduler.  Event queues are BOUNDED (slow-client protection):
        a full queue means the client stopped draining, and the
        documented policy is disconnect, not unbounded buffering — the
        request is cancelled (the scheduler sweep releases its slots),
        the oldest undelivered event is dropped to make room, and a
        terminal 503 lands so a handler blocked in ``events.get()``
        wakes up and closes the connection."""
        try:
            req.events.put_nowait(ev)
            return True
        except queue.Full:
            if not req.dropped:
                req.dropped = True
                req.cancelled = True
                self._m_dropped.inc()
                self.recorder.record("tpu_serve_slow_client_drop",
                                     trace=req.trace, rid=req.rid)
                self._finish_request(req, "dropped")
                try:
                    req.events.get_nowait()
                except queue.Empty:
                    pass
                try:
                    req.events.put_nowait({
                        "error": "client not draining its stream; "
                                 "disconnecting (slow-client policy)",
                        "code": 503})
                except queue.Full:
                    pass
            return False

    def _emit(self, slot: int, req: _Request, idx: int,
              tokens: List[int]) -> None:
        """Push copy *idx*'s unseen tokens, honoring the budget and
        retiring the slot when the copy is done; the request completes
        when ALL n copies have.  The hot path coalesces each run_scan
        window's tokens into ONE pre-serialized JSON-lines frame
        (``{"tokens": [...]}``) — no per-token dict, dumps, or queue
        round-trip; ``per_token`` (and logprobs, whose stats are
        per-token) fall back to the legacy ``{"token": t}`` events.
        With a tokenizer, stop STRINGS are matched against the
        detokenized stream (a match truncates the copy there) and
        "text" deltas ride alongside the token frames, holding back
        any tail that could still become a stop string."""
        eng = self.engine
        seen = req.emitted[idx]
        new = tokens[seen:req.max_new_tokens]
        if new and not req.ttft_observed and req.t_arrival:
            # first generated token of ANY copy: the TTFT the client
            # perceives (queue wait + prefill + first window); the
            # trace-id rides along as the bucket's OpenMetrics exemplar
            req.ttft_observed = True
            ttft_dt = time.perf_counter() - req.t_arrival
            req.ttft_s = ttft_dt  # the SLO verdict reads this back
            self._m_ttft.observe(
                ttft_dt,
                trace_id=(req.trace.trace_id if req.trace else None))
            self._mark(req, "tpu_serve_ttft", ttft_dt)
        st = None
        if (req.stop_strs or req.detokenize) and self.tokenizer:
            st = req.detok.setdefault(idx, _DetokState())
            st.feed(self.tokenizer, tokens, min(len(tokens),
                                                req.max_new_tokens))
        stop_text = None  # truncated text when a stop string matched
        stop_keep = None  # tokens kept by the match (<= seen possible)
        if req.stop_strs and new:
            # min_tokens floors stop strings too (vLLM: no stop check
            # below the floor): scanning starts only past the floor, so
            # a match can only complete at token min_tokens+1 or later
            keep = scanned = None
            if seen + len(new) > req.min_tokens:
                scanned = True
                start = req.stop_scanned.get(idx, 0)
                while True:
                    keep, text = _find_stop(st, req.stop_strs, start)
                    if keep is None or keep > req.min_tokens:
                        break
                    # a match COMPLETING at or below the floor never
                    # fires (vLLM: no stop check below min_tokens) —
                    # resume scanning past its completion instead of
                    # clamping the cut to the floor, which used to
                    # leave the ids surface at min_tokens+1 while the
                    # text was cut at the (pre-floor) match start
                    start = st.cum[keep]
            if keep is not None:
                # kept tokens include the completing token; keep may
                # sit BELOW tokens already streamed (a detok stall or
                # floor-deferred scan) — the final tokens array
                # truncates to the kept count either way, so the ids
                # and text surfaces of one response always agree
                # (streamed frames past the match cannot be
                # unsent, the final array is authoritative)
                new = tokens[seen:keep] if keep > seen else []
                stop_text = text
                stop_keep = keep
            elif scanned:
                # resume point advances ONLY past text a scan actually
                # covered — below the floor nothing was scanned, and a
                # match there must still surface at the first
                # post-floor scan
                req.stop_scanned[idx] = len(st.text)
        lps = (eng.token_logprobs(slot) if req.logprobs else None)
        if new and req.stream and not req.openai:
            # OpenAI streams carry text deltas only (raw ids never hit
            # that wire); non-streaming requests need just the final
            # event — neither pays for token frames
            if lps is not None or req.per_token:
                # legacy per-token shape (and logprobs, whose stats
                # are inherently per-token)
                for j, t in enumerate(new):
                    ev = {"token": int(t)}
                    if req.n > 1:
                        ev["index"] = idx
                    if lps is not None:
                        clp, top = lps[seen + j]
                        ev["logprob"] = clp
                        ev["top_logprobs"] = [[i, p] for i, p in top]
                    if not self._push(req, ev):
                        break
            else:
                # engine-rate hot path: the whole window in one
                # pre-encoded frame, one queue hop, one client write
                self._push(req, _tokens_frame(new, idx, req.n))
        req.emitted[idx] = seen + len(new)
        finished = eng.finished(slot)
        done = (stop_text is not None
                or req.emitted[idx] >= req.max_new_tokens or finished)
        if req.detokenize and req.stream:
            # the committed incremental text (never ends mid-char:
            # _DetokState withholds UTF-8-unstable tails, so the old
            # U+FFFD backscan is structurally unnecessary), capped at
            # the emitted token count; a stop match overrides with its
            # truncation.  An eos finish excludes the eos token from
            # the TEXT (OpenAI/vLLM semantics: special tokens never
            # reach text; the ids surface keeps it)
            n_text = req.emitted[idx]
            if (stop_text is None and finished and n_text
                    and eng.finish_reason(slot) == "eos"
                    and int(tokens[n_text - 1]) == eng.eos_id):
                n_text -= 1
            cur = (stop_text if stop_text is not None
                   else st.text[:st.cum[n_text]])
            hold = (0 if done or not req.stop_strs
                    else _holdback(cur, req.stop_strs))
            safe = len(cur) - hold
            # if an earlier emission turns out to mismatch (a stop
            # truncation rewrote history), stop emitting deltas; the
            # final event carries the authoritative full text
            sent = req.text_sent.get(idx, "")
            if cur[:len(sent)] == sent and safe > len(sent):
                ev = {"text": cur[len(sent):safe]}
                if req.n > 1:
                    ev["index"] = idx
                self._push(req, ev)
                req.text_sent[idx] = cur[:safe]
        if req.cancelled:
            eng.release(slot)
            del self._running[slot]
            return
        if done:
            if stop_text is not None:
                out = tokens[:stop_keep]
                reason = "stop"
            else:
                full = eng.output(slot)
                out = full[:req.max_new_tokens]
                if finished and len(full) <= req.max_new_tokens:
                    # the engine's own verdict (eos / stop / length)
                    reason = eng.finish_reason(slot) or "length"
                else:
                    # budget cut the stream before (or at) the
                    # engine's retirement point
                    reason = "length"
            # session tiering: a conversation's retiring slot parks as
            # its device tier (KV pages + record stay, slot reserved)
            # instead of releasing — the next turn warm-resumes.
            # Parking reads the slot's live lens/outputs, so it must
            # happen HERE, before any release resets them; logprob
            # records survive the park exactly as they survive a
            # release.
            if not self._park_session(req, slot, len(out)) \
                    and not finished:
                eng.release(slot)
            choice = {
                "index": idx,
                "tokens": [int(t) for t in out],
                "finish_reason": reason,
            }
            if req.detokenize:
                text_ids = [int(t) for t in out]
                if (stop_text is None and reason == "eos" and text_ids
                        and text_ids[-1] == eng.eos_id):
                    # eos is data on the ids surface, never text
                    text_ids = text_ids[:-1]
                choice["text"] = (
                    stop_text if stop_text is not None
                    else self.tokenizer.decode(text_ids))
            if req.logprobs:
                choice["logprobs"] = [
                    {"logprob": clp,
                     "top_logprobs": [[i, p] for i, p in top]}
                    for clp, top in
                    eng.token_logprobs(slot)[:len(out)]
                ]
            if req.prompt_logprobs and idx == 0:
                choice["prompt_logprobs"] = [
                    None if rec is None else
                    {"logprob": rec[0],
                     "top_logprobs": [[i, p] for i, p in rec[1]]}
                    for rec in eng.prompt_logprobs(slot)
                ]
            del self._running[slot]
            req.choices.append(choice)
            if len(req.choices) == req.n:
                if req.n == 1:
                    done = {"done": True, **req.choices[0]}
                    del done["index"]  # single-completion wire shape
                else:
                    done = {"done": True, "choices": sorted(
                        req.choices, key=lambda c: c["index"])}
                    if req.prompt_logprobs:
                        # identical across copies — attached ONCE,
                        # from the one copy that computed them
                        for ch in done["choices"]:
                            if "prompt_logprobs" in ch:
                                done["prompt_logprobs"] = ch.pop(
                                    "prompt_logprobs")
                # count BEFORE the event lands: a client reacting to
                # the final chunk must not read a stale /stats counter
                self._requests_served += 1
                self._push(req, done)
                self._finish_request(req, "ok")

    def _park_session(self, req: "_Request", slot: int,
                      kept: int) -> bool:
        """Park the retiring slot as *req*'s session device tier.
        Returns False — caller releases as before — whenever tiering
        is off, inapplicable (multi-copy, dropped client, prefill
        side), or the park fails; parking is strictly best-effort."""
        store = self._session_store
        if (store is None or not req.session or req.n != 1
                or req.dropped or req.prefill_only or req.cancelled):
            return False
        try:
            canon = self.engine.park_session(slot, req.session, kept)
        except Exception as e:
            suppressed("server.park_session", e, log)
            return False
        now_s = time.monotonic()
        store.note_parked(req.session, slot, now_s)
        self.recorder.record(
            "tpu_kv_park", trace=req.trace, rid=req.rid, slot=slot,
            session=sid_hash(req.session), canon=canon)
        return True

    def _scheduler_loop(self) -> None:
        eng = self.engine
        sched = self._sched
        while not self._stop.is_set():
            # drop requests whose client went away: running slots and
            # admissions still prefilling alike
            for slot, (req, _idx) in list(self._running.items()):
                if req.cancelled:
                    eng.release(slot)
                    del self._running[slot]
            for ticket, (req, _idx) in list(self._tickets.items()):
                if req.cancelled:
                    sched.cancel(ticket)
                    del self._tickets[ticket]
            if self._session_store is not None:
                # tiering policy tick (engine ops are scheduler-thread
                # only): idle demotions, host-cap/disk GC, handler
                # export requests, and — when admissions are waiting —
                # slot-pressure demotion of parked sessions
                self._session_store.tick(
                    time.monotonic(),
                    slot_pressure=self._intake_waiting())
            if (not self._running and not sched.busy()
                    and not self._intake_waiting()):
                # idle: wait for work without spinning (admission is
                # priority-then-FIFO; requests stay in the heap).  The
                # wait is the loop's "idle" phase — the denominator of
                # the device duty-cycle gauge
                t_idle = time.perf_counter()
                sched.begin_phase("idle")
                self._work.wait(timeout=_IDLE_POLL_S)
                self._work.clear()
                sched.note_phase("idle",
                                 time.perf_counter() - t_idle)
                continue
            # chaos hooks (serve.step / serve.schedule) fire INSIDE
            # iterate, after admission work and before the decode
            # round — an armed fault can never crash an idle loop, and
            # a crashed iteration's requests are already ticket-bound
            # so the supervisor's drain 503s every one of them
            t_win = time.perf_counter()
            # one scheduler iteration: admission work (pull, prefill
            # chunks, finishes) interleaved with at most one decode
            # round — scan window, spec round, jump round, or endgame
            # step (the scheduler replicates the old adaptive choice)
            if self._sched_watchdog is not None:
                res = self._sched_watchdog.call(sched.iterate)
            else:
                res = sched.iterate()
            win_dt = time.perf_counter() - t_win
            # admissions were bound + their first tokens emitted the
            # moment they resolved (the scheduler's on_admit callback
            # fires mid-window); only decode output is left to stream
            if not res.steps:
                continue
            t_stream = time.perf_counter()
            sched.begin_phase("stream")
            for slot, (req, idx) in list(self._running.items()):
                before = req.emitted.get(idx, 0)
                self._emit(slot, req, idx, eng.output(slot))
                k = req.emitted.get(idx, 0) - before
                if k > 0:
                    # the stream's inter-token latency this window:
                    # window wall time spread over its k tokens,
                    # weighted by token count (one bulk observe)
                    self._m_token.observe_n(win_dt / k, k)
                    self._mark(req, "tpu_serve_window", win_dt,
                               tokens=k, slot=slot)
            # the post-harvest emit work is the loop's "stream" phase:
            # with --overlap-dispatch the next window is already on
            # the device underneath it (that is the overlap's win)
            sched.note_phase("stream",
                             time.perf_counter() - t_stream)
        # the scheduler owns _running/_head: it performs the shutdown
        # drain itself so stop() never mutates them while a device step
        # is still in flight (a stuck 5s join used to race here)
        if self._session_store is not None:
            # a clean shutdown pushes every parked conversation to the
            # disk tier: the respawned generation rehydrates them
            # lazily on first touch
            self._session_store.spill_all(time.monotonic())
        self._drain_on_stop()

    def _intake_waiting(self) -> bool:
        """Anything in the priority heap (or a partially-admitted n>1
        head) the scheduler could pull?"""
        with self._lock:
            return bool(self._pending) or self._head is not None

    def _budget_hint(self, slot: int):
        """Remaining-token hint for the scheduler's adaptive window:
        how many more steps this slot's request needs.  None (= stay
        at the window floor) for stop-STRING requests — their cut is
        a server-side text scan, so harvest granularity is the only
        thing bounding post-stop garbage decode."""
        binding = self._running.get(slot)
        if binding is None:
            return None
        req, idx = binding
        if req.stop_strs:
            return None
        return max(1, req.max_new_tokens - req.emitted.get(idx, 0))

    def _bind_admitted(self, ticket) -> None:
        """An admission went live (the scheduler's on_admit callback,
        possibly MID-WINDOW): bind the slot into ``_running`` and
        stream the admission's first sampled token right away."""
        eng = self.engine
        binding = self._tickets.pop(ticket, None)
        if binding is None:
            # cancelled after its splice landed: free the slot
            eng.release(ticket.slot)
            return
        req, idx = binding
        admit_dt = ticket.t_done - ticket.t_begin
        self._m_admit.observe(admit_dt)
        self._mark(req, "tpu_serve_admit", admit_dt,
                   slot=ticket.slot, copy=idx,
                   chunks=ticket.chunks_total,
                   mid_window=ticket.mid_window)
        if (req.prefill_only and not req.cancelled
                and not eng.finished(ticket.slot)
                and req.max_new_tokens > 1):
            # disaggregated prefill: the admission (packed prefill +
            # first token) is exactly the work this replica class
            # exists for — checkpoint the fresh slot bit-exactly to
            # host, free its pages, and hand the state to the handler
            # thread, which answers the router with the serialized
            # payload instead of a token stream.  A request that
            # already FINISHED at its first token (eos/stop, or a
            # 1-token budget) has nothing left to migrate: it falls
            # through and this replica serves the complete response
            # itself (the router passes it straight through).
            self._export_migration(req, ticket.slot)
            return
        self._running[ticket.slot] = (req, idx)
        self._emit(ticket.slot, req, idx, eng.output(ticket.slot))

    def _export_migration(self, req: _Request, slot: int) -> None:
        """Checkpoint a freshly-admitted prefill-only slot and hand
        the state to the request's handler thread (scheduler thread —
        preempt is an engine call).  Grammar state is re-based to
        grammar-LOCAL form so the decode replica can re-home it onto
        its own combined table regardless of registration order."""
        eng = self.engine
        try:
            state = eng.preempt(slot)
        except (RuntimeError, ValueError) as e:
            # cannot checkpoint (should not happen on a paged engine
            # with an active slot): serve the request here instead of
            # failing it — correctness over topology
            log.warning("prefill-only export failed (%s); serving "
                        "locally", e)
            self.recorder.record("tpu_serve_migrate_declined",
                                 trace=req.trace, rid=req.rid,
                                 error=str(e))
            self._running[slot] = (req, 0)
            self._emit(slot, req, 0, eng.output(slot))
            return
        if req.grammar_key is not None:
            state["gstate"] = eng.grammar_rel(int(state["gstate"]))
            state["gstate_rel"] = True
        self._mig_out.inc()
        self.recorder.record("tpu_serve_migrate_out",
                             trace=req.trace, rid=req.rid, slot=slot,
                             tokens=len(req.tokens),
                             outputs=len(state["outputs"]))
        self._push(req, {"__migrate__": state})
        self._finish_request(req, "migrated")

    def _admit_pending(self) -> None:
        """Synchronously admit every queued request copy that fits —
        the pre-scheduler cadence, kept as the deterministic hook for
        tests and embedders that drive the engine without the loop
        thread (the loop itself admits through ``iterate()``, where
        prefill interleaves with open decode windows).  Binding and
        first-token emission ride the scheduler's on_admit callback."""
        self._sched._drain_admissions()

    def warm_scheduler(self) -> None:
        """Pre-compile the scheduler's quantized adaptive-window scan
        variants AND the ragged packed-prefill shape set.  Every
        distinct window length — and every pack size's [K, chunk]
        extend — is its own CUDA-graph capture; without this, the FIRST
        synchronized batch (or packed convoy) eats seconds of compile
        mid-traffic.  The CLI and the serving bench call it before
        taking traffic; tests that never hit grown windows skip the
        cost.  Call BEFORE start() or while idle — it drives the
        engine directly.

        Observes ``tpu_serve_warmup_seconds{phase}`` so replica
        cold-start cost is a dashboard number; with a warm
        ``--compile-cache-dir`` the phases collapse to cache loads
        (the cold-start bench asserts the delta)."""
        eng = self.engine
        t_start = time.perf_counter()
        slot = eng.admit([0], ignore_eos=True)
        try:
            for k in range(1, ADAPTIVE_WINDOW_FACTOR + 1):
                n = self.window * k
                if eng.lens[slot] + n > eng.model.max_len:
                    break
                eng.run_scan(n)
        finally:
            eng.release(slot)
        t_scan = time.perf_counter()
        self._m_warmup.labels(phase="scan").set(t_scan - t_start)
        if self._sched._packing:
            # only when the scheduler can actually pack (chunked
            # engine, no MoE): a shape the packed path never
            # dispatches is compile time for nothing
            eng.warm_packed(
                range(2, self._sched.max_pack + 1))
            self._m_warmup.labels(phase="packed_prefill").set(
                time.perf_counter() - t_scan)
        self._m_warmup.labels(phase="total").set(
            time.perf_counter() - t_start)

    def _scheduler_supervisor(self) -> None:
        """Crash containment for the engine's sole owner.  A scheduler
        crash used to be a silent hang: the thread died, every
        connected client blocked forever on its event queue, and
        /healthz kept answering ok.  Now each crash 503s the in-flight
        requests (their slots released) and restarts the loop with
        capped backoff; a crash LOOP (``_SCHED_MAX_RESTARTS`` in a row
        without ``_SCHED_CRASH_RESET_S`` of clean running) marks the
        server dead — new requests get an immediate 503 and /healthz
        fails so the orchestrator replaces the pod."""
        crashes = 0
        last_crash = 0.0
        while not self._stop.is_set():
            try:
                self._scheduler_loop()
                return  # clean stop-path exit; loop already drained
            except Exception as e:
                now = time.monotonic()
                crashes = (1 if now - last_crash > _SCHED_CRASH_RESET_S
                           else crashes + 1)
                last_crash = now
                log.exception("engine scheduler crashed (%d/%d)",
                              crashes, _SCHED_MAX_RESTARTS)
                self._m_sched_crashes.inc()
                self.recorder.record(
                    "tpu_serve_scheduler_crash",
                    error=f"{type(e).__name__}: {e}", crashes=crashes)
                # invalidate the crashed iteration FIRST: a
                # watchdog-abandoned worker that wakes later re-checks
                # the generation and bails before touching the engine
                # the restarted loop now owns; pending admissions are
                # aborted (their requests 503 in the drain below)
                try:
                    self._sched.supersede()
                except Exception as se:
                    log.debug("post-crash scheduler supersede "
                              "failed: %s", se)
                # contain: free every engine slot (their device state
                # is suspect after an arbitrary crash point) and 503
                # the requests that were riding them
                for slot in list(self._running):
                    try:
                        self.engine.release(slot)
                    except Exception as re:
                        log.debug("post-crash release of slot %s "
                                  "failed: %s", slot, re)
                self._drain_on_stop(
                    "engine scheduler crashed; request aborted — "
                    "retry")
                if crashes >= _SCHED_MAX_RESTARTS:
                    break
                self._m_sched_restarts.inc()
                self.recorder.record("tpu_serve_scheduler_restart",
                                     attempt=crashes)
                if self._stop.wait(min(0.05 * (2 ** (crashes - 1)),
                                       _SCHED_BACKOFF_MAX_S)):
                    return
        if self._stop.is_set():
            return
        # permanent death: drain the pending heap too and refuse new
        # work at admission (see _enqueue) and /healthz
        self._sched_dead = True
        self.recorder.record("tpu_serve_scheduler_dead",
                             crashes=crashes)
        log.error("engine scheduler dead after %d consecutive "
                  "crashes; serving 503s until restarted", crashes)
        bye = {"error": "engine scheduler crashed; server needs a "
                        "restart", "code": 503}
        with self._lock:
            drained, self._pending = self._pending, []
        for *_k, req in drained:
            self._push(req, dict(bye))
            self._finish_request(req, "shutdown")

    def _drain_on_stop(self, reason: str = "server shutting down"
                       ) -> None:
        """Send every connected client a terminal 503. Idempotent."""
        bye = {"error": reason, "code": 503}
        try:
            self._sched.supersede()  # abort in-flight admissions
        except Exception as se:
            log.debug("drain-time scheduler supersede failed: %s", se)
        notified = set()
        for req, _idx in self._running.values():
            if id(req) not in notified:
                notified.add(id(req))
                self._push(req, dict(bye))
                self._finish_request(req, "shutdown")
        self._running.clear()
        # admissions still prefilling when the loop died: same 503
        # (their tickets were aborted by supersede/stop — the slot
        # reservation is gone either way)
        for req, _idx in self._tickets.values():
            if id(req) not in notified:
                notified.add(id(req))
                self._push(req, dict(bye))
                self._finish_request(req, "shutdown")
        self._tickets.clear()
        if self._head is not None:
            if id(self._head) not in notified:
                self._push(self._head, dict(bye))
                self._finish_request(self._head, "shutdown")
            self._head = None

    # -- lifecycle ----------------------------------------------------------

    def start(self, host: str = "0.0.0.0", port: int = 8000
              ) -> "EngineServer":
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # per-connection socket deadline: a peer that stops
            # reading AND writing cannot pin a pool worker forever
            timeout = server.client_timeout

            def do_GET(self):  # noqa: N802 (http.server API)
                self._trace = None  # keep-alive: no stale echo
                url = urlparse(self.path)
                if url.path == "/healthz":
                    if server.healthy():
                        self._send(200, "text/plain", "ok\n")
                    else:
                        # a dead scheduler must flunk the liveness
                        # probe, not keep the pod looking fine while
                        # every request 503s
                        self._send(503, "text/plain",
                                   "engine scheduler dead\n")
                elif url.path == "/stats":
                    body = json.dumps(server.stats(), indent=2)
                    self._send(200, "application/json", body + "\n")
                elif url.path == "/statz":
                    # the router's load-signal poll: small, flat, and
                    # in lock-step with the /metrics families (see
                    # statz()); kept off /stats so the router never
                    # pays for the full engine dump
                    self._send(200, "application/json",
                               json.dumps(server.statz()) + "\n")
                elif url.path == "/metrics":
                    # Prometheus exposition (vLLM's server exposes
                    # /metrics; scrape configs expect it from a
                    # serving pod): the obs registry — request/TTFT/
                    # per-token histograms, shed counters — plus the
                    # bridged engine stats.  The OpenMetrics Accept
                    # type additionally gets trace-id exemplars + EOF;
                    # the plain exposition is byte-compatible with
                    # pre-exemplar scrapes
                    om = obs.negotiate_openmetrics(
                        self.headers.get("Accept"))
                    try:
                        body = server.render_metrics(openmetrics=om)
                    except Exception:
                        log.exception("/metrics render failed")
                        self._send(500, "text/plain",
                                   "internal error; see server logs\n")
                        return
                    self._send(
                        200,
                        obs.OPENMETRICS_CONTENT_TYPE if om
                        else obs.TEXT_CONTENT_TYPE,
                        body)
                elif url.path == "/alerts":
                    # alert-evaluator surface: every rule's
                    # state machine + the firing roll-up, same schema
                    # on all four HTTP surfaces
                    self._send(200, "application/json",
                               server.alerts.status_json() + "\n")
                elif url.path == "/debug/query":
                    # retained-series readback: ?expr=&range= against
                    # the in-process TSDB (rate()/increase()/
                    # avg_over_time()/histogram_quantile over the ring
                    # buffers the background tick fills)
                    params = {k: v[0] for k, v
                              in parse_qs(url.query).items()}
                    try:
                        body_s = server.tsdb.handle_query_json(params)
                    except ValueError as e:
                        self._send(400, "application/json", json.dumps(
                            {"error": str(e)}) + "\n")
                        return
                    self._send(200, "application/json", body_s + "\n")
                elif url.path == "/debug/traces":
                    # ?trace_id=… -> that trace's event timeline;
                    # without it, the recent-trace index
                    q = parse_qs(url.query)
                    tid = q.get("trace_id", [None])[0]
                    if tid:
                        body = {"trace_id": tid,
                                "events": server.recorder.events(
                                    trace_id=tid)}
                    else:
                        body = {"traces": server.recorder.trace_ids()}
                    self._send(200, "application/json",
                               json.dumps(body, indent=2) + "\n")
                elif url.path == "/debug/events":
                    # ?since=<wall seconds> -> events after that stamp
                    q = parse_qs(url.query)
                    try:
                        since = float(q.get("since", ["0"])[0])
                    except ValueError:
                        self._send(400, "application/json", json.dumps(
                            {"error": "'since' must be a unix "
                                      "timestamp"}) + "\n")
                        return
                    body = {"since": since,
                            "dropped": server.recorder.dropped,
                            "events": server.recorder.events(
                                since=since)}
                    self._send(200, "application/json",
                               json.dumps(body, indent=2) + "\n")
                elif url.path == "/debug/profile":
                    # continuous-profiling hook: capture ?seconds=N of
                    # torch.profiler trace into --profile-dir.  Blocking
                    # (the worker sleeps through the capture), single-
                    # flight (concurrent capture answers 409)
                    q = parse_qs(url.query)
                    try:
                        seconds = float(q.get("seconds", ["1"])[0])
                    except ValueError:
                        self._send(400, "application/json", json.dumps(
                            {"error": "'seconds' must be a number"})
                            + "\n")
                        return
                    try:
                        out = server.profile(seconds)
                    except ValueError as e:
                        self._send(400, "application/json",
                                   json.dumps({"error": str(e)}) + "\n")
                        return
                    except RuntimeError as e:
                        self._send(409, "application/json",
                                   json.dumps({"error": str(e)}) + "\n")
                        return
                    except Exception as e:
                        log.exception("/debug/profile capture failed")
                        self._send(500, "application/json", json.dumps(
                            {"error": f"profiler failed: {e}"}) + "\n")
                        return
                    self._send(200, "application/json",
                               json.dumps(out) + "\n")
                elif url.path == "/debug/pprof":
                    # the always-on sampling profiler's ring:
                    # ?seconds=N&format=folded|json — folded stacks
                    # pipe straight into flamegraph.pl / speedscope
                    try:
                        ctype, body = server.profiler.handle_pprof(
                            parse_qs(url.query))
                    except ValueError as e:
                        self._send(400, "application/json",
                                   json.dumps({"error": str(e)}) + "\n")
                        return
                    self._send(200, ctype, body)
                else:
                    self._send(404, "text/plain", "not found\n")

            def do_POST(self):  # noqa: N802
                # trace intake: continue the caller's traceparent as a
                # child context, or open a fresh root (malformed
                # headers fall back, never reject); every response
                # path echoes the trace-id back (see _send)
                self._trace = obs.trace_from_header(
                    self.headers.get("traceparent"))
                if self.path == "/v1/completions":
                    self._openai_completions(chat=False)
                    return
                if self.path == "/v1/chat/completions":
                    self._openai_completions(chat=True)
                    return
                if self.path == "/migrate":
                    self._migrate()
                    return
                if self.path == "/session/export":
                    self._session_export()
                    return
                if self.path == "/session/import":
                    self._session_import()
                    return
                if self.path != "/generate":
                    self._send(404, "text/plain", "not found\n")
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(length))
                except (ValueError, TypeError) as e:
                    self._send(400, "application/json",
                               json.dumps({"error": str(e)}) + "\n")
                    return
                self._generate(body)

            def _generate(self, body, migrate_state=None,
                          migrate_budget=None):
                """The native /generate path; also the resume half of
                /migrate (a checkpoint rides in as *migrate_state*
                with the prefill replica's capped *migrate_budget*)."""
                try:
                    req = server._parse_request(body,
                                                trace=self._trace)
                    if migrate_state is not None:
                        server._attach_migration(req, migrate_state,
                                                 migrate_budget)
                except (ValueError, TypeError, KeyError) as e:
                    self._send(400, "application/json",
                               json.dumps({"error": str(e)}) + "\n")
                    return
                server._enqueue(req)
                try:
                    if req.prefill_only:
                        self._migrate_reply(req, body, "/generate")
                    elif req.stream:
                        self._stream(req)
                    else:
                        self._collect(req)
                except (BrokenPipeError, ConnectionResetError,
                        TimeoutError):
                    req.cancelled = True
                    server._note_client_abandon(req)
                    server._finish_request(req, "cancelled")

            def _migrate(self):
                """POST /migrate (internal, replica-to-replica via the
                router): resume a prefill replica's checkpoint into a
                slot here and serve the request's stream from where
                prefill left off."""
                length = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(length) if length else b""
                try:
                    payload = load_payload(raw)
                    path = payload["path"]
                    body = payload["body"]
                    state = payload["state"]
                    budget = int(payload["budget"])
                    if path not in ("/generate", "/v1/completions",
                                    "/v1/chat/completions"):
                        raise MigrateError(f"bad path {path!r}")
                    if not isinstance(body, dict) \
                            or not isinstance(state, dict):
                        raise MigrateError(
                            "body and state must be objects")
                except (MigrateError, KeyError, TypeError,
                        ValueError) as e:
                    self._send(400, "application/json", json.dumps(
                        {"error": f"bad migration payload: {e}"})
                        + "\n")
                    return
                pool = getattr(server.engine, "_pool", None)
                if not getattr(server.engine, "kv_paging", False) \
                        or pool is None:
                    # a replica without a paged pool cannot resume a
                    # checkpoint: 503 so the router retries elsewhere
                    self._send(503, "application/json", json.dumps(
                        {"error": "replica cannot resume migrated KV "
                                  "state (no paged pool)",
                         "code": 503}) + "\n")
                    return
                lens = int(state.get("lens", 0))
                if lens < 1 or lens > server.engine.model.max_len \
                        or pool.pages_needed(lens) > pool.n_pages:
                    self._send(503, "application/json", json.dumps(
                        {"error": f"checkpoint of {lens} tokens does "
                                  "not fit this replica's pool",
                         "code": 503}) + "\n")
                    return
                if path == "/generate":
                    self._generate(body, migrate_state=state,
                                   migrate_budget=budget)
                else:
                    self._openai_completions(
                        chat=path.endswith("/chat/completions"),
                        body=body, migrate_state=state,
                        migrate_budget=budget)

            def _session_export(self):
                """POST /session/export (internal, router-driven):
                hand a parked session's checkpoint to the replica the
                router now routes the session to (single-owner move —
                the local copy is dropped on success)."""
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(length))
                    sid = str(body.get("session_id") or "")
                    if not sid:
                        raise ValueError("session_id required")
                except (ValueError, TypeError) as e:
                    self._send(400, "application/json",
                               json.dumps({"error": str(e)}) + "\n")
                    return
                store = server._session_store
                if store is None:
                    self._send(503, "application/json", json.dumps(
                        {"error": "session tiering disabled",
                         "code": 503}) + "\n")
                    return
                try:
                    payload = store.export_session(sid)
                except KeyError:
                    self._send(404, "application/json", json.dumps(
                        {"error": "unknown session"}) + "\n")
                    return
                except Exception as e:
                    log.warning("session export %s failed: %s", sid, e)
                    self._send(503, "application/json", json.dumps(
                        {"error": f"session export failed: {e}",
                         "code": 503}) + "\n")
                    return
                self._send_bytes(200, MIGRATE_CONTENT_TYPE, payload)

            def _session_import(self):
                """POST /session/import (internal, router-driven):
                accept another replica's session checkpoint into the
                host tier; the session's first request here promotes
                it to device."""
                store = server._session_store
                if store is None:
                    self._send(503, "application/json", json.dumps(
                        {"error": "session tiering disabled",
                         "code": 503}) + "\n")
                    return
                length = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(length) if length else b""
                try:
                    sid = store.import_payload(raw, time.monotonic())
                except (MigrateError, ValueError, TypeError) as e:
                    self._send(400, "application/json", json.dumps(
                        {"error": f"bad session payload: {e}"}) + "\n")
                    return
                self._send(200, "application/json", json.dumps(
                    {"ok": True, "session": sid_hash(sid)}) + "\n")

            def _migrate_reply(self, req: _Request, body, path,
                               openai=False, model_name=None,
                               chat=False):
                """Answer a prefill_only request: the serialized
                checkpoint payload (the router ships it to a decode
                replica) — or, when the scheduler declined (the
                request FINISHED at its first token), the normal
                response the client expects anyway."""
                first = req.events.get()
                if isinstance(first, dict) and "error" in first:
                    if openai:
                        self._openai_error(first.get("code", 400),
                                           first["error"])
                    else:
                        self._send(first.get("code", 400),
                                   "application/json",
                                   json.dumps(first) + "\n")
                    return
                if isinstance(first, dict) and "__migrate__" in first:
                    payload = dump_payload({
                        "path": path,
                        "body": {k: v for k, v in body.items()
                                 if k != "prefill_only"},
                        "state": first["__migrate__"],
                        # the budget as THIS replica capped it (prompt
                        # + budget must fit max_len) — the decode
                        # replica adopts it instead of re-deriving
                        "budget": req.max_new_tokens,
                    })
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     MIGRATE_CONTENT_TYPE)
                    self.send_header("Content-Length",
                                     str(len(payload)))
                    self._trace_headers()
                    self.end_headers()
                    self.wfile.write(payload)
                    return
                # declined at bind (finished at the first token):
                # serve the normal response, starting from the event
                # already in hand
                if openai:
                    if req.stream:
                        self._openai_stream(req, model_name, chat,
                                            first=first)
                    else:
                        self._openai_collect(req, model_name, chat,
                                             first=first)
                elif req.stream:
                    self._stream(req, first=first)
                else:
                    self._collect(req, first=first)

            def _openai_completions(self, chat: bool = False,
                                    body=None, migrate_state=None,
                                    migrate_budget=None):
                """OpenAI-compatible text completions (the interface
                vLLM serves first): translate the body onto the native
                request, answer in the OpenAI wire shape — streamed as
                SSE `data:` chunks or one JSON object.  /migrate
                resumption rides in via *body* + *migrate_state*."""
                stream = False
                try:
                    if body is None:
                        length = int(
                            self.headers.get("Content-Length", 0))
                        body = json.loads(self.rfile.read(length))
                    stream = bool(body.get("stream", False))
                    native, model_name = (
                        server._openai_chat_to_native(body) if chat
                        else server._openai_to_native(body))
                    if body.get("prefill_only"):
                        # the router's disagg marker rides through the
                        # OpenAI translation like any native field
                        native["prefill_only"] = True
                    if stream and native.get("logprobs") is not None:
                        # explicit 400 beats silently dropping the
                        # data: the SSE chunks carry text deltas that
                        # do not align 1:1 with tokens
                        raise ValueError(
                            "logprobs with stream=true is not "
                            "supported; request them unstreamed")
                    req = server._parse_request(native,
                                                trace=self._trace)
                    if migrate_state is not None:
                        server._attach_migration(req, migrate_state,
                                                 migrate_budget)
                    if native.get("_lp_count") is not None:
                        # the client-requested count (may be 0): the
                        # response trims the engine's top list to it
                        req.openai_logprobs = native["_lp_count"]
                    req.echo = bool(native.get("_echo"))
                    if req.echo:
                        # the ORIGINAL prompt string when the client
                        # sent one (decode(req.tokens) would echo the
                        # tokenizer's BOS/special text); token-array
                        # prompts decode skipping specials when the
                        # tokenizer supports it
                        if isinstance(native.get("prompt"), str):
                            req.echo_text = native["prompt"]
                        else:
                            try:
                                req.echo_text = server.tokenizer.decode(
                                    req.tokens,
                                    skip_special_tokens=True)
                            except TypeError:  # minimal test fakes
                                req.echo_text = server.tokenizer.decode(
                                    req.tokens)
                    req.include_usage = bool(
                        native.get("_include_usage"))
                except (ValueError, TypeError, KeyError) as e:
                    self._openai_error(400, str(e))
                    return
                req.openai = True   # text deltas only on this wire
                req.stream = stream
                server._enqueue(req)
                try:
                    if req.prefill_only:
                        self._migrate_reply(
                            req, body,
                            "/v1/chat/completions" if chat
                            else "/v1/completions",
                            openai=True, model_name=model_name,
                            chat=chat)
                    elif stream:
                        self._openai_stream(req, model_name, chat)
                    else:
                        self._openai_collect(req, model_name, chat)
                except (BrokenPipeError, ConnectionResetError,
                        TimeoutError):
                    req.cancelled = True
                    server._note_client_abandon(req)
                    server._finish_request(req, "cancelled")

            def _openai_error(self, code: int, message: str):
                """OpenAI error wire shape; 5xx are server faults so
                retry middleware retries them, 429 is rate limiting
                (with Retry-After), other 4xx are caller errors."""
                kind = ("server_error" if code >= 500
                        else "rate_limit_exceeded" if code == 429
                        else "invalid_request_error")
                self._send(code, "application/json",
                           json.dumps({"error": {
                               "message": message,
                               "type": kind}}) + "\n")

            def _openai_stream(self, req: _Request, model_name,
                   chat: bool = False, first=None):
                if first is None:
                    first = req.events.get()
                if "error" in first:
                    self._openai_error(first.get("code", 400),
                                       first["error"])
                    return
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Transfer-Encoding", "chunked")
                self._trace_headers()
                self.end_headers()
                # the completion id IS the trace id: a slow completion
                # pasted into /debug/traces resolves without any
                # id-to-id mapping step
                rid = f"cmpl-{req.trace.trace_id}"
                if chat:
                    # the chat stream contract: role arrives in the
                    # first chunk's delta, content in later deltas
                    self._chunk("data: " + json.dumps(_sse_envelope(
                        rid, model_name, True,
                        [{"index": i,
                          "delta": {"role": "assistant"},
                          "finish_reason": None}
                         for i in range(req.n)],
                        **({"usage": None} if req.include_usage
                           else {}))) + "\n\n")
                if req.echo and not chat:
                    # OpenAI echo streams the prompt text first, one
                    # chunk covering every choice (it never counts
                    # toward the completion's sent-text accounting)
                    self._chunk("data: " + json.dumps(_sse_envelope(
                        rid, model_name, False,
                        [{"index": i, "text": req.echo_text,
                          "finish_reason": None}
                         for i in range(req.n)],
                        **({"usage": None} if req.include_usage
                           else {}))) + "\n\n")
                sent: dict = {}  # index -> streamed text so far
                ev = first
                while True:
                    if "error" in ev:
                        # mid-stream failure (e.g. shutdown drain):
                        # surface it as an error chunk, never as a
                        # clean-looking [DONE]
                        kind = ("server_error"
                                if ev.get("code", 400) >= 500
                                else "invalid_request_error")
                        self._chunk("data: " + json.dumps({
                            "error": {"message": ev["error"],
                                      "type": kind}}) + "\n\n")
                        break
                    chunk = _openai_chunk(
                        rid, model_name, ev, sent, chat=chat,
                        include_usage=req.include_usage)
                    if chunk is not None:
                        self._chunk("data: " + json.dumps(chunk)
                                    + "\n\n")
                    if "done" in ev:
                        if req.include_usage:
                            # stream_options.include_usage: one final
                            # usage-only chunk before [DONE]
                            chs = (ev["choices"] if "choices" in ev
                                   else [ev])
                            completion = sum(
                                len(c.get("tokens", ()))
                                for c in chs)
                            self._chunk("data: " + json.dumps(
                                _sse_envelope(
                                    rid, model_name, chat, [],
                                    usage=_usage(len(req.tokens),
                                                 completion)))
                                + "\n\n")
                        break
                    ev = req.events.get()
                self._chunk("data: [DONE]\n\n")
                self._chunk("")

            def _openai_collect(self, req: _Request, model_name,
                    chat: bool = False, first=None):
                while True:
                    ev = first if first is not None \
                        else req.events.get()
                    first = None
                    if "error" in ev:
                        self._openai_error(ev.get("code", 400),
                                           ev["error"])
                        return
                    if "done" in ev:
                        echo_text = (req.echo_text if req.echo
                                     else None)
                        self._send(
                            200, "application/json",
                            json.dumps(_openai_response(
                                f"cmpl-{req.trace.trace_id}",
                                model_name, req, ev, chat=chat,
                                echo_text=echo_text)) + "\n")
                        return

            def _stream(self, req: _Request, first=None):
                # wait for the FIRST event before sending headers: an
                # admission-time rejection must surface as a real 4xx,
                # not an in-band error line on a 200 (status-checking
                # clients — curl -f, k8s probes — would see success)
                if first is None:
                    first = req.events.get()
                if isinstance(first, dict) and "error" in first:
                    self._send(first.get("code", 400),
                               "application/json",
                               json.dumps(first) + "\n")
                    return
                self.send_response(200)
                self.send_header("Content-Type",
                                 "application/jsonlines")
                self.send_header("Transfer-Encoding", "chunked")
                self._trace_headers()
                self.end_headers()
                # the engine-rate write loop: drain every event the
                # scheduler has already queued (pre-encoded window
                # frames are raw bytes) into ONE chunked write — the
                # socket sees at most one syscall per window, and a
                # briefly-stalled reader catches up in one write
                # instead of one per missed event
                ev = first
                terminal = False
                while not terminal:
                    parts = []
                    while True:
                        if isinstance(ev, bytes):
                            parts.append(ev)
                        else:
                            parts.append(
                                (json.dumps(ev) + "\n").encode())
                            if "done" in ev or "error" in ev:
                                terminal = True
                                break
                        try:
                            ev = req.events.get_nowait()
                        except queue.Empty:
                            break
                    payload = b"".join(parts)
                    t_w = time.perf_counter()
                    self.wfile.write(b"%x\r\n" % len(payload)
                                     + payload + b"\r\n")
                    write_dt = time.perf_counter() - t_w
                    server._m_stream_write.observe(write_dt)
                    server._mark(req, "tpu_serve_stream_write",
                                 write_dt, bytes=len(payload))
                    if not terminal:
                        ev = req.events.get()
                self.wfile.write(b"0\r\n\r\n")

            def _collect(self, req: _Request, first=None):
                while True:
                    ev = first if first is not None \
                        else req.events.get()
                    first = None
                    if isinstance(ev, bytes):
                        continue  # window frames: stream-only payload
                    if "error" in ev:
                        self._send(ev.get("code", 400),
                                   "application/json",
                                   json.dumps(ev) + "\n")
                        return
                    if "done" in ev:
                        self._send(200, "application/json",
                                   json.dumps(ev) + "\n")
                        return

            def _chunk(self, text: str):
                data = text.encode()
                self.wfile.write(f"{len(data):x}\r\n".encode()
                                 + data + b"\r\n")

            def _trace_headers(self):
                """Echo the request's trace back to the caller: the
                raw id for greps (X-Trace-Id) and the propagable form
                (traceparent) for clients that keep the chain going."""
                ctx = getattr(self, "_trace", None)
                if ctx is not None:
                    self.send_header("X-Trace-Id", ctx.trace_id)
                    self.send_header("traceparent",
                                     ctx.to_traceparent())

            def _send_bytes(self, code, ctype, data: bytes):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self._trace_headers()
                self.end_headers()
                self.wfile.write(data)

            def _send(self, code, ctype, body: str):
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self._trace_headers()
                if code == 429:
                    # OpenAI rate-limit semantics: tell the client
                    # when to come back instead of letting it hammer
                    self.send_header("Retry-After", "1")
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, fmt, *args):
                log.debug("serve-http: " + fmt, *args)

        if self.profile_dir:
            self._prime_profiler()
        self._httpd = _PooledHTTPServer((host, port), Handler,
                                        workers=self.max_connections,
                                        shed_counter=self._shed_conns,
                                        recorder=self.recorder)
        threading.Thread(target=self._httpd.serve_forever,
                         name="serve-http", daemon=True).start()
        self._scheduler = threading.Thread(
            target=self._scheduler_supervisor, name="engine-scheduler",
            daemon=True)
        self._scheduler.start()
        self.tsdb.start(self.alert_interval_s)
        self.profiler.start()
        if self._incidents is not None:
            self._incidents.start()
        log.info("serving engine on http://%s:%d", host, self.port)
        return self

    @property
    def port(self) -> int:
        """Actual bound port (differs from the requested one for 0)."""
        return self._httpd.server_address[1] if self._httpd else 0

    def healthy(self) -> bool:
        """Liveness: the scheduler is (or can still be) driving the
        engine.  False once the supervisor declared it dead or the
        thread vanished without the stop flag."""
        if self._sched_dead:
            return False
        t = self._scheduler
        if t is None:
            return True  # not started yet / stopped cleanly
        return t.is_alive() or self._stop.is_set()

    def stop(self) -> None:
        self.tsdb.stop()
        self.profiler.stop()
        if self._incidents is not None:
            self._incidents.stop()
        self._stop.set()
        self._work.set()  # wake an idle scheduler so it can exit
        sched = self._scheduler
        if sched is not None:
            sched.join(timeout=5)
            if sched.is_alive():
                # stuck in a long device step (e.g. a first-window
                # run_scan compile): the scheduler drains _running and
                # _head itself on exit — mutating them here would race
                # with the still-running thread (KeyError in _emit,
                # re-admitted requests)
                log.warning(
                    "scheduler busy after 5s join; clients will be "
                    "drained when the in-flight device step returns")
            else:
                self._scheduler = None
                self._drain_on_stop()  # no-op if scheduler drained
        else:
            # never started: unblock any connected client directly —
            # handler threads sit in req.events.get(), and
            # ThreadingHTTPServer.shutdown() only stops the ACCEPT loop
            self._drain_on_stop()
        bye = {"error": "server shutting down", "code": 503}
        with self._lock:
            drained, self._pending = self._pending, []
        for *_k, req in drained:
            self._push(req, dict(bye))
            self._finish_request(req, "shutdown")
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None

    def _enqueue(self, req: _Request) -> None:
        """Admit *req* to the bounded priority heap, or answer 429.
        Overflow surfaces through the same first-event path every
        handler already checks, so all four response surfaces (native
        stream/unary, OpenAI SSE/unary) get a real 429 + Retry-After
        instead of unbounded heap growth (vLLM's admission-control
        semantics)."""
        if self._sched_dead:
            # nothing will ever pop the heap again: fail fast instead
            # of letting the client block on an event queue forever
            self._push(req, {
                "error": "engine scheduler crashed; server needs a "
                         "restart", "code": 503})
            self._finish_request(req, "shutdown")
            return
        if self._qos and not req.migrated:
            # per-tenant token-rate quota: charge the ESTIMATE (prompt
            # + requested budget, all n copies) at admission — over
            # quota is a 429 the tenant earned, not a global verdict.
            # Migrated-in requests are exempt: the prefill replica
            # already charged this request once, and the router's
            # fleet-level bucket is the global arbiter
            cost = float(
                (len(req.tokens) + req.max_new_tokens) * req.n)
            with self._lock:
                quota = self._resolve_quota(req.tenant)
                ok = quota is None or quota.try_charge(cost)
            if not ok:
                self._shed_quota.inc()
                self.recorder.record(
                    "tpu_serve_shed", trace=req.trace, rid=req.rid,
                    reason="quota", tenant=req.tenant)
                self._push(req, {
                    "error": f"tenant {req.tenant or '(default)'} "
                             "over token-rate quota; retry later",
                    "code": 429})
                self._finish_request(req, "throttled")
                return
        with self._lock:
            if len(self._pending) >= self.max_queue:
                full = True
            else:
                self._pending_seq += 1
                req._seq = self._pending_seq
                if self._qos:
                    # weighted fair queueing WITHIN a priority level:
                    # virtual finish time = max(virtual clock, the
                    # tenant's last vft) + cost/weight, so a bursting
                    # tenant queues behind its own backlog while the
                    # quiet tenant's occasional request keeps jumping
                    # near the virtual clock
                    quota = self._resolve_quota(req.tenant)
                    weight = quota.weight if quota is not None else 1.0
                    base = max(self._vtime, quota._last_vft
                               if quota is not None else 0.0)
                    req._vft = base + float(
                        (len(req.tokens) + req.max_new_tokens)
                        * req.n) / weight
                    if quota is not None:
                        quota._last_vft = req._vft
                heapq.heappush(
                    self._pending,
                    (-req.priority, req._vft, req._seq, req))
                full = False
        if full:
            self._shed_queue.inc()
            self.recorder.record("tpu_serve_shed", trace=req.trace,
                                 rid=req.rid, reason="queue")
            self._push(req, {
                "error": f"admission queue full ({self.max_queue} "
                         "requests pending); retry later",
                "code": 429})
            self._finish_request(req, "throttled")
            return
        self._work.set()

    def _attach_migration(self, req: _Request, state: dict,
                          budget) -> None:
        """Bind a migrated-in checkpoint to *req* (the /migrate
        resume half): the existing preempted-resume machinery does
        the actual engine work — ``_pull_ticket`` resumes preempted
        checkpoints before admitting anything new."""
        if req.n != 1:
            raise ValueError("migrated requests must have n=1")
        if not getattr(self.engine, "kv_paging", False):
            raise ValueError(
                "this replica cannot resume migrated KV state "
                "(kv_paging is off)")
        req.migrated = True
        req.prefill_only = False
        if budget is not None:
            # adopt the prefill replica's capped budget (prompt +
            # budget fits max_len there; configs match by contract)
            req.max_new_tokens = int(budget)
        req.budget_capped = True
        req.admitted = 1
        req.emitted[0] = 0
        req.preempted[0] = state
        self._mig_in.inc()
        self.recorder.record(
            "tpu_serve_migrate_in", trace=req.trace, rid=req.rid,
            tokens=len(req.tokens),
            outputs=len(state.get("outputs") or ()))

    # -- request plumbing ---------------------------------------------------

    def _token_byte_table(self) -> List[bytes]:
        """Per-token byte strings for grammar compilation: the
        explicit constructor table, or derived once from the tokenizer
        (the outlines/xgrammar token-to-bytes mapping)."""
        if self._token_bytes is None:
            if self.tokenizer is None:
                raise ValueError(
                    "guided decoding needs a token-to-bytes table: "
                    "start the server with --tokenizer (or "
                    "EngineServer(token_bytes=...))")
            self._token_bytes = token_bytes_of(
                self.tokenizer, self.engine.model.vocab)
        return self._token_bytes

    def _compile_grammar(self, pattern: str):
        """Pattern -> TokenDfa, cached: compilation runs on the
        HANDLER thread (it is pure — the engine is untouched), so slow
        first-compiles of big grammars never stall the scheduler loop;
        concurrent first requests may compile twice, last write wins
        harmlessly.  The engine-side register happens later, on the
        scheduler thread (see _admit_pending)."""
        with self._glock:
            tdfa = self._grammar_tdfas.get(pattern)
            if tdfa is None and self._grammar_count() >= \
                    self.max_grammars:
                self.recorder.record("tpu_serve_grammar_rejected",
                                     reason="cache_full",
                                     patterns=self.max_grammars)
                raise ValueError(
                    f"grammar cache full ({self.max_grammars} distinct "
                    "patterns); raise --max-grammars or reuse patterns")
        if tdfa is None:
            cdfa = regex_to_dfa(pattern)
            if self.max_grammar_states and \
                    len(cdfa.table) > self.max_grammar_states:
                # reject BEFORE the [N, V] token table: N states x a
                # real vocabulary is the gigabytes-of-host-memory
                # blowup the untrusted HTTP surface must not reach
                self.recorder.record("tpu_serve_grammar_rejected",
                                     reason="states_cap",
                                     states=len(cdfa.table),
                                     bound=self.max_grammar_states)
                raise ValueError(
                    f"pattern compiles to {len(cdfa.table)} DFA "
                    f"states, over the --max-grammar-states bound "
                    f"{self.max_grammar_states}; simplify the "
                    "constraint")
            tdfa = token_dfa(cdfa, self._token_byte_table(),
                             eos_id=self.engine.eos_id)
            with self._glock:
                # re-check under the lock: concurrent first requests
                # with DISTINCT new patterns each passed the earlier
                # size check and must not overshoot the bound (cache
                # entries pin engine grammar-table rows for life)
                if pattern not in self._grammar_tdfas and \
                        pattern not in self._grammar_gids and \
                        self._grammar_count() >= self.max_grammars:
                    self.recorder.record("tpu_serve_grammar_rejected",
                                         reason="cache_full",
                                         patterns=self.max_grammars)
                    raise ValueError(
                        f"grammar cache full ({self.max_grammars} "
                        "distinct patterns); raise --max-grammars or "
                        "reuse patterns")
                tdfa = self._grammar_tdfas.setdefault(pattern, tdfa)
        return tdfa

    def _grammar_count(self) -> int:
        """Distinct patterns this server has seen: registered (rows
        live in the engine's combined table) plus compiled-but-pending
        (a union — a pattern briefly sits in both mid-registration)."""
        return len(set(self._grammar_gids) | set(self._grammar_tdfas))

    def _grammar_request(self, body: dict) -> Optional[str]:
        """Extract the guided-decoding constraint from a native body:
        ``guided_regex`` (a pattern in the served regex subset),
        ``guided_json`` (true = any JSON, or a schema-subset object),
        or ``guided_choice`` (a list of literal strings — vLLM's
        choice mode, lowered as a literal alternation).  Returns the
        lowered regex pattern, or None."""
        regex = body.get("guided_regex")
        gjson = body.get("guided_json")
        choice = body.get("guided_choice")
        if sum(x is not None for x in (regex, gjson, choice)) > 1:
            raise ValueError(
                "pass exactly one of 'guided_regex', 'guided_json', "
                "'guided_choice'")
        if regex is not None:
            if not isinstance(regex, str) or not regex:
                raise ValueError(
                    "'guided_regex' must be a non-empty pattern string")
            if len(regex) > _MAX_REGEX_LEN:
                # client-supplied pattern text is attacker-controlled
                # and subset construction is super-linear in it; the
                # compiled-state bound still applies after this
                self.recorder.record("tpu_serve_grammar_rejected",
                                     reason="regex_len",
                                     chars=len(regex))
                raise ValueError(
                    f"'guided_regex' is {len(regex)} chars; the "
                    f"served bound is {_MAX_REGEX_LEN}")
            return regex
        if choice is not None:
            if (not isinstance(choice, list) or not choice or not all(
                    isinstance(c, str) and c for c in choice)):
                raise ValueError(
                    "'guided_choice' must be a non-empty list of "
                    "non-empty strings")
            from .grammar import _regex_escape

            return "(" + "|".join(
                _regex_escape(c) for c in choice) + ")"
        if gjson is None:
            return None
        if gjson is True:
            return json_value_regex()
        if isinstance(gjson, dict):
            return schema_to_regex(gjson)
        raise ValueError(
            "'guided_json' must be true or a JSON-schema object")

    def _openai_to_native(self, body: dict):
        """Translate an OpenAI /v1/completions body onto the native
        request shape.  Returns (native_body, model_name)."""
        if self.tokenizer is None:
            raise ValueError(
                "/v1/completions needs a tokenizer (start the server "
                "with --tokenizer); the native /generate endpoint "
                "speaks raw token ids")
        prompt = body.get("prompt")
        native: dict = {"detokenize": True}
        if isinstance(prompt, list) and prompt and all(
                isinstance(t, int) and not isinstance(t, bool)
                for t in prompt):
            native["tokens"] = prompt  # OpenAI's token-array form
        elif isinstance(prompt, str):
            native["prompt"] = prompt
        else:
            raise ValueError(
                "'prompt' must be a string or a token-id array")
        def opt(key, default=None):
            # an explicit JSON null means "use the default" in the
            # OpenAI API (clients serialize unset optionals as null)
            v = body.get(key)
            return default if v is None else v

        native["max_new_tokens"] = int(
            opt("max_tokens", opt("max_completion_tokens", 16)))
        if opt("user") is not None:
            # OpenAI's end-user identity doubles as the QoS tenant
            native["tenant"] = str(opt("user"))
        if opt("session") is not None:
            # session KV tiering: the extension key `session` names the
            # conversation; scoped under `user` when both are present
            # so two users' identically-named sessions never collide
            sid = str(opt("session"))
            native["session_id"] = (f"{opt('user')}/{sid}"
                                    if opt("user") is not None else sid)
        if opt("slo_class") is not None or \
                opt("service_tier") is not None:
            # SLO class: the vLLM-style extension key, or OpenAI's
            # service_tier as the nearest native concept
            native["slo_class"] = str(
                opt("slo_class", opt("service_tier")))
        # OpenAI defaults temperature to 1.0 (sampled); clients wanting
        # greedy pass 0 explicitly, exactly as with OpenAI/vLLM
        native["temperature"] = float(opt("temperature", 1.0))
        if opt("top_p") is not None:
            native["top_p"] = float(opt("top_p"))
        if opt("n") is not None:
            native["n"] = int(opt("n"))
        if opt("seed") is not None:
            native["seed"] = int(opt("seed"))
        if opt("presence_penalty") is not None:
            native["presence_penalty"] = float(opt("presence_penalty"))
        if opt("frequency_penalty") is not None:
            native["frequency_penalty"] = float(
                opt("frequency_penalty"))
        if opt("logprobs") is not None:
            # OpenAI logprobs=0 means "chosen token's logprob, no
            # alternatives" — the engine's 0 means OFF, so request
            # top-1 and trim the alternatives in the response
            # (_lp_count carries the client-requested count through to
            # the response code; _parse_request ignores it)
            native["_lp_count"] = int(opt("logprobs"))
            native["logprobs"] = max(1, native["_lp_count"])
        stop = opt("stop")
        if stop is not None:
            native["stop"] = [stop] if isinstance(stop, str) else stop
        if opt("logit_bias") is not None:
            native["logit_bias"] = opt("logit_bias")
        if opt("min_tokens") is not None:  # vLLM's OpenAI extension
            native["min_tokens"] = int(opt("min_tokens"))
        rf = opt("response_format")
        if rf is not None:
            # OpenAI guided decoding: json_object constrains to any
            # JSON value, json_schema to the declared schema subset
            if not isinstance(rf, dict) or "type" not in rf:
                raise ValueError(
                    "'response_format' must be an object with 'type'")
            kind = rf["type"]
            if kind == "json_object":
                # the OpenAI contract is an OBJECT, not any JSON value
                native["guided_json"] = {"type": "object"}
            elif kind == "json_schema":
                js = rf.get("json_schema")
                schema = js.get("schema") if isinstance(js, dict) \
                    else None
                if not isinstance(schema, dict):
                    # a 400 beats silently under-constraining: the
                    # client believes its schema is enforced
                    raise ValueError(
                        "'response_format.json_schema.schema' must be "
                        "a schema object")
                native["guided_json"] = schema
            elif kind != "text":
                raise ValueError(
                    f"unsupported response_format type {kind!r} "
                    "(text, json_object, json_schema)")
        if opt("guided_regex") is not None:  # vLLM's OpenAI extension
            native["guided_regex"] = opt("guided_regex")
        if opt("guided_choice") is not None:  # vLLM's OpenAI extension
            native["guided_choice"] = opt("guided_choice")
        if opt("echo"):
            native["_echo"] = True
            if native.get("logprobs"):
                # OpenAI echo+logprobs covers the PROMPT tokens too
                # (first entry null): ride the engine's prompt_logprobs
                # (prefill-logit scoring) so the response aligns
                # tokens/token_logprobs with the echoed text
                native["prompt_logprobs"] = native["logprobs"]
        so = opt("stream_options")
        if so is not None:
            if not bool(body.get("stream", False)):
                raise ValueError(
                    "'stream_options' is only allowed with "
                    "'stream': true")
            if not isinstance(so, dict):
                raise ValueError("'stream_options' must be an object")
            if so.get("include_usage"):
                native["_include_usage"] = True
        return native, str(opt("model", "default"))

    def _openai_chat_to_native(self, body: dict):
        """Translate an OpenAI /v1/chat/completions body: the
        tokenizer's chat template renders the messages into the
        prompt, everything else rides the completions translation."""
        if self.tokenizer is None:
            raise ValueError(
                "/v1/chat/completions needs a tokenizer (start the "
                "server with --tokenizer)")
        template = getattr(self.tokenizer, "apply_chat_template", None)
        if template is None:
            raise ValueError(
                "the loaded tokenizer has no chat template; use "
                "/v1/completions")
        messages = body.get("messages")
        if (not isinstance(messages, list) or not messages or not all(
                isinstance(m, dict)
                and isinstance(m.get("role"), str)
                and isinstance(m.get("content"), str)
                for m in messages)):
            raise ValueError(
                "'messages' must be a non-empty list of "
                "{role, content} objects")
        if body.get("echo"):
            raise ValueError(
                "'echo' is a completions-only parameter")
        prompt = template(messages, tokenize=False,
                          add_generation_prompt=True)
        flat = dict(body)
        flat.pop("messages")
        # chat templates already emit BOS/special markers: re-encoding
        # with default special-token addition would double the BOS, so
        # pre-encode here (token-array prompts skip encode entirely)
        try:
            ids = self.tokenizer.encode(prompt,
                                        add_special_tokens=False)
        except TypeError:  # tokenizer without the kwarg (test fakes)
            ids = self.tokenizer.encode(prompt)
        flat["prompt"] = [int(t) for t in ids]
        # chat logprobs semantics: a BOOLEAN plus top_logprobs (int),
        # not the completions integer — translate before delegating
        lpb = flat.pop("logprobs", None)
        top_n = flat.pop("top_logprobs", None)
        if lpb:
            flat["logprobs"] = int(top_n or 0)
        return self._openai_to_native(flat)

    def _parse_request(self, body: dict, trace=None) -> _Request:
        tokens = body.get("tokens")
        prompt = body.get("prompt")
        detokenize = bool(body.get("detokenize", prompt is not None))
        if prompt is not None:
            if tokens is not None:
                raise ValueError("pass 'prompt' OR 'tokens', not both")
            if not isinstance(prompt, str) or not prompt:
                raise ValueError("'prompt' must be a non-empty string")
            if self.tokenizer is None:
                raise ValueError(
                    "'prompt' strings need a tokenizer (start the "
                    "server with --tokenizer); pass 'tokens' instead")
            tokens = [int(t) for t in self.tokenizer.encode(prompt)]
        if detokenize and self.tokenizer is None:
            raise ValueError("'detokenize' needs a tokenizer")
        if (not isinstance(tokens, list) or not tokens
                or not all(isinstance(t, int)
                           and not isinstance(t, bool) for t in tokens)):
            # bool is an int subclass: JSON `true` would silently
            # become token id 1 instead of a 400 (same guard as 'stop')
            raise ValueError("'tokens' must be a non-empty int list")
        max_new = int(body.get("max_new_tokens", self.default_max_new))
        if max_new < 1:
            raise ValueError("max_new_tokens must be >= 1")
        min_new = int(body.get("min_tokens", 0))
        if min_new < 0:
            raise ValueError("min_tokens must be >= 0")
        if min_new > max_new:
            raise ValueError(
                f"min_tokens {min_new} exceeds max_new_tokens "
                f"{max_new}")
        top_k = body.get("top_k")
        adapter = body.get("adapter")
        logprobs = body.get("logprobs")
        prompt_logprobs = body.get("prompt_logprobs")
        # copies admit incrementally, so n may exceed the slot count;
        # the cap is only a sanity bound against runaway requests
        n = int(body.get("n", 1))
        if not 1 <= n <= 128:
            raise ValueError(f"n={n} outside [1, 128]")
        logit_bias = body.get("logit_bias")
        if logit_bias == {}:
            logit_bias = None  # OpenAI treats an empty object as unset
        if logit_bias is not None:
            if not isinstance(logit_bias, dict):
                raise ValueError(
                    "'logit_bias' must be a {token id: bias} object")
            try:
                # JSON object keys are strings (OpenAI sends them so)
                logit_bias = {int(k): float(v)
                              for k, v in logit_bias.items()}
            except (TypeError, ValueError):
                raise ValueError(
                    "'logit_bias' keys must be token ids and values "
                    "numbers")
        stop = body.get("stop")
        stop_strs: Optional[List[str]] = None
        if stop is not None:
            if not isinstance(stop, list) or not all(
                    (isinstance(t, int) and not isinstance(t, bool))
                    or isinstance(t, str)
                    for t in stop):
                # bool is an int subclass: JSON `true` would silently
                # become token id 1 instead of a 400
                raise ValueError(
                    "'stop' must be a list of token ids and/or strings")
            stop_strs = [s for s in stop if isinstance(s, str) and s]
            stop = [t for t in stop if isinstance(t, int)]
            if stop_strs and self.tokenizer is None:
                raise ValueError(
                    "stop STRINGS need a tokenizer (start the server "
                    "with --tokenizer); pass stop token ids instead")
            stop = stop or None
            stop_strs = stop_strs or None
        grammar_key = grammar_tdfa = None
        pattern = self._grammar_request(body)
        if pattern is not None:
            if self.engine.eos_id is None:
                raise ValueError(
                    "guided decoding needs an engine eos id (the "
                    "grammar gates completion on it)")
            grammar_key = pattern
            with self._glock:
                registered = pattern in self._grammar_gids
            if not registered:
                # compiles (or cache-hits) here on the handler thread;
                # regex syntax errors and vocabulary dead-ends surface
                # as this request's 400, never a scheduler stall.
                # Registered patterns skip the compile entirely — the
                # engine's combined table already holds their rows
                grammar_tdfa = self._compile_grammar(pattern)
        req = _Request(
            tokens=tokens,
            max_new_tokens=max_new,
            temperature=float(body.get("temperature", 0.0)),
            top_k=None if top_k is None else int(top_k),
            top_p=float(body.get("top_p", 1.0)),
            min_p=float(body.get("min_p", 0.0)),
            presence_penalty=float(body.get("presence_penalty", 0.0)),
            frequency_penalty=float(body.get("frequency_penalty", 0.0)),
            repetition_penalty=float(
                body.get("repetition_penalty", 1.0)),
            adapter=None if adapter is None else int(adapter),
            stop=stop,
            stop_strs=stop_strs,
            detokenize=detokenize,
            logit_bias=logit_bias,
            min_tokens=min_new,
            ignore_eos=bool(body.get("ignore_eos", False)),
            seed=(None if body.get("seed") is None
                  else int(body["seed"])),
            priority=int(body.get("priority", 0)),
            tenant=str(body.get("tenant", "") or ""),
            # conversation key for the session KV tier: purely
            # opt-in, absent/empty means the request is anonymous
            session=str(
                body.get("session_id", body.get("session", "")) or ""),
            # free-form on the wire, BOUNDED at record time: an
            # unknown class lands under the "other" label, never a
            # new series (the O1/slo contract)
            slo_class=str(body.get("slo_class", "") or ""),
            logprobs=None if logprobs is None else int(logprobs),
            prompt_logprobs=(None if prompt_logprobs is None
                             else int(prompt_logprobs)),
            n=n,
            grammar_key=grammar_key,
            grammar_tdfa=grammar_tdfa,
            stream=bool(body.get("stream", True)),
            per_token=bool(body.get("per_token", False)),
            # bounded: the slow-client disconnect policy (see _push)
            events=queue.Queue(self.max_events),
        )
        # request tracing: the span starts at parse (its duration is
        # the full wire-visible latency) and ends exactly once at the
        # terminal outcome; the rid tags every structured log line
        # (process-wide counter: unique across servers in one process).
        # The trace context (continued from the caller's traceparent or
        # a fresh root) rides the span into its log line, the request
        # histogram's exemplar, and the flight-recorder event
        req.rid = f"req-{next(_RID_COUNTER):x}"
        req.trace = trace if trace is not None else obs.new_trace()
        req.t_arrival = time.perf_counter()
        req.span = obs.Span(
            "tpu_serve_request",
            histogram=getattr(self, "_m_request", None),
            request_id=req.rid, logger=log, trace=req.trace,
            recorder=getattr(self, "recorder", None),
        ).annotate(prompt_tokens=len(tokens), n=n)
        if body.get("prefill_only"):
            # internal router marker (disagg path): run prefill, then
            # export the checkpoint instead of decoding.  Eligibility
            # is decided HERE — an ineligible request silently serves
            # normally and the router passes the stream through
            # (graceful degradation beats a hard 4xx mid-topology)
            if (getattr(self.engine, "kv_paging", False) and n == 1
                    and self.replica_role != "decode"):
                req.prefill_only = True
            else:
                self.recorder.record(
                    "tpu_serve_migrate_declined", trace=req.trace,
                    rid=req.rid,
                    reason=("role" if self.replica_role == "decode"
                            else "paging" if not getattr(
                                self.engine, "kv_paging", False)
                            else "multi_copy"))
        return req

    def stats(self) -> dict:
        st = dict(self.engine.stats())
        with self._glock:
            grammar_patterns = self._grammar_count()
        st.update({
            "pending_requests": len(self._pending),
            # distinct REQUESTS (an n>1 request occupies n slots)
            "running_requests": len(
                {id(r) for r, _ in self._running.values()}),
            "running_copies": len(self._running),
            "admitting_copies": len(self._tickets),
            "requests_served": self._requests_served,
            "requests_rejected": self._requests_rejected,
            # promoted counters read back so /stats and /metrics agree
            "requests_throttled": self._requests_throttled,
            "requests_dropped": self._requests_dropped,
            "client_abandons": int(self._m_abandons.value),
            "grammar_patterns": grammar_patterns,
            "window": self.window,
            "max_queue": self.max_queue,
        })
        if self._httpd is not None:
            st.update(self._httpd.pool_stats())
        return st

    def _prime_profiler(self) -> None:
        """Start and stop one empty ``torch.profiler`` capture on the
        calling thread, before the scheduler thread exists.  The
        profiler's CUDA tracing initialises on its first start and
        must do so on the thread that loaded torch: a first start on a
        handler thread records no CUDA activity.  ``start`` runs on
        the embedder's thread, which is that thread in the CLI."""
        prof = self._new_profile()
        prof.start()
        prof.stop()

    def _new_profile(self):
        """A ``torch.profiler.profile`` of CPU activities, and of CUDA
        ones when the engine lives on a card."""
        import torch.profiler as tprof

        acts = [tprof.ProfilerActivity.CPU]
        if self.engine.device.type == "cuda":
            acts.append(tprof.ProfilerActivity.CUDA)
        return tprof.profile(activities=acts)

    def profile(self, seconds: float) -> dict:
        """Capture one ``torch.profiler`` trace of *seconds* into
        ``--profile-dir`` (the /debug/profile handler), with CPU
        activities and, on a CUDA engine, CUDA ones; the chrome trace
        is written there as ``torch-trace-<ms>.json``.  Single-flight:
        a second capture while one is running raises RuntimeError (the
        profiler is process-global — two overlapping traces corrupt
        each other).  Blocking by design: the handler's worker sleeps
        through the capture and answers with the dump dir, so callers
        (and tests) need no polling protocol.

        The capture starts on this handler thread, and CUDA activity
        tracing (CUPTI) is process-wide: the kernels the scheduler
        thread launches, graph replays included, land in it.  The
        profiler starts and stops under ``inference.CAPTURE_LOCK``, so
        it never does so while the scheduler thread captures a CUDA
        graph (a capture fails on another thread's CUDA call)."""
        if not self.profile_dir:
            raise ValueError(
                "profiling is not configured: start the server with "
                "--profile-dir")
        if not 0 < seconds <= 60:
            raise ValueError("seconds must be in (0, 60]")
        if not self._profile_lock.acquire(blocking=False):
            raise RuntimeError("a profile capture is already running")
        try:
            import os

            from .inference import CAPTURE_LOCK

            # compose with the continuous sampler: the ring
            # sampler parks for the capture window — suspended ticks
            # are still counted, so the profile timeline shows an
            # honest gap instead of samples of the capture machinery
            t0 = time.perf_counter()
            prof = self._new_profile()
            with self.profiler.suspend(reason="torch_profiler"):
                with CAPTURE_LOCK:
                    prof.start()
                try:
                    time.sleep(seconds)
                finally:
                    with CAPTURE_LOCK:
                        prof.stop()
            os.makedirs(self.profile_dir, exist_ok=True)
            trace = os.path.join(
                self.profile_dir,
                f"torch-trace-{int(time.time() * 1000)}.json")
            prof.export_chrome_trace(trace)
            dt = time.perf_counter() - t0
        finally:
            self._profile_lock.release()
        self._m_profile.inc()
        self.recorder.record("tpu_serve_profile", seconds=seconds,
                             duration_s=dt, dir=self.profile_dir)
        return {"ok": True, "seconds": seconds,
                "profile_dir": self.profile_dir, "trace": trace}

    def statz(self) -> dict:
        """The router tier's load signal: one SMALL fixed-schema JSON
        snapshot (queue depth, in-flight copies, KV pool occupancy,
        shed counts, scheduler health) assembled from the same host
        ints /metrics bridges — so the router never parses Prometheus
        text on the routing hot path, and the lock-step test can pin
        this surface against the tpu_serving_* families."""
        st = self.stats()
        return {
            "scheduler_alive": self.healthy(),
            "queue_depth": st["pending_requests"],
            "in_flight": (st["running_copies"]
                          + st["admitting_copies"]),
            "capacity": st["n_slots"],
            "kv_pages": st.get("kv_pages", 0),
            "kv_pages_free": st.get("kv_pages_free", 0),
            "requests_served": st["requests_served"],
            # disaggregated serving (router v2): the role this replica
            # registered as, and the migration ledger in lock-step
            # with tpu_serve_migrations_total{direction}
            "role": self.replica_role,
            "migrations": {
                "out": int(self._mig_out.value),
                "in": int(self._mig_in.value),
            },
            "shed": {
                "connections": int(self._shed_conns.value),
                "queue": int(self._shed_queue.value),
                "quota": int(self._shed_quota.value),
            },
            # session KV tier occupancy (fixed schema even when the
            # tier is off, so /fleet/statz aggregation never branches)
            "kv_tiers": (self._session_store.stats()
                         if self._session_store is not None
                         else empty_tier_stats()),
            # the fixed-schema goodput block the router's /fleet/statz
            # aggregates and the autoscaler will key scaling on
            "goodput": self._slo.summary(),
            # firing/pending alert roll-up: rides the same
            # heartbeat the goodput block does, so the router's
            # /fleet/statz can aggregate firing_alerts without an
            # extra fan-out poll
            "alerts": self.alerts.brief(),
        }

    def slo_miss_traces(self, top: int = 5) -> dict:
        """The incident bundle's span-attribution payload: the slowest
        *top* requests that missed their SLO (per the journal's
        ``tpu_serve_slo_miss`` markers), each with every ring event of
        its trace — ``obs_query --incident`` stitches these back into
        span trees offline."""
        misses = self.recorder.events(name="tpu_serve_slo_miss")

        def _dur(ev: dict) -> float:
            attrs = ev.get("attrs")
            if isinstance(attrs, dict):
                try:
                    return float(attrs.get("duration_s", 0.0))
                except (TypeError, ValueError):
                    return 0.0
            return 0.0

        misses.sort(key=_dur, reverse=True)
        out = []
        for ev in misses[:top]:
            attrs = ev.get("attrs")
            attrs = attrs if isinstance(attrs, dict) else {}
            tid = ev.get("trace_id") or ""
            events = (self.recorder.events(trace_id=str(tid))
                      if tid else [ev])
            out.append({
                "rid": attrs.get("rid", ""),
                "trace_id": tid,
                "duration_s": _dur(ev),
                "slo_class": attrs.get("slo_class", ""),
                "outcome": attrs.get("outcome", ""),
                "events": events,
            })
        return {"schema": "tpu-incident-traces/v1", "misses": out}

    # -- router registration (multi-replica serving) ------------------------

    def start_registration(self, router: str,
                           advertise: Optional[str] = None,
                           replica_id: Optional[str] = None,
                           model: str = "",
                           interval_s: float = 2.0) -> None:
        """Self-register with a router tier and keep heartbeating
        (slice-coordinator-style membership for the serving data
        plane).  *router* is ``http://host:port`` (or bare
        ``host:port``); *advertise* is the address the ROUTER should
        dial back (default ``127.0.0.1:<bound port>`` — wrong across
        hosts, so deployments set it to the pod IP).  Heartbeats carry
        an inline statz snapshot so the router's load signal freshens
        without waiting for its next poll.  A down router never hurts
        serving: failures are counted + logged and the loop just tries
        again next interval (retried within a beat by the shared
        RetryPolicy).  Call after :meth:`start`."""
        target = router
        if target.startswith("http://"):
            target = target[len("http://"):]
        target = target.rstrip("/")
        host, _, port_s = target.rpartition(":")
        if not host or not port_s.isdigit():
            raise ValueError(
                f"--register-with {router!r} must be http://host:port")
        addr = advertise or f"127.0.0.1:{self.port}"
        rid = replica_id or addr
        self._replica_id = rid
        policy = resilience.RetryPolicy(
            max_attempts=2, initial_backoff_s=0.1, max_backoff_s=0.5)
        rmetrics = resilience.ResilienceMetrics(self.registry)

        def beat_once() -> float:
            """One registration POST; returns the router's interval
            hint (seconds)."""
            import http.client

            conn = http.client.HTTPConnection(host, int(port_s),
                                              timeout=5.0)
            try:
                conn.request(
                    "POST", "/register",
                    json.dumps({
                        "replica_id": rid,
                        "address": addr,
                        "model": model,
                        "capacity": self.engine.n_slots,
                        "role": self.replica_role,
                        "statz": self.statz(),
                    }),
                    {"Content-Type": "application/json"})
                resp = conn.getresponse()
                body = resp.read()
                if resp.status != 200:
                    raise OSError(
                        f"router answered {resp.status}: "
                        f"{body[:120]!r}")
                out = json.loads(body)
                return float(out.get("interval_s", interval_s))
            finally:
                conn.close()

        def loop() -> None:
            wait = interval_s
            while not self._stop.wait(wait):
                try:
                    hint = policy.call(
                        beat_once, op="serve.register",
                        retry_on=(OSError, ValueError),
                        stop=self._stop, metrics=rmetrics,
                        recorder=self.recorder)
                    wait = max(0.2, min(interval_s, hint))
                except resilience.CircuitOpenError:
                    return  # stop() aborted the retry sleep
                except (OSError, ValueError) as e:
                    # the router being down is ITS outage, not ours:
                    # serving keeps serving, the loop keeps knocking
                    resilience.suppressed(
                        "serve.register", e, logger=log,
                        metrics=rmetrics)
            log.debug("registration loop stopped")

        try:
            policy.call(beat_once, op="serve.register",
                        retry_on=(OSError, ValueError),
                        stop=self._stop, metrics=rmetrics,
                        recorder=self.recorder)
            log.info("registered with router %s as %s (%s)",
                     router, rid, addr)
        except (OSError, ValueError, resilience.CircuitOpenError) as e:
            log.warning("initial router registration failed (%s); "
                        "will keep retrying every %.1fs", e,
                        interval_s)
        self._register_thread = threading.Thread(
            target=loop, name="serve-register", daemon=True)
        self._register_thread.start()

    def render_metrics(self, openmetrics: bool = False) -> str:
        """The serving /metrics body: the obs registry (request spans,
        TTFT / per-token / queue-wait / admit / stream-write
        histograms, shed + drop counters) plus every numeric stats()
        entry bridged as ``tpu_serving_<key>``.  *openmetrics* adds
        trace-id exemplars + the ``# EOF`` terminator (serve it only
        under the OpenMetrics content type).

        Rename (promlint): bridged MONOTONIC stats now carry the
        ``_total`` suffix counters require —
        ``tpu_serving_requests_served`` is
        ``tpu_serving_requests_served_total`` and so on; gauges keep
        their old names.

        The stats bridge itself runs as a registry collect hook (PR
        18) so the TSDB's background sampling tick retains fresh
        ``tpu_serving_*`` values too, not just HTTP scrapes; the
        render is accounted via :class:`obs.ScrapeMeta`
        (``tpu_scrape_*``)."""
        return self.scrape_meta.render(openmetrics=openmetrics)

    def _bridge_stats(self) -> None:
        """Registry collect hook: mirror every numeric stats() entry
        as a ``tpu_serving_*`` family (gauge or ``_total`` counter)."""
        st = self.stats()
        reg = self.registry
        for k, v in st.items():
            if not isinstance(v, (int, float)) or isinstance(v, bool):
                continue
            if k in _GAUGE_STATS:
                reg.gauge(f"tpu_serving_{k}",
                          f"Server/engine gauge '{k}' (see /stats)."
                          ).set(v)
            else:
                name = f"tpu_serving_{k}"
                if not name.endswith("_total"):
                    name += "_total"
                reg.counter(
                    name,
                    f"Server/engine counter '{k}' (see /stats)."
                )._set(v)


def enable_compile_cache(path: str) -> bool:
    """The JAX server points jax's persistent compilation cache at
    *path*, so a fresh replica loads its executables instead of
    recompiling them.  The port has no such cache: its CUDA graphs are
    captured by each process on first use (``warm_scheduler`` captures
    the window variants and the packed shapes before traffic), and
    nothing persists them.  Returns False with the JAX server's log
    line, as that server does when its jax lacks the knobs: a missing
    cache only costs warmup time."""
    log.warning("persistent compile cache unavailable (%s); "
                "replica cold starts pay full compile time",
                f"the port captures its CUDA graphs in-process; "
                f"{path!r} is not used")
    return False


def main(argv=None) -> int:
    """CLI: build a Llama-family engine and serve it, on CUDA unless
    ``--device cpu`` is given (without CUDA and without that flag it
    raises rather than serving on the CPU).  The JAX server's options,
    plus ``--device``.

    ``--tp N`` runs one process a rank over a model axis of N
    (:func:`_tp_start`): under torchrun's environment each process is
    its rank, else this process is rank 0 and starts the other N - 1
    itself.  Each rank builds its pieces of the model
    (``build_model_and_params(mesh=)``) and its engine; rank 0 serves
    HTTP through ``tp_driver.EngineLeader`` and the others replay its
    engine calls (``tp_driver.follow``).  NCCL on CUDA (one device a
    rank), gloo under ``--device cpu``.  A rank that fails stops the
    server; stopping rank 0 stops every rank."""
    from .bench_serving import CONFIGS, build_model_and_params
    from .transformer import resolve_device

    p = argparse.ArgumentParser(prog="tpu-serve")
    p.add_argument("--config", choices=sorted(CONFIGS), default="tiny")
    p.add_argument("--quantized", action="store_true",
                   help="weight-only int8")
    p.add_argument("--int4", action="store_true",
                   help="weight-only int4")
    p.add_argument("--n-slots", type=int, default=8)
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ways: shard params/KV over a "
                        "model-axis mesh of N ranks, one process and "
                        "one visible CUDA device each (the native "
                        "analog of vLLM's --tensor-parallel-size)")
    p.add_argument("--max-len", type=int, default=2048)
    p.add_argument("--max-new-tokens", type=int, default=256,
                   help="default per-request budget")
    p.add_argument("--window", type=int, default=DEFAULT_WINDOW)
    p.add_argument("--prefix-chunk", type=int, default=0,
                   metavar="N",
                   help="admission/prefix-cache grid: prompts prefill "
                        "in N-token chunks and APC matches floor to "
                        "whole chunks (must divide --max-len); 0 = "
                        "engine auto (32-grid when max_len allows)")
    p.add_argument("--no-interleave", action="store_true",
                   help="disable iteration-level prefill/decode "
                        "interleaving (admissions then run fully "
                        "between decode windows, the pre-scheduler "
                        "cadence; outputs are identical either way)")
    p.add_argument("--prefill-chunks", type=int,
                   default=DEFAULT_PREFILL_BUDGET, metavar="K",
                   help="prefill chunks dispatched into one open "
                        "decode window (interleave granularity): "
                        "higher admits long prompts faster, lower "
                        "bounds how long a window's harvest can be "
                        "delayed behind prefill")
    p.add_argument("--packed-prefill", default=True,
                   action=argparse.BooleanOptionalAction,
                   help="ragged packed prefill (default on): "
                        "concurrent admissions' prefill chunks batch "
                        "into ONE extend dispatch per chunk-round "
                        "(pack sizes 2..--max-pack, a fixed compiled "
                        "shape set); outputs byte-identical either "
                        "way")
    p.add_argument("--overlap-dispatch", default=True,
                   action=argparse.BooleanOptionalAction,
                   help="double-buffered dispatch/harvest (default "
                        "on): dispatch decode window N+1 before "
                        "streaming window N so host stream writes "
                        "overlap device compute; auto-falls back to "
                        "the serial cadence while any sampled request "
                        "is live (outputs byte-identical either way)")
    p.add_argument("--fused-decode", default=False,
                   action=argparse.BooleanOptionalAction,
                   help="fused decode loop (default off): decode "
                        "windows carry per-slot eos/stop/budget finish "
                        "flags on-device, harvest slices kept prefixes "
                        "columnar-side instead of re-scanning tokens "
                        "on host, and dispatch-ahead overlap extends "
                        "to SAMPLED windows (outputs byte-identical "
                        "either way — the fused equivalence suite "
                        "pins it)")
    p.add_argument("--max-pack", type=int, default=DEFAULT_MAX_PACK,
                   metavar="K",
                   help="packed-prefill width cap: each pack size in "
                        "2..K is one compiled extend shape "
                        "(warm_scheduler pre-compiles the set)")
    p.add_argument("--compile-cache-dir", default=None, metavar="DIR",
                   help="the JAX server's persistent compile cache (env: "
                        "TPU_DP_COMPILE_CACHE_DIR); the port captures "
                        "its CUDA graphs in-process and logs that the "
                        "cache is unavailable")
    p.add_argument("--schedule-watchdog", type=float, default=0.0,
                   metavar="SECONDS",
                   help="fail a scheduler iteration stuck past this "
                        "deadline (503 + supervised restart instead "
                        "of a silent hang); 0 disables — first-window "
                        "compiles can legitimately take tens of "
                        "seconds, so size it to your steady state")
    p.add_argument("--logprobs-k", type=int, default=5,
                   help="engine-wide top-k logprobs cap (requests ask "
                        "for n <= k; 0 disables the stats entirely)")
    p.add_argument("--draft-config", choices=sorted(CONFIGS), default=None,
                   help="speculative draft model (e.g. llama3-1b for "
                        "llama3-8b); greedy requests decode in "
                        "propose/verify rounds")
    p.add_argument("--gamma", type=int, default=4,
                   help="draft proposals per speculative round")
    p.add_argument("--spec-ngram", type=int, default=0, metavar="N",
                   help="draft-free prompt-lookup speculation with "
                        "N-gram matching (vLLM's [ngram] mode); "
                        "mutually exclusive with --draft-config")
    p.add_argument("--max-grammars", type=int, default=64,
                   help="distinct guided-decoding patterns cached per "
                        "server lifetime (each occupies engine grammar "
                        "table rows)")
    p.add_argument("--max-grammar-states", type=int, default=8192,
                   help="reject guided-decoding patterns whose "
                        "char-DFA exceeds this many states (before "
                        "the [N, V] token table is built); 0 disables")
    p.add_argument("--max-queue", type=int, default=1024,
                   help="admission queue bound: requests past it get "
                        "429 + Retry-After instead of unbounded heap "
                        "growth")
    p.add_argument("--max-connections", type=int, default=64,
                   help="HTTP worker pool size (fixed thread count); "
                        "connections past 2x this are shed with 429 "
                        "at accept")
    p.add_argument("--client-timeout", type=float, default=120.0,
                   help="per-connection socket timeout in seconds: a "
                        "stuck peer frees its pool worker")
    p.add_argument("--flight-record-dir", default=None, metavar="DIR",
                   help="dump the flight-recorder event journal (JSON "
                        "lines) to DIR on exit/SIGTERM — the black-box "
                        "post-mortem; unset disables the dump (the "
                        "in-memory ring and /debug/traces stay on)")
    p.add_argument("--flight-dump-keep", type=int, default=20,
                   metavar="K",
                   help="keep only the newest K flight-record dump "
                        "files in --flight-record-dir (older ones are "
                        "deleted at dump time; deletions count in "
                        "tpu_flight_dump_gc_total)")
    p.add_argument("--slo", action="append", default=None,
                   metavar="CLASS=TTFT_MS[:DEADLINE_MS]",
                   help="declare an SLO class (repeatable), e.g. "
                        "'interactive=250' (TTFT target) or "
                        "'batch=0:60000' (completion deadline); "
                        "default: interactive=2500 + batch=0:60000. "
                        "Requests pick a class with \"slo_class\"; "
                        "unknown names land under the bounded 'other' "
                        "label")
    p.add_argument("--slo-window", type=float, default=60.0,
                   metavar="S",
                   help="rolling window (seconds) for the goodput and "
                        "error-budget burn-rate gauges")
    p.add_argument("--alert-rules", default=None, metavar="FILE",
                   help="JSON alert-rule file ({\"rules\": [...]}) "
                        "evaluated by the in-process alert engine on "
                        "top of the burn-rate rules derived from every "
                        "--slo class; firing state serves on /alerts")
    p.add_argument("--alert-interval", type=float, default=5.0,
                   metavar="S",
                   help="TSDB sampling / alert evaluation tick "
                        "(seconds)")
    p.add_argument("--alert-window-scale", type=float, default=1.0,
                   metavar="X",
                   help="scale factor on the derived burn-rate rule "
                        "windows (5m/1h/6h * X) — CI and soak tests "
                        "shrink them to fire within seconds")
    p.add_argument("--profile-dir", default=None, metavar="DIR",
                   help="enable GET /debug/profile?seconds=N: dump "
                        "torch.profiler chrome traces there (CPU and "
                        "CUDA activities; single-flight; "
                        "env TPU_DP_PROFILE_DIR)")
    p.add_argument("--incident-dir", default=None, metavar="DIR",
                   help="alert-triggered incident bundles: when a "
                        "page-severity alert fires, write one atomic "
                        "directory there (alert history, journal "
                        "dump, TSDB snapshot, continuous-profile "
                        "slice, statz, slowest SLO-missed traces); "
                        "rate-limited per alert, GC'd newest-K "
                        "(env TPU_DP_INCIDENT_DIR)")
    p.add_argument("--profiler-hz", type=float, default=19.0,
                   metavar="HZ",
                   help="continuous sampling profiler rate for "
                        "GET /debug/pprof (default 19 — prime, so the "
                        "sampler cannot phase-lock a periodic loop)")
    p.add_argument("--flight-record-capacity", type=int, default=4096,
                   help="flight-recorder ring size in events "
                        "(drop-oldest past it)")
    p.add_argument("--fault-spec", default=None, metavar="SPEC",
                   help="arm deterministic fault injection (chaos "
                        "testing ONLY): op:kind:arg[;...] — e.g. "
                        "'serve.step:error:0.02'.  Unset (the "
                        "default) leaves every hook a no-op attribute "
                        "check.  Env: TPU_DP_FAULTS")
    p.add_argument("--fault-seed", type=int, default=None,
                   help="RNG seed for --fault-spec probabilities "
                        "(default 0; env: TPU_DP_FAULT_SEED)")
    p.add_argument("--jump-len", type=int, default=8,
                   help="structural jump-ahead width: up to this many "
                        "DFA-forced tokens (a schema's keys and "
                        "punctuation) commit per multi-token extend")
    p.add_argument("--kv-paging", action="store_true",
                   help="paged KV cache: fixed-size pages + free-list "
                        "allocator with copy-on-write prefix sharing "
                        "and preemption-by-page-eviction (outputs "
                        "bit-identical to the contiguous default)")
    p.add_argument("--kv-page-size", type=int, default=0, metavar="N",
                   help="KV page size in tokens (0 = the admission "
                        "chunk; must divide it and --max-len)")
    p.add_argument("--kv-pages", type=int, default=0, metavar="P",
                   help="physical KV pool size in pages (0 = full "
                        "reservation, n_slots * max_len/page; smaller "
                        "oversubscribes — shared prefixes and "
                        "preemption absorb the pressure)")
    p.add_argument("--kv-dtype", choices=["int8"], default=None,
                   help="quantize paged KV pool storage (int8 values "
                        "+ per-row f32 scales; ~47%% of the bf16 "
                        "bytes, NOT bit-identical to contiguous)")
    p.add_argument("--session-tier", action="store_true",
                   help="three-tier session KV store keyed by the "
                        "optional session_id request field: parked "
                        "device pages -> bounded host-RAM pool -> "
                        "crash-safe --session-dir spill files; a "
                        "returning session resumes its KV instead of "
                        "re-prefilling (needs --kv-paging)")
    p.add_argument("--session-dir", default=None, metavar="DIR",
                   help="disk spill directory for --session-tier "
                        "(atomic tmp->rename .kvs files that survive "
                        "process death; unset disables the disk tier)")
    p.add_argument("--session-host-mb", type=int, default=256,
                   help="host-RAM tier cap in MiB — over it the "
                        "oldest sessions spill to disk or evict")
    p.add_argument("--session-disk-keep", type=int, default=512,
                   help="newest-K GC bound on spilled .kvs files")
    p.add_argument("--session-idle", type=float, default=30.0,
                   metavar="SECONDS",
                   help="idle seconds (seeded +/-10%% jitter) before "
                        "a parked device session demotes to host RAM")
    p.add_argument("--session-host-idle", type=float, default=120.0,
                   metavar="SECONDS",
                   help="idle seconds (seeded jitter) before a "
                        "host-tier session spills to --session-dir")
    p.add_argument("--session-seed", type=int, default=0,
                   help="RNG seed for the tier timers' jitter (keeps "
                        "demotion schedules reproducible in tests)")
    p.add_argument("--tenant-quota", action="append", default=None,
                   metavar="NAME=RATE[:BURST[:WEIGHT]]",
                   help="per-tenant QoS (repeatable; NAME '*' is the "
                        "default tenant): token-rate quota (tokens/s "
                        "over prompt+budget estimates, 429 past it) "
                        "and weighted fair queueing in the admission "
                        "heap; requests carry 'tenant' (native) or "
                        "'user' (OpenAI)")
    p.add_argument("--prefix-registry-max", type=int, default=256,
                   help="LRU cap on registered prefixes + the bound "
                        "feeding tpu_serve_prefix_evictions_total "
                        "(each entry pins a full-length KV copy)")
    p.add_argument("--checkpoint", default=None, metavar="DIR",
                   help="serve REAL weights: a checkpoint dir "
                        "(workloads.checkpoint layout, state "
                        "{'params': ...} in the f32 train layout); "
                        "--quantized/--int4 quantize after restore. "
                        "Without it the CLI serves random weights in "
                        "the benchmark posture. (--draft-config drafts "
                        "stay random either way — correctness never "
                        "depends on the draft.)")
    p.add_argument("--checkpoint-step", type=int, default=None,
                   help="checkpoint step to restore (default: latest)")
    p.add_argument("--tokenizer", default=None, metavar="NAME_OR_PATH",
                   help="transformers tokenizer enabling the text "
                        "surface: 'prompt' strings, stop STRINGS, "
                        "'text' in responses (ids-only without it)")
    p.add_argument("--register-with", default=None, metavar="URL",
                   help="router tier to self-register with "
                        "(http://host:port, workloads.router): this "
                        "replica heartbeats its address/model/"
                        "capacity + statz snapshot so the router can "
                        "load-balance and failover across the fleet")
    p.add_argument("--advertise", default=None, metavar="HOST:PORT",
                   help="address the ROUTER should dial back for this "
                        "replica (default 127.0.0.1:<port> — set to "
                        "the pod IP when router and replica are on "
                        "different hosts)")
    p.add_argument("--replica-id", default=None,
                   help="stable replica identity for routing/metrics "
                        "(default: the advertised address; keep it "
                        "stable across restarts so the router's "
                        "consistent-hash ring does not reshuffle)")
    p.add_argument("--register-interval", type=float, default=2.0,
                   help="seconds between router heartbeats (the "
                        "router's interval hint lowers it)")
    p.add_argument("--replica-role",
                   choices=["mixed", "prefill", "decode"],
                   default="mixed",
                   help="disaggregated-serving role, advertised via "
                        "/register and /statz: the router sends "
                        "prefill-heavy admissions to prefill-class "
                        "replicas and migrates the finished KV state "
                        "to decode-class ones (POST /migrate); "
                        "prefill/decode need --kv-paging (migration "
                        "is the paged pool's preempt/resume).  mixed "
                        "(default) serves everything locally")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda, required; pass "
                        "cpu to serve on the CPU)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    args = p.parse_args(argv)
    if args.int4 and args.quantized:
        p.error("--quantized and --int4 are mutually exclusive")
    if args.spec_ngram < 0:
        p.error("--spec-ngram must be >= 1 (0 disables)")
    if args.draft_config and args.spec_ngram:
        # before the (potentially many-GB) target build, like the
        # quantization check above
        p.error("--draft-config and --spec-ngram are mutually "
                "exclusive")
    if args.jump_len < 1:
        p.error("--jump-len must be >= 1")
    if args.prefix_chunk < 0:
        p.error("--prefix-chunk must be >= 0 (0 = auto)")
    if args.prefix_chunk and args.max_len % args.prefix_chunk:
        p.error(f"--prefix-chunk {args.prefix_chunk} must divide "
                f"--max-len {args.max_len}")
    if args.prefill_chunks < 1:
        p.error("--prefill-chunks must be >= 1")
    if args.max_pack < 2:
        p.error("--max-pack must be >= 2")
    if args.schedule_watchdog < 0:
        p.error("--schedule-watchdog must be >= 0 (0 disables)")
    if args.checkpoint_step is not None and not args.checkpoint:
        p.error("--checkpoint-step needs --checkpoint (without it the "
                "server would silently serve random weights)")
    if (args.kv_page_size or args.kv_pages or args.kv_dtype) \
            and not args.kv_paging:
        p.error("--kv-page-size/--kv-pages/--kv-dtype need --kv-paging")
    if args.kv_page_size < 0 or args.kv_pages < 0:
        p.error("--kv-page-size/--kv-pages must be >= 0")
    if args.prefix_registry_max < 1:
        p.error("--prefix-registry-max must be >= 1")
    if args.session_tier and not args.kv_paging:
        p.error("--session-tier needs --kv-paging (tier transitions "
                "are the paged pool's preempt/resume checkpoints)")
    if not args.session_tier and (
            args.session_dir or args.session_host_mb != 256
            or args.session_disk_keep != 512
            or args.session_idle != 30.0
            or args.session_host_idle != 120.0
            or args.session_seed != 0):
        p.error("--session-dir/--session-host-mb/--session-disk-keep/"
                "--session-idle/--session-host-idle/--session-seed "
                "need --session-tier")
    if args.session_tier:
        if args.session_host_mb < 1:
            p.error("--session-host-mb must be >= 1")
        if args.session_disk_keep < 1:
            p.error("--session-disk-keep must be >= 1")
        if args.session_idle <= 0 or args.session_host_idle <= 0:
            p.error("--session-idle/--session-host-idle must be > 0")
    if (args.advertise or args.replica_id) and not args.register_with:
        p.error("--advertise/--replica-id need --register-with")
    if args.replica_role != "mixed" and not args.kv_paging:
        p.error(f"--replica-role {args.replica_role} needs "
                "--kv-paging (KV migration is the paged pool's "
                "preempt/resume)")
    if args.register_interval <= 0:
        p.error("--register-interval must be > 0")
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
    if args.slo_window <= 0:
        p.error("--slo-window must be > 0")
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
    if args.flight_dump_keep < 1:
        p.error("--flight-dump-keep must be >= 1")
    import os as _pd_os
    profile_dir = (args.profile_dir
                   or _pd_os.environ.get("TPU_DP_PROFILE_DIR"))
    incident_dir = (args.incident_dir
                    or _pd_os.environ.get("TPU_DP_INCIDENT_DIR"))
    if args.profiler_hz <= 0:
        p.error("--profiler-hz must be > 0")

    cache_dir = (args.compile_cache_dir
                 or _pd_os.environ.get("TPU_DP_COMPILE_CACHE_DIR"))
    if cache_dir:
        enable_compile_cache(cache_dir)
    quantized = "int4" if args.int4 else args.quantized
    device = resolve_device(args.device)
    mesh = ctrl = None
    rank, tp_procs = 0, []
    if args.tp < 1:
        p.error("--tp must be >= 1")
    if args.tp > 1:
        # validated BEFORE any weight is built: a bad --tp fails in
        # milliseconds with an argparse error
        import torch

        for name in filter(None, (args.config, args.draft_config)):
            c = CONFIGS[name]
            n_kv = getattr(c, "n_kv_heads", None) or c.n_heads
            if n_kv % args.tp or c.n_heads % args.tp:
                p.error(f"--tp {args.tp} must divide {name}'s {n_kv} KV "
                        f"heads and {c.n_heads} query heads (the heads "
                        "and the cache shard on them)")
        if device.type == "cuda" and torch.cuda.device_count() < args.tp:
            p.error(f"--tp {args.tp} needs {args.tp} visible CUDA devices "
                    f"(NCCL takes one a rank), found "
                    f"{torch.cuda.device_count()}")
        world = _pd_os.environ.get("WORLD_SIZE")
        if world is not None and int(world) != args.tp:
            p.error(f"--tp {args.tp} under a launcher's WORLD_SIZE "
                    f"{world}")
        rank, device, mesh, ctrl, tp_procs = _tp_start(
            args.tp, device, sys.argv[1:] if argv is None else argv)
    if args.checkpoint:
        from .bench_serving import load_checkpoint_params

        t_restore = time.perf_counter()
        try:
            cfg, model = load_checkpoint_params(
                args.config, args.max_len, quantized, args.checkpoint,
                step=args.checkpoint_step, device=device, mesh=mesh)
        except FileNotFoundError as e:
            p.error(str(e))
        print(f"restored {args.checkpoint} in "
              f"{time.perf_counter() - t_restore:.2f}s (restore, "
              f"quantize, load onto {device})", flush=True)
    else:
        cfg, model = build_model_and_params(args.config, args.max_len,
                                            device, quantized=quantized,
                                            mesh=mesh)
    draft = None
    if args.draft_config:
        # greedy requests decode in spec rounds; sampled ones turn the
        # scheduler to windows
        _, draft = build_model_and_params(args.draft_config, args.max_len,
                                          device, seed=1,
                                          quantized=quantized, mesh=mesh)
    elif args.spec_ngram:
        draft = "ngram"
    engine = ServingEngine(model, n_slots=args.n_slots,
                           eos_id=getattr(cfg, "eos_id", None),
                           prefix_chunk=(args.prefix_chunk or "auto"),
                           logprobs_k=args.logprobs_k,
                           draft=draft, gamma=args.gamma,
                           ngram_n=args.spec_ngram or 3,
                           jump_len=args.jump_len,
                           kv_paging=args.kv_paging,
                           kv_pages=args.kv_pages or None,
                           kv_page_size=args.kv_page_size,
                           kv_dtype=args.kv_dtype,
                           prefix_registry_max=args.prefix_registry_max,
                           fused_decode=args.fused_decode,
                           mesh=mesh, device=device)
    leader = None
    if mesh is not None:
        from . import tp_driver

        if rank != 0:
            tp_driver.follow(engine, ctrl)
            return 0
        stopping = threading.Event()
        leader = engine = tp_driver.EngineLeader(
            engine, ctrl, on_lost=lambda err: _tp_lost(err, stopping))
        _tp_watch(tp_procs, stopping)
        print(f"tensor parallel: {args.tp} ranks, steps "
              f"{engine.stats()['tp_steps']}", flush=True)
    tokenizer = None
    if args.tokenizer:
        try:
            from transformers import AutoTokenizer

            tokenizer = AutoTokenizer.from_pretrained(args.tokenizer)
        except Exception as e:
            p.error(f"could not load tokenizer {args.tokenizer!r}: {e}")
    srv = EngineServer(engine, max_new_tokens=args.max_new_tokens,
                       window=args.window, tokenizer=tokenizer,
                       max_grammars=args.max_grammars,
                       max_grammar_states=args.max_grammar_states,
                       max_queue=args.max_queue,
                       max_connections=args.max_connections,
                       client_timeout=args.client_timeout,
                       flight_record_dir=args.flight_record_dir,
                       flight_record_capacity=args.flight_record_capacity,
                       interleave=not args.no_interleave,
                       prefill_chunks=args.prefill_chunks,
                       schedule_watchdog_s=args.schedule_watchdog,
                       tenant_quotas=tenant_quotas,
                       packed_prefill=args.packed_prefill,
                       overlap_dispatch=args.overlap_dispatch,
                       max_pack=args.max_pack,
                       slo_policies=slo_policies,
                       slo_window_s=args.slo_window,
                       profile_dir=profile_dir,
                       flight_dump_keep=args.flight_dump_keep,
                       replica_role=args.replica_role,
                       alert_rules=alert_rules,
                       alert_interval_s=args.alert_interval,
                       alert_window_scale=args.alert_window_scale,
                       incident_dir=incident_dir,
                       profiler_hz=args.profiler_hz,
                       session_tier=args.session_tier,
                       session_dir=args.session_dir,
                       session_host_mb=args.session_host_mb,
                       session_disk_keep=args.session_disk_keep,
                       session_idle_s=args.session_idle,
                       session_host_idle_s=args.session_host_idle,
                       session_seed=args.session_seed)
    if args.fault_spec is not None or args.fault_seed is not None:
        if args.fault_spec is None:
            p.error("--fault-seed needs --fault-spec")
        import os as _os
        seed = (args.fault_seed if args.fault_seed is not None
                else int(_os.environ.get(faults.ENV_FAULT_SEED, "0")
                         or 0))
        faults.install(args.fault_spec, seed=seed,
                       recorder=srv.recorder)
    else:
        faults.install_from_env(recorder=srv.recorder)
    # capture the adaptive-window step variants + packed-prefill
    # shapes before taking traffic (see warm_scheduler)
    t_warm = time.perf_counter()
    srv.warm_scheduler()
    print(f"warmup {time.perf_counter() - t_warm:.2f}s "
          f"(compile-cache: {cache_dir or 'off'})", flush=True)
    srv.start(host=args.host, port=args.port)
    if args.register_with:
        srv.start_registration(
            args.register_with, advertise=args.advertise,
            replica_id=args.replica_id, model=args.config,
            interval_s=args.register_interval)
    print(f"serving {args.config} (quantized={quantized}) on "
          f"http://{args.host}:{srv.port}  "
          f"[POST /generate, POST /v1/completions, GET /healthz, "
          f"GET /stats, GET /metrics]", flush=True)
    if leader is not None:
        import signal

        def _term(signum, frame):
            raise KeyboardInterrupt

        signal.signal(signal.SIGTERM, _term)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        srv.stop()
        if leader is not None:
            _tp_stop(leader, tp_procs, stopping)
    return 0


def _tp_start(n: int, device, argv):
    """Join (or start) the ranks of a ``--tp n`` server: ``(rank, device,
    mesh, control group, started processes)``.  Under torchrun's
    environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``) this process is its rank; else it is rank 0 and
    starts ranks 1..n-1 as this CLI with the same *argv* and that
    environment, their standard output dropped.  A started rank exits
    when its parent does.  Each rank takes CUDA device ``LOCAL_RANK``
    (NCCL), or the CPU (gloo); the control group, which carries rank
    0's engine calls, is gloo and waits as long as the server idles."""
    import datetime
    import os
    import socket
    import subprocess

    import torch
    import torch.distributed as dist

    from .transformer import make_lm_mesh

    procs, rank, local, init = [], 0, 0, "env://"
    if "RANK" in os.environ:
        rank = int(os.environ["RANK"])
        local = int(os.environ.get("LOCAL_RANK", rank))
    else:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        init = f"tcp://127.0.0.1:{port}"
        env = dict(os.environ, WORLD_SIZE=str(n), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), TPU_DP_TP_PARENT=str(os.getpid()))
        for r in range(1, n):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", __package__ + ".server", *argv],
                env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                stdout=subprocess.DEVNULL))
    if device.type == "cuda":
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=init, rank=rank, world_size=n)
    mesh = make_lm_mesh(seq=1, model=n, expert=1, device=device)
    ctrl = dist.new_group(backend="gloo",
                          timeout=datetime.timedelta(days=365))
    parent = os.environ.get("TPU_DP_TP_PARENT")
    if parent is not None and rank != 0:
        def watch():
            while os.getppid() == int(parent):
                time.sleep(1.0)
            os._exit(1)

        threading.Thread(target=watch, name="tp-parent", daemon=True).start()
    return rank, device, mesh, ctrl, procs


def _tp_lost(err: BaseException, stopping: threading.Event) -> None:
    """A tensor-parallel rank is gone: the server stops, it never serves
    on the ranks that are left (unless it is *stopping* already)."""
    import os

    if stopping.is_set():
        return
    log.error("tensor-parallel control group failed (%s); stopping", err)
    os._exit(1)


def _tp_watch(procs, stopping: threading.Event) -> None:
    """Stop this server when a rank it started exits before it is
    *stopping*."""
    import os

    def wait(proc):
        rc = proc.wait()
        if not stopping.is_set():
            log.error("tensor-parallel rank (pid %d) exited with %s; "
                      "stopping", proc.pid, rc)
            os._exit(1)

    for proc in procs:
        threading.Thread(target=wait, args=(proc,), name="tp-rank",
                         daemon=True).start()


def _tp_stop(leader, procs, stopping: threading.Event,
             timeout: float = 30.0) -> None:
    """End the other ranks' replay loops and wait for the ranks this
    process started (killed after *timeout*)."""
    import subprocess

    stopping.set()
    try:
        leader.close()
    except Exception as e:  # a rank already gone: kill what is left
        log.error("tensor-parallel close failed: %s", e)
    for proc in procs:
        try:
            proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


if __name__ == "__main__":
    raise SystemExit(main())
