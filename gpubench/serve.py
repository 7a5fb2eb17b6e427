"""Serving cells: the port's ``IterationScheduler`` over a paged
``ServingEngine``, driven the way the port's HTTP server drives it.

The host loop here is the server's scheduler loop without HTTP:
``pull`` hands the oldest due request to ``sched.begin`` (deferring, as
the server does, a prompt whose leading chunk an in-flight packed
admission shares), ``on_admit`` takes the first token, and after each
``iterate`` the loop takes every running stream's new tokens and
releases a slot when its request has all the tokens it asked for.
Decoding is greedy; the engine knows no end-of-sequence id, so every
request runs to its drawn length.

Open loop (``arrivals`` in the mix): requests fall due on the mix's
schedule from the traffic's start, whether or not the engine keeps up.
Closed loop (``callers`` in the mix): that many callers each send
their next request the moment the last one is answered.

A run: build the model and engine, warm every captured shape the
traffic uses, start the traffic, ramp (``ramp_s`` seconds of traffic,
or until every caller holds its first token), then measure from one
harvest to the first harvest ``--seconds`` later.  With ``--trace 1``
the profiler then records ``trace_slice_s`` seconds more of the same
traffic.  Every time is the
host's ``perf_counter`` as the loop sees it.  After the window the
program's state is freed and the reference checks a sample of the
finished requests (``check.py``).
"""

from __future__ import annotations

import gc
import math
import random
import sys
import time
from collections import deque
from typing import Dict, List, Optional

import torch

from . import traffic, weights
from .trace import Tracer

# the idle loop's sleep while nothing is due
_IDLE_S = 0.0005


class _Req:
    __slots__ = ("rid", "due", "prompt", "n_out", "pull", "first", "done",
                 "times", "tokens", "reused", "caller")

    def __init__(self, r: traffic.Request, due: float, caller: int = -1):
        self.rid, self.due, self.prompt = r.rid, due, r.prompt
        self.n_out = r.n_out
        self.pull = self.first = self.done = None
        self.times: List[float] = []
        self.tokens: List[int] = []
        self.reused = 0
        self.caller = caller

    def record(self) -> Dict:
        return dict(rid=self.rid, due=self.due, pull=self.pull,
                    first=self.first, done=self.done, times=self.times,
                    prompt_len=len(self.prompt), reused=self.reused,
                    n_out=self.n_out, caller=self.caller)


class Owner:
    """The engine's sole caller: intake, first tokens, streams, slot
    release.  *reqs* are due at ``t_start + t_due`` (open loop) or
    handed to callers in order (closed loop)."""

    def __init__(self, engine, max_len: int, reqs: List[traffic.Request],
                 callers: int, tracer: Tracer, fault=None):
        self.eng = engine
        self.max_len = max_len
        self.src = reqs
        self.callers = callers
        self.tracer = tracer
        self.fault = fault
        self.sched = None
        self.backlog: deque = deque()
        self.future: deque = deque()
        self.all: List[_Req] = []
        self.running: Dict[int, _Req] = {}
        self.tickets: Dict[object, _Req] = {}
        self.steps: List[tuple] = []
        self.harvests: List[float] = []
        self.stopping = False
        self.exhausted = False

    # -- traffic ------------------------------------------------------------

    def start(self, t_start: float) -> None:
        self.t_start = t_start
        if self.callers:
            self._pool = iter(self.src)
            for c in range(self.callers):
                self._send(c, t_start)
        else:
            self.future = deque(_Req(r, t_start + r.t_due)
                                for r in self.src)
            self.all.extend(self.future)

    def _send(self, caller: int, now: float) -> None:
        r = next(self._pool, None)
        if r is None:
            # the mix's pool is spent: this caller stops sending
            self.exhausted = True
            return
        q = _Req(r, now, caller)
        self.all.append(q)
        self.backlog.append(q)

    def _arrive(self, now: float) -> None:
        while self.future and self.future[0].due <= now:
            self.backlog.append(self.future.popleft())

    def next_due(self) -> Optional[float]:
        return self.future[0].due if self.future else None

    # -- the scheduler's callbacks -----------------------------------------

    def pull(self):
        with self.tracer.phase("pull"):
            if self.stopping:
                return None
            now = time.perf_counter()
            self._arrive(now)
            if not self.backlog:
                return None
            q = self.backlog[0]
            if self.sched.packing_conflict(q.prompt):
                return None
            self.backlog.popleft()
            # the server's budget cap: prompt + generation fit the cache
            q.n_out = max(1, min(q.n_out, self.max_len - len(q.prompt)))
            ticket = self.sched.begin(q.prompt)
            q.pull = now
            self.tickets[ticket] = q
            return ticket

    def on_admit(self, ticket) -> None:
        now = time.perf_counter()
        q = self.tickets.pop(ticket)
        q.first = now
        src = ticket.state.auto_src
        q.reused = int(src[2]) if src is not None else 0
        self.running[ticket.slot] = q
        self._emit(ticket.slot, now)

    def budget_hint(self, slot: int):
        q = self.running.get(slot)
        if q is None:
            return None
        return max(1, q.n_out - len(q.tokens))

    def _emit(self, slot: int, now: float) -> None:
        q = self.running[slot]
        new = self.eng.output(slot)[len(q.tokens):q.n_out]
        if self.fault is not None:
            new = self.fault(q, new)
        q.tokens += new
        q.times += [now] * len(new)
        if len(q.tokens) >= q.n_out:
            self.eng.release(slot)
            del self.running[slot]
            q.done = now
            if self.callers and not self.stopping:
                self._send(q.caller, now)

    # -- the loop -----------------------------------------------------------

    def step(self) -> bool:
        """One pass of the loop: wait while there is nothing to do, or
        one ``iterate`` and the streams' new tokens.  True when the pass
        ended at a harvest (decode tokens were taken)."""
        sched = self.sched
        now = time.perf_counter()
        self._arrive(now)
        if not self.running and not sched.busy() and not self.backlog:
            with self.tracer.phase("idle"):
                nxt = self.next_due()
                wait = _IDLE_S if nxt is None else min(_IDLE_S, nxt - now)
                if wait > 0:
                    time.sleep(wait)
            return False
        with self.tracer.phase("iterate"):
            res = sched.iterate()
        if not res.steps:
            return False
        t = time.perf_counter()
        self.steps.append((t, res.steps, len(res.decoded)))
        with self.tracer.phase("owner"):
            for slot in list(self.running):
                self._emit(slot, t)
        self.harvests.append(t)
        return True

    def idle(self) -> bool:
        return not (self.running or self.sched.busy() or self.backlog)

    def run_until(self, cond) -> float:
        """Loop until *cond(t)* holds at a harvest, or while the engine
        is idle; that instant."""
        while True:
            if self.step():
                t = self.harvests[-1]
            elif self.idle():
                t = time.perf_counter()
            else:
                continue
            if cond(t):
                return t


def _n_requests(mix: Dict, seconds: float) -> int:
    tr = mix["traffic"]
    if "callers" in tr:
        return int(tr["pool"])
    # the traced slice follows the window, with traffic still due, in
    # every run alike (so a traced run sends what an untraced one does)
    span = (float(mix["ramp_s"]) + seconds
            + float(mix.get("trace_slice_s", 3.0)) + 2.0)
    return int(math.ceil(float(tr["arrivals"]["rate"]) * span))


def _server_defaults():
    """The server CLI's defaults that its scheduler's and engine's
    constructors do not share: ``--window`` (``server.DEFAULT_WINDOW``)
    and ``--logprobs-k`` (5, a literal of the parser that
    ``server.main`` builds).  Every other setting is the constructors'
    own default, which the server passes unchanged."""
    from tpu_k8s_device_plugin_torch.workloads import server

    return dict(window=server.DEFAULT_WINDOW), dict(logprobs_k=5)


def build(cfg: Dict, mix: Dict, seed: int, device):
    """The program under test: the decoder at the configuration's
    widths with the benchmark's weights and the engine at the mix's
    slots, length and paging (everything else the server CLI's
    defaults), with every captured shape the scheduler uses warmed as
    the server's ``warm_scheduler`` warms them (and the serial
    admission extend)."""
    from tpu_k8s_device_plugin_torch.workloads import (inference, scheduler,
                                                        serving)

    m = weights.dims(cfg)
    e = mix["engine"]
    if m["dh"] * m["h"] != m["d"]:
        raise ValueError("the port's decoder takes head_dim = "
                         "hidden_size / num_attention_heads")
    model = inference.make_decoder(
        vocab=m["vocab"], d_model=m["d"], n_heads=m["h"],
        n_layers=m["layers"], d_ff=m["f"], max_len=int(e["max_len"]),
        dtype=torch.bfloat16, n_kv_heads=m["hkv"], ffn="swiglu",
        rope_theta=float(cfg["rope_theta"]), device="meta")
    flat, norms = weights.make(cfg, seed, device, torch.bfloat16)
    weights.bind_(model, cfg, flat, norms)
    del flat, norms
    sched_kw, engine_kw = _server_defaults()
    engine = serving.ServingEngine(
        model, n_slots=int(e["n_slots"]), eos_id=None,
        kv_paging=bool(e.get("kv_paging", False)),
        kv_page_size=int(e.get("kv_page_size", 0)), device=device,
        **engine_kw)
    window = sched_kw["window"]
    slot = engine.admit([0], ignore_eos=True)
    try:
        for k in range(1, scheduler.ADAPTIVE_WINDOW_FACTOR + 1):
            if engine.lens[slot] + window * k > model.max_len:
                break
            engine.run_scan(window * k)
    finally:
        engine.release(slot)
    engine.warm_packed(range(1, scheduler.DEFAULT_MAX_PACK + 1))
    return model, engine


def attach(engine, owner: "Owner"):
    """An ``IterationScheduler`` over *engine* with *owner*'s callbacks."""
    from tpu_k8s_device_plugin_torch.workloads import scheduler

    sched = scheduler.IterationScheduler(
        engine, pull=owner.pull, on_admit=owner.on_admit,
        budget_hint=owner.budget_hint, **_server_defaults()[0])
    owner.sched = sched
    return sched


def run(cfg: Dict, mix: Dict, seed: int, seconds: float, trace: bool,
        device, t_process: float, fault=None) -> Dict:
    """One serving run; returns the run record the readers and the
    check take.  *fault* (tests only) alters tokens as they are taken."""
    vocab = weights.dims(cfg)["vocab"]
    tr = mix["traffic"]
    reqs = traffic.generate(mix, vocab, seed, _n_requests(mix, seconds))
    tracer = Tracer()
    t_build = time.perf_counter()
    model, engine = build(cfg, mix, seed, device)
    owner = Owner(engine, int(mix["engine"]["max_len"]), reqs,
                  int(tr.get("callers", 0)), tracer, fault)
    sched = attach(engine, owner)
    t_traffic = time.perf_counter()
    owner.start(t_traffic)
    if owner.callers:
        t0 = owner.run_until(lambda t: all(
            q.first is not None for q in owner.all[:owner.callers]))
    else:
        ramp_end = owner.t_start + float(mix["ramp_s"])
        t0 = owner.run_until(lambda t: t >= ramp_end)
    stats0 = engine.stats()
    setup_s = t0 - t_process
    t_end = t0 + seconds
    t1 = owner.run_until(lambda t: t >= t_end)
    stats1 = engine.stats()
    if trace:
        tracer.start()
        t_stop = time.perf_counter() + float(mix.get("trace_slice_s", 3.0))
        owner.run_until(lambda t: t >= t_stop)
        tracer.stop()
    owner.stopping = True
    peak = 0
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device)
    done = [q for q in owner.all if q.done is not None]
    s0, s1 = stats0, stats1
    if owner.exhausted:
        print("gpubench serve: the closed loop's pool ran out: raise the "
              "mix's pool", file=sys.stderr, flush=True)
    print(f"gpubench serve: process to build {t_build - t_process:.2f} s, "
          f"build and warm-up {t_traffic - t_build:.2f} s, ramp "
          f"{t0 - t_traffic:.2f} s, window {t1 - t0:.3f} s; requests "
          f"{len(owner.all)} made, {len(done)} done, {len(owner.backlog)} "
          f"waiting, {len(owner.running)} running at the end; in the "
          f"window: prefill tokens "
          f"{s1['prefill_tokens'] - s0['prefill_tokens']}, prefix-reused "
          f"{s1['prefix_reused_tokens'] - s0['prefix_reused_tokens']}, "
          f"decode steps {s1['decode_steps'] - s0['decode_steps']}, "
          f"preemptions {s1.get('kv_preemptions', 0) - s0.get('kv_preemptions', 0)}"
          f"; peak {peak / 2**30:.2f} GiB", file=sys.stderr, flush=True)
    record = dict(
        kind="serve", t0=t0, t1=t1, setup_s=setup_s,
        attempted=sum(t0 <= q.due < t1 for q in owner.all), failed=0,
        requests=[q.record() for q in owner.all],
        steps=owner.steps, trace=tracer.result or None,
        memory_peak_bytes=peak, dims=weights.dims(cfg),
        samples=_sample(done, mix, seed))
    del model, engine, sched, owner
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return record


def _sample(done: List[_Req], mix: Dict, seed: int) -> List[Dict]:
    """The finished requests the reference checks: the one with the
    longest sequence, then others drawn from the seed until the sample
    holds the mix's ``check.tokens`` served tokens or
    ``check.requests`` requests."""
    if not done:
        return []
    c = mix["check"]
    longest = max(done, key=lambda q: len(q.prompt) + len(q.tokens))
    rest = [q for q in done if q is not longest]
    random.Random(seed ^ 0xC4EC).shuffle(rest)
    pick = [longest]
    n_tok = len(longest.tokens)
    for q in rest:
        if n_tok >= int(c["tokens"]) or len(pick) >= int(c["requests"]):
            break
        pick.append(q)
        n_tok += len(q.tokens)
    return [dict(rid=q.rid, prompt=list(q.prompt), served=list(q.tokens))
            for q in pick]
