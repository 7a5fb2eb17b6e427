# tpulint: deterministic-path -- the engine equivalence suites replay this file's decisions from seeds; D1 bans bare random/time.time() here
"""Iteration-level scheduler: chunked prefill interleaved with decode.

The JAX package's ``workloads/scheduler.py`` over the port's
``ServingEngine``, decision for decision.  Without it a multi-chunk
prompt prefill stalls every running stream, and a request that arrives
while a window is open waits for it to close.  This module is the
Orca/vLLM move (iteration-level scheduling / continuous batching with
chunked prefill) built on the engine's own primitives:

* **unified work queue** — every iteration owns both kinds of work:
  decode-ready slots (one ``scan_dispatch`` window) and pending
  prefill chunks (``begin_admit`` tickets advanced one
  ``admit_step`` at a time).
* **interleave** — the decode window is DISPATCHED first (async), then
  prefill chunks, new admissions, and admission finishes are enqueued
  while the device chews the window; the window's one blocking
  ``scan_harvest`` then covers the scan AND the admissions.  Prefill
  compute overlaps in-flight decode instead of serializing with it,
  and the host bookkeeping between device calls overlaps device time
  instead of adding to it.
* **mid-window admission** — ``pull`` (the owner's intake callback)
  runs again between the window's dispatch and harvest, so a request
  that arrives while a window is open starts prefilling BEFORE that
  window closes instead of queueing behind it.
* **ragged packed prefill** — multiple pending admissions' next
  chunks dispatch as ONE batched extend
  (``engine.admit_step_packed``): K concurrent cold prompts cost one
  host dispatch per chunk-round instead of K, and on parallel
  hardware share one pass over the weights.  On the port every chunked
  admission extend runs at the engine's ``pack_width`` rows (one CUDA
  graph, see ``warm_packed``), so ``max_pack`` may not exceed it; the
  head ticket still splices FIRST, so admission order — and with it
  the APC-donor and draw-chain order — is exactly the serial path's.
* **dispatch-ahead overlap** — after harvesting window N the
  scheduler immediately dispatches window N+1 (double-buffered
  dispatch/harvest), so the owner's host-side stream-write work
  between ``iterate()`` calls overlaps device compute instead of
  leaving the device idle.  GUARDED to the all-greedy knob regime: a
  live sampled slot retiring behind an already-dispatched window
  would shift the draw chain that seeded neighbors replay, so any
  sampled slot live ⇒ serial cadence (outputs stay byte-identical
  with overlap on or off — the equivalence suite pins it).

Correctness bar (the house invariant): outputs are bit-identical with
interleaving on or off — and with packing or overlap on or off.
Greedy and grammar-constrained slots are deterministic per slot;
seeded sampled slots draw from their own fold_in chain indexed by a
per-slot draw counter that advances only with picks the slot
participates in — all scheduling-order invariant.  (Unseeded sampled
streams depend on the global key stream by design; per-request seeds
exist precisely to opt out of that.)  The engine enforces the
mechanics: mid-window splices — and slots the owner releases while an
overlap window is in flight — land in the dispatched window's
``skip`` set so harvest never advances a lens or draw chain behind
their back.

Fault hook: ``serve.schedule`` fires at the top of every iteration
(error/hang kinds), and :meth:`IterationScheduler.supersede` lets the
crash supervisor invalidate an iteration a watchdog abandoned — the
abandoned worker re-checks the generation right after the hook and
bails before touching the engine (an outstanding dispatch-ahead
window is abandoned with it).
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from .. import obs
from ..obs.ranges import device_range
from ..resilience import faults
from .serving import AdmitState, ServingEngine, _knobs_live

# interleave granularity: how many prefill chunk DISPATCHES may ride
# one open window (a packed dispatch advances up to max_pack
# admissions but spends ONE unit — that is the point of packing).
# Bounds how far prefill can delay the window's harvest; the
# remainder rides the next window(s).
DEFAULT_PREFILL_BUDGET = 4

# ragged packed prefill: most admissions packed into one batched
# extend.  The port runs every chunked admission extend at the engine's
# pack_width rows (serving.PACK_WIDTH, also 4), which bounds it; 4
# covers the common convoy widths.
DEFAULT_MAX_PACK = 4

# batch-forming dwell at a fresh-batch boundary (the engine just went
# idle and admissions are landing): wait this long for stragglers so
# the whole convoy enters ONE synchronized window instead of desyncing
# into underfull ones.  First tokens already streamed at admit (eager
# resolve), so the dwell costs second-token latency only.
DEFAULT_SYNC_DWELL_S = 0.002

# adaptive-window growth cap, as a multiple of the configured window:
# the window may grow toward the smallest remaining per-request budget
# (fewer harvests when every stream still needs the steps) but never
# past FACTOR x the floor — the floor stays the operator's stream-
# pacing/shutdown-granularity knob, grown windows just amortize it
ADAPTIVE_WINDOW_FACTOR = 4

# the loop's phases (``IterationScheduler.in_phase``): the four the device
# duty cycle reads -- dispatch (host-side window dispatch), harvest
# (blocking device sync: scan harvest, spec/jump rounds, endgame
# steps), stream (the owner's emit work between iterations), idle (the
# owner waiting for work) -- then admission's: begin (begin_admit: APC
# match, slot and page reservation), admit (one prefill chunk dispatch,
# serial or packed), splice (the finish dispatch) and first_token (the
# first-token read, the admission's one synchronisation)
DUTY_PHASES = ("dispatch", "harvest", "stream", "idle")
PHASES = DUTY_PHASES + ("begin", "admit", "splice", "first_token")


class SchedulerSuperseded(RuntimeError):
    """This iteration was invalidated (crash supervisor restarted the
    loop while a watchdog-abandoned worker still held it)."""


class Ticket:
    """One admission riding the scheduler: an engine
    :class:`~.serving.AdmitState` plus scheduling stamps on the
    ``perf_counter`` clock: ``t_begin`` after ``begin_admit``,
    ``t_splice`` just before the splice dispatch, ``t_done`` once the
    first token is read.  ``slot`` is reserved from ``begin`` on; the
    request is live only after the ticket shows up in
    :class:`IterationResult` ``admitted``."""

    __slots__ = ("state", "t_begin", "t_splice", "t_done", "mid_window")

    def __init__(self, state: AdmitState, t_begin: float,
                 mid_window: bool):
        self.state = state
        self.t_begin = t_begin
        self.t_splice = 0.0
        self.t_done = 0.0
        self.mid_window = mid_window

    @property
    def slot(self) -> int:
        return self.state.slot

    @property
    def chunks_done(self) -> int:
        return self.state.chunks_done

    @property
    def chunks_total(self) -> int:
        return self.state.chunks_total


class IterationResult:
    """What one :meth:`IterationScheduler.iterate` did: admissions
    that went live (their first token is in ``engine.output(slot)``),
    the decode output map (``{slot: [tokens]}`` for slots in the
    window/round), and how many decode steps ran."""

    __slots__ = ("admitted", "decoded", "steps")

    def __init__(self, admitted: List[Ticket],
                 decoded: Dict[int, List[int]], steps: int):
        self.admitted = admitted
        self.decoded = decoded
        self.steps = steps


class IterationScheduler:
    """Iteration-level scheduler over one :class:`ServingEngine`.

    Single-threaded by contract, like the engine it drives: exactly
    one loop calls :meth:`iterate`.  The owner supplies *pull*, called
    whenever the scheduler can take new work (``None`` = nothing
    waiting); it must create the ticket via :meth:`begin` and handle
    its own validation errors.

    With ``packed_prefill`` off (or an unpackable engine) one ticket
    is in flight at a time: admission is serial on the device anyway,
    and serializing tickets keeps sibling/repeat prompts hitting the
    prefix cache exactly as one-shot admission did (a prompt becomes a
    donor only once its splice lands).  With packing on, up to
    ``max_pack`` tickets prefill CONCURRENTLY through batched extends;
    splices stay strictly FIFO, and owners that care about sibling APC
    reuse defer conflicting pulls via :meth:`packing_conflict` (the
    HTTP server does), so the donor order a repeat prompt observes is
    unchanged."""

    def __init__(self, engine: ServingEngine, window: int = 8,
                 interleave: bool = True,
                 prefill_budget: int = DEFAULT_PREFILL_BUDGET,
                 pull: Optional[Callable[[], Optional[Ticket]]] = None,
                 on_admit: Optional[Callable[[Ticket], None]] = None,
                 budget_hint: Optional[
                     Callable[[int], Optional[int]]] = None,
                 sync_dwell_s: float = DEFAULT_SYNC_DWELL_S,
                 packed_prefill: bool = True,
                 max_pack: int = DEFAULT_MAX_PACK,
                 overlap: bool = True,
                 registry=None, recorder=None):
        if window < 1:
            raise ValueError("window must be >= 1")
        if prefill_budget < 1:
            raise ValueError("prefill_budget must be >= 1")
        if max_pack < 2:
            raise ValueError("max_pack must be >= 2")
        self.engine = engine
        self.window = window
        self.interleave = bool(interleave)
        self.prefill_budget = prefill_budget
        # packing needs a fixed chunk grid (the packed extend's shape)
        # and per-row-independent FFN math — the engine's _PrefillJob
        # re-checks per admission (plp jobs stay serial)
        self._packing = (bool(packed_prefill)
                         and engine.chunk is not None
                         and engine.model.n_experts == 0)
        if self._packing and max_pack > engine.pack_width:
            raise ValueError(
                f"max_pack {max_pack} exceeds the engine's pack_width "
                f"{engine.pack_width}")
        self.max_pack = max_pack
        self.overlap = bool(overlap)
        self._pull = pull
        # called the moment an admission goes live (scheduler thread,
        # possibly MID-WINDOW): the owner streams the first token right
        # away instead of waiting for the window's harvest — TTFT stays
        # decoupled from the window size
        self._on_admit = on_admit
        # remaining-token hint per slot (None = unknown): lets the
        # window GROW past its floor when every running request still
        # needs that many steps — a batch-synchronized generation
        # harvests once instead of once per `window` steps, without
        # adding garbage decode (the window never outruns the smallest
        # remaining budget)
        self._budget_hint = budget_hint
        self.sync_dwell_s = sync_dwell_s
        self.recorder = recorder
        self._pending: List[Ticket] = []   # FIFO; len <= pack limit
        self._await_first: List[Ticket] = []  # finalized, pre-1st-step
        self._ahead: Optional[Tuple[object, int]] = None  # (handle, n)
        self._gen = 0                         # supersession counter
        self._m_chunk = self._m_first = self._m_first_wait = None
        self._m_chunk_tokens = None
        self._m_overlap_idle = self._m_overlap_windows = None
        self._g_prefill = self._g_decode = None
        # per-window phase breakdown + device duty cycle: cumulative
        # wall seconds by phase (PHASES).  Single writer (the
        # scheduler thread); the scrape-time duty collector only reads
        self._phase_acc: Dict[str, float] = dict.fromkeys(PHASES, 0.0)
        # the phase entered last (``in_phase`` sets it) — the continuous
        # profiler's phase_fn reads this to tag stack samples, so a
        # profile slice can split "time under dispatch" from "time
        # blocked in harvest".  Single writer (the loop's thread); racy
        # reads are fine, a sample tagged one phase late is still an
        # honest sample.
        self.phase: str = "idle"
        self._phase_hist: Dict[str, object] = {}
        self._m_phase = None
        self._g_duty = None
        self._duty_snap = dict.fromkeys(DUTY_PHASES, 0.0)
        if registry is not None:
            self._m_chunk = registry.histogram(
                "tpu_serve_prefill_chunk_seconds",
                "One prefill-chunk dispatch on the scheduler thread "
                "(async: device time overlaps the open decode window; "
                "a packed dispatch advances several admissions and "
                "observes once).",
                buckets=obs.FAST_BUCKETS_S)
            self._m_first = registry.histogram(
                "tpu_serve_admit_to_first_step_seconds",
                "Admission handoff to the slot's first decode-window "
                "dispatch (prefill + finalize, interleave included).",
                buckets=obs.LATENCY_BUCKETS_S)
            self._m_first_wait = registry.histogram(
                "tpu_serve_first_token_wait_seconds",
                "An admission's splice dispatch to its first token on "
                "the host (the first-token read waits for the device "
                "work queued before it, an open decode window "
                "included).",
                buckets=obs.LATENCY_BUCKETS_S)
            self._m_chunk_tokens = registry.counter(
                "tpu_serve_prefill_chunk_tokens_total",
                "Prompt tokens extended by prefill chunk dispatches "
                "(pad rows and prefix-cache hits left out), counted "
                "at each dispatch.")
            self._m_overlap_idle = registry.histogram(
                "tpu_serve_overlap_idle_seconds",
                "Device time a dispatch-ahead window still had left "
                "when its harvest was reached — overlap the host work "
                "did NOT cover (0-bucket harvests mean the window was "
                "already done: full overlap).",
                buckets=obs.FAST_BUCKETS_S)
            self._m_overlap_windows = registry.counter(
                "tpu_serve_overlap_windows_total",
                "Decode windows dispatched AHEAD of their harvest "
                "(double-buffered dispatch/harvest overlap).")
            # materialize the default children so overlap-off (or
            # not-yet-overlapped) servers still render the families
            # as zeros — dashboards see ONE schema
            self._m_overlap_idle._default()
            self._m_overlap_windows.inc(0)
            self._m_first_wait._default()
            self._m_chunk_tokens.inc(0)
            g = registry.gauge(
                "tpu_serve_scheduler_queue_depth",
                "Iteration-scheduler work-queue depth by kind: "
                "prefill (admissions in flight), decode (active "
                "slots).", ("kind",))
            self._g_prefill = g.labels(kind="prefill")
            self._g_decode = g.labels(kind="decode")
            self._m_phase = registry.histogram(
                "tpu_serve_window_phase_seconds",
                "Scheduler-loop time by phase: dispatch (host-side "
                "window dispatch), harvest (blocking device sync — "
                "scan harvest, spec/jump rounds, endgame steps), "
                "stream (the owner's emit/stream-write work between "
                "iterations), idle (waiting for work), begin "
                "(begin_admit: prefix match, slot and page "
                "reservation), admit (one prefill chunk dispatch, "
                "serial or packed), splice (an admission's finish "
                "dispatch), first_token (its first-token read).",
                ("phase",), buckets=obs.FAST_BUCKETS_S)
            # one schema from boot: every phase child renders (zeros)
            # whether or not the loop has reached it yet
            self._phase_hist = {
                p: self._m_phase.labels(phase=p)
                for p in self._phase_acc}
            self._g_duty = registry.gauge(
                "tpu_serve_device_duty_cycle",
                "Fraction of scheduler-loop wall time the device was "
                "kept busy (dispatch+harvest over all phases) since "
                "the previous scrape — the direct measurement of the "
                "prefill-gap estimates.")
            self._g_duty.set(0.0)
            registry.on_collect(self._collect_duty)
            registry.on_collect(lambda: self._m_chunk_tokens._set(
                self.engine.prefill_chunk_tokens))

    # -- intake -------------------------------------------------------------

    def begin(self, prompt, **admit_kwargs) -> Ticket:
        """Validate + reserve via ``engine.begin_admit`` and queue the
        ticket.  Called from inside the owner's *pull* callback (same
        thread as iterate — the engine has one owner).  Raises
        whatever begin_admit raises; nothing is queued then."""
        with self.in_phase("begin"):
            st = self.engine.begin_admit(prompt, **admit_kwargs)
        t = Ticket(st, time.perf_counter(),
                   mid_window=self.engine.scan_inflight)
        self._pending.append(t)
        return t

    def cancel(self, ticket: Ticket) -> None:
        """Abandon a queued admission (client went away)."""
        if ticket in self._pending:
            self._pending.remove(ticket)
            self.engine.abort_admit(ticket.state)

    def busy(self) -> bool:
        """Admission work still queued, or a dispatch-ahead window
        still awaiting its harvest?"""
        return bool(self._pending or self._await_first
                    or self._ahead is not None)

    def pending_tickets(self) -> List[Ticket]:
        return list(self._pending)

    def packing_conflict(self, prompt) -> bool:
        """Would beginning *prompt* NOW forfeit an APC match a serial
        admission would have had?  True when packing is active and an
        in-flight pending admission shares a >= chunk-grid prefix with
        *prompt* (the donor it would match has not spliced yet).
        Owners defer such pulls until the conflicting ticket lands —
        tokens would be identical either way, but sibling copies and
        repeat prompts would pay a full cold prefill the serial path
        never paid."""
        if not self._packing or not self._pending:
            return False
        c = self.engine.chunk
        p = np.asarray(prompt, np.int32).ravel()
        if len(p) < c:
            return False
        for t in self._pending:
            q = t.state.prompt_np[0]
            if len(q) >= c and np.array_equal(p[:c], q[:c]):
                return True
        return False

    def supersede(self) -> None:
        """Invalidate the current iteration (crash-supervisor restart
        path): a watchdog-abandoned worker re-checks the generation
        right after the fault hook and bails before touching the
        engine.  Pending admissions are aborted — their requests get
        the supervisor's 503 — and an outstanding dispatch-ahead
        window is abandoned (its slots are about to be released)."""
        self._gen += 1
        if self._ahead is not None:
            self.engine.scan_abandon(self._ahead[0])
            self._ahead = None
        for t in self._pending:
            try:
                self.engine.abort_admit(t.state)
            except RuntimeError:
                pass  # already spliced: the supervisor releases slots
        self._pending.clear()
        self._await_first.clear()

    # -- the iteration ------------------------------------------------------

    def _check(self, gen: int) -> None:
        if gen != self._gen:
            raise SchedulerSuperseded(
                "scheduler restarted while this iteration was "
                "abandoned by the watchdog")

    def _pull_limit(self) -> int:
        return self.max_pack if self._packing else 1

    def _pull_tickets(self) -> None:
        """Take new work while there is a free slot and ticket room —
        one in-flight ticket serially, up to ``max_pack`` when packing
        (concurrent prefills are what the batched extend packs)."""
        if self._pull is None:
            return
        limit = self._pull_limit()
        while len(self._pending) < limit and self.engine.free_slots():
            if self._pull() is None:
                return

    def _pack_group(self) -> List[AdmitState]:
        """The states the next prefill dispatch advances: the head
        alone (serial, or an unpackable head — plp jobs), or every
        packable in-flight state up to ``max_pack``."""
        head = self._pending[0].state
        if (not self._packing or head.gen is None
                or not head.gen.packable):
            return [head]
        group = [t.state for t in self._pending
                 if t.state.gen is not None and t.state.gen.packable]
        return group[:self.max_pack]

    def _admit_work(self, budget: int) -> List[Ticket]:
        """Admission work: spend up to *budget* prefill DISPATCHES
        (each serial or packed — a packed dispatch advances every
        in-flight packable admission one chunk), finalize-dispatch
        every admission that completes IN FIFO ORDER, and pull
        replacements as slots allow — multiple admissions can land
        inside ONE open window (slot turnover refills the whole batch
        without waiting a window per request).  Returns the
        splice-dispatched tickets; the caller resolves them after the
        window's harvest."""
        fins: List[Ticket] = []
        eng = self.engine
        n = budget
        while True:
            if len(self._pending) < self._pull_limit():
                self._pull_tickets()
            # splice strictly head-first: a later ticket may finish
            # its chunks early, but it becomes live (and an APC donor)
            # only in arrival order — the serial path's order
            while self._pending and self._pending[0].state.ready:
                t = self._finalize_dispatch()
                if t is not None:
                    # resolve EAGERLY: the first token streams as soon
                    # as the device has picked it.  The pick depends
                    # only on the prefill chain, but the port enqueues
                    # everything on one CUDA stream, so the read waits
                    # for all the work dispatched before it, the open
                    # decode window included: the first token comes
                    # when that window ends, as it would at the
                    # harvest, and the host enqueues nothing more
                    # until then
                    fins += self._finalize_resolve(t)
                self._pull_tickets()
            if not self._pending or n <= 0:
                return fins
            group = self._pack_group()
            t0 = time.perf_counter()
            with self.in_phase("admit"):
                if len(group) >= 2:
                    # one resident pack session: run until the shortest
                    # member's last chunk (or the budget) — pack/unpack
                    # copies amortize over the whole session
                    rounds = min(n, min(st.gen.remaining for st in group))
                    eng.admit_step_packed(group, rounds)
                    n -= rounds
                else:
                    eng.admit_step(group[0])
                    n -= 1
            if self._m_chunk is not None:
                self._m_chunk.observe(time.perf_counter() - t0)

    def _finalize_dispatch(self) -> Optional[Ticket]:
        """Splice a fully-prefilled head ticket (device dispatch only;
        the first-token pick stays on device until resolve)."""
        if self._pending and self._pending[0].state.ready:
            t = self._pending.pop(0)
            t.t_splice = time.perf_counter()
            with self.in_phase("splice"):
                self.engine._finish_admit_dispatch(t.state)
            return t
        return None

    def _finalize_resolve(self, t: Optional[Ticket]) -> List[Ticket]:
        if t is None:
            return []
        with self.in_phase("first_token"):
            self.engine._finish_admit_resolve(t.state)
        t.t_done = time.perf_counter()
        if self._m_first_wait is not None:
            self._m_first_wait.observe(t.t_done - t.t_splice)
        self._await_first.append(t)
        if self._on_admit is not None:
            self._on_admit(t)
        return [t]

    def _drain_admissions(self) -> List[Ticket]:
        """Admit everything waiting, one-shot style (interleave off /
        spec & jump rounds / fresh-batch boundaries): pull → prefill
        to completion → finalize, until no capacity or no work.
        Serially this is byte-for-byte the admission order the
        pre-scheduler loop produced; with packing the prefills batch
        but the finalize order is unchanged."""
        return self._admit_work(1 << 30)

    def _note_first_step(self) -> None:
        """A decode dispatch is about to include every live slot:
        observe admit→first-step for freshly admitted ones."""
        if not self._await_first:
            return
        now = time.perf_counter()
        if self._m_first is not None:
            for t in self._await_first:
                if self.engine.active[t.slot]:
                    self._m_first.observe(now - t.t_begin)
        self._await_first.clear()

    @contextmanager
    def in_phase(self, name: str) -> Iterator[None]:
        """Run the body as scheduler-loop phase *name* (one of
        ``PHASES``): it becomes ``phase`` (the sampling profiler's
        tag), its wall seconds are added to the phase's sum and
        histogram child, and while a torch profiler records it is the
        range ``serve.<name>`` in the trace.  Phases do not nest.
        The scheduler times its own; the loop's OWNER runs its
        stream-write and idle-wait work under ``stream`` and ``idle``
        (the scheduler cannot see between its own iterations)."""
        if name not in self._phase_acc:
            raise ValueError(f"unknown scheduler phase {name!r}")
        self.phase = name
        t0 = time.perf_counter()
        with device_range(f"serve.{name}"):
            yield
        dt = time.perf_counter() - t0
        self._phase_acc[name] += dt
        child = self._phase_hist.get(name)
        if child is not None:
            child.observe(dt)  # type: ignore[attr-defined]

    def _collect_duty(self) -> None:
        """Scrape-time device duty cycle: dispatch+harvest seconds
        over the seconds of the four DUTY_PHASES since the PREVIOUS
        scrape, falling back to the lifetime ratio on the first
        (delta-free) scrape."""
        cur = {p: self._phase_acc[p] for p in DUTY_PHASES}
        prev = self._duty_snap
        busy = (cur["dispatch"] - prev["dispatch"]
                + cur["harvest"] - prev["harvest"])
        total = sum(cur.values()) - sum(prev.values())
        if total <= 0.0:
            busy = cur["dispatch"] + cur["harvest"]
            total = sum(cur.values())
        self._duty_snap = cur
        if self._g_duty is not None and total > 0.0:
            self._g_duty.set(max(0.0, min(1.0, busy / total)))

    def _timed_dispatch(self, window: int) -> object:
        with self.in_phase("dispatch"):
            return self.engine.scan_dispatch(window)

    def _gauges(self) -> None:
        if self._g_prefill is not None:
            self._g_prefill.set(len(self._pending)
                                + len(self._await_first))
            self._g_decode.set(sum(self.engine.active))

    def _choose_window(self, consumed: Optional[Dict[int, int]] = None
                       ) -> int:
        """Window length for the next scan: the configured floor,
        grown in quantized floor-multiples toward the smallest
        remaining per-request budget (full engine only), capped by
        cache headroom.  < 1 means a slot ran out of cache (endgame
        step territory — never dispatched ahead).  *consumed* adjusts
        the owner's budget hints by tokens a just-harvested window
        produced that the owner has not streamed yet (the
        dispatch-ahead path runs BEFORE the owner's emit, so its raw
        hints are stale by exactly one window)."""
        eng = self.engine
        headroom = min(eng.model.max_len - eng.lens[s]
                       for s in range(eng.n_slots) if eng.active[s])
        window = self.window
        if self._budget_hint is not None and not eng.free_slots():
            # adaptive window, gated on a FULL engine: grow toward the
            # smallest remaining per-request budget (one harvest per
            # synchronized generation instead of one per `window`
            # steps, with no slot decoding garbage past its
            # retirement).  With free or reserved slots the floor
            # window stands — a request arriving moments after a long
            # window opened would otherwise sit it out entirely, which
            # costs far more than the extra harvests (the JAX package's
            # server measured the ungated version swinging with the
            # clients' arrival phase)
            need = None
            for s in range(eng.n_slots):
                if not eng.active[s]:
                    continue
                h = self._budget_hint(s)
                if h is not None and consumed:
                    h -= consumed.get(s, 0)
                if h is None:
                    need = None
                    break
                need = h if need is None or h < need else need
            if need is not None and need > window:
                # QUANTIZED to whole multiples of the floor, as the JAX
                # package's scheduler does (there each window length is
                # its own XLA compile; the port replays one captured
                # step n times, so a length costs no capture, and the
                # same rule keeps the two schedulers' decisions equal).
                # Round UP when the overshoot is under half a floor (a
                # 63-step batch runs one 64-window, not 48+16 — the
                # single garbage step costs less than the extra
                # harvest); otherwise down.
                k, rem = divmod(need, self.window)
                if rem and self.window - rem <= self.window // 2:
                    k += 1
                window = self.window * max(
                    1, min(ADAPTIVE_WINDOW_FACTOR, k))
        return min(window, headroom)

    def _maybe_dispatch_ahead(
            self, decoded: Optional[Dict[int, List[int]]] = None
    ) -> None:
        """Double-buffered dispatch: put the NEXT window on the device
        before returning from iterate, so the owner's host-side
        harvest/stream-write work between calls overlaps device
        compute instead of leaving it idle.  Engaged ONLY when the
        post-harvest state would choose a plain scan anyway AND —
        without the fused decode loop — no sampled knob is live: a
        sampled slot retiring behind an already-dispatched window
        would shift the draw accounting seeded neighbors replay —
        greedy/grammar windows have no draw stream, and a slot the
        owner releases mid-window lands in the handle's skip set, so
        output bytes are unchanged (the equivalence suite pins overlap
        on == off).  With ``fused_decode`` the sampled stand-down
        lifts: dispatch-ahead runs AFTER the previous harvest applied
        all draw/retirement accounting, the picked rows are
        independent per slot (a retired neighbor's key-stream rows
        produce only discarded tokens, same masking contract as
        run_scan), and boundaries the carry detects truncate at
        harvest — so sampled windows overlap byte-identically too, and
        only the budget-imminent check below still stands windows
        down.

        *decoded* — the harvest this iterate just returned, which the
        owner has NOT streamed yet — adjusts the budget hints: if any
        stream's remaining budget (net of the unstreamed tokens) is
        exhausted, the owner is about to release its slot, and a
        pre-dispatched window would decode a garbage column the whole
        width; stand down and let the serial path re-evaluate after
        the owner's emit (without this check every batch turnover
        burns one to two full garbage windows)."""
        if not (self.overlap and self.interleave):
            return
        eng = self.engine
        if not any(eng.active):
            return
        if eng.spec_ready() or eng.forced_pending():
            return
        if not getattr(eng, "fused_decode", False) and \
                _knobs_live(eng.temps, eng.topks, eng.topps,
                            eng.minps, eng.pres, eng.freqs, eng.reps):
            return
        consumed = ({s: len(t) for s, t in decoded.items()}
                    if decoded else None)
        if self._budget_hint is not None:
            for s in range(eng.n_slots):
                if not eng.active[s]:
                    continue
                h = self._budget_hint(s)
                if h is None:
                    continue
                if consumed:
                    h -= consumed.get(s, 0)
                if h < 1:
                    return      # retirement imminent: serial cadence
        window = self._choose_window(consumed)
        if window < 1:
            return
        self._note_first_step()
        handle = self._timed_dispatch(window)
        self._ahead = (handle, window)
        if self._m_overlap_windows is not None:
            self._m_overlap_windows.inc()

    def _iterate_ahead(self, gen: int) -> IterationResult:
        """One iteration against a window dispatched by the PREVIOUS
        iterate: admission work overlaps it exactly as it would a
        same-iteration window (same mid-window splice semantics, same
        skip set), then the harvest's blocking sync covers whatever
        device time the host work did not already hide."""
        eng = self.engine
        handle, window = self._ahead
        if faults.ACTIVE is not None:
            faults.ACTIVE.fire("serve.step")
            faults.ACTIVE.fire("serve.schedule")
        self._check(gen)
        # taken only now: a crash or a watchdog trip above leaves the
        # window in ``_ahead``, where the supervisor's ``supersede``
        # abandons it (else the engine keeps it outstanding and every
        # dispatch of the restarted loop refuses)
        self._ahead = None
        fins = self._admit_work(self.prefill_budget)
        t0 = time.perf_counter()
        with self.in_phase("harvest"):
            decoded = eng.scan_harvest(handle)
        dt = time.perf_counter() - t0
        if self._m_overlap_idle is not None:
            self._m_overlap_idle.observe(dt)
        self._maybe_dispatch_ahead(decoded)
        self._gauges()
        return IterationResult(fins, decoded, window)

    def iterate(self) -> IterationResult:
        """One scheduler iteration: admission work + at most one
        decode round (scan window / spec round / jump round / endgame
        step), interleaved when enabled.  The owner loops this."""
        gen = self._gen
        eng = self.engine
        if self._ahead is not None:
            # overlap mode: window N+1 is already on the device —
            # admission work rides it, then its harvest
            return self._iterate_ahead(gen)
        admitted: List[Ticket] = []
        fresh_batch = self.interleave and not any(eng.active)
        if not self.interleave or fresh_batch:
            # interleave off, or an idle engine with no window to
            # overlap (cold start / whole-batch turnover): admit
            # everything that fits one-shot style, so the next window
            # dispatches with FULL slots — underfull windows cost more
            # than unoverlapped prefill here
            admitted += self._drain_admissions()
            if fresh_batch and self.sync_dwell_s > 0:
                # batch forming: closed-loop convoys arrive a couple
                # of milliseconds apart; a short dwell lets the
                # stragglers in so the whole batch shares one
                # synchronized (growable) window.  Bounded: each round
                # must admit someone or we dispatch with what we have.
                while admitted and eng.free_slots():
                    time.sleep(self.sync_dwell_s)
                    more = self._drain_admissions()
                    if not more:
                        break
                    admitted += more
        else:
            self._pull_tickets()
        if not any(eng.active):
            # no slot is live, so no admission still waiting for its
            # first step will take one here (the owner preempted or
            # released it at on_admit, as a prefill-only export does):
            # keeping them would leave busy() true and the owner's loop
            # spinning where it should idle
            self._await_first.clear()
            self._gauges()
            return IterationResult(admitted, {}, 0)
        # chaos hooks (inert attribute checks when no --fault-spec):
        # fire between admission and the decode round, so a crashed
        # iteration's requests are already ticket-bound (the crash
        # supervisor's drain 503s them) and an armed fault never
        # crashes an idle loop.  serve.step is the legacy decode-step
        # site; serve.schedule is the scheduler's own (error/hang)
        if faults.ACTIVE is not None:
            faults.ACTIVE.fire("serve.step")
            faults.ACTIVE.fire("serve.schedule")
        # a watchdog-abandoned worker wakes from an injected hang
        # HERE: bail before any engine mutation can race the restarted
        # loop (real device hangs have no such guarantee — the
        # supervisor's restart budget and the pod replacement policy
        # are the backstop there, as with the probe watchdog)
        self._check(gen)
        if eng.spec_ready() or eng.forced_pending():
            # speculative / jump rounds are single sync calls with no
            # dispatch/harvest seam — admissions go in ahead of them,
            # exactly like the pre-scheduler loop
            admitted += self._drain_admissions()
            self._note_first_step()
            if eng.spec_ready():
                with self.in_phase("harvest"):
                    decoded = eng.spec_round()
                self._gauges()
                return IterationResult(admitted, decoded, 1)
            if eng.forced_pending():
                with self.in_phase("harvest"):
                    decoded = eng.jump_round()
                if decoded is not None:
                    self._gauges()
                    return IterationResult(admitted, decoded, 1)
            if not any(eng.active):
                self._gauges()
                return IterationResult(admitted, {}, 0)
        window = self._choose_window()
        if window < 1:
            # a slot ran out of cache: one step() retires it
            self._note_first_step()
            with self.in_phase("harvest"):
                decoded = {s: [t] for s, t in eng.step().items()}
            self._gauges()
            return IterationResult(admitted, decoded, 1)
        self._note_first_step()
        handle = self._timed_dispatch(window)
        fins: List[Ticket] = []
        if self.interleave:
            # the window is on the device; everything below overlaps
            # it: prefill chunks (serial or packed), NEW arrivals
            # (mid-window admission), and completed admissions'
            # splices + first-token picks — as many as the chunk
            # budget lands, so turnover refills every free slot inside
            # one window
            self._check(gen)
            fins = self._admit_work(self.prefill_budget)
        with self.in_phase("harvest"):
            decoded = eng.scan_harvest(handle)
        admitted += fins
        self._maybe_dispatch_ahead(decoded)
        self._gauges()
        return IterationResult(admitted, decoded, window)
