"""Always-on sampling profiler: the flight data recorder for CPU time.

``/debug/profile`` answers "what is the process doing RIGHT
NOW" — an operator asks, the device profiler captures, the operator reads the
dump.  It can never answer the incident question: what was the process
doing in the seconds *before* the page fired?  By the time a human
asks, the evidence is gone.

:class:`SamplingProfiler` closes that gap dependency-free: a daemon
thread walks :func:`sys._current_frames` at a configurable rate
(default 19 hz — deliberately prime, so the sampler can't phase-lock
with a 10/20/100 hz periodic workload and systematically over- or
under-count it), folds each thread's stack into the flamegraph
``frame;frame;leaf`` form, and accumulates (stack, phase) → count
buckets in a bounded per-second ring.  Every sample is tagged with the
scheduler's current window phase (``dispatch``/``harvest``/``stream``/
``idle``) and the number of in-flight requests, so a profile slice
reads as "during dispatch, under load, the process was HERE".

Bounds are structural, not aspirational: the ring holds at most
``window_s`` one-second buckets, distinct folded stacks are interned up
to ``max_stacks`` (overflow folds into the ``(other)`` leaf), and every
bucket key is drawn from that bounded set — memory is flat no matter
how long the process runs (the determinism suite drives +1000 ticks
and asserts exactly that).  Measured overhead is exported as
``tpu_profiler_overhead_ratio`` and tested to stay under 3% wall time
at the default rate.

Composition with the device profiler (``torch.profiler`` in the port's
server): a capture and the sampler
must not double-account — while a capture runs the server wraps it in
:meth:`SamplingProfiler.suspend`, which parks the sampling thread
(ticks are still counted as ``suspended`` so the timeline shows the
gap honestly) instead of sampling the capture machinery itself.

Exposed on every HTTP surface as::

    GET /debug/pprof?seconds=N&format=folded   # flamegraph.pl-ready
    GET /debug/pprof?seconds=N&format=json     # tpu-profile/v1 schema

The folded output prepends the phase as a synthetic root frame
(``phase:dispatch;module.func;...``) so a flamegraph splits by phase
with zero post-processing.

Stdlib only.  Test seams: ``frames_fn``/``now_fn`` inject fake frame
maps and clocks, and :meth:`sample_once` runs one sampling pass inline
— the determinism suite never needs a real thread or a real sleep.

The port's own copy of the JAX package's ``obs/profiler.py`` (the port
imports nothing of that package): the same calls give the same
results.
"""

from __future__ import annotations

import sys
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import (
    Any,
    Callable,
    Deque,
    Dict,
    Iterator,
    List,
    Mapping,
    Optional,
    Sequence,
    Set,
    Tuple,
)

from .core import Counter, Gauge, Registry

# schema tag for the JSON form — bundles and obs_query key on it
PROFILE_SCHEMA = "tpu-profile/v1"

DEFAULT_HZ = 19.0
DEFAULT_WINDOW_S = 600.0
DEFAULT_MAX_STACKS = 512

# frames deeper than this fold into a "(deep)" marker: a runaway
# recursion must cost bounded bytes per sample, like everything else
MAX_FRAMES = 64

# the interning overflow leaf: once max_stacks distinct stacks have
# been seen, new shapes aggregate here instead of growing the set
OVERFLOW_STACK = "(other)"

# phase tag used when no phase_fn is wired (router, exporter, plugin)
NO_PHASE = "none"

# BucketKey/Bucket: per-second accumulation cell.  The value list is
# [sample_count, active_request_sum] — mean active load per stack is
# recovered at read time as sum/count.
_BucketKey = Tuple[str, str]
_Bucket = Tuple[int, Dict[_BucketKey, List[float]]]


def fold_stack(frame: Any, limit: int = MAX_FRAMES) -> str:
    """Fold one thread's frame chain into ``root;...;leaf`` form.

    Frames render as ``module.function`` (the flamegraph convention);
    the chain is walked leaf→root via ``f_back`` then reversed, and
    chains deeper than *limit* keep the leaf-most frames under a
    ``(deep)`` root so pathological recursion stays bounded.
    """
    names: List[str] = []
    depth = 0
    while frame is not None:
        code = frame.f_code
        mod = frame.f_globals.get("__name__", "?")
        names.append(f"{mod}.{code.co_name}")
        frame = frame.f_back
        depth += 1
        if depth >= limit:
            names.append("(deep)")
            break
    names.reverse()
    return ";".join(names)


class SamplingProfiler:
    """Background stack sampler with a bounded phase-tagged ring.

    Parameters
    ----------
    registry:
        Optional :class:`Registry` for the profiler's own (bounded)
        meta-metrics.  No per-stack labels ever reach the registry —
        stacks live only in the ring (the O1 cardinality contract).
    hz:
        Sampling rate.  19 by default (prime — see module docstring).
    window_s:
        Ring span in seconds; one bucket per second.
    max_stacks:
        Interning cap on distinct folded stacks.
    phase_fn:
        Zero-arg callable returning the current scheduler phase string
        (``IterationScheduler.phase``); samples tag ``none`` without it.
    active_fn:
        Zero-arg callable returning the current in-flight request
        count; each sample accumulates it so slices report mean load.
    frames_fn / now_fn:
        Test seams; default to :func:`sys._current_frames` and
        :func:`time.time`.
    """

    def __init__(self, registry: Optional[Registry] = None, *,
                 hz: float = DEFAULT_HZ,
                 window_s: float = DEFAULT_WINDOW_S,
                 max_stacks: int = DEFAULT_MAX_STACKS,
                 phase_fn: Optional[Callable[[], str]] = None,
                 active_fn: Optional[Callable[[], int]] = None,
                 frames_fn: Optional[
                     Callable[[], Mapping[int, Any]]] = None,
                 now_fn: Optional[Callable[[], float]] = None) -> None:
        if hz <= 0:
            raise ValueError("hz must be positive")
        if window_s < 1:
            raise ValueError("window_s must be >= 1")
        if max_stacks < 1:
            raise ValueError("max_stacks must be >= 1")
        self.hz = float(hz)
        self.window_s = float(window_s)
        self.max_stacks = int(max_stacks)
        self._phase_fn = phase_fn
        self._active_fn = active_fn
        self._frames_fn = frames_fn or sys._current_frames
        self._now = now_fn or time.time

        self._lock = threading.Lock()
        # ring: maxlen bounds memory structurally (one bucket a second)
        self._buckets: Deque[_Bucket] = deque(
            maxlen=max(1, int(self.window_s)))
        self._known: Set[str] = set()
        self._suspended = 0
        self._ticks = 0
        self._samples = 0
        self._suspended_ticks = 0
        self._busy_s = 0.0
        self._started_mono: Optional[float] = None
        self._first_t: Optional[float] = None
        self._last_t: Optional[float] = None

        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # the sampling thread's own ident (set when it starts): its
        # stack is excluded from samples.  Inline sample_once() calls
        # (tests) run on a caller thread and are NOT excluded.
        self._self_ident: Optional[int] = None

        self._c_ticks: Optional[Counter] = None
        self._c_samples: Optional[Counter] = None
        self._c_suspended: Optional[Counter] = None
        self._g_stacks: Optional[Gauge] = None
        self._g_overhead: Optional[Gauge] = None
        if registry is not None:
            self._c_ticks = registry.counter(
                "tpu_profiler_ticks_total",
                "Sampling passes attempted by the continuous profiler "
                "(includes suspended passes).")
            self._c_samples = registry.counter(
                "tpu_profiler_samples_total",
                "Thread stack samples folded into the profile ring.")
            self._c_suspended = registry.counter(
                "tpu_profiler_suspended_ticks_total",
                "Sampling passes skipped while the profiler was "
                "suspended (e.g. during a /debug/profile capture).")
            self._g_stacks = registry.gauge(
                "tpu_profiler_stacks",
                "Distinct folded stacks currently interned by the "
                "continuous profiler (bounded by its max_stacks cap).")
            self._g_overhead = registry.gauge(
                "tpu_profiler_overhead_ratio",
                "Measured fraction of wall time the continuous "
                "profiler's sampling thread spends on-CPU.")
            registry.on_collect(self._collect)

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        """Start the sampling thread (idempotent)."""
        with self._lock:
            if self._thread is not None:
                return
            if self._started_mono is None:
                self._started_mono = time.perf_counter()
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="tpu-profiler", daemon=True)
            self._thread.start()

    def stop(self) -> None:
        """Stop the sampling thread (idempotent, joins briefly)."""
        with self._lock:
            t = self._thread
            self._thread = None
        if t is None:
            return
        self._stop.set()
        t.join(timeout=2.0)

    def _run(self) -> None:
        self._self_ident = threading.get_ident()
        interval = 1.0 / self.hz
        while not self._stop.wait(interval):
            try:
                self.sample_once()
            # tpulint: disable=R2 -- the profiler must NEVER take down or log-spam the process it observes at 19hz; a broken pass loses one tick and the tick counter still shows the gap
            except Exception:
                pass

    @contextmanager
    def suspend(self, reason: str = "torch_profiler") -> Iterator[None]:
        """Park sampling for the duration of the block (re-entrant).

        Used around device-profiler captures so the two profilers compose:
        suspended passes are counted (the timeline shows the gap) but
        record no stacks — no double-accounting of capture machinery.
        """
        del reason  # documented intent; the counter is the record
        with self._lock:
            self._suspended += 1
        try:
            yield
        finally:
            with self._lock:
                self._suspended -= 1

    @property
    def suspended(self) -> bool:
        with self._lock:
            return self._suspended > 0

    # -- sampling -----------------------------------------------------------

    def sample_once(self) -> int:
        """Run one sampling pass; returns stacks recorded (0 when
        suspended).  Public so tests drive passes deterministically."""
        t0 = time.perf_counter()
        now = float(self._now())
        with self._lock:
            if self._started_mono is None:
                self._started_mono = t0
            self._ticks += 1
            if self._c_ticks is not None:
                self._c_ticks.inc()
            if self._suspended > 0:
                self._suspended_ticks += 1
                if self._c_suspended is not None:
                    self._c_suspended.inc()
                self._busy_s += time.perf_counter() - t0
                return 0
        phase = NO_PHASE
        if self._phase_fn is not None:
            try:
                phase = str(self._phase_fn() or NO_PHASE)
            # tpulint: disable=R2 -- a broken phase probe degrades one sample's TAG to 'none'; raising or logging at sample rate would make the profiler the incident
            except Exception:
                phase = NO_PHASE
        active = 0
        if self._active_fn is not None:
            try:
                active = int(self._active_fn())
            # tpulint: disable=R2 -- same contract as the phase probe: a broken load probe zeroes one sample's annotation, never the sampling pass
            except Exception:
                active = 0
        # fold outside the lock: frame objects are read-only snapshots
        folded: List[str] = []
        frames = self._frames_fn()
        for ident, frame in list(frames.items()):
            if ident == self._self_ident:
                continue  # never profile the profiler
            try:
                folded.append(fold_stack(frame))
            # tpulint: disable=R2 -- frames are snapshots of live threads and can mutate mid-walk; losing one thread's sample this tick is the only safe degradation
            except Exception:
                continue
        n = 0
        with self._lock:
            sec = int(now)
            if not self._buckets or self._buckets[-1][0] != sec:
                self._buckets.append((sec, {}))
            bucket = self._buckets[-1][1]
            for stack in folded:
                if stack not in self._known:
                    if len(self._known) < self.max_stacks:
                        self._known.add(stack)
                    else:
                        stack = OVERFLOW_STACK
                cell = bucket.get((stack, phase))
                if cell is None:
                    cell = [0.0, 0.0]
                    bucket[(stack, phase)] = cell
                cell[0] += 1.0
                cell[1] += float(active)
                n += 1
            self._samples += n
            if self._c_samples is not None and n:
                self._c_samples.inc(n)
            if self._first_t is None:
                self._first_t = now
            self._last_t = now
            self._busy_s += time.perf_counter() - t0
        return n

    # -- reading ------------------------------------------------------------

    def overhead_ratio(self) -> float:
        """Fraction of wall time spent inside sampling passes since the
        first pass — the measured (not estimated) profiler cost."""
        with self._lock:
            if self._started_mono is None:
                return 0.0
            wall = time.perf_counter() - self._started_mono
            if wall <= 0:
                return 0.0
            return self._busy_s / wall

    def stack_count(self) -> int:
        with self._lock:
            return len(self._known)

    def _collect(self) -> None:
        if self._g_stacks is not None:
            self._g_stacks.set(float(self.stack_count()))
        if self._g_overhead is not None:
            self._g_overhead.set(self.overhead_ratio())

    def _slice(self, seconds: Optional[float]
               ) -> Tuple[Dict[_BucketKey, List[float]],
                          List[Tuple[int, float]]]:
        """Aggregate the last *seconds* of ring buckets (None = whole
        window) into one {(stack, phase): [count, active_sum]} map plus
        a per-second sample-count timeline."""
        now = float(self._now())
        cutoff = (-1.0 if seconds is None
                  else now - max(0.0, float(seconds)))
        agg: Dict[_BucketKey, List[float]] = {}
        timeline: List[Tuple[int, float]] = []
        with self._lock:
            for sec, bucket in self._buckets:
                if sec < cutoff:
                    continue
                total = 0.0
                for key, (count, active_sum) in bucket.items():
                    cell = agg.get(key)
                    if cell is None:
                        cell = [0.0, 0.0]
                        agg[key] = cell
                    cell[0] += count
                    cell[1] += active_sum
                    total += count
                timeline.append((sec, total))
        return agg, timeline

    def folded(self, seconds: Optional[float] = None) -> str:
        """The flamegraph.pl/speedscope form: one ``stack count`` line
        per (stack, phase), phase prepended as a synthetic root frame
        so a flamegraph splits by phase for free."""
        agg, _ = self._slice(seconds)
        lines = []
        for (stack, phase), (count, _active) in sorted(agg.items()):
            root = f"phase:{phase or NO_PHASE}"
            body = f"{root};{stack}" if stack else root
            lines.append(f"{body} {int(count)}")
        return "\n".join(lines) + ("\n" if lines else "")

    def as_json(self, seconds: Optional[float] = None
                ) -> Dict[str, Any]:
        """The ``tpu-profile/v1`` document incident bundles embed."""
        agg, timeline = self._slice(seconds)
        stacks = []
        for (stack, phase), (count, active_sum) in sorted(
                agg.items(), key=lambda kv: -kv[1][0]):
            stacks.append({
                "stack": stack,
                "phase": phase,
                "count": int(count),
                "mean_active": (active_sum / count) if count else 0.0,
            })
        with self._lock:
            doc: Dict[str, Any] = {
                "schema": PROFILE_SCHEMA,
                "hz": self.hz,
                "window_s": self.window_s,
                "seconds": (float(seconds)
                            if seconds is not None else None),
                "ticks": self._ticks,
                "samples": self._samples,
                "suspended_ticks": self._suspended_ticks,
                "first_t": self._first_t,
                "last_t": self._last_t,
            }
        doc["overhead_ratio"] = self.overhead_ratio()
        doc["stacks"] = stacks
        doc["timeline"] = [[sec, n] for sec, n in timeline]
        return doc

    def handle_pprof(self, params: Mapping[str, Sequence[str]]
                     ) -> Tuple[str, str]:
        """The shared ``GET /debug/pprof`` implementation: parse
        ``seconds``/``format`` query params, return (content_type,
        body).  Raises ValueError on malformed input — surfaces map
        that to a 400, exactly like ``/debug/query``."""
        import json as _json

        raw_seconds = params.get("seconds", [])
        seconds: Optional[float] = None
        if raw_seconds:
            seconds = float(raw_seconds[0])
            if not 0 < seconds <= self.window_s:
                raise ValueError(
                    f"seconds must be in (0, {self.window_s:g}]")
        fmt = (params.get("format", ["folded"]) or ["folded"])[0]
        if fmt == "folded":
            return ("text/plain; charset=utf-8", self.folded(seconds))
        if fmt == "json":
            return ("application/json",
                    _json.dumps(self.as_json(seconds), indent=2,
                                sort_keys=True) + "\n")
        raise ValueError("format must be 'folded' or 'json'")
