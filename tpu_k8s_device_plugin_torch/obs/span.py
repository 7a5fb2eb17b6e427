"""Span: one timed operation that feeds a histogram and leaves a
structured, trace-tagged log line behind.

The repo's hot paths (serving requests, Allocate RPCs, pulse rounds)
need BOTH a latency distribution (the histogram a dashboard reads) and
a per-occurrence trace (the log line an operator greps when one
request misbehaves).  A Span is the single object that does both, so
the two can never disagree about what was measured:

    with span("tpu_plugin_allocate", histogram=m.allocate_seconds,
              labels={"resource": "tpu"}, logger=log):
        ...                       # outcome=ok on clean exit
                                  # outcome=error if the body raises

    sp = Span("tpu_serve_request", histogram=m.request_seconds,
              request_id=rid)     # long-lived: ends on the terminal
    ...                           # event, possibly on another thread
    sp.end(outcome="throttled")

A span also carries a :class:`~.trace.TraceContext`
(``trace=``): the trace-id lands in the log line, in the histogram
bucket's OpenMetrics exemplar, and in the flight-recorder event
(``recorder=``), so one id stitches every surface a request touched.

If the histogram family declares an ``outcome`` label, the outcome is
recorded there; otherwise it only reaches the log line.  ``end()`` is
idempotent — exactly one observation and one log line per span, even
when a handler thread and the scheduler race to finish a request.

Slow-span escalation: spans construct at DEBUG, but a span whose
duration crosses ``slow_threshold_s`` logs at WARNING instead — a
pathological request must not vanish at default log levels.  The
default threshold is 5x the histogram's top finite bucket (anything
past the distribution's measurable range is by definition pathological
for that surface); pass ``slow_threshold_s=0`` to disable.

The port's own copy of the JAX package's ``obs/span.py`` (the port
imports nothing of that package): the same calls give the same
results.
"""

from __future__ import annotations

import logging
import threading
import time
from contextlib import contextmanager
from typing import TYPE_CHECKING, Dict, Iterator, Optional

from .core import Histogram, escape_label_value

if TYPE_CHECKING:  # typing only: no runtime import-order coupling
    from .recorder import FlightRecorder
    from .trace import TraceContext

_default_log = logging.getLogger(__name__)

# slow_threshold_s default: this multiple of the histogram's top finite
# bucket (observations past the top bucket are already off the
# distribution's scale; 5x that is unambiguously pathological)
SLOW_THRESHOLD_BUCKETS = 5.0


class Span:
    """One timed operation (see module docstring)."""

    __slots__ = ("name", "histogram", "request_id", "labels", "logger",
                 "level", "trace", "recorder", "slow_threshold_s",
                 "t0", "_lock", "_done", "_notes")

    def __init__(self, name: str,
                 histogram: Optional[Histogram] = None,
                 request_id: Optional[str] = None,
                 labels: Optional[Dict[str, str]] = None,
                 logger: Optional[logging.Logger] = None,
                 level: int = logging.DEBUG,
                 trace: Optional["TraceContext"] = None,
                 recorder: Optional["FlightRecorder"] = None,
                 slow_threshold_s: Optional[float] = None) -> None:
        self.name = name
        self.histogram = histogram
        self.request_id = request_id
        self.labels = dict(labels or {})
        self.logger = logger if logger is not None else _default_log
        self.level = level
        self.trace = trace
        self.recorder = recorder
        if slow_threshold_s is None and histogram is not None:
            slow_threshold_s = (SLOW_THRESHOLD_BUCKETS
                                * histogram.top_finite_bucket)
        self.slow_threshold_s = slow_threshold_s or 0.0
        self.t0 = time.perf_counter()
        self._lock = threading.Lock()
        self._done = False
        self._notes: Dict[str, object] = {}

    def annotate(self, **kv: object) -> "Span":
        """Attach extra key=value pairs to the eventual log line."""
        self._notes.update(kv)
        return self

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    def end(self, outcome: str = "ok") -> float:
        """Finish the span: observe the histogram once, log once,
        record once.  Idempotent — later calls return the recorded
        duration without re-observing (terminal events can race across
        threads)."""
        with self._lock:
            if self._done:
                prior = self._notes.get("_duration", 0.0)
                return prior if isinstance(prior, float) else 0.0
            self._done = True
            dt = time.perf_counter() - self.t0
            self._notes["_duration"] = dt
        trace = self.trace
        hist = self.histogram
        if hist is not None:
            tid = trace.trace_id if trace is not None else None
            if hist.labelnames:
                kv = dict(self.labels)
                if "outcome" in hist.labelnames:
                    kv["outcome"] = outcome
                hist.labels(**kv).observe(dt, trace_id=tid)
            else:
                hist.observe(dt, trace_id=tid)
        if self.recorder is not None:
            self.recorder.record(
                self.name, trace=trace, duration_s=dt, outcome=outcome,
                **{k: v for k, v in {**self.labels,
                                     **self._notes}.items()
                   if not k.startswith("_")})
        # slow-span escalation: a duration past the threshold logs at
        # WARNING whatever the construction level — pathological
        # requests must surface at default log levels, trace-id included
        level = self.level
        if self.slow_threshold_s and dt >= self.slow_threshold_s:
            level = max(level, logging.WARNING)
        if self.logger.isEnabledFor(level):
            parts = [f"span={self.name}"]
            if self.request_id:
                parts.append(f"request_id={self.request_id}")
            if trace is not None:
                parts.append(f"trace_id={trace.trace_id}")
                parts.append(f"span_id={trace.span_id}")
                if trace.parent_id:
                    parts.append(f"parent_id={trace.parent_id}")
            parts.append(f"duration_s={dt:.6f}")
            parts.append(f"outcome={outcome}")
            if level >= logging.WARNING and self.slow_threshold_s:
                parts.append(
                    f"slow_threshold_s={self.slow_threshold_s:g}")
            for k in sorted(self.labels):
                parts.append(
                    f'{k}="{escape_label_value(self.labels[k])}"')
            for k in sorted(self._notes):
                if not k.startswith("_"):
                    parts.append(f"{k}={self._notes[k]}")
            self.logger.log(level, "%s", " ".join(parts))
        return dt


@contextmanager
def span(name: str,
         histogram: Optional[Histogram] = None,
         request_id: Optional[str] = None,
         labels: Optional[Dict[str, str]] = None,
         logger: Optional[logging.Logger] = None,
         level: int = logging.DEBUG,
         trace: Optional["TraceContext"] = None,
         recorder: Optional["FlightRecorder"] = None,
         slow_threshold_s: Optional[float] = None) -> Iterator[Span]:
    """Context-manager form: outcome=ok on clean exit, outcome=error
    (exception class name annotated) when the body raises."""
    sp = Span(name, histogram=histogram, request_id=request_id,
              labels=labels, logger=logger, level=level, trace=trace,
              recorder=recorder, slow_threshold_s=slow_threshold_s)
    try:
        yield sp
    except BaseException as e:
        sp.annotate(error=type(e).__name__).end(outcome="error")
        raise
    sp.end(outcome="ok")
