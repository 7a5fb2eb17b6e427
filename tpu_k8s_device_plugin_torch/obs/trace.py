"""Trace context: W3C ``traceparent`` parse/format + child derivation.

Every surface has latency histograms and per-operation spans, but
each span was an island: the serving request, the Allocate that placed
its pod, and the heartbeat that demoted its devices could not be
stitched together.  A :class:`TraceContext` is the thread-light thread
between them — a (trace-id, span-id, parent) triple that rides HTTP
headers (``traceparent``), gRPC metadata, span log lines, histogram
exemplars, and flight-recorder events, so ONE id greps across every
surface a request touched.

Wire format is the W3C Trace Context ``traceparent`` header::

    00-<32 hex trace-id>-<16 hex span-id>-<2 hex flags>

Malformed or absent headers fall back to a fresh root trace (the W3C
"restart the trace" rule): propagation is best-effort and can never
reject a request.  Stdlib only, like the rest of ``obs``.

The port's own copy of the JAX package's ``obs/trace.py`` (the port
imports nothing of that package): the same calls give the same
results.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Optional

_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")

# all-zero ids are invalid per the W3C spec (they mean "no trace")
_ZERO_TRACE = "0" * 32
_ZERO_SPAN = "0" * 16


def _rand_hex(nbytes: int) -> str:
    return os.urandom(nbytes).hex()


@dataclass(frozen=True)
class TraceContext:
    """One position in a trace: this operation's span-id inside the
    request-wide trace-id, plus the parent span that caused it."""

    trace_id: str
    span_id: str
    parent_id: Optional[str] = None
    sampled: bool = True

    def child(self) -> "TraceContext":
        """A child context: same trace, fresh span-id, this span as
        parent — what a sub-operation (queue wait, admit, one stream
        write) carries so its log line links back here."""
        return TraceContext(
            trace_id=self.trace_id,
            span_id=_rand_hex(8),
            parent_id=self.span_id,
            sampled=self.sampled,
        )

    def to_traceparent(self) -> str:
        """The W3C ``traceparent`` header value for this context."""
        return (f"00-{self.trace_id}-{self.span_id}-"
                f"{'01' if self.sampled else '00'}")


def new_trace() -> TraceContext:
    """A fresh root context (new trace-id, no parent)."""
    return TraceContext(trace_id=_rand_hex(16), span_id=_rand_hex(8))


def parse_traceparent(value: Optional[str]) -> Optional[TraceContext]:
    """Parse a ``traceparent`` header value; None when malformed.

    Per the spec: exactly four ``-``-separated lowercase-hex fields,
    version ``ff`` and all-zero trace/span ids are invalid.  The caller
    decides the fallback (usually :func:`new_trace`)."""
    if not value:
        return None
    m = _TRACEPARENT_RE.match(value.strip())
    if not m:
        return None
    version, trace_id, span_id, flags = m.groups()
    if version == "ff" or trace_id == _ZERO_TRACE or span_id == _ZERO_SPAN:
        return None
    return TraceContext(trace_id=trace_id, span_id=span_id,
                        sampled=bool(int(flags, 16) & 0x01))


def trace_from_header(value: Optional[str]) -> TraceContext:
    """The front-door rule in one call: continue the caller's trace as
    a CHILD context when the header parses, else start a new root.  A
    malformed header degrades to a fresh trace, never an error."""
    parsed = parse_traceparent(value)
    if parsed is None:
        return new_trace()
    return parsed.child()
