"""Flight recorder: a bounded in-memory event journal with crash dumps.

Histograms answer "how slow is the p99"; the flight recorder answers
"what happened to THIS request" and — crucially — "what happened in the
last minute before the process died".  It is the black-box layer the
production accelerator stacks in PAPERS.md pair with their metrics:

- a fixed-memory ring of :class:`Event` records (drop-oldest on
  overflow, with a dropped-events counter on the owning registry so the
  loss is itself observable),
- every ``Span.end`` plus discrete lifecycle events (device
  demotion/recovery, membership transitions, 429 sheds, slow-client
  drops, grammar-cap rejections) land here, each stamped with trace-id,
  monotonic + wall time, and key=value attrs,
- read paths: ``events()`` / ``trace()`` snapshots feed the
  ``/debug/events`` and ``/debug/traces`` endpoints,
- crash safety: ``install_dump_handlers()`` wires atexit + a chaining
  SIGTERM handler (and a faulthandler file for hard crashes) that write
  the journal as JSON-lines to ``--flight-record-dir``, so a post-mortem
  survives the process that produced it.

Thread-safe, stdlib only, and deliberately cheap: one lock hop and one
deque append per event — safe to call from the serving scheduler loop.

The port's own copy of the JAX package's ``obs/recorder.py`` (the port
imports nothing of that package): the same calls give the same
results.
"""

from __future__ import annotations

import atexit
import json
import logging
import os
import signal
import threading
import time
from collections import deque
from types import FrameType
from typing import (
    TYPE_CHECKING,
    Deque,
    Dict,
    Iterable,
    List,
    Optional,
)

if TYPE_CHECKING:  # typing only: no runtime import-order coupling
    from .core import Counter, Registry
    from .trace import TraceContext

log = logging.getLogger(__name__)

DEFAULT_CAPACITY = 4096

# crash dumps accumulate across restarts (the file name embeds pid +
# time precisely so restarts never clobber them); keep the newest K
# and garbage-collect the rest at dump time so a crash-looping pod
# cannot fill the node's disk with post-mortems
DEFAULT_DUMP_KEEP = 20


class Event:
    """One journal entry (see module docstring)."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "t_wall",
                 "t_mono", "attrs")

    def __init__(self, name: str, trace_id: str = "", span_id: str = "",
                 parent_id: str = "",
                 attrs: Optional[Dict[str, object]] = None) -> None:
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.t_wall = time.time()
        self.t_mono = time.monotonic()
        self.attrs: Dict[str, object] = attrs if attrs is not None else {}

    def to_dict(self) -> Dict[str, object]:
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            # the cross-PROCESS link: a hop continues the caller's
            # traceparent as a child context, so parent_id points at
            # the upstream process's span and obs.stitch can re-link
            # events from several journals into one tree
            "parent_id": self.parent_id,
            "t_wall": self.t_wall,
            "t_mono": self.t_mono,
            "attrs": self.attrs,
        }


def _jsonable(v: object) -> object:
    """Attrs must survive json.dumps in a signal-time dump; anything
    exotic degrades to its str() at RECORD time, not dump time."""
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


class FlightRecorder:
    """Thread-safe bounded ring journal (see module docstring)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 registry: Optional["Registry"] = None,
                 dump_keep: int = DEFAULT_DUMP_KEEP) -> None:
        if capacity < 1:
            raise ValueError("recorder capacity must be >= 1")
        if dump_keep < 1:
            raise ValueError("dump_keep must be >= 1")
        self.capacity = capacity
        self.dump_keep = dump_keep
        self._lock = threading.Lock()
        self._ring: Deque[Event] = deque(maxlen=capacity)
        self._recorded = 0
        self._dropped = 0
        self._dump_gc = 0
        # loss is observable: the registry (when the owning surface has
        # one) carries the totals next to the latency histograms the
        # events annotate
        self._m_events: Optional["Counter"] = None
        self._m_dropped: Optional["Counter"] = None
        self._m_dump_gc: Optional["Counter"] = None
        if registry is not None:
            self._m_events = registry.counter(
                "tpu_flight_events_total",
                "Events recorded into the flight-recorder ring.")
            self._m_dropped = registry.counter(
                "tpu_flight_dropped_events_total",
                "Events evicted from the full flight-recorder ring "
                "(drop-oldest).")
            self._m_dump_gc = registry.counter(
                "tpu_flight_dump_gc_total",
                "Old flight-record dump files deleted to keep the "
                "newest dump_keep in --flight-record-dir.")
        self._dump_paths: List[str] = []
        self._dump_installed = False

    # -- write path ---------------------------------------------------------

    def record(self, name: str, trace: Optional["TraceContext"] = None,
               trace_id: str = "", span_id: str = "",
               parent_id: str = "", **attrs: object) -> None:
        """Append one event.  *trace* (a TraceContext) wins over the
        explicit id strings (its parent link rides along, so a
        cross-process stitcher can re-link hops); attrs are sanitized
        to JSON scalars now so a SIGTERM-time dump can never fail on a
        live object."""
        if trace is not None:
            trace_id = trace.trace_id
            span_id = trace.span_id
            parent_id = trace.parent_id or ""
        ev = Event(name, trace_id=trace_id, span_id=span_id,
                   parent_id=parent_id,
                   attrs={k: _jsonable(v) for k, v in attrs.items()})
        with self._lock:
            if len(self._ring) == self.capacity:
                self._dropped += 1
                if self._m_dropped is not None:
                    self._m_dropped.inc()
            self._ring.append(ev)  # deque(maxlen) evicts the oldest
            self._recorded += 1
        if self._m_events is not None:
            self._m_events.inc()

    # -- read paths ---------------------------------------------------------

    @property
    def recorded(self) -> int:
        with self._lock:
            return self._recorded

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def events(self, since: float = 0.0, trace_id: Optional[str] = None,
               name: Optional[str] = None,
               limit: int = 1000) -> List[Dict[str, object]]:
        """Snapshot of matching events, oldest first.  *since* filters
        on wall time (the /debug/events?since= contract), *trace_id*
        on the stamped trace, *name* on the event name."""
        with self._lock:
            snap = list(self._ring)
        out: List[Dict[str, object]] = []
        for ev in snap:
            if ev.t_wall <= since:
                continue
            if trace_id is not None and ev.trace_id != trace_id:
                continue
            if name is not None and ev.name != name:
                continue
            out.append(ev.to_dict())
        return out[-limit:] if limit else out

    def trace_ids(self, limit: int = 64) -> List[Dict[str, object]]:
        """The most recent distinct trace ids with event counts —
        the /debug/traces index view."""
        with self._lock:
            snap = list(self._ring)
        counts: Dict[str, int] = {}
        last: Dict[str, float] = {}
        for ev in snap:
            if not ev.trace_id:
                continue
            counts[ev.trace_id] = counts.get(ev.trace_id, 0) + 1
            last[ev.trace_id] = ev.t_wall
        order = sorted(counts, key=lambda t: last[t], reverse=True)
        return [{"trace_id": t, "events": counts[t], "last_t_wall": last[t]}
                for t in order[:limit]]

    # -- crash dumps --------------------------------------------------------

    def dump(self, path: str) -> int:
        """Write the journal as JSON-lines to *path* (one event per
        line, oldest first).  Returns the event count written."""
        with self._lock:
            snap = list(self._ring)
            dropped = self._dropped
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            # header line first: a dump that was truncated mid-write is
            # still identifiable, and the drop count frames what's missing
            f.write(json.dumps({
                "flight_record": True, "pid": os.getpid(),
                "events": len(snap), "dropped": dropped,
                "t_wall": time.time(),
            }) + "\n")
            for ev in snap:
                f.write(json.dumps(ev.to_dict()) + "\n")
        os.replace(tmp, path)  # a crash mid-dump never leaves half a file
        return len(snap)

    def dump_to_dir(self, dir_path: str) -> Optional[str]:
        """One dump file in *dir_path*, named by pid + wall time so
        restarts never clobber the post-mortem they should explain.
        After a successful dump, older dumps past ``dump_keep`` are
        deleted (newest-first by mtime) so crash loops cannot grow the
        directory without bound; deletions count in
        ``tpu_flight_dump_gc_total``."""
        try:
            os.makedirs(dir_path, exist_ok=True)
            path = os.path.join(
                dir_path,
                f"flight-{os.getpid()}-{int(time.time())}.jsonl")
            self.dump(path)
        except OSError as e:
            log.error("flight-record dump to %s failed: %s", dir_path, e)
            return None
        self._gc_dumps(dir_path)
        return path

    @property
    def dump_gc_count(self) -> int:
        with self._lock:
            return self._dump_gc

    def _gc_dumps(self, dir_path: str) -> None:
        """Keep the newest ``dump_keep`` flight-*.jsonl dumps in
        *dir_path*.  Best-effort: a GC failure must never fail the
        dump that just succeeded (this runs on SIGTERM/atexit)."""
        try:
            dumps = [
                os.path.join(dir_path, f)
                for f in os.listdir(dir_path)
                if f.startswith("flight-") and f.endswith(".jsonl")
            ]
            dumps.sort(key=lambda p: (os.path.getmtime(p), p),
                       reverse=True)
            stale = dumps[self.dump_keep:]
        except OSError as e:
            log.warning("flight-record dump GC scan failed: %s", e)
            return
        removed = 0
        for p in stale:
            try:
                os.remove(p)
                removed += 1
            except OSError as e:
                log.warning("flight-record dump GC of %s failed: %s",
                            p, e)
        if removed:
            with self._lock:
                self._dump_gc += removed
            if self._m_dump_gc is not None:
                self._m_dump_gc.inc(removed)
            log.info("flight-record dump GC removed %d old dump(s) "
                     "from %s (keep %d)", removed, dir_path,
                     self.dump_keep)

    def install_dump_handlers(self, dir_path: str,
                              signals: Iterable[int] = (signal.SIGTERM,)
                              ) -> None:
        """Dump the journal on process exit: atexit (clean exits and
        sys.exit paths), a CHAINING handler on each listed signal
        (k8s sends SIGTERM on pod shutdown), and a faulthandler file in
        *dir_path* for hard crashes the interpreter can still report.
        Idempotent; signal installation is skipped off the main thread
        (library embedders) — atexit still covers them."""
        if self._dump_installed:
            return
        self._dump_installed = True

        def _dump_once(_done: List[bool] = [False]) -> None:
            if _done[0]:
                return
            _done[0] = True
            path = self.dump_to_dir(dir_path)
            if path:
                log.info("flight record dumped to %s", path)

        atexit.register(_dump_once)
        try:
            import faulthandler
            os.makedirs(dir_path, exist_ok=True)
            f = open(os.path.join(
                dir_path, f"faulthandler-{os.getpid()}.log"), "w")
            faulthandler.enable(file=f)
        except (OSError, RuntimeError) as e:
            log.warning("faulthandler file unavailable: %s", e)
        for sig in signals:
            try:
                prev = signal.getsignal(sig)

                def _handler(signum: int, frame: Optional[FrameType],
                             _prev: object = prev) -> None:
                    _dump_once()
                    if callable(_prev):
                        _prev(signum, frame)
                    elif _prev != signal.SIG_IGN:
                        # default disposition: terminate with the
                        # conventional 128+sig status
                        raise SystemExit(128 + signum)

                signal.signal(sig, _handler)
            except (ValueError, OSError) as e:
                # not the main thread, or an unsupported signal: the
                # atexit hook still covers orderly shutdown
                log.warning("cannot install dump handler for %s: %s",
                            sig, e)
