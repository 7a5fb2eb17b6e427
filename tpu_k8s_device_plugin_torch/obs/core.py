"""Dependency-free metrics core: the ONE registry/renderer every HTTP
surface in this repo exposes Prometheus metrics through.

The port's own copy of the JAX package's ``obs/core.py`` (the port
imports nothing of that package); it renders the same exposition text
for the same calls.

Before this module the repo carried three divergent hand-rolled text
renderers (plugin debug endpoint, health exporter, serving server), no
histograms, and a cross-module private import for label escaping.  This
is the common substrate they all rewire onto:

- labeled :class:`Counter` / :class:`Gauge` / :class:`Histogram`
  families with fixed bucket schemes,
- a thread-safe :class:`Registry` with get-or-create instrument
  constructors and render-time collector callbacks,
- one promlint-clean text-exposition renderer (``# HELP`` + ``# TYPE``
  for every family, counters forced to end in ``_total``, histogram
  ``_bucket``/``_sum``/``_count`` triples with a ``+Inf`` bucket),
- parsing + quantile-estimation helpers so benchmarks and tests can
  read latency percentiles back out of a scraped exposition body.

Stdlib only, by design: the exporter daemon and slice layer must stay
importable on a bare grpc+protobuf image, and client-library registry
state must never leak between tests (every surface owns its Registry
instance; there is deliberately NO process-global default registry).
"""

from __future__ import annotations

import logging
import math
import os
import re
import threading
import time
from bisect import bisect_left
from typing import (
    Any,
    Callable,
    Dict,
    Generic,
    Iterable,
    List,
    Optional,
    Tuple,
    TypeVar,
    cast,
)

log = logging.getLogger(__name__)

# Content types for the two exposition modes.  Every /metrics handler
# negotiates via the Accept header: the OpenMetrics type unlocks
# exemplars (last trace-id per histogram bucket) and the `# EOF`
# terminator; the default text exposition stays byte-identical to
# pre-exemplar output so promlint and existing scrapes never change.
TEXT_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
OPENMETRICS_CONTENT_TYPE = (
    "application/openmetrics-text; version=1.0.0; charset=utf-8")


def negotiate_openmetrics(accept: Optional[str]) -> bool:
    """True when the Accept header asks for the OpenMetrics exposition
    (what a Prometheus server scraping with exemplar support sends)."""
    return accept is not None and "application/openmetrics-text" in accept

_METRIC_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# Fixed bucket schemes (seconds).  Shared across surfaces so the same
# dashboard query shape works on every histogram; pick by time scale:
#
# FAST_BUCKETS_S   sub-millisecond .. 1s: per-token decode, stream
#                  writes, ListAndWatch frame builds, sysfs probes
# LATENCY_BUCKETS_S  1ms .. 60s: request latency, TTFT, queue wait
# SLOW_BUCKETS_S   100ms .. 10min: slice join/formation
FAST_BUCKETS_S = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
    0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
)
LATENCY_BUCKETS_S = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
    0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)
SLOW_BUCKETS_S = (
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0, 600.0,
)


def escape_label_value(v: str) -> str:
    """Prometheus label-value escaping (backslash, quote, newline).

    The one copy of the escaping rule: ``health.metrics`` and the
    plugin debug renderer used to each carry their own (one reaching
    into the other's private ``_escape``)."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace(
        "\n", "\\n")


def escape_help(v: str) -> str:
    """HELP-line escaping (backslash and newline only, per exposition
    format — quotes are legal in help text)."""
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_value(v: float) -> str:
    """Sample value formatting: integers render bare (promtool-friendly
    and diff-stable), floats via repr (full precision)."""
    f = float(v)
    if f != f:
        return "NaN"
    if f in (math.inf, -math.inf):
        return "+Inf" if f > 0 else "-Inf"
    if f.is_integer() and abs(f) < 2**53:
        return str(int(f))
    return repr(f)


def _fmt_le(bound: float) -> str:
    """``le`` label formatting: +Inf for the top bucket, shortest exact
    decimal otherwise (0.005, not 0.005000000000000001)."""
    if bound == math.inf:
        return "+Inf"
    return format(bound, "g")


class _Child:
    """One labeled series of a counter/gauge family."""

    __slots__ = ("_lock", "_value")

    def __init__(self, lock: threading.Lock) -> None:
        self._lock = lock
        self._value = 0.0

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters can only go up; use a Gauge")
        with self._lock:
            self._value += amount

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    # counters bridging pre-existing monotonic ints (engine stats, RPC
    # count dicts) adopt the externally-tracked total at render time
    _set = set


class _HistChild:
    """One labeled series of a histogram family."""

    __slots__ = ("_lock", "_bounds", "_counts", "_sum", "_count",
                 "_exemplars")

    def __init__(self, lock: threading.Lock,
                 bounds: Tuple[float, ...]) -> None:
        self._lock = lock
        self._bounds = bounds                 # includes trailing +Inf
        self._counts: List[int] = [0] * len(bounds)
        self._sum = 0.0
        self._count = 0
        # bucket index -> (trace_id, observed value, wall time): the
        # LAST traced observation per bucket, rendered as an
        # OpenMetrics exemplar so a dashboard's slow bucket links to a
        # concrete /debug/traces entry.  None until a traced observe.
        self._exemplars: Optional[Dict[int, Tuple[str, float, float]]] \
            = None

    def observe(self, value: float, trace_id: Optional[str] = None
                ) -> None:
        self.observe_n(value, 1, trace_id=trace_id)

    def observe_n(self, value: float, n: int,
                  trace_id: Optional[str] = None) -> None:
        """Record *n* observations of *value* under one lock hop — the
        per-window token path records a whole window at once."""
        if n < 1:
            return
        i = bisect_left(self._bounds, value)
        with self._lock:
            self._counts[i] += n
            self._sum += value * n
            self._count += n
            if trace_id:
                if self._exemplars is None:
                    self._exemplars = {}
                self._exemplars[i] = (trace_id, value, time.time())

    def snapshot(self) -> Tuple[List[int], float, int]:
        with self._lock:
            return list(self._counts), self._sum, self._count

    def exemplars(self) -> Dict[int, Tuple[str, float, float]]:
        with self._lock:
            return dict(self._exemplars) if self._exemplars else {}


# the child type one family hands out: _Child for counters/gauges,
# _HistChild for histograms — generic so strict-typed callers get the
# right .inc()/.observe() surface back from .labels()
_C = TypeVar("_C", _Child, _HistChild)


class _Family(Generic[_C]):
    """Base: one metric family (name, help, kind, label names)."""

    kind: str = "untyped"

    def __init__(self, name: str, help: str,
                 labelnames: Tuple[str, ...] = ()) -> None:
        if not _METRIC_NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        if not help:
            raise ValueError(f"metric {name} needs non-empty help text")
        for ln in labelnames:
            if not _LABEL_NAME_RE.match(ln) or ln.startswith("__"):
                raise ValueError(f"invalid label name {ln!r} on {name}")
            if ln == "le" and self.kind == "histogram":
                raise ValueError("'le' is reserved on histograms")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], _C] = {}

    def _make_child(self) -> _C:
        raise NotImplementedError

    def render(self, out: List[str], openmetrics: bool = False) -> None:
        raise NotImplementedError

    def labels(self, **kv: object) -> _C:
        """Get-or-create the child for one label-value combination."""
        if set(kv) != set(self.labelnames):
            raise ValueError(
                f"{self.name} takes labels {self.labelnames}, "
                f"got {tuple(sorted(kv))}")
        key = tuple(str(kv[ln]) for ln in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._make_child()
            return child

    def clear(self) -> None:
        """Drop every child — for snapshot-style families whose label
        sets are rebuilt from scratch each scrape (per-chip health,
        per-member heartbeat age): a vanished chip must not leave a
        stale series behind."""
        with self._lock:
            self._children.clear()

    def _default(self) -> _C:
        return self.labels(**{})

    def _sorted_children(self) -> List[Tuple[Tuple[str, ...], _C]]:
        with self._lock:
            return sorted(self._children.items())


class Counter(_Family[_Child]):
    """Monotonic counter family.  Names MUST end in ``_total`` — the
    renderer is promlint-clean by construction, not by review."""

    kind = "counter"

    def __init__(self, name: str, help: str,
                 labelnames: Tuple[str, ...] = ()) -> None:
        if not name.endswith("_total"):
            raise ValueError(
                f"counter {name!r} must end in '_total' (promlint)")
        super().__init__(name, help, labelnames)

    def _make_child(self) -> _Child:
        return _Child(threading.Lock())

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    def _set(self, value: float) -> None:
        """Adopt an externally-tracked monotonic total (bridge path for
        counters whose source of truth predates the registry)."""
        self._default()._set(value)

    @property
    def value(self) -> float:
        return self._default().value

    def render(self, out: List[str], openmetrics: bool = False) -> None:
        for key, child in self._sorted_children():
            out.append(_sample(self.name, self.labelnames, key,
                               child.value))


class Gauge(_Family[_Child]):
    kind = "gauge"

    def _make_child(self) -> _Child:
        return _Child(threading.Lock())

    def set(self, value: float) -> None:
        self._default().set(value)

    def inc(self, amount: float = 1.0) -> None:
        child = self._default()
        with child._lock:
            child._value += amount

    @property
    def value(self) -> float:
        return self._default().value

    def render(self, out: List[str], openmetrics: bool = False) -> None:
        for key, child in self._sorted_children():
            out.append(_sample(self.name, self.labelnames, key,
                               child.value))


class Histogram(_Family[_HistChild]):
    kind = "histogram"

    def __init__(self, name: str, help: str,
                 labelnames: Tuple[str, ...] = (),
                 buckets: Iterable[float] = LATENCY_BUCKETS_S) -> None:
        bounds = tuple(sorted(set(float(b) for b in buckets)))
        if not bounds:
            raise ValueError(f"histogram {name} needs >= 1 bucket")
        if any(b != b for b in bounds):
            raise ValueError(f"NaN bucket bound on {name}")
        if bounds[-1] != math.inf:
            bounds = bounds + (math.inf,)
        self.buckets = bounds
        super().__init__(name, help, labelnames)

    def _make_child(self) -> _HistChild:
        return _HistChild(threading.Lock(), self.buckets)

    def observe(self, value: float,
                trace_id: Optional[str] = None) -> None:
        self._default().observe(value, trace_id=trace_id)

    def observe_n(self, value: float, n: int,
                  trace_id: Optional[str] = None) -> None:
        self._default().observe_n(value, n, trace_id=trace_id)

    @property
    def top_finite_bucket(self) -> float:
        """Highest finite bound — the anchor for slow-span escalation
        (Span's default WARNING threshold is 5x this)."""
        finite = [b for b in self.buckets if b != math.inf]
        return finite[-1] if finite else 0.0

    def render(self, out: List[str], openmetrics: bool = False) -> None:
        for key, child in self._sorted_children():
            counts, total, count = child.snapshot()
            # exemplars render ONLY under the OpenMetrics content type:
            # the plain text exposition must stay byte-compatible with
            # pre-exemplar scrapes (and promlint-clean)
            ex = child.exemplars() if openmetrics else {}
            cum = 0
            for i, (bound, c) in enumerate(zip(self.buckets, counts)):
                cum += c
                line = _sample(
                    self.name + "_bucket",
                    self.labelnames + ("le",),
                    key + (_fmt_le(bound),), cum)
                if i in ex:
                    tid, val, ts = ex[i]
                    line += (f' # {{trace_id="{escape_label_value(tid)}"'
                             f"}} {_fmt_value(val)} {ts:.3f}")
                out.append(line)
            out.append(_sample(self.name + "_sum", self.labelnames,
                               key, total))
            out.append(_sample(self.name + "_count", self.labelnames,
                               key, count))


def _sample(name: str, labelnames: Tuple[str, ...],
            labelvalues: Tuple[str, ...], value: float) -> str:
    if labelnames:
        body = ",".join(
            f'{ln}="{escape_label_value(lv)}"'
            for ln, lv in zip(labelnames, labelvalues))
        return f"{name}{{{body}}} {_fmt_value(value)}"
    return f"{name} {_fmt_value(value)}"


class Registry:
    """Thread-safe family registry + the one exposition renderer.

    Instrument constructors are get-or-create: asking twice for the
    same (name, kind) returns the same family, so a coordinator and a
    client sharing a process share series instead of colliding.  Kind
    or label-set mismatches on an existing name raise — silent type
    drift is how the three old renderers diverged.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._families: Dict[str, _Family[Any]] = {}
        self._collectors: List[Callable[[], None]] = []
        # the one ProcessCollector this registry carries (see
        # attach_process_collector): tracked here so repeated attaches
        # — e.g. a fresh ScrapeMeta per render — can't stack duplicate
        # on_collect hooks (the collector list has no dedup by design)
        self._process_collector: Optional["ProcessCollector"] = None

    def _get_or_create(self, cls: type, name: str, help: str,
                       labelnames: Iterable[str],
                       **kw: Any) -> "_Family[Any]":
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if not isinstance(fam, cls) or \
                        fam.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind}{fam.labelnames}")
                return fam
            made: _Family[Any] = cls(name, help, tuple(labelnames),
                                     **kw)
            self._families[name] = made
            return made

    def counter(self, name: str, help: str,
                labelnames: Tuple[str, ...] = ()) -> Counter:
        return cast(Counter,
                    self._get_or_create(Counter, name, help, labelnames))

    def gauge(self, name: str, help: str,
              labelnames: Tuple[str, ...] = ()) -> Gauge:
        return cast(Gauge,
                    self._get_or_create(Gauge, name, help, labelnames))

    def histogram(self, name: str, help: str,
                  labelnames: Tuple[str, ...] = (),
                  buckets: Iterable[float] = LATENCY_BUCKETS_S
                  ) -> Histogram:
        return cast(Histogram,
                    self._get_or_create(Histogram, name, help,
                                        labelnames, buckets=buckets))

    def on_collect(self, fn: Callable[[], None]) -> None:
        """Register a callback run at the top of every render() — the
        hook snapshot-style surfaces use to refresh gauges (manager
        status, heartbeat ages) right before the scrape reads them."""
        with self._lock:
            self._collectors.append(fn)

    def render(self, openmetrics: bool = False) -> str:
        """The whole registry in exposition format.  Plain mode is the
        Prometheus text format, unchanged.  *openmetrics* adds histogram
        exemplars (last trace-id per bucket) and the ``# EOF``
        terminator — serve it only under
        :data:`OPENMETRICS_CONTENT_TYPE` (see
        :func:`negotiate_openmetrics`) so plain-text scrapers never see
        an exemplar."""
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            try:
                fn()
            except Exception:
                # a broken collector degrades one scrape's freshness,
                # never the scrape itself
                log.exception("metrics collector failed")
        # snapshot the family list only AFTER the collectors ran: a
        # hook that lazily registers its instruments on first call must
        # still see them rendered in that same (first) scrape
        with self._lock:
            families = sorted(self._families.values(),
                              key=lambda f: f.name)
        out: List[str] = []
        for fam in families:
            samples: List[str] = []
            fam.render(samples, openmetrics=openmetrics)
            if not samples:
                continue
            out.append(f"# HELP {fam.name} {escape_help(fam.help)}")
            out.append(f"# TYPE {fam.name} {fam.kind}")
            out.extend(samples)
        if openmetrics:
            out.append("# EOF")
        return "\n".join(out) + "\n"


class ProcessCollector:
    """Standard process self-metrics, read at scrape time (dep-free).

    Every ``/metrics`` surface answers the same first incident
    questions — is the process leaking memory, burning CPU, or
    exhausting file descriptors — through four conventional families:

    - ``tpu_process_cpu_seconds_total``  user+system CPU (os.times)
    - ``tpu_process_rss_bytes``          resident set (/proc/self/statm)
    - ``tpu_process_open_fds``           open descriptors (/proc/self/fd)
    - ``tpu_process_start_time_seconds`` epoch start (/proc/self/stat)

    Values refresh lazily via :meth:`Registry.on_collect` — no
    background thread, no cost between scrapes.  Where ``/proc`` is
    missing (macOS dev boxes, odd containers) the affected family
    degrades to its last value instead of breaking the scrape.

    Use :func:`attach_process_collector` (idempotent per registry)
    rather than constructing directly: ``Registry.on_collect`` appends
    without dedup, so a second construction would double-register.
    """

    def __init__(self, registry: "Registry") -> None:
        self._c_cpu = registry.counter(
            "tpu_process_cpu_seconds_total",
            "Total user and system CPU time this process has "
            "consumed, in seconds.")
        self._g_rss = registry.gauge(
            "tpu_process_rss_bytes",
            "Resident set size of this process in bytes.")
        self._g_fds = registry.gauge(
            "tpu_process_open_fds",
            "File descriptors currently open in this process.")
        self._g_start = registry.gauge(
            "tpu_process_start_time_seconds",
            "Start time of this process, seconds since the unix "
            "epoch.")
        self._page_size = 4096
        try:
            self._page_size = os.sysconf("SC_PAGE_SIZE")
        except (ValueError, OSError, AttributeError):
            pass
        self._g_start.set(self._read_start_time())
        registry.on_collect(self._collect)

    @staticmethod
    def _read_start_time() -> float:
        """Process start epoch: kernel boot time (/proc/stat btime)
        plus the process start offset (/proc/self/stat field 22, in
        clock ticks).  Falls back to 'now' at attach time — surfaces
        attach at boot, so the error is bounded by startup cost."""
        try:
            btime = None
            with open("/proc/stat", encoding="ascii") as f:
                for line in f:
                    if line.startswith("btime "):
                        btime = float(line.split()[1])
                        break
            with open("/proc/self/stat", encoding="ascii") as f:
                stat = f.read()
            # field 2 (comm) may contain spaces; split after its ')'
            ticks = float(stat.rsplit(")", 1)[1].split()[19])
            hz = os.sysconf("SC_CLK_TCK")
            if btime is not None and hz > 0:
                return btime + ticks / hz
        except (OSError, ValueError, IndexError, AttributeError):
            pass
        return time.time()

    def _collect(self) -> None:
        t = os.times()
        self._c_cpu._set(float(t.user + t.system))
        try:
            with open("/proc/self/statm", encoding="ascii") as f:
                self._g_rss.set(
                    float(f.read().split()[1]) * self._page_size)
        except (OSError, ValueError, IndexError):
            pass
        try:
            self._g_fds.set(float(len(os.listdir("/proc/self/fd"))))
        except OSError:
            pass


# attach serialization: construction registers an on_collect hook, so
# two racing attaches must not both construct (the hook list does not
# dedup).  A module lock is the simplest correct gate — construction
# itself takes registry._lock via counter()/gauge()/on_collect().
_PROCESS_ATTACH_LOCK = threading.Lock()


def attach_process_collector(registry: "Registry") -> ProcessCollector:
    """Get-or-create the registry's :class:`ProcessCollector`.

    Idempotent — safe to call from every ScrapeMeta construction even
    on surfaces that build a fresh ScrapeMeta per render."""
    with _PROCESS_ATTACH_LOCK:
        if registry._process_collector is None:
            registry._process_collector = ProcessCollector(registry)
        return registry._process_collector


class ScrapeMeta:
    """Scrape self-observability for one ``/metrics`` surface.

    Wraps :meth:`Registry.render` and records, about the exposition it
    just produced: wall time (``tpu_scrape_duration_seconds``), sample
    lines (``tpu_scrape_series``) and body bytes
    (``tpu_scrape_size_bytes``), each by exposition ``mode``
    (``text``/``openmetrics``).  Values land in the *next* scrape —
    the standard self-scrape convention (a scrape cannot contain its
    own duration).  One instance per surface, created next to the
    surface's Registry.
    """

    def __init__(self, registry: "Registry") -> None:
        self._registry = registry
        # every /metrics surface carries the standard process
        # self-metrics: ScrapeMeta construction is the one chokepoint
        # all four surfaces already pass through, and the attach is
        # idempotent per registry
        attach_process_collector(registry)
        self._h_duration = registry.histogram(
            "tpu_scrape_duration_seconds",
            "Wall time spent rendering this surface's own /metrics "
            "exposition, by exposition mode.",
            ("mode",), buckets=FAST_BUCKETS_S)
        self._g_series = registry.gauge(
            "tpu_scrape_series",
            "Sample lines in this surface's most recent /metrics "
            "exposition, by exposition mode.",
            ("mode",))
        self._g_size = registry.gauge(
            "tpu_scrape_size_bytes",
            "Byte size of this surface's most recent /metrics "
            "exposition body, by exposition mode.",
            ("mode",))
        # render from boot: the very FIRST scrape already carries both
        # mode children (zeroed), so the schema never shifts between
        # scrape 1 and scrape 2
        for mode in ("text", "openmetrics"):
            self._h_duration.labels(mode=mode)
            self._g_series.labels(mode=mode).set(0.0)
            self._g_size.labels(mode=mode).set(0.0)

    def render(self, openmetrics: bool = False) -> str:
        """Render the registry and account the render itself."""
        t0 = time.perf_counter()
        body = self._registry.render(openmetrics=openmetrics)
        duration = time.perf_counter() - t0
        mode = "openmetrics" if openmetrics else "text"
        series = sum(1 for line in body.splitlines()
                     if line and not line.startswith("#"))
        self._h_duration.labels(mode=mode).observe(duration)
        self._g_series.labels(mode=mode).set(float(series))
        self._g_size.labels(mode=mode).set(
            float(len(body.encode("utf-8"))))
        return body


# -- reading expositions back (benchmarks, lint, tests) ---------------------

def parse_exposition(text: str) -> List[Tuple[str, Dict[str, str], float]]:
    """Parse exposition text into (name, labels, value) samples.
    Comment/blank lines are skipped; malformed sample lines raise."""
    samples: List[Tuple[str, Dict[str, str], float]] = []
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name, labels, value = _parse_sample(line)
        samples.append((name, labels, value))
    return samples


def _parse_sample(line: str) -> Tuple[str, Dict[str, str], float]:
    m = re.match(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)", line)
    if not m:
        raise ValueError(f"malformed sample line: {line!r}")
    name = m.group(1)
    rest = line[m.end():]
    labels: Dict[str, str] = {}
    if rest.startswith("{"):
        i = 1
        while True:
            while i < len(rest) and rest[i] in ", ":
                i += 1
            if i < len(rest) and rest[i] == "}":
                i += 1
                break
            lm = re.match(r'([a-zA-Z_][a-zA-Z0-9_]*)="', rest[i:])
            if not lm:
                raise ValueError(f"malformed labels in: {line!r}")
            ln = lm.group(1)
            i += lm.end()
            buf: List[str] = []
            while i < len(rest):
                c = rest[i]
                if c == "\\":
                    nxt = rest[i + 1:i + 2]
                    buf.append({"\\": "\\", '"': '"', "n": "\n"}.get(
                        nxt, "\\" + nxt))
                    i += 2
                elif c == '"':
                    i += 1
                    break
                else:
                    buf.append(c)
                    i += 1
            else:
                raise ValueError(f"unterminated label value in: {line!r}")
            labels[ln] = "".join(buf)
        rest = rest[i:]
    parts = rest.split()
    if not parts:
        raise ValueError(f"sample line has no value: {line!r}")
    val = parts[0]
    if val == "+Inf":
        fval = math.inf
    elif val == "-Inf":
        fval = -math.inf
    else:
        fval = float(val)
    return name, labels, fval


def histogram_quantile(
    samples: List[Tuple[str, Dict[str, str], float]],
    name: str,
    q: float,
    match: Optional[Dict[str, str]] = None,
) -> float:
    """Estimate quantile *q* of histogram *name* from parsed exposition
    samples (linear interpolation inside the bucket, the same estimate
    PromQL's histogram_quantile makes).  ``match`` filters by label
    subset; children passing the filter are aggregated.  Returns NaN
    when the histogram is absent or empty."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile must be in [0, 1], got {q}")
    by_le: Dict[float, float] = {}
    for sname, labels, value in samples:
        if sname != name + "_bucket" or "le" not in labels:
            continue
        if match and any(labels.get(k) != v for k, v in match.items()):
            continue
        le = math.inf if labels["le"] == "+Inf" else float(labels["le"])
        by_le[le] = by_le.get(le, 0.0) + value
    if not by_le or math.inf not in by_le:
        return math.nan
    total = by_le[math.inf]
    if total <= 0:
        return math.nan
    target = q * total
    prev_bound, prev_cum = 0.0, 0.0
    for bound in sorted(by_le):
        cum = by_le[bound]
        if cum >= target:
            if bound == math.inf:
                return prev_bound  # PromQL: highest finite bound
            if cum == prev_cum:
                return bound
            frac = (target - prev_cum) / (cum - prev_cum)
            return prev_bound + frac * (bound - prev_bound)
        prev_bound, prev_cum = bound, cum
    return prev_bound
