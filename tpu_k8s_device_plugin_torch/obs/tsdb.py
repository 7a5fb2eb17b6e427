"""Bounded in-process time-series retention over the metrics registry.

Every surface in this repo is *point-in-time*: ``/metrics`` renders the
instant a scraper asks, ``/statz`` snapshots now, and "is this getting
worse" needs an external Prometheus.  This module is the missing
retention layer, dep-free like the rest of :mod:`obs`:

- :class:`TSDB` samples an :class:`~.core.Registry` on a tick (a
  background thread in production, a fake-clock ``tick(now)`` in
  tests), re-using :func:`~.core.parse_exposition` on the one renderer
  so the TSDB sees exactly what a scraper would — collect hooks
  included.
- Storage is a **fixed memory budget**: per-series raw ring (high-res
  recent window) plus downsampled tiers (last-sample-per-aligned-bucket
  — which preserves counter monotonicity across tier boundaries), a
  hard series cap with an observable drop counter, and bounded points
  per ring.  No allocation grows with uptime.
- A small recording-rule engine evaluates ``rate()``, ``increase()``,
  ``avg/min/max_over_time()`` and ``histogram_quantile()`` over the
  retained windows — the grammar :mod:`.alerts` rules and the
  ``GET /debug/query`` endpoint share.

Determinism is a feature, not an accident: under an injected ``now_fn``
(or explicit ``tick(now=...)``), identical sample streams produce
byte-identical query results — the seeded fuzz in
``tests/test_tsdb.py`` holds the module to that.

Divergences from PromQL, chosen for boundedness and determinism:
``increase()`` is the sum of positive deltas over points in the window
(reset-aware, no extrapolation), and ``rate()`` is that increase
divided by the window length.

The port's own copy of the JAX package's ``obs/tsdb.py`` (the port
imports nothing of that package): the same calls give the same
results.
"""

from __future__ import annotations

import json
import logging
import math
import re
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import (
    Callable,
    Deque,
    Dict,
    List,
    Mapping,
    Optional,
    Sequence,
    Tuple,
    Union,
)

from .core import (
    FAST_BUCKETS_S,
    Counter,
    Gauge,
    Histogram,
    Registry,
    parse_exposition,
)

log = logging.getLogger(__name__)

# one (timestamp, value) sample
Point = Tuple[float, float]
# sorted (label, value) items — the hashable half of a series key
LabelItems = Tuple[Tuple[str, str], ...]
SeriesKey = Tuple[str, LabelItems]

# raw high-res window retained at tick resolution
DEFAULT_RAW_WINDOW_S = 300.0
# (bucket step, retention window) per downsampled tier, fine -> coarse;
# defaults follow the SRE burn-rate windows this TSDB exists to serve:
# 30s buckets cover the 1h window, 5m buckets the 6h window
DEFAULT_TIERS: Tuple[Tuple[float, float], ...] = (
    (30.0, 3600.0),
    (300.0, 21600.0),
)
# hard cap on retained series; past it new series are dropped and
# counted, never silently grown
DEFAULT_MAX_SERIES = 4096
# raw ring length in points (the second half of the raw bound: the
# window prunes by time, this prunes by count when ticks come fast)
DEFAULT_RAW_POINTS = 512
# instant-vector staleness: a series with no sample in this window
# before the evaluation time yields no value (mirrors Prometheus's
# 5m staleness default)
DEFAULT_LOOKBACK_S = 300.0

_DURATION_RE = re.compile(
    r"^\s*(\d+(?:\.\d+)?)\s*(ms|s|m|h|d)?\s*$")
_DURATION_UNIT_S = {"ms": 0.001, "s": 1.0, "m": 60.0, "h": 3600.0,
                    "d": 86400.0, None: 1.0}


def parse_duration(text: str) -> float:
    """``"30s"``/``"5m"``/``"1h"``/``"250ms"``/bare seconds -> seconds."""
    m = _DURATION_RE.match(text)
    if not m:
        raise ValueError(f"bad duration {text!r} (want e.g. 30s, 5m, 1h)")
    return float(m.group(1)) * _DURATION_UNIT_S[m.group(2)]


def format_duration(seconds: float) -> str:
    """Inverse of :func:`parse_duration` for round-trippable display."""
    for unit, scale in (("d", 86400.0), ("h", 3600.0), ("m", 60.0)):
        if seconds >= scale and seconds % scale == 0:
            return f"{int(seconds / scale)}{unit}"
    if seconds == int(seconds):
        return f"{int(seconds)}s"
    return f"{seconds}s"


# -- expression grammar ------------------------------------------------------

_NAME_RE = r"[a-zA-Z_:][a-zA-Z0-9_:]*"
_SELECTOR_RE = re.compile(
    rf"^\s*({_NAME_RE})\s*(\{{[^}}]*\}})?\s*$")
_MATCHER_RE = re.compile(
    r'\s*([a-zA-Z_][a-zA-Z0-9_]*)\s*=\s*"((?:[^"\\]|\\.)*)"\s*(,|$)')
_RANGE_FN_RE = re.compile(
    rf"^\s*(rate|increase|avg_over_time|min_over_time|max_over_time)"
    rf"\s*\(\s*(.+?)\s*\[\s*([^\]]+)\s*\]\s*\)\s*$", re.S)
_HISTQ_RE = re.compile(
    r"^\s*histogram_quantile\s*\(\s*([0-9.]+)\s*,"
    r"\s*(.+?)\s*\[\s*([^\]]+)\s*\]\s*\)\s*$", re.S)

RANGE_FUNCTIONS = ("rate", "increase", "avg_over_time",
                   "min_over_time", "max_over_time",
                   "histogram_quantile")


@dataclass(frozen=True)
class Selector:
    """``name{label="value",...}`` — an instant vector selector."""

    name: str
    matchers: LabelItems = ()

    def matches(self, labels: Mapping[str, str]) -> bool:
        return all(labels.get(k) == v for k, v in self.matchers)

    def __str__(self) -> str:
        if not self.matchers:
            return self.name
        body = ",".join(f'{k}="{v}"' for k, v in self.matchers)
        return f"{self.name}{{{body}}}"


@dataclass(frozen=True)
class RangeExpr:
    """``fn(selector[window])`` — a range function over one selector.

    ``histogram_quantile`` carries its quantile in ``quantile`` and
    selects the base histogram name (``_bucket`` resolved internally).
    """

    fn: str
    selector: Selector
    window_s: float
    quantile: Optional[float] = None

    def __str__(self) -> str:
        win = format_duration(self.window_s)
        if self.fn == "histogram_quantile":
            return (f"histogram_quantile({self.quantile}, "
                    f"{self.selector}[{win}])")
        return f"{self.fn}({self.selector}[{win}])"


Expr = Union[Selector, RangeExpr]


def _unescape(v: str) -> str:
    return v.replace('\\"', '"').replace("\\n", "\n").replace(
        "\\\\", "\\")


def parse_selector(text: str) -> Selector:
    m = _SELECTOR_RE.match(text)
    if not m:
        raise ValueError(f"bad selector {text!r}")
    name, raw = m.group(1), m.group(2)
    matchers: List[Tuple[str, str]] = []
    if raw:
        body = raw[1:-1].strip()
        pos = 0
        while pos < len(body):
            mm = _MATCHER_RE.match(body, pos)
            if not mm:
                raise ValueError(f"bad label matcher in {text!r}")
            matchers.append((mm.group(1), _unescape(mm.group(2))))
            pos = mm.end()
        if body and not matchers:
            raise ValueError(f"bad label matcher in {text!r}")
    return Selector(name, tuple(sorted(matchers)))


def parse_expr(text: str) -> Expr:
    """Parse one query expression.  Grammar::

        expr     := selector
                  | fn '(' selector '[' duration ']' ')'
                  | 'histogram_quantile' '(' q ',' selector '[' dur ']' ')'
        fn       := 'rate' | 'increase' | 'avg_over_time'
                  | 'min_over_time' | 'max_over_time'
        selector := name ( '{' label '=' '"' value '"' , ... '}' )?
    """
    m = _HISTQ_RE.match(text)
    if m:
        q = float(m.group(1))
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        return RangeExpr("histogram_quantile", parse_selector(m.group(2)),
                         parse_duration(m.group(3)), quantile=q)
    m = _RANGE_FN_RE.match(text)
    if m:
        return RangeExpr(m.group(1), parse_selector(m.group(2)),
                         parse_duration(m.group(3)))
    return parse_selector(text)


def expr_metric_names(text: str) -> List[str]:
    """Metric family names referenced by an expression — the hook the
    tpulint O2 rule and doc tables use.  Raises on a malformed
    expression (a rule that cannot parse can never evaluate)."""
    expr = parse_expr(text)
    sel = expr if isinstance(expr, Selector) else expr.selector
    return [sel.name]


# -- storage -----------------------------------------------------------------

class _Series:
    """One retained series: raw ring + downsampled tier rings."""

    __slots__ = ("raw", "tiers")

    def __init__(self, tiers: Sequence[Tuple[float, float]],
                 raw_points: int) -> None:
        self.raw: Deque[Point] = deque(maxlen=raw_points)
        self.tiers: List[Deque[Point]] = [
            deque(maxlen=int(window / step) + 2)
            for step, window in tiers]

    def n_points(self) -> int:
        return len(self.raw) + sum(len(t) for t in self.tiers)


class TSDB:
    """Bounded retention + recording rules over one Registry.

    ``tick()`` samples the registry (render -> parse -> append); call
    it manually with a fake ``now`` in tests, or :meth:`start` a
    background thread in production.  Registered tick hooks (the alert
    evaluator) run after each sample pass, inside the same tick — so
    "within two evaluation ticks" is a real bound, not a race.
    """

    def __init__(self, registry: Registry, *,
                 raw_window_s: float = DEFAULT_RAW_WINDOW_S,
                 tiers: Sequence[Tuple[float, float]] = DEFAULT_TIERS,
                 max_series: int = DEFAULT_MAX_SERIES,
                 raw_points: int = DEFAULT_RAW_POINTS,
                 lookback_s: float = DEFAULT_LOOKBACK_S,
                 now_fn: Optional[Callable[[], float]] = None,
                 self_metrics: bool = True) -> None:
        if raw_window_s <= 0:
            raise ValueError("raw_window_s must be > 0")
        if max_series < 1 or raw_points < 2:
            raise ValueError("max_series >= 1 and raw_points >= 2")
        tiers = tuple(sorted(((float(s), float(w)) for s, w in tiers)))
        for step, window in tiers:
            if step <= 0 or window < step:
                raise ValueError(
                    f"bad tier (step={step}, window={window})")
        self._registry = registry
        self._raw_window_s = float(raw_window_s)
        self._tiers = tiers
        self._max_series = int(max_series)
        self._raw_points = int(raw_points)
        self._lookback_s = float(lookback_s)
        self._now_fn: Callable[[], float] = now_fn or time.time
        self._lock = threading.RLock()
        self._series: Dict[SeriesKey, _Series] = {}
        self._hooks: List[Callable[[float], None]] = []
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._last_tick: Optional[float] = None
        self._c_ticks: Optional[Counter] = None
        self._c_dropped: Optional[Counter] = None
        self._g_series: Optional[Gauge] = None
        self._g_points: Optional[Gauge] = None
        self._h_tick: Optional[Histogram] = None
        if self_metrics:
            self._c_ticks = registry.counter(
                "tpu_tsdb_ticks_total",
                "Registry sampling ticks the in-process TSDB has run.")
            self._c_dropped = registry.counter(
                "tpu_tsdb_dropped_samples_total",
                "Samples dropped because the TSDB series cap was "
                "reached (new series past the fixed memory budget).")
            self._g_series = registry.gauge(
                "tpu_tsdb_series",
                "Series currently retained by the in-process TSDB.")
            self._g_points = registry.gauge(
                "tpu_tsdb_points",
                "Points currently retained across all TSDB rings "
                "(raw window plus downsampled tiers).")
            self._h_tick = registry.histogram(
                "tpu_tsdb_tick_duration_seconds",
                "Wall time of one TSDB sampling tick (render + parse "
                "+ append).", buckets=FAST_BUCKETS_S)

    # -- clock + lifecycle ---------------------------------------------------

    def now(self) -> float:
        return self._now_fn()

    @property
    def registry(self) -> Registry:
        return self._registry

    @property
    def lookback_s(self) -> float:
        return self._lookback_s

    def add_tick_hook(self, fn: Callable[[float], None]) -> None:
        """Run *fn(now)* after every sample pass (alert evaluation)."""
        with self._lock:
            self._hooks.append(fn)

    def start(self, interval_s: float = 5.0) -> None:
        """Start the background sampling thread (idempotent)."""
        if interval_s <= 0:
            raise ValueError("interval_s must be > 0")
        with self._lock:
            if self._thread is not None:
                return
            self._stop.clear()
            t = threading.Thread(
                target=self._run, args=(float(interval_s),),
                name="obs-tsdb", daemon=True)
            self._thread = t
        t.start()

    def stop(self) -> None:
        with self._lock:
            t = self._thread
            self._thread = None
        if t is not None:
            self._stop.set()
            t.join(timeout=5.0)

    def _run(self, interval_s: float) -> None:
        while not self._stop.wait(interval_s):
            try:
                self.tick()
            except Exception:
                # one bad tick degrades freshness, never the server
                log.exception("tsdb tick failed")

    # -- write path ----------------------------------------------------------

    def tick(self, now: Optional[float] = None) -> int:
        """Sample the registry once; returns the sample count."""
        t = self._now_fn() if now is None else float(now)
        t0 = time.perf_counter()
        text = self._registry.render()
        samples = parse_exposition(text)
        dropped = 0
        with self._lock:
            if self._last_tick is not None and t < self._last_tick:
                t = self._last_tick  # clock went backwards: clamp
            self._last_tick = t
            for name, labels, value in samples:
                if value != value:  # NaN never aggregates
                    continue
                key: SeriesKey = (name, tuple(sorted(labels.items())))
                s = self._series.get(key)
                if s is None:
                    if len(self._series) >= self._max_series:
                        dropped += 1
                        continue
                    s = self._series[key] = _Series(
                        self._tiers, self._raw_points)
                self._append_locked(s, t, value)
            n_series = len(self._series)
            n_points = sum(s.n_points() for s in self._series.values())
            hooks = list(self._hooks)
        if self._c_ticks is not None:
            self._c_ticks.inc()
        if dropped and self._c_dropped is not None:
            self._c_dropped.inc(dropped)
        if self._g_series is not None:
            self._g_series.set(float(n_series))
        if self._g_points is not None:
            self._g_points.set(float(n_points))
        if self._h_tick is not None:
            self._h_tick.observe(time.perf_counter() - t0)
        for fn in hooks:
            try:
                fn(t)
            except Exception:
                log.exception("tsdb tick hook failed")
        return len(samples)

    def _append_locked(self, s: _Series, t: float, value: float) -> None:
        raw = s.raw
        if raw and t <= raw[-1][0]:
            # same-instant re-tick (fake clocks do this): latest wins
            raw[-1] = (t, value)
        else:
            raw.append((t, value))
        cutoff = t - self._raw_window_s
        while raw and raw[0][0] < cutoff:
            raw.popleft()
        for (step, window), ring in zip(self._tiers, s.tiers):
            bucket = math.floor(t / step)
            if ring and math.floor(ring[-1][0] / step) >= bucket:
                ring[-1] = (t, value)  # last sample per aligned bucket
            else:
                ring.append((t, value))
            wcut = t - window
            while ring and ring[0][0] < wcut:
                ring.popleft()

    # -- read path -----------------------------------------------------------

    def series_count(self) -> int:
        with self._lock:
            return len(self._series)

    def series_names(self) -> List[str]:
        """Sorted distinct metric names currently held — the incident
        bundler enumerates these to snapshot whole family sets
        (``tpu_serve_*`` and the firing rule's referenced families)
        without knowing every name up front."""
        with self._lock:
            return sorted({name for name, _ in self._series})

    def point_count(self) -> int:
        with self._lock:
            return sum(s.n_points() for s in self._series.values())

    def _matching_locked(self, sel: Selector
                         ) -> List[Tuple[LabelItems, _Series]]:
        out: List[Tuple[LabelItems, _Series]] = []
        for (name, items), s in self._series.items():
            if name != sel.name:
                continue
            if sel.matchers and not sel.matches(dict(items)):
                continue
            out.append((items, s))
        out.sort(key=lambda kv: kv[0])
        return out

    @staticmethod
    def _merged(s: _Series, start: float, end: float) -> List[Point]:
        """Merge tiers + raw into one ascending point list: raw where
        available, each coarser tier only for time older than every
        finer level it hands off to."""
        merged: List[Point] = list(s.raw)
        oldest = merged[0][0] if merged else math.inf
        for ring in s.tiers:  # fine -> coarse
            older = [p for p in ring if p[0] < oldest]
            if older:
                merged = older + merged
                oldest = older[0][0]
        return [p for p in merged if start <= p[0] <= end]

    def points(self, sel: Selector, start: float, end: float
               ) -> List[Tuple[Dict[str, str], List[Point]]]:
        """Raw merged points per matching series over [start, end]."""
        with self._lock:
            matches = self._matching_locked(sel)
            return [(dict(items), self._merged(s, start, end))
                    for items, s in matches]

    # -- evaluation ----------------------------------------------------------

    @staticmethod
    def _increase(points: Sequence[Point]) -> float:
        """Reset-aware increase: sum of positive deltas."""
        inc = 0.0
        for i in range(1, len(points)):
            d = points[i][1] - points[i - 1][1]
            if d > 0:
                inc += d
        return inc

    def _window_points(self, s: _Series, at: float, window_s: float
                       ) -> List[Point]:
        """Points in (at - window, at], plus one baseline point just
        before the window so increase() sees the counter's value at
        window start (within the staleness lookback)."""
        start = at - window_s
        pts = self._merged(s, start - self._lookback_s, at)
        inside = [p for p in pts if p[0] > start]
        baseline = [p for p in pts if p[0] <= start]
        if baseline:
            return [baseline[-1]] + inside
        return inside

    def evaluate(self, expr: Union[str, Expr],
                 at: Optional[float] = None
                 ) -> List[Tuple[Dict[str, str], float]]:
        """Instant evaluation: (labels, value) per output series."""
        e = parse_expr(expr) if isinstance(expr, str) else expr
        t = self.now() if at is None else float(at)
        with self._lock:
            if isinstance(e, Selector):
                out: List[Tuple[Dict[str, str], float]] = []
                for items, s in self._matching_locked(e):
                    pts = self._merged(s, t - self._lookback_s, t)
                    if pts:
                        out.append((dict(items), pts[-1][1]))
                return out
            if e.fn == "histogram_quantile":
                return self._hist_quantile_locked(e, t)
            out = []
            for items, s in self._matching_locked(e.selector):
                pts = self._window_points(s, t, e.window_s)
                val = self._apply_fn(e, pts)
                if val is not None:
                    out.append((dict(items), val))
            return out

    def _apply_fn(self, e: RangeExpr, pts: List[Point]
                  ) -> Optional[float]:
        if not pts:
            return None
        if e.fn == "increase":
            return self._increase(pts)
        if e.fn == "rate":
            return self._increase(pts) / e.window_s
        values = [v for _, v in pts]
        if e.fn == "avg_over_time":
            return sum(values) / len(values)
        if e.fn == "min_over_time":
            return min(values)
        if e.fn == "max_over_time":
            return max(values)
        raise ValueError(f"unknown function {e.fn!r}")

    def _hist_quantile_locked(self, e: RangeExpr, at: float
                              ) -> List[Tuple[Dict[str, str], float]]:
        """histogram_quantile(q, name[w]): per label group (minus
        ``le``), quantile of the bucket *increase* over the window —
        the same interpolation PromQL makes."""
        base = e.selector.name
        if base.endswith("_bucket"):
            base = base[:-len("_bucket")]
        bucket_sel = Selector(base + "_bucket", e.selector.matchers)
        groups: Dict[LabelItems, Dict[float, float]] = {}
        for items, s in self._matching_locked(bucket_sel):
            labels = dict(items)
            le_raw = labels.pop("le", None)
            if le_raw is None:
                continue
            le = math.inf if le_raw == "+Inf" else float(le_raw)
            gkey = tuple(sorted(labels.items()))
            pts = self._window_points(s, at, e.window_s)
            inc = self._increase(pts)
            by_le = groups.setdefault(gkey, {})
            by_le[le] = by_le.get(le, 0.0) + inc
        q = e.quantile if e.quantile is not None else 0.5
        out: List[Tuple[Dict[str, str], float]] = []
        for gkey in sorted(groups):
            val = _bucket_quantile(groups[gkey], q)
            if val == val:  # skip NaN (empty window)
                out.append((dict(gkey), val))
        return out

    # -- HTTP ----------------------------------------------------------------

    def query_range(self, expr: Union[str, Expr], start: float,
                    end: float, step_s: Optional[float] = None
                    ) -> List[Dict[str, object]]:
        """Series for ``GET /debug/query``: selectors return stored
        points verbatim; range functions evaluate on a step grid."""
        e = parse_expr(expr) if isinstance(expr, str) else expr
        if end < start:
            raise ValueError("range end before start")
        if isinstance(e, Selector):
            out: List[Dict[str, object]] = []
            for labels, pts in self.points(e, start, end):
                out.append({"name": e.name, "labels": labels,
                            "points": [[t, v] for t, v in pts]})
            return out
        step = float(step_s) if step_s else max(
            1.0, (end - start) / 120.0)
        if step <= 0:
            raise ValueError("step must be > 0")
        by_series: Dict[Tuple[Tuple[str, str], ...],
                        List[List[float]]] = {}
        t = start
        while t <= end + 1e-9:
            for labels, val in self.evaluate(e, at=t):
                key = tuple(sorted(labels.items()))
                by_series.setdefault(key, []).append([t, val])
            t += step
        name = str(e)
        return [{"name": name, "labels": dict(key), "points": pts}
                for key, pts in sorted(by_series.items())]

    def handle_query(self, params: Mapping[str, str]
                     ) -> Dict[str, object]:
        """``GET /debug/query?expr=&range=[&step=][&at=]`` -> JSON
        payload.  Raises ValueError on a malformed request (surfaces
        map that to a 400)."""
        expr_text = params.get("expr", "")
        if not expr_text:
            raise ValueError("missing expr parameter")
        e = parse_expr(expr_text)
        range_s = parse_duration(params.get("range", "300"))
        if range_s <= 0:
            raise ValueError("range must be > 0")
        step_s = (parse_duration(params["step"])
                  if params.get("step") else None)
        end = float(params["at"]) if params.get("at") else self.now()
        start = end - range_s
        series = self.query_range(e, start, end, step_s)
        return {
            "expr": expr_text,
            "start": start,
            "end": end,
            "range_s": range_s,
            "series": series,
        }

    def handle_query_json(self, params: Mapping[str, str]) -> str:
        return json.dumps(self.handle_query(params), sort_keys=True)


def _bucket_quantile(by_le: Dict[float, float], q: float) -> float:
    """Quantile from cumulative bucket increases (PromQL's linear
    interpolation — same math as :func:`core.histogram_quantile` but
    over increases, not lifetime counts)."""
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
                return prev_bound
            if cum == prev_cum:
                return bound
            frac = (target - prev_cum) / (cum - prev_cum)
            return prev_bound + frac * (bound - prev_bound)
        prev_bound, prev_cum = bound, cum
    return prev_bound
