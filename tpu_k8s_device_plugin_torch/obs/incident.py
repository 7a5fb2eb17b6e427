"""Alert-triggered incident bundles: the automatic post-mortem.

The alert evaluator closes the *detection* loop — burn-rate pages fire from the
in-process TSDB.  Diagnosis was still manual: an on-call had to race
the flight-recorder ring and hand-stitch ``/debug/query``,
``/debug/traces``, ``/alerts`` and ``/statz`` before the evidence aged
out of the bounded rings.  :class:`IncidentManager` closes that half:
it subscribes to the :class:`~.alerts.AlertEvaluator` state machine
and, the moment a page-severity rule transitions to firing, writes one
self-contained directory under ``--incident-dir``::

    incident-<alert>-<epoch>/
        alert.json       evaluator status + the ring's transition log
        journal.jsonl    full flight-recorder dump (header + events)
        tsdb.json        snapshot of the rule's referenced families
                         plus the tpu_serve_*/tpu_router_* core set
        profile.folded   last-N-seconds continuous profile (flamegraph)
        profile.json     same slice, tpu-profile/v1 schema
        <collector>.json surface snapshots (statz, slowest SLO-missed
                         traces, ...) — whatever the surface wired in
        replicas/...     router only: per-replica bundle fragments
        meta.json        written LAST: schema tag + file manifest

    The bundle is built under a hidden ``.incident-tmp-*`` name and
    renamed into place, so a reader listing ``incident-*`` never sees
    a partial bundle (meta.json doubling as the completeness marker).

Operational guardrails, all tested:

- **rate limit** — one bundle per alert per ``min_interval_s`` (a
  flapping page must not write the disk full),
- **GC** — newest ``keep`` bundles survive, foreign files are spared
  (same contract as the flight recorder's dump GC),
- **isolation** — the evaluator hook only enqueues; a dedicated worker
  thread does the writing, and every collector is individually
  guarded, so a hung ``/statz`` fetch or a SIGKILLed replica degrades
  one file to an error marker instead of wedging alert evaluation
  (chaos episode 16 proves this with a real kill),
- **accounting** — ``tpu_incident_bundles_total{alert}``,
  ``tpu_incident_bundle_seconds`` and a ``tpu_incident_bundle``
  journal event.

``tools/obs_query.py --incident DIR`` renders a bundle offline.
Stdlib only, like the rest of :mod:`~tpu_k8s_device_plugin_torch.obs`.

The port's own copy of the JAX package's ``obs/incident.py`` (the port
imports nothing of that package): the same calls give the same
results.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import threading
import time
from typing import (
    Any,
    Callable,
    Dict,
    Iterable,
    List,
    Mapping,
    Optional,
    Tuple,
)

from .alerts import (
    ALERT_TRANSITION_EVENT,
    AlertEvaluator,
    AlertRule,
    SEVERITY_PAGE,
    STATE_FIRING,
)
from .core import LATENCY_BUCKETS_S, Registry
from .profiler import SamplingProfiler
from .recorder import FlightRecorder
from .tsdb import TSDB, Selector, expr_metric_names

log = logging.getLogger(__name__)

# schema tags (obs_query --incident keys on these)
BUNDLE_SCHEMA = "tpu-incident/v1"
TSDB_SNAPSHOT_SCHEMA = "tpu-incident-tsdb/v1"

# journal event written after every successful bundle
INCIDENT_EVENT = "tpu_incident_bundle"

# bundle directory naming: the GC and obs_query both match this prefix
BUNDLE_PREFIX = "incident-"
_TMP_PREFIX = ".incident-tmp-"

DEFAULT_KEEP = 8
DEFAULT_MIN_INTERVAL_S = 300.0
DEFAULT_PROFILE_WINDOW_S = 60.0
DEFAULT_METRIC_PREFIXES = ("tpu_serve_", "tpu_router_")

# collector return value: anything json.dumps can take (default=str
# backstops the rest) — or a ready string for non-JSON payloads
Collector = Callable[[], Any]
ExtraFilesFn = Callable[[], Mapping[str, Any]]


def _write_json(path: str, doc: Any) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=2, sort_keys=True, default=str)
        f.write("\n")


class IncidentManager:
    """Subscribe to an evaluator; write bundles when pages fire.

    Parameters
    ----------
    dir_path:
        The ``--incident-dir``.  Created if missing.
    evaluator:
        The surface's :class:`AlertEvaluator`; the manager registers a
        transition hook on it at construction.
    registry / recorder / tsdb / profiler:
        The surface's observability stack; each optional piece that is
        wired in contributes its file to the bundle.
    collectors:
        ``{filename: zero-arg callable}`` surface snapshots (e.g.
        ``{"statz.json": server.statz}``).  Filenames ending ``.json``
        serialize the return value; others are written verbatim (str).
    extra_files_fn:
        Called once per bundle for dynamic multi-file payloads —
        returns ``{relative/path: content}``.  The router uses this to
        pull per-replica fragments into ``replicas/<id>/``.
    keep / min_interval_s / profile_window_s / metric_prefixes /
    severities:
        Guardrails; see module docstring.
    now_fn:
        Test seam for the wall clock.
    """

    def __init__(self, dir_path: str, evaluator: AlertEvaluator, *,
                 registry: Registry,
                 recorder: Optional[FlightRecorder] = None,
                 tsdb: Optional[TSDB] = None,
                 profiler: Optional[SamplingProfiler] = None,
                 collectors: Optional[Mapping[str, Collector]] = None,
                 extra_files_fn: Optional[ExtraFilesFn] = None,
                 keep: int = DEFAULT_KEEP,
                 min_interval_s: float = DEFAULT_MIN_INTERVAL_S,
                 profile_window_s: float = DEFAULT_PROFILE_WINDOW_S,
                 metric_prefixes: Iterable[str] =
                 DEFAULT_METRIC_PREFIXES,
                 severities: Iterable[str] = (SEVERITY_PAGE,),
                 now_fn: Optional[Callable[[], float]] = None) -> None:
        if keep < 1:
            raise ValueError("keep must be >= 1")
        self.dir_path = dir_path
        self._evaluator = evaluator
        self._recorder = recorder
        self._tsdb = tsdb
        self._profiler = profiler
        self._collectors: Dict[str, Collector] = dict(collectors or {})
        self._extra_files_fn = extra_files_fn
        self.keep = int(keep)
        self.min_interval_s = float(min_interval_s)
        self.profile_window_s = float(profile_window_s)
        self._metric_prefixes = tuple(metric_prefixes)
        self._severities = frozenset(severities)
        self._now = now_fn or time.time

        os.makedirs(dir_path, exist_ok=True)
        self._lock = threading.Lock()
        self._last_bundle: Dict[str, float] = {}
        # the hook only ENQUEUES — writing happens on the worker so a
        # slow disk or hung collector can never stall rule evaluation
        self._queue: "queue.Queue[Optional[Tuple[AlertRule, float, Optional[float]]]]" \
            = queue.Queue(maxsize=4)
        self._worker: Optional[threading.Thread] = None

        self._c_bundles = registry.counter(
            "tpu_incident_bundles_total",
            "Incident bundles written, by the alert whose firing "
            "transition triggered them.",
            ("alert",))
        self._h_seconds = registry.histogram(
            "tpu_incident_bundle_seconds",
            "Wall time spent assembling one incident bundle.",
            buckets=LATENCY_BUCKETS_S)
        # boot-materialize the per-alert children for every rule this
        # manager can trigger on: the schema is stable from scrape 1
        for rule in evaluator.rules:
            if rule.severity in self._severities:
                self._c_bundles.labels(alert=rule.name)

        evaluator.add_transition_hook(self._on_transition)

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        """Start the bundle-writer thread (idempotent)."""
        with self._lock:
            if self._worker is not None:
                return
            self._worker = threading.Thread(
                target=self._run, name="tpu-incident", daemon=True)
            self._worker.start()

    def stop(self) -> None:
        """Stop the writer (idempotent; drains nothing — pending
        triggers are dropped, the journal already has the alert)."""
        with self._lock:
            t = self._worker
            self._worker = None
        if t is None:
            return
        try:
            self._queue.put_nowait(None)
        except queue.Full:
            pass
        t.join(timeout=5.0)

    def _run(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            rule, at, value = item
            try:
                self.write_bundle(rule, at, value)
            except Exception:
                log.exception("incident bundle for %s failed",
                              rule.name)

    # -- trigger path -------------------------------------------------------

    def _on_transition(self, rule: AlertRule, state_from: str,
                       state_to: str, at: float,
                       value: Optional[float]) -> None:
        """The evaluator hook: filter, rate-limit, enqueue."""
        if state_to != STATE_FIRING:
            return
        if rule.severity not in self._severities:
            return
        now = float(self._now())
        with self._lock:
            last = self._last_bundle.get(rule.name)
            if last is not None and now - last < self.min_interval_s:
                log.info("incident bundle for %s suppressed "
                         "(rate limit: %gs since last)",
                         rule.name, now - last)
                return
            self._last_bundle[rule.name] = now
        try:
            self._queue.put_nowait((rule, at, value))
        except queue.Full:
            # journal still has the transition; losing the bundle is
            # the correct degradation under a trigger storm
            log.warning("incident bundle queue full; dropping "
                        "trigger for %s", rule.name)

    # -- bundle assembly ----------------------------------------------------

    def write_bundle(self, rule: AlertRule, at: float,
                     value: Optional[float]) -> str:
        """Assemble one bundle synchronously; returns its final path.

        Public so tests (and the smoke tool) can drive a bundle
        without going through the evaluator.  Atomic: everything is
        written under a hidden tmp name in the same directory, then
        renamed into place in one step.
        """
        t0 = time.perf_counter()
        now = float(self._now())
        stamp = int(now * 1000)
        final = os.path.join(self.dir_path,
                             f"{BUNDLE_PREFIX}{rule.name}-{stamp}")
        tmp = os.path.join(self.dir_path,
                           f"{_TMP_PREFIX}{rule.name}-{stamp}")
        os.makedirs(tmp)
        files: List[str] = []
        errors: Dict[str, str] = {}

        def _guarded(relpath: str,
                     write: Callable[[str], None]) -> None:
            path = os.path.join(tmp, relpath)
            try:
                os.makedirs(os.path.dirname(path), exist_ok=True)
                write(path)
                files.append(relpath)
            except Exception as e:  # one bad file, not a lost bundle
                errors[relpath] = f"{type(e).__name__}: {e}"
                log.exception("incident bundle %s: %s failed",
                              rule.name, relpath)

        _guarded("alert.json",
                 lambda p: _write_json(p, self._alert_doc(now)))
        if self._recorder is not None:
            _guarded("journal.jsonl",
                     lambda p: self._recorder.dump(p)
                     if self._recorder is not None else None)
        if self._tsdb is not None:
            _guarded("tsdb.json",
                     lambda p: _write_json(
                         p, self._tsdb_doc(rule, now)))
        if self._profiler is not None:
            prof = self._profiler
            win = self.profile_window_s
            _guarded("profile.folded",
                     lambda p: self._write_text(p, prof.folded(win)))
            _guarded("profile.json",
                     lambda p: _write_json(p, prof.as_json(win)))
        for relpath, fn in sorted(self._collectors.items()):
            _guarded(relpath, lambda p, fn=fn: self._write_payload(
                p, fn()))
        if self._extra_files_fn is not None:
            try:
                extra = dict(self._extra_files_fn())
            except Exception as e:
                extra = {}
                errors["<extra_files>"] = f"{type(e).__name__}: {e}"
                log.exception("incident bundle %s: extra files failed",
                              rule.name)
            for relpath, content in sorted(extra.items()):
                _guarded(relpath,
                         lambda p, c=content: self._write_payload(p, c))

        # meta.json LAST: its presence certifies a complete bundle
        meta: Dict[str, Any] = {
            "schema": BUNDLE_SCHEMA,
            "alert": rule.name,
            "severity": rule.severity,
            "description": rule.description,
            "state_to": STATE_FIRING,
            "at": at,
            "value": value,
            "created_t": now,
            "pid": os.getpid(),
            "files": sorted(files),
            "errors": errors,
        }
        _write_json(os.path.join(tmp, "meta.json"), meta)
        os.rename(tmp, final)

        dt = time.perf_counter() - t0
        self._c_bundles.labels(alert=rule.name).inc()
        self._h_seconds.observe(dt)
        if self._recorder is not None:
            self._recorder.record(
                INCIDENT_EVENT, alert=rule.name,
                severity=rule.severity, dir=final, files=len(files),
                errors=len(errors), duration_s=dt)
        self._gc()
        return final

    @staticmethod
    def _write_text(path: str, text: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            f.write(text)

    @staticmethod
    def _write_payload(path: str, content: Any) -> None:
        if isinstance(content, str) and not path.endswith(".json"):
            IncidentManager._write_text(path, content)
        else:
            _write_json(path, content)

    def _alert_doc(self, now: float) -> Dict[str, Any]:
        doc: Dict[str, Any] = {
            "status": self._evaluator.status(now),
            "transitions": [],
        }
        if self._recorder is not None:
            doc["transitions"] = self._recorder.events(
                name=ALERT_TRANSITION_EVENT)
        return doc

    def _tsdb_doc(self, rule: AlertRule, now: float) -> Dict[str, Any]:
        """Snapshot the rule's referenced families plus every retained
        family matching the core prefixes — the bundle must stand
        alone, so over-collecting beats a missing series."""
        assert self._tsdb is not None
        names = set()
        for cond in rule.conditions:
            try:
                names.update(expr_metric_names(cond.expr))
            except ValueError:
                pass
        for name in self._tsdb.series_names():
            if name.startswith(self._metric_prefixes):
                names.add(name)
            # histogram rules reference the base name; retained series
            # carry _bucket/_sum/_count — keep the whole family
            elif any(name.startswith(n) for n in list(names)):
                names.add(name)
        series: List[Dict[str, Any]] = []
        for name in sorted(names):
            for labels, points in self._tsdb.points(
                    Selector(name, ()), 0.0, now):
                series.append({
                    "name": name,
                    "labels": labels,
                    "points": [[t, v] for t, v in points],
                })
        return {
            "schema": TSDB_SNAPSHOT_SCHEMA,
            "at": now,
            "alert": rule.name,
            "series": series,
        }

    # -- GC -----------------------------------------------------------------

    def _gc(self) -> None:
        """Keep the newest ``keep`` bundles; spare everything that is
        not an ``incident-*`` directory (same contract as the flight
        recorder's dump GC — an operator's notes survive)."""
        try:
            entries = []
            for name in os.listdir(self.dir_path):
                if not name.startswith(BUNDLE_PREFIX):
                    continue
                path = os.path.join(self.dir_path, name)
                if not os.path.isdir(path):
                    continue
                try:
                    entries.append((os.path.getmtime(path), path))
                except OSError:
                    continue
            entries.sort(reverse=True)
            for _, path in entries[self.keep:]:
                self._rmtree(path)
        except OSError:
            log.exception("incident bundle GC failed")

    @staticmethod
    def _rmtree(path: str) -> None:
        """Best-effort recursive removal (shutil-free by taste, and a
        failure must never propagate into the worker loop)."""
        for root, dirs, names in os.walk(path, topdown=False):
            for n in names:
                try:
                    os.unlink(os.path.join(root, n))
                except OSError:
                    pass
            for d in dirs:
                try:
                    os.rmdir(os.path.join(root, d))
                except OSError:
                    pass
        try:
            os.rmdir(path)
        except OSError:
            pass


def read_bundle(dir_path: str) -> Dict[str, Any]:
    """Load a bundle directory back into one dict keyed by relative
    file path, ``meta`` parsed and validated first — the offline half
    (``obs_query --incident``) and the schema round-trip test both go
    through here."""
    meta_path = os.path.join(dir_path, "meta.json")
    if not os.path.isfile(meta_path):
        raise ValueError(
            f"{dir_path}: not an incident bundle (no meta.json)")
    with open(meta_path, "r", encoding="utf-8") as f:
        meta = json.load(f)
    if meta.get("schema") != BUNDLE_SCHEMA:
        raise ValueError(
            f"{dir_path}: unknown bundle schema "
            f"{meta.get('schema')!r}")
    out: Dict[str, Any] = {"meta": meta}
    for rel in meta.get("files", []):
        path = os.path.join(dir_path, rel)
        try:
            if rel.endswith(".json"):
                with open(path, "r", encoding="utf-8") as f:
                    out[rel] = json.load(f)
            else:
                with open(path, "r", encoding="utf-8") as f:
                    out[rel] = f.read()
        except (OSError, ValueError) as e:
            out[rel] = {"error": f"{type(e).__name__}: {e}"}
    return out
