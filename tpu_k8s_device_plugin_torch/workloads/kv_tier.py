# tpulint: deterministic-path
"""Three-tier session KV store: device pages → host RAM → disk.

A chat fleet is mostly *idle* conversations.  The serving engine can
park a finished request's KV pages in its slot (``park_session``), but
device pages and slots are the scarcest resource in the system — so
this module runs the tiering policy that turns parked slots into a
session-scale durability contract:

- **device** — the slot itself: pages mapped, record resident, a
  returning request warm-resumes through the automatic prefix match
  with zero data movement.
- **host** — a bounded RAM pool of ``demote_session()`` checkpoints
  (storage-exact raw KV + tokens).  Idle or pressured device sessions
  demote here; a returning session promotes back with one scatter.
- **disk** — a crash-safe spill directory of migrate-codec payloads.
  Files are written ``tmp → os.replace`` atomic (a final-named file is
  complete by construction; the codec's length-checked container
  rejects truncation), pruned newest-K, and *survive process death*:
  a respawned replica rehydrates spilled sessions lazily on first
  touch, so a SIGKILL no longer destroys conversations.

Demotions ride seeded-jitter idle timers (one ``random.Random(seed)``
— the D1 deterministic-path discipline; callers inject ``now_s``) plus
page/slot pressure.  Every transition is wrapped in the PR-5
resilience layer: RetryPolicy on disk I/O, a watchdog on disk-tier
promotion fetches, a circuit breaker on a sick disk, and the
``suppressed()`` contract on every boundary — **a tiering failure must
never fail the request**; the worst case is a cold re-prefill.
``kv.demote`` / ``kv.promote`` / ``kv.spill`` fault hooks make every
one of those paths provokable from ``--fault-spec``.

Engine calls (park / demote / resume / discard) are scheduler-thread
only; HTTP handler threads use :meth:`export_session` /
:meth:`import_payload`, which touch the engine solely through a
command queue serviced by :meth:`tick`.

The port's own copy of the JAX package's ``workloads/kv_tier.py`` (the port
imports nothing of that package): the same calls give the same
results.
"""

from __future__ import annotations

import hashlib
import logging
import os
import random
import threading
import time
from typing import TYPE_CHECKING, Any, Dict, List, Optional, Tuple

from ..resilience import faults
from ..resilience.policy import (
    CircuitBreaker,
    CircuitOpenError,
    ResilienceMetrics,
    RetryPolicy,
    Watchdog,
    suppressed,
)
from .migrate import MigrateError, dump_payload, load_payload

if TYPE_CHECKING:  # typing only: keep the runtime import graph lean
    from ..obs import FlightRecorder, Registry

log = logging.getLogger(__name__)

TIERS = ("device", "host", "disk")

# spill filename: <sha1(session_id)[:20]>-<seq:08d>.kvs — the hash keys
# the session without leaking its raw id into the filesystem, the seq
# makes every spill a fresh name (os.replace within one name, newest-K
# GC across names)
_SPILL_SUFFIX = ".kvs"


def sid_hash(session_id: str) -> str:
    return hashlib.sha1(session_id.encode("utf-8")).hexdigest()[:20]


def _state_nbytes(obj: object) -> int:
    """Approximate host bytes held by a checkpoint state (arrays
    dominate; scalars are noise)."""
    n = getattr(obj, "nbytes", None)
    if isinstance(n, int):
        return n
    if isinstance(obj, (bytes, bytearray)):
        return len(obj)
    if isinstance(obj, dict):
        return sum(_state_nbytes(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(_state_nbytes(v) for v in obj)
    return 0


class TierMetrics:
    """The ``tpu_kv_tier_*`` families on one obs registry."""

    def __init__(self, registry: "Registry") -> None:
        self.occupancy = registry.gauge(
            "tpu_kv_tier_occupancy",
            "Sessions currently resident per KV tier.", ("tier",))
        self.hits = registry.counter(
            "tpu_kv_tier_hits_total",
            "Returning-session warm hits by the tier that served "
            "them.", ("tier",))
        self.demotions = registry.counter(
            "tpu_kv_tier_demotions_total",
            "Session demotions by destination tier and reason.",
            ("tier", "reason"))
        self.promotions = registry.counter(
            "tpu_kv_tier_promotions_total",
            "Session promotion attempts by source tier and outcome "
            "(ok / degraded — degraded falls back to re-prefill).",
            ("tier", "outcome"))
        self.resume_seconds = registry.histogram(
            "tpu_kv_tier_resume_seconds",
            "Warm-resume latency (checkpoint fetch + scatter) by "
            "source tier.", ("tier",))
        self.spill_bytes = registry.gauge(
            "tpu_kv_tier_spill_bytes",
            "Bytes of session checkpoints resident in the disk tier.")
        self.evictions = registry.counter(
            "tpu_kv_tier_evictions_total",
            "Sessions evicted from the store (KV dropped, next visit "
            "re-prefills) by reason.", ("reason",))


class _Entry:
    """One tracked session (device or host tier; disk rides the
    filename index so it survives the process)."""

    __slots__ = ("sid", "tier", "slot", "state", "nbytes", "deadline",
                 "seq")

    def __init__(self, sid: str, tier: str, *, slot: int = -1,
                 state: Optional[Dict[str, object]] = None,
                 nbytes: int = 0, deadline: float = 0.0,
                 seq: int = 0) -> None:
        self.sid = sid
        self.tier = tier
        self.slot = slot
        self.state = state
        self.nbytes = nbytes
        self.deadline = deadline
        self.seq = seq


class _ExportReq:
    """A handler-thread request for a device-tier checkpoint, serviced
    on the scheduler thread by :meth:`SessionStore.tick`."""

    __slots__ = ("sid", "done", "payload", "error")

    def __init__(self, sid: str) -> None:
        self.sid = sid
        self.done = threading.Event()
        self.payload: Optional[bytes] = None
        self.error: Optional[str] = None


class SessionStore:
    """The tiering policy over one engine's parked sessions.

    All public entry points are no-raise (``suppressed()`` contract)
    except :meth:`export_session` / :meth:`import_payload`, whose
    callers translate errors to HTTP statuses."""

    def __init__(self, engine: Any, *,
                 spill_dir: Optional[str] = None,
                 host_cap_bytes: int = 256 * 1024 * 1024,
                 disk_keep: int = 512,
                 device_idle_s: float = 30.0,
                 host_idle_s: float = 120.0,
                 seed: int = 0,
                 registry: Optional["Registry"] = None,
                 recorder: Optional["FlightRecorder"] = None,
                 rmetrics: Optional[ResilienceMetrics] = None,
                 logger: Optional[logging.Logger] = None) -> None:
        self._engine = engine
        self._dir = spill_dir
        self.host_cap_bytes = host_cap_bytes
        self.disk_keep = disk_keep
        self.device_idle_s = device_idle_s
        self.host_idle_s = host_idle_s
        self._rng = random.Random(seed)
        self._recorder = recorder
        self._rmetrics = rmetrics
        self._log = logger or log
        self._m = TierMetrics(registry) if registry is not None else None
        self._lock = threading.RLock()
        self._entries: Dict[str, _Entry] = {}
        self._host_bytes = 0
        self._seq = 0
        # disk index: sid-hash -> (path, seq, nbytes); lazily rebuilt
        # from filenames at construction, which is how a respawned
        # generation inherits its predecessor's spilled sessions
        self._disk: Dict[str, Tuple[str, int, int]] = {}
        self._exports: List[_ExportReq] = []
        self._stale_slots: List[int] = []
        self._hit_counts = {t: 0 for t in TIERS}
        self._demote_count = 0
        self._promote_count = 0
        self._evict_count = 0
        self._retry = RetryPolicy(max_attempts=3, initial_backoff_s=0.05,
                                  max_backoff_s=0.5, seed=seed)
        self._breaker = CircuitBreaker("kv.disk", failure_threshold=3,
                                       reset_timeout_s=10.0,
                                       metrics=rmetrics,
                                       recorder=recorder)
        self._watchdog = Watchdog("kv.promote", timeout_s=10.0,
                                  metrics=rmetrics, recorder=recorder)
        if self._dir:
            try:
                os.makedirs(self._dir, exist_ok=True)
                self._scan_disk()
            except OSError as e:
                suppressed("kv_tier.scan", e, self._log, self._rmetrics)
        self._refresh_gauges()

    # -- bookkeeping -------------------------------------------------------

    def _jittered(self, now_s: float, idle_s: float) -> float:
        # seeded jitter de-synchronizes demotion herds across sessions
        # while keeping replays deterministic
        return now_s + idle_s * (0.9 + 0.2 * self._rng.random())

    def _scan_disk(self) -> None:
        assert self._dir is not None
        for name in os.listdir(self._dir):
            if not name.endswith(_SPILL_SUFFIX):
                continue
            stem = name[:-len(_SPILL_SUFFIX)]
            head, _, tail = stem.rpartition("-")
            if not head or not tail.isdigit():
                continue
            path = os.path.join(self._dir, name)
            try:
                nbytes = os.path.getsize(path)
            except OSError:
                continue
            seq = int(tail)
            self._seq = max(self._seq, seq + 1)
            old = self._disk.get(head)
            if old is None or old[1] < seq:
                if old is not None:
                    self._unlink_quiet(old[0])
                self._disk[head] = (path, seq, nbytes)
            else:
                self._unlink_quiet(path)

    def _unlink_quiet(self, path: str) -> None:
        try:
            os.unlink(path)
        except OSError as e:
            suppressed("kv_tier.unlink", e, self._log, self._rmetrics)

    def _refresh_gauges(self) -> None:
        if self._m is None:
            return
        with self._lock:
            dev = sum(1 for e in self._entries.values()
                      if e.tier == "device")
            host = sum(1 for e in self._entries.values()
                       if e.tier == "host")
            self._m.occupancy.labels(tier="device").set(dev)
            self._m.occupancy.labels(tier="host").set(host)
            self._m.occupancy.labels(tier="disk").set(len(self._disk))
            self._m.spill_bytes.set(
                sum(n for _, _, n in self._disk.values()))

    def _journal(self, name: str, **fields: object) -> None:
        if self._recorder is not None:
            self._recorder.record(name, **fields)

    # -- scheduler-thread API ----------------------------------------------

    def note_parked(self, session_id: str, slot: int,
                    now_s: float) -> None:
        """Bind *session_id* to its freshly parked device *slot*,
        superseding any older copy in any tier.  Scheduler thread."""
        try:
            with self._lock:
                old = self._entries.get(session_id)
                if old is not None and old.tier == "device" \
                        and old.slot != slot:
                    try:
                        self._engine.discard_session(old.slot)
                    except Exception as e:
                        suppressed("kv_tier.supersede", e, self._log,
                                   self._rmetrics)
                if old is not None and old.tier == "host":
                    self._host_bytes -= old.nbytes
                # a stale disk file (if any) stays: its rows are a
                # bit-exact PREFIX of the newer conversation, so a
                # crash before the next spill degrades to a partial
                # warm resume instead of serving nothing
                self._entries[session_id] = _Entry(
                    session_id, "device", slot=slot,
                    deadline=self._jittered(now_s, self.device_idle_s))
            self._refresh_gauges()
        except Exception as e:
            suppressed("kv_tier.note_parked", e, self._log,
                       self._rmetrics)

    def prepare(self, session_id: str, now_s: float,
                can_restore: bool = True) -> str:
        """Promote *session_id* to the device tier ahead of admission.
        Returns the tier that served the warm hit ("device" / "host" /
        "disk") or "" for a cold miss or any failure — the caller then
        simply omits the session from admission and the request
        re-prefills.  *can_restore* gates host/disk restores (they
        consume a slot the caller may need); a device hit needs no
        slot and always answers.  Scheduler thread; never raises."""
        tier = ""
        try:
            tier = self._prepare(session_id, now_s, can_restore)
        except Exception as e:
            suppressed("kv_tier.prepare", e, self._log, self._rmetrics)
        self._refresh_gauges()
        return tier

    def _prepare(self, session_id: str, now_s: float,
                 can_restore: bool) -> str:
        with self._lock:
            e = self._entries.get(session_id)
        if e is not None and e.tier == "device":
            if faults.ACTIVE is not None:
                try:
                    faults.ACTIVE.fire("kv.promote")
                except faults.InjectedFault as exc:
                    self._degraded("device", exc)
                    return ""
            with self._lock:
                e.deadline = self._jittered(now_s, self.device_idle_s)
            self._hit("device")
            return "device"
        if not can_restore:
            return ""
        if e is not None and e.tier == "host":
            return self._promote_host(e, now_s)
        h = sid_hash(session_id)
        with self._lock:
            on_disk = self._disk.get(h)
        if on_disk is not None:
            return self._promote_disk(session_id, h, on_disk, now_s)
        return ""

    def _degraded(self, tier: str, exc: BaseException) -> None:
        self._log.warning("kv_tier: %s promotion degraded to "
                          "re-prefill: %s", tier, exc)
        if self._m is not None:
            self._m.promotions.labels(tier=tier,
                                      outcome="degraded").inc()
        self._journal("tpu_kv_promote", tier=tier, outcome="degraded",
                      error=str(exc))

    def _hit(self, tier: str) -> None:
        with self._lock:
            self._hit_counts[tier] += 1
        if self._m is not None:
            self._m.hits.labels(tier=tier).inc()

    def _promote_host(self, e: _Entry, now_s: float) -> str:
        t0 = time.monotonic()
        try:
            if faults.ACTIVE is not None:
                faults.ACTIVE.fire("kv.promote")
            slot = int(self._engine.resume_session(e.state))
        # tpulint: disable=R2 -- not a swallow: _degraded() logs, journals tpu_kv_promote{outcome="degraded"} and counts the metric; the session stays parked in host RAM and this request re-prefills (acceptance: a tiering failure never fails the request)
        except Exception as exc:
            self._degraded("host", exc)
            return ""
        with self._lock:
            self._host_bytes -= e.nbytes
            self._entries[e.sid] = _Entry(
                e.sid, "device", slot=slot,
                deadline=self._jittered(now_s, self.device_idle_s))
        self._promoted("host", time.monotonic() - t0)
        return "host"

    def _promote_disk(self, sid: str, h: str,
                      rec: Tuple[str, int, int], now_s: float) -> str:
        path = rec[0]
        t0 = time.monotonic()
        try:
            if faults.ACTIVE is not None:
                faults.ACTIVE.fire("kv.promote")
            state = self._read_state(path)
            if state.get("session_id") != sid:
                # hash-prefix collision or foreign file: never resume
                # another conversation's KV
                raise MigrateError(
                    f"spill file {path} does not hold session")
            slot = int(self._engine.resume_session(state))
        except (MigrateError, ValueError) as exc:
            # corrupt / truncated / foreign: quarantine the file so the
            # store never retries a poisoned checkpoint
            with self._lock:
                if self._disk.get(h, (None,))[0] == path:
                    del self._disk[h]
            self._unlink_quiet(path)
            self._evicted("corrupt")
            self._degraded("disk", exc)
            return ""
        # tpulint: disable=R2 -- not a swallow: _degraded() logs, journals tpu_kv_promote{outcome="degraded"} and counts the metric; the spill file stays on disk for a later visit while this request re-prefills
        except Exception as exc:
            self._degraded("disk", exc)
            return ""
        with self._lock:
            if self._disk.get(h, (None,))[0] == path:
                del self._disk[h]
            self._entries[sid] = _Entry(
                sid, "device", slot=slot,
                deadline=self._jittered(now_s, self.device_idle_s))
        self._unlink_quiet(path)
        self._promoted("disk", time.monotonic() - t0)
        return "disk"

    def _promoted(self, tier: str, dt_s: float) -> None:
        with self._lock:
            self._promote_count += 1
        self._hit(tier)
        if self._m is not None:
            self._m.promotions.labels(tier=tier, outcome="ok").inc()
            self._m.resume_seconds.labels(tier=tier).observe(dt_s)
        self._journal("tpu_kv_promote", tier=tier, outcome="ok",
                      seconds=dt_s)

    def _read_state(self, path: str) -> Dict[str, object]:
        """Disk-tier fetch: breaker-gated, retried, watchdogged — the
        one promotion step that can wedge on a sick disk."""
        if not self._breaker.allow():
            raise CircuitOpenError("kv.disk: circuit open")

        def fetch() -> Dict[str, object]:
            with open(path, "rb") as f:
                return load_payload(f.read())

        try:
            state = self._watchdog.call(
                lambda: self._retry.call(
                    fetch, op="kv.promote", retry_on=(OSError,),
                    metrics=self._rmetrics, recorder=self._recorder))
        except (MigrateError, ValueError):
            # a cleanly-read-but-invalid file is the file's fault, not
            # the disk's: don't open the breaker for it
            raise
        except Exception:
            self._breaker.record_failure()
            raise
        self._breaker.record_success()
        return state

    def tick(self, now_s: float, slot_pressure: bool = False) -> None:
        """Run the demotion policy: service handler-thread export
        requests, demote idle device sessions, spill idle host
        sessions, enforce the host-RAM cap and disk newest-K, and
        (under *slot_pressure*) free a slot for waiting admissions.
        Scheduler thread; never raises."""
        try:
            self._tick(now_s, slot_pressure)
        except Exception as e:
            suppressed("kv_tier.tick", e, self._log, self._rmetrics)
        self._refresh_gauges()

    def _tick(self, now_s: float, slot_pressure: bool) -> None:
        with self._lock:
            exports = list(self._exports)
            self._exports.clear()
            stale = list(self._stale_slots)
            self._stale_slots.clear()
        for slot in stale:
            try:
                self._engine.discard_session(slot)
            except Exception as e:
                suppressed("kv_tier.stale_slot", e, self._log,
                           self._rmetrics)
        for req in exports:
            self._service_export(req)
        with self._lock:
            device = sorted((e for e in self._entries.values()
                             if e.tier == "device"),
                            key=lambda e: e.deadline)
            hosts = sorted((e for e in self._entries.values()
                            if e.tier == "host"),
                           key=lambda e: e.deadline)
        for e in device:
            if e.deadline <= now_s:
                self._demote_to_host(e, now_s, reason="idle")
        if slot_pressure and not self._engine.free_slots():
            with self._lock:
                device = sorted((x for x in self._entries.values()
                                 if x.tier == "device"),
                                key=lambda x: x.deadline)
            if device:
                self._demote_to_host(device[0], now_s, reason="slots")
        for e in hosts:
            if e.deadline <= now_s and self._entries.get(e.sid) is e:
                self._spill_or_drop(e, now_s, reason="idle")
        self._enforce_host_cap(now_s)
        self._gc_disk()

    def _service_export(self, req: _ExportReq) -> None:
        with self._lock:
            e = self._entries.get(req.sid)
        try:
            if e is None:
                req.error = "unknown session"
            elif e.tier == "device":
                state = self._engine.demote_session(e.slot)
                req.payload = dump_payload(state)
                with self._lock:
                    self._entries.pop(req.sid, None)
            elif e.tier == "host":
                assert e.state is not None
                req.payload = dump_payload(e.state)
                with self._lock:
                    self._entries.pop(req.sid, None)
                    self._host_bytes -= e.nbytes
            else:
                req.error = f"unexpected tier {e.tier}"
        except Exception as exc:
            req.error = str(exc)
            suppressed("kv_tier.export", exc, self._log, self._rmetrics)
        req.done.set()

    def demote_for_pages(self, now_s: float) -> bool:
        """Page-pressure valve: demote the closest-to-idle device
        session to host, freeing its pages.  Returns True when a
        session was demoted (the caller retries its allocation).
        Scheduler thread; never raises."""
        try:
            with self._lock:
                device = sorted((e for e in self._entries.values()
                                 if e.tier == "device"),
                                key=lambda e: e.deadline)
            if not device:
                return False
            ok = self._demote_to_host(device[0], now_s, reason="pages")
            self._refresh_gauges()
            return ok
        except Exception as e:
            suppressed("kv_tier.pressure", e, self._log, self._rmetrics)
            return False

    def _demote_to_host(self, e: _Entry, now_s: float,
                        reason: str) -> bool:
        try:
            if faults.ACTIVE is not None:
                faults.ACTIVE.fire("kv.demote")
            state = self._engine.demote_session(e.slot)
        except Exception as exc:
            # the session stays device-parked; idle demotion will
            # retry on the next tick
            suppressed("kv_tier.demote", exc, self._log, self._rmetrics)
            return False
        nbytes = _state_nbytes(state)
        with self._lock:
            self._entries[e.sid] = _Entry(
                e.sid, "host", state=state, nbytes=nbytes,
                deadline=self._jittered(now_s, self.host_idle_s))
            self._host_bytes += nbytes
            self._demote_count += 1
        if self._m is not None:
            self._m.demotions.labels(tier="host", reason=reason).inc()
        self._journal("tpu_kv_demote", session=sid_hash(e.sid),
                      tier="host", reason=reason, bytes=nbytes)
        self._enforce_host_cap(now_s)
        return True

    def _enforce_host_cap(self, now_s: float) -> None:
        while True:
            with self._lock:
                if self._host_bytes <= self.host_cap_bytes:
                    return
                hosts = sorted((e for e in self._entries.values()
                                if e.tier == "host"),
                               key=lambda e: e.deadline)
            if not hosts:
                return
            self._spill_or_drop(hosts[0], now_s, reason="host_cap")

    def _spill_or_drop(self, e: _Entry, now_s: float,
                       reason: str) -> None:
        """host → disk, or host → gone when the disk tier is missing
        or sick (bounded RAM beats unbounded hope)."""
        if self._spill(e, reason):
            return
        with self._lock:
            if self._entries.get(e.sid) is e:
                del self._entries[e.sid]
                self._host_bytes -= e.nbytes
        self._evicted(reason)

    def _spill(self, e: _Entry, reason: str) -> bool:
        if self._dir is None:
            return False
        try:
            if faults.ACTIVE is not None:
                faults.ACTIVE.fire("kv.spill")
            if not self._breaker.allow():
                raise CircuitOpenError("kv.disk: circuit open")
            assert e.state is not None
            payload = dump_payload(e.state)
            with self._lock:
                seq = self._seq
                self._seq += 1
            h = sid_hash(e.sid)
            path = os.path.join(self._dir,
                                f"{h}-{seq:08d}{_SPILL_SUFFIX}")

            def write() -> None:
                tmp = path + ".tmp"
                with open(tmp, "wb") as f:
                    f.write(payload)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, path)

            try:
                self._retry.call(write, op="kv.spill",
                                 retry_on=(OSError,),
                                 metrics=self._rmetrics,
                                 recorder=self._recorder)
            except Exception:
                self._breaker.record_failure()
                raise
            self._breaker.record_success()
        except Exception as exc:
            suppressed("kv_tier.spill", exc, self._log, self._rmetrics)
            return False
        with self._lock:
            old = self._disk.get(h)
            self._disk[h] = (path, seq, len(payload))
            if self._entries.get(e.sid) is e:
                del self._entries[e.sid]
                self._host_bytes -= e.nbytes
            self._demote_count += 1
        if old is not None:
            self._unlink_quiet(old[0])
        if self._m is not None:
            self._m.demotions.labels(tier="disk", reason=reason).inc()
        self._journal("tpu_kv_spill", session=h, reason=reason,
                      bytes=len(payload), path=path)
        self._gc_disk()
        return True

    def _gc_disk(self) -> None:
        with self._lock:
            if len(self._disk) <= self.disk_keep:
                return
            by_age = sorted(self._disk.items(), key=lambda kv: kv[1][1])
            drop = by_age[:len(self._disk) - self.disk_keep]
            for h, _ in drop:
                del self._disk[h]
        for _, (path, _, _) in drop:
            self._unlink_quiet(path)
            self._evicted("disk_cap")

    def _evicted(self, reason: str) -> None:
        with self._lock:
            self._evict_count += 1
        if self._m is not None:
            self._m.evictions.labels(reason=reason).inc()
        self._journal("tpu_kv_evict", reason=reason)

    def spill_all(self, now_s: float) -> None:
        """Drain: push every session down to the disk tier so a
        clean shutdown loses nothing.  Scheduler thread; never
        raises."""
        try:
            with self._lock:
                device = [e for e in self._entries.values()
                          if e.tier == "device"]
            for e in device:
                self._demote_to_host(e, now_s, reason="drain")
            with self._lock:
                hosts = [e for e in self._entries.values()
                         if e.tier == "host"]
            for e in hosts:
                self._spill_or_drop(e, now_s, reason="drain")
        except Exception as e:
            suppressed("kv_tier.drain", e, self._log, self._rmetrics)
        self._refresh_gauges()

    # -- handler-thread API (cross-replica moves) --------------------------

    def export_session(self, session_id: str,
                       timeout_s: float = 5.0) -> bytes:
        """Hand the session's checkpoint to another replica (single-
        owner move: the local copy is dropped).  Raises KeyError
        (unknown), TimeoutError (scheduler busy), or RuntimeError."""
        h = sid_hash(session_id)
        claimed: Optional[Tuple[str, int, int]] = None
        req: Optional[_ExportReq] = None
        with self._lock:
            e = self._entries.get(session_id)
            if e is None:
                claimed = self._disk.pop(h, None)
                if claimed is None:
                    raise KeyError(session_id)
            elif e.tier == "host":
                assert e.state is not None
                payload = dump_payload(e.state)
                self._entries.pop(session_id, None)
                self._host_bytes -= e.nbytes
                self._refresh_gauges()
                return payload
            else:
                req = _ExportReq(session_id)
                self._exports.append(req)
        if claimed is not None:
            # the index slot is claimed; read outside the lock (disk
            # I/O must not block the scheduler's tick)
            try:
                state = self._read_state(claimed[0])
                if state.get("session_id") != session_id:
                    raise KeyError(session_id)
            except BaseException:
                with self._lock:
                    self._disk.setdefault(h, claimed)
                raise
            payload = dump_payload(state)
            self._unlink_quiet(claimed[0])
            self._refresh_gauges()
            return payload
        assert req is not None
        if not req.done.wait(timeout_s):
            raise TimeoutError(
                f"session export {sid_hash(session_id)} timed out")
        if req.payload is None:
            raise RuntimeError(req.error or "export failed")
        self._refresh_gauges()
        return req.payload

    def import_payload(self, raw: bytes, now_s: float) -> str:
        """Accept a checkpoint from another replica into the host
        tier (promotion to device happens on the session's first
        request here).  Returns the session_id; raises MigrateError /
        ValueError on a bad payload."""
        state = load_payload(raw)
        if state.get("kind") != "session":
            raise MigrateError(
                f"not a session checkpoint: {state.get('kind')!r}")
        sid = state.get("session_id")
        if not isinstance(sid, str) or not sid:
            raise MigrateError("payload carries no session_id")
        nbytes = _state_nbytes(state)
        with self._lock:
            old = self._entries.get(sid)
            if old is not None and old.tier == "device":
                # engine ops are scheduler-thread only: queue the
                # superseded slot for discard at the next tick
                self._stale_slots.append(old.slot)
            if old is not None and old.tier == "host":
                self._host_bytes -= old.nbytes
            self._entries[sid] = _Entry(
                sid, "host", state=state, nbytes=nbytes,
                deadline=self._jittered(now_s, self.host_idle_s))
            self._host_bytes += nbytes
        self._journal("tpu_kv_import", session=sid_hash(sid),
                      bytes=nbytes)
        self._refresh_gauges()
        return sid

    # -- introspection -----------------------------------------------------

    def stats(self) -> Dict[str, object]:
        """The fixed-schema /statz block."""
        with self._lock:
            dev = sum(1 for e in self._entries.values()
                      if e.tier == "device")
            host = sum(1 for e in self._entries.values()
                       if e.tier == "host")
            return {
                "device": dev,
                "host": host,
                "host_bytes": self._host_bytes,
                "disk": len(self._disk),
                "disk_bytes": sum(n for _, _, n in self._disk.values()),
                "hits": dict(self._hit_counts),
                "demotions": self._demote_count,
                "promotions": self._promote_count,
                "evictions": self._evict_count,
            }


def empty_tier_stats() -> Dict[str, object]:
    """The same /statz schema when tiering is off — the block is
    always present so fleet roll-ups and schema tests stay simple."""
    return {
        "device": 0, "host": 0, "host_bytes": 0, "disk": 0,
        "disk_bytes": 0, "hits": {t: 0 for t in TIERS},
        "demotions": 0, "promotions": 0, "evictions": 0,
    }
