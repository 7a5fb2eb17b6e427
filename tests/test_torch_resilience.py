"""The port's ``resilience/policy.py`` against the JAX package's: retry
schedules per seed, retry loops over scripted failures, circuit-breaker
state machines under a fake clock, the watchdog, and the suppressed-
error sink; what each returns, the metric families it moves (exposition
bytes) and the flight-recorder events it journals must be equal.  And
``resilience`` exports the reference's names."""

import threading
import time

import pytest

from tpu_k8s_device_plugin import obs as jobs
from tpu_k8s_device_plugin import resilience as jres
from tpu_k8s_device_plugin.resilience import policy as jpolicy
from tpu_k8s_device_plugin_torch import obs as tobs
from tpu_k8s_device_plugin_torch import resilience as tres
from tpu_k8s_device_plugin_torch.resilience import policy as tpolicy

SIDES = {"jax": (jobs, jres, jpolicy), "torch": (tobs, tres, tpolicy)}


class FakeTime:
    """``time`` for the policy module: monotonic() reads a fake clock;
    sleep() advances it."""

    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t

    def sleep(self, dt):
        self.t += dt


def _events(rec):
    return [(e["name"], e["attrs"]) for e in rec.events()]


def scenario_retry_schedule(side, seed, _clock):
    _, res, _ = side
    out = []
    for kw in (dict(), dict(initial_backoff_s=0.1, max_backoff_s=1.0,
                            multiplier=3.0, jitter=0.5),
               dict(jitter=0.0)):
        p = res.RetryPolicy(max_attempts=10, seed=seed, **kw)
        out.append([p.backoff_s(a) for a in range(1, 10)])
    return out


def scenario_retry_calls(side, seed, clock):
    obs, res, _ = side
    reg = obs.Registry()
    rec = obs.FlightRecorder(registry=None)
    metrics = res.ResilienceMetrics(reg)
    out = []
    for fails, max_attempts, retry_on in ((2, 4, (OSError,)),
                                          (9, 3, (OSError,)),
                                          (1, 3, (ValueError,))):
        n = [0]

        def fn():
            n[0] += 1
            if n[0] <= fails:
                raise OSError(f"try {n[0]}")
            return n[0]

        p = res.RetryPolicy(max_attempts=max_attempts, seed=seed,
                            initial_backoff_s=0.5)
        try:
            out.append(("ok", p.call(fn, op=f"op{fails}",
                                     retry_on=retry_on, metrics=metrics,
                                     recorder=rec)))
        except OSError as e:
            out.append(("raised", str(e), n[0]))
    stop = threading.Event()
    stop.set()
    try:
        res.RetryPolicy(seed=seed).call(lambda: 1, op="stopped", stop=stop,
                                        metrics=metrics, recorder=rec)
    except res.CircuitOpenError as e:
        out.append(("aborted", str(e)))
    out.append(round(clock.t - 1000.0, 9))
    out.append(_events(rec))
    out.append(reg.render())
    return out


def scenario_breaker(side, _seed, clock):
    obs, res, _ = side
    reg = obs.Registry()
    rec = obs.FlightRecorder(registry=None)
    br = res.CircuitBreaker("dial", failure_threshold=3,
                            reset_timeout_s=10.0,
                            metrics=res.ResilienceMetrics(reg),
                            recorder=rec)
    out = []
    script = ["f", "f", "s", "f", "f", "f", "a", "t5", "a", "t6", "a", "a",
              "f", "t11", "a", "s", "a", "c-ok", "c-err", "c-err", "c-err",
              "c-err"]
    for step in script:
        if step == "f":
            br.record_failure()
        elif step == "s":
            br.record_success()
        elif step == "a":
            out.append(br.allow())
        elif step.startswith("t"):
            clock.t += float(step[1:])
        elif step == "c-ok":
            out.append(br.call(lambda: "ok"))
        else:
            def boom():
                raise ValueError("boom")
            try:
                br.call(boom)
            except (ValueError, res.CircuitOpenError) as e:
                out.append((type(e).__name__, str(e)))
        out.append(br.state)
    out.append(_events(rec))
    out.append(reg.render())
    return out


def scenario_watchdog_and_suppressed(side, _seed, _clock):
    obs, res, _ = side
    reg = obs.Registry()
    rec = obs.FlightRecorder(registry=None)
    metrics = res.ResilienceMetrics(reg)
    wd = res.Watchdog("probe", timeout_s=0.5, metrics=metrics,
                      recorder=rec)
    out = [wd.call(lambda: 7)]
    gate = threading.Event()
    try:
        wd_fast = res.Watchdog("hang", timeout_s=0.05, metrics=metrics,
                               recorder=rec)
        wd_fast.call(lambda: gate.wait(5))
    except res.WatchdogTimeout as e:
        out.append(str(e))
    gate.set()
    try:
        wd.call(lambda: 1 / 0)
    except ZeroDivisionError as e:
        out.append(str(e))
    res.suppressed("site.a", ValueError("x"), metrics=metrics)
    res.set_suppressed_metrics(metrics)
    try:
        res.suppressed("site.b", KeyError("y"))
        res.suppressed("site.b", KeyError("y"))
    finally:
        res.set_suppressed_metrics(None)
    res.suppressed("site.c", KeyError("z"))  # no sink: log line only
    out.append(_events(rec))
    out.append(reg.render())
    return out


SCENARIOS = {
    "retry_schedule_0": (scenario_retry_schedule, 0),
    "retry_schedule_13": (scenario_retry_schedule, 13),
    "retry_calls_1": (scenario_retry_calls, 1),
    "retry_calls_4": (scenario_retry_calls, 4),
    "breaker": (scenario_breaker, 0),
    "watchdog_and_suppressed": (scenario_watchdog_and_suppressed, 0),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_port_matches_reference(name, monkeypatch):
    fn, seed = SCENARIOS[name]
    got = {}
    for tag, side in SIDES.items():
        clock = FakeTime()
        if fn is not scenario_watchdog_and_suppressed:
            # the policies read time.monotonic and sleep through
            # time.sleep (or a stop event's wait); both run on the fake
            monkeypatch.setattr(side[2], "time", clock)
        got[tag] = fn(side, seed, clock)
        monkeypatch.undo()
    assert got["torch"] == got["jax"]


def test_exports_match_reference():
    assert sorted(tres.__all__) == sorted(jres.__all__)
    for name in ("BREAKER_CLOSED", "BREAKER_HALF_OPEN", "BREAKER_OPEN"):
        assert getattr(tres, name) == getattr(jres, name)
    assert issubclass(tres.WatchdogTimeout, TimeoutError)
    assert issubclass(tres.CircuitOpenError, RuntimeError)


def test_real_clock_retry_sleeps_its_schedule():
    """Unpatched, the port's retry loop sleeps the schedule it reports
    (a stop event's wait, then plain sleeps)."""
    p = tres.RetryPolicy(max_attempts=3, initial_backoff_s=0.02,
                         jitter=0.0, seed=0)
    n = [0]

    def fn():
        n[0] += 1
        if n[0] < 3:
            raise OSError("again")
        return "done"

    t0 = time.monotonic()
    assert p.call(fn, op="x") == "done"
    assert time.monotonic() - t0 >= 0.02 + 0.04
