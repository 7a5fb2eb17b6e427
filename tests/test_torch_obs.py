"""The port's ``obs/`` (trace, span, recorder, stitch, slo, tsdb, alerts,
profiler, incident) against the JAX package's: each scenario drives one
module of each package through the same seeded sequence of calls, under
fake clocks, and what the two return must be equal: query JSON, alert
states and journals, burn rates and goodput summaries, exposition
bytes, profiles and incident bundles.  Wall-clock stamps (``t_wall``,
``t_mono``, bundle times) are the only fields taken out.

The one intended difference: the HELP text of
``tpu_profiler_suspended_ticks_total`` names the port's capture
(``/debug/profile``) where the reference's names ``jax.profiler``."""

import json
import os
import random

import pytest

from tpu_k8s_device_plugin import obs as jobs
from tpu_k8s_device_plugin_torch import obs as tobs

pytestmark = pytest.mark.filterwarnings("ignore")

T0 = 1_700_000_000.0
PACKAGES = {"jax": jobs, "torch": tobs}
_HELP_REF = "suspended (e.g. during a jax.profiler capture)."
_HELP_PORT = "suspended (e.g. during a /debug/profile capture)."


class FakeClock:
    def __init__(self, t=T0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt
        return self.t


def _strip(ev):
    """An event dict without its wall-clock stamps."""
    return {k: v for k, v in ev.items() if k not in ("t_wall", "t_mono")}


def _same_render(body: str) -> str:
    return body.replace(_HELP_REF, _HELP_PORT)


# -- scenarios: each takes an obs package and returns comparable data -------

def scenario_tsdb_fuzz(obs, seed):
    rng = random.Random(seed)
    reg = obs.Registry()
    g = reg.gauge("fz_gauge", "h", ("cls",))
    c = reg.counter("fz_total", "h")
    h = reg.histogram("fz_seconds", "h", buckets=(0.1, 0.5, 1.0))
    clock = FakeClock()
    db = obs.TSDB(reg, now_fn=clock, raw_window_s=30.0, raw_points=64,
                  tiers=((15.0, 120.0), (60.0, 600.0)), max_series=64)
    for _ in range(300):
        for cls in ("a", "b", "c"):
            if rng.random() < 0.8:
                g.labels(cls=cls).set(rng.uniform(0, 100))
        c.inc(rng.uniform(0, 5))
        if rng.random() < 0.5:
            h.observe(rng.uniform(0, 2))
        db.tick(clock.advance(rng.choice([0.5, 1.0, 2.0, 5.0])))
    out = [db.series_count(), db.point_count()]
    for q in ("fz_total", 'fz_gauge{cls="b"}', "rate(fz_total[2m])",
              "increase(fz_total[10m])", "avg_over_time(fz_gauge[1m])",
              "min_over_time(fz_gauge[5m])", "max_over_time(fz_gauge[5m])",
              "histogram_quantile(0.9, fz_seconds[5m])", "unknown_family"):
        out.append(db.handle_query_json(
            {"expr": q, "range": "10m", "at": str(clock.t)}))
    for bad in ("rate(fz_total)", "fz_total[", "histogram_quantile(x, a)"):
        try:
            db.handle_query_json({"expr": bad})
        except ValueError as e:
            out.append(str(e))
    out.append(_drop_wall(reg.render()))
    return out


def _drop_wall(body: str) -> str:
    """Exposition without the TSDB's own tick-duration family (wall
    time of each tick)."""
    return "\n".join(line for line in body.splitlines()
                     if "tpu_tsdb_tick_duration_seconds" not in line)


def scenario_expr_grammar(obs, _seed):
    out = []
    for e in ("tpu_serve_queue_depth", 'a{b="c",d="e"}', "rate(x[5m])",
              "increase(x[1h])", "histogram_quantile(0.95, h[30s])",
              "avg_over_time(g[250ms])"):
        out.append(repr(obs.parse_expr(e)))
        out.append(sorted(obs.expr_metric_names(e)))
    for d in ("30s", "5m", "1h", "250ms", "2d", "45"):
        out.append(obs.parse_duration(d))
        out.append(obs.format_duration(obs.parse_duration(d)))
    return out


def scenario_alert_traversal(obs, _seed):
    reg = obs.Registry()
    g = reg.gauge("sig", "h")
    g2 = reg.gauge("sig2", "h")
    clock = FakeClock()
    db = obs.TSDB(reg, now_fn=clock, self_metrics=False)
    rec = obs.FlightRecorder(registry=None)
    rules = [obs.threshold_rule("hot", "sig", ">", 10.0, for_s=5.0,
                                severity="page", description="too hot"),
             obs.threshold_rule("cold", "sig2", "<=", 1.0,
                                severity="ticket")]
    ev = obs.AlertEvaluator(db, rules, recorder=rec,
                            resolved_hold_s=20.0)
    out = []
    for value, dt in ((1.0, 1.0), (50.0, 1.0), (50.0, 2.0), (50.0, 4.0),
                      (1.0, 1.0), (1.0, 5.0), (1.0, 30.0)):
        g.set(value)
        g2.set(value)
        db.tick(clock.advance(dt))
        out.append(ev.status_json())
        out.append(json.dumps(ev.brief(), sort_keys=True))
        out.append(ev.firing())
    out.append([_strip(e) for e in rec.events()])
    out.append(reg.render())
    return out


def scenario_burn_rate_rules(obs, _seed):
    policies = obs.parse_slo_specs(["interactive=250", "batch=0:60000",
                                    "chat=500:9000"])
    out = [repr(sorted(policies.items()))]
    for scale in (1.0, 0.01):
        rules = obs.burn_rate_rules(policies, window_scale=scale)
        out.append([repr(r) for r in rules])
    text = json.dumps({"rules": [
        {"name": "q", "severity": "ticket", "for": "30s",
         "conditions": [{"expr": "tpu_serve_queue_depth", "op": ">",
                         "threshold": 5}]}]})
    out.append([repr(r) for r in obs.parse_alert_rules(text)])
    for total, miss, objective in ((100, 5, 0.99), (1000, 144, 0.999),
                                   (0, 0, 0.99)):
        out.append(obs.burn_rate(total, miss, objective))
    return out


def scenario_slo_accounting(obs, seed):
    rng = random.Random(seed)
    reg = obs.Registry()
    acct = obs.SLOAccountant(
        reg, policies=obs.parse_slo_specs(["interactive=250",
                                           "batch=0:2000"]),
        tenants=["alpha", "beta", "*"], window_s=3600.0)
    out = []
    for _ in range(200):
        cls = rng.choice(["interactive", "batch", "bogus", "", None])
        tenant = rng.choice(["alpha", "beta", "gamma", ""])
        ttft = rng.choice([None, rng.uniform(0, 0.5)])
        out.append(acct.record(cls, tenant, ttft_s=ttft,
                               total_s=rng.uniform(0, 3),
                               ok=rng.random() < 0.9,
                               fallback=rng.choice(["interactive",
                                                    "batch"])))
    out.append(json.dumps(acct.summary(), sort_keys=True))
    out.append(reg.render())
    return out


def scenario_trace_context(obs, _seed):
    out = []
    for header in ("00-4bf92f3577b34da6a3ce929d0e0e4736-"
                   "00f067aa0ba902b7-01",
                   "00-4bf92f3577b34da6a3ce929d0e0e4736-"
                   "00f067aa0ba902b7-00",
                   "garbage", "", None,
                   "00-00000000000000000000000000000000-"
                   "00f067aa0ba902b7-01",
                   "ff-4bf92f3577b34da6a3ce929d0e0e4736-"
                   "00f067aa0ba902b7-01"):
        ctx = obs.parse_traceparent(header)
        out.append(None if ctx is None else
                   (ctx.trace_id, ctx.span_id, ctx.parent_id,
                    ctx.to_traceparent()))
        cont = obs.trace_from_header(header)
        out.append(ctx is not None and cont.trace_id == ctx.trace_id
                   and cont.parent_id == ctx.span_id)
    return out


def scenario_recorder_span_stitch(obs, seed, tmp):
    rng = random.Random(seed)
    reg = obs.Registry()
    rec = obs.FlightRecorder(capacity=64, registry=reg, dump_keep=2)
    hist = reg.histogram("tpu_test_seconds", "h", ("outcome",))
    root = obs.parse_traceparent(
        "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01")
    ctxs = [root]
    for i in range(80):
        parent = rng.choice(ctxs)
        ctx = obs.TraceContext(parent.trace_id, f"{i + 1:016x}",
                               parent.span_id)
        ctxs.append(ctx)
        rec.record(rng.choice(["tpu_a", "tpu_b", "tpu_serve_shed",
                               "tpu_serve_scheduler_crash"]),
                   trace=ctx, n=i, duration_s=rng.uniform(0, 1),
                   blob=object if i % 7 == 0 else "x")
    sp = obs.Span("tpu_test", histogram=hist, request_id="req-1",
                  trace=root, recorder=rec).annotate(k=1)
    sp.end(outcome="ok")
    sp.end(outcome="late")  # idempotent
    events = [_strip(e) for e in rec.events()]
    for e in events:
        e["attrs"] = {k: v for k, v in e["attrs"].items()
                      if k not in ("duration_s", "blob")
                      or e["name"] != "tpu_test"}
    evs = rec.events(trace_id=root.trace_id)
    for e in evs:
        e["t_wall"] = e["t_mono"] = 0.0
        if e["name"] == "tpu_test":
            e["attrs"].pop("duration_s", None)
    tree = obs.stitch(evs)
    out = [events, rec.recorded, rec.dropped,
           [sorted((k, v) for k, v in t.items() if k != "last_t_wall")
            for t in rec.trace_ids()],
           json.dumps(tree, sort_keys=True), obs.render_tree(tree),
           [obs.event_severity(e) for e in events],
           json.dumps(obs.flatten(tree), sort_keys=True)]
    for _ in range(3):
        rec.dump_to_dir(tmp)
    out.append(len([f for f in os.listdir(tmp)]))
    out.append(rec.dump_gc_count)
    body = reg.render()
    out.append([line for line in body.splitlines()
                if "tpu_test_seconds_sum" not in line])
    return out


class _Code:
    def __init__(self, name):
        self.co_name = name


class _Frame:
    def __init__(self, name, mod="fake", back=None):
        self.f_code = _Code(name)
        self.f_globals = {"__name__": mod}
        self.f_back = back


def _chain(*names):
    frame = None
    for name in names:
        frame = _Frame(name, "fake", frame)
    return frame


def scenario_profiler(obs, seed):
    rng = random.Random(seed)
    clock = FakeClock()
    reg = obs.Registry()
    phase = ["dispatch"]
    stacks = [_chain("main", "loop", f"f{i}") for i in range(12)]
    prof = obs.SamplingProfiler(
        reg, hz=19.0, window_s=10, max_stacks=8,
        phase_fn=lambda: phase[0], active_fn=lambda: 3,
        frames_fn=lambda: {1: rng.choice(stacks), 2: rng.choice(stacks)},
        now_fn=clock)
    out = []
    for i in range(60):
        phase[0] = rng.choice(["dispatch", "harvest", "stream", "idle"])
        if i % 10 == 9:
            with prof.suspend():
                out.append(prof.sample_once())
        else:
            out.append(prof.sample_once())
        clock.advance(0.5)
    for q in ({"seconds": ["5"], "format": ["folded"]},
              {"seconds": ["10"], "format": ["json"]}):
        ctype, body = prof.handle_pprof(q)
        if ctype.startswith("application/json"):
            doc = json.loads(body)
            doc.pop("overhead_ratio", None)
            body = json.dumps(doc, sort_keys=True)
        out.append((ctype, body))
    out.append(obs.fold_stack(_chain("a", "b", "c")))
    out.append(_same_render("\n".join(
        line for line in reg.render().splitlines()
        if "overhead_ratio" not in line)))
    return out


def scenario_incident(obs, _seed, tmp):
    clock = FakeClock()
    reg = obs.Registry()
    rec = obs.FlightRecorder(registry=reg)
    goodput = reg.gauge("tpu_serve_goodput", "Goodput ratio.")
    goodput.set(1.0)
    db = obs.TSDB(reg, now_fn=clock)
    rule = obs.threshold_rule("goodput_page", "tpu_serve_goodput", "<",
                              0.5, for_s=0.0, severity="page",
                              description="goodput collapsed")
    ev = obs.AlertEvaluator(db, [rule], recorder=rec)
    prof = obs.SamplingProfiler(
        reg, hz=19.0, now_fn=clock, phase_fn=lambda: "dispatch",
        frames_fn=lambda: {1: _chain("main", "serve")})
    prof.sample_once()
    mgr = obs.IncidentManager(
        tmp, ev, registry=reg, recorder=rec, tsdb=db, profiler=prof,
        collectors={"statz.json": lambda: {"pending": 3},
                    "broken.json": lambda: 1 / 0},
        now_fn=clock, keep=2)
    db.tick(clock.advance(1.0))
    ev.evaluate()
    goodput.set(0.1)
    db.tick(clock.advance(5.0))
    ev.evaluate()
    item = mgr._queue.get_nowait()
    mgr.write_bundle(*item)
    names = sorted(p for p in os.listdir(tmp)
                   if p.startswith(obs.BUNDLE_PREFIX))
    bundle = obs.read_bundle(os.path.join(tmp, names[0]))
    meta = bundle["meta"]
    out = [len(names), sorted(meta["files"]), sorted(meta["errors"]),
           meta["alert"], meta["schema"], bundle["statz.json"],
           sorted(s["name"] for s in bundle["tsdb.json"]["series"]),
           bundle["profile.folded"],
           [sorted(json.loads(line)) for line in
            bundle["journal.jsonl"].splitlines() if line.strip()]]
    out.append([line for line in reg.render().splitlines()
                if line.startswith("tpu_incident")
                and "bundle_seconds" not in line])
    return out


SCENARIOS = {
    "tsdb_fuzz_0": (scenario_tsdb_fuzz, 0),
    "tsdb_fuzz_7": (scenario_tsdb_fuzz, 7),
    "tsdb_fuzz_42": (scenario_tsdb_fuzz, 42),
    "expr_grammar": (scenario_expr_grammar, 0),
    "alert_traversal": (scenario_alert_traversal, 0),
    "burn_rate_rules": (scenario_burn_rate_rules, 0),
    "slo_accounting_1": (scenario_slo_accounting, 1),
    "slo_accounting_5": (scenario_slo_accounting, 5),
    "trace_context": (scenario_trace_context, 0),
    "recorder_span_stitch_3": (scenario_recorder_span_stitch, 3),
    "recorder_span_stitch_9": (scenario_recorder_span_stitch, 9),
    "profiler_2": (scenario_profiler, 2),
    "profiler_8": (scenario_profiler, 8),
    "incident": (scenario_incident, 0),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_port_matches_reference(name, tmp_path):
    fn, seed = SCENARIOS[name]
    needs_dir = fn in (scenario_recorder_span_stitch, scenario_incident)
    got = {}
    for tag, pkg in PACKAGES.items():
        args = (pkg, seed) + ((str(tmp_path / tag),) if needs_dir else ())
        if needs_dir:
            os.makedirs(args[-1])
        got[tag] = fn(*args)
    assert got["torch"] == got["jax"]


def test_exports_match_reference():
    """``obs`` exports every name the reference's does, and the server's
    bucket and content-type constants carry the same values."""
    assert sorted(tobs.__all__) == sorted(jobs.__all__)
    for name in ("FAST_BUCKETS_S", "LATENCY_BUCKETS_S", "SLOW_BUCKETS_S",
                 "OPENMETRICS_CONTENT_TYPE", "TEXT_CONTENT_TYPE",
                 "BUNDLE_SCHEMA", "PROFILE_SCHEMA", "TSDB_SNAPSHOT_SCHEMA",
                 "ALERT_TRANSITION_EVENT", "INCIDENT_EVENT"):
        assert getattr(tobs, name) == getattr(jobs, name), name
    for accept in (None, "", "text/plain",
                   "application/openmetrics-text; version=1.0.0",
                   "application/openmetrics-text;q=0, text/plain"):
        assert tobs.negotiate_openmetrics(accept) == \
            jobs.negotiate_openmetrics(accept)
