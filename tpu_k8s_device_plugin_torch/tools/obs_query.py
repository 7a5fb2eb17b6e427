"""obs_query: query live /debug endpoints AND flight-recorder dumps.

The fleet's post-mortem companion: one trace-id (or time range) in,
one merged view out — whether the processes that produced the events
are still alive (live ``/debug/traces`` / ``/debug/events`` endpoints
on routers, replicas, and device plugins) or already dead (their
``--flight-record-dir`` JSON-lines dumps).  Events from every source
are merged, deduplicated, and — in trace-id mode — re-linked into the
same span tree the router's stitched ``/debug/traces`` serves, via the
``parent_id`` each hop's traceparent stamped.

Examples::

    # a live fleet: router + 2 replicas
    python -m tpu_k8s_device_plugin_torch.tools.obs_query \
        --trace-id 4bf9... \
        --endpoint http://router:8100 \
        --endpoint http://rep0:8000 --endpoint http://rep1:8000

    # the same trace after a replica died: its dump has its half
    python -m tpu_k8s_device_plugin_torch.tools.obs_query \
        --trace-id 4bf9... \
        --endpoint http://router:8100 \
        --dump /var/lib/tpu-flight-records/

    # what happened in the last minute before the crash?
    python -m tpu_k8s_device_plugin_torch.tools.obs_query \
        --dump flight-43-1754300612.jsonl \
        --since 1754300550 --until 1754300612

    # replay -> post-mortem in one command: the slowest SLO-missed
    # requests of a workloads.replay report, span trees and all
    python -m tpu_k8s_device_plugin_torch.tools.obs_query \
        --replay-report replay-report.json --top 3

    # live dashboard: sparklines from the server's in-process TSDB
    # (GET /debug/query) + the firing-alert table (GET /alerts)
    python -m tpu_k8s_device_plugin_torch.tools.obs_query \
        --watch --endpoint http://rep0:8000

    # render an alert-triggered incident bundle offline: alert
    # timeline, burn sparkline, top profile stacks by phase, and the
    # stitched span trees of the slowest SLO-missed requests
    python -m tpu_k8s_device_plugin_torch.tools.obs_query --incident \
        /var/lib/tpu-incidents/incident-slo_burn_page_chat-1754300612000

Dependency-free (stdlib + the stdlib-only ``obs`` package), like
every tool in this repo.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time
from typing import Callable, Dict, List, Optional
from urllib.parse import quote
from urllib.request import urlopen

from .. import obs


def _fetch_json(url: str, timeout_s: float) -> Optional[dict]:
    try:
        with urlopen(url, timeout=timeout_s) as resp:
            out = json.loads(resp.read())
        return out if isinstance(out, dict) else None
    except (OSError, ValueError) as e:
        print(f"obs_query: {url}: {e}", file=sys.stderr)
        return None


def fetch_endpoint(base: str, trace_id: Optional[str],
                   since: float, timeout_s: float
                   ) -> List[Dict[str, object]]:
    """One live endpoint's events: /debug/traces?trace_id= in trace
    mode, /debug/events?since= in time-range mode."""
    base = base.rstrip("/")
    if trace_id:
        url = (f"{base}/debug/traces"
               f"?trace_id={quote(trace_id, safe='')}")
    else:
        url = f"{base}/debug/events?since={since}"
    out = _fetch_json(url, timeout_s)
    if out is None:
        return []
    events = out.get("events")
    if not isinstance(events, list):
        # the router's stitched shape: flatten its tree back to events
        tree = out.get("tree")
        if isinstance(tree, list):
            return [dict(e, _origin=base)
                    for e in obs.flatten(tree)]
        return []
    return [dict(e, _origin=base) for e in events
            if isinstance(e, dict)]


def read_dump(path: str) -> List[Dict[str, object]]:
    """One flight-recorder dump file (JSON-lines; header line skipped),
    or every flight-*.jsonl in a directory."""
    if os.path.isdir(path):
        out: List[Dict[str, object]] = []
        for name in sorted(os.listdir(path)):
            if name.startswith("flight-") and name.endswith(".jsonl"):
                out.extend(read_dump(os.path.join(path, name)))
        return out
    events: List[Dict[str, object]] = []
    origin = os.path.basename(path)
    try:
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    ev = json.loads(line)
                except ValueError:
                    continue  # truncated tail of a crash-time dump
                if not isinstance(ev, dict) or "name" not in ev:
                    continue  # the header line, or foreign JSON
                ev["_origin"] = origin
                events.append(ev)
    except OSError as e:
        print(f"obs_query: {path}: {e}", file=sys.stderr)
    return events


def _f(v: object) -> float:
    return float(v) if isinstance(v, (int, float)) else 0.0


def collect(trace_id: Optional[str], endpoints: List[str],
            dumps: List[str], since: float, until: float,
            name: Optional[str], timeout_s: float
            ) -> List[Dict[str, object]]:
    """Gather + filter + dedup events from every source, oldest
    first.  Dedup key: (name, trace span, wall time) — a live
    endpoint and that process's dump report the same event once."""
    events: List[Dict[str, object]] = []
    for ep in endpoints:
        events.extend(fetch_endpoint(ep, trace_id, since, timeout_s))
    for d in dumps:
        events.extend(read_dump(d))
    seen = set()
    out: List[Dict[str, object]] = []
    for ev in events:
        if trace_id and ev.get("trace_id") != trace_id:
            continue
        t = _f(ev.get("t_wall"))
        if since and t <= since:
            continue
        if until and t > until:
            continue
        if name and ev.get("name") != name:
            continue
        key = (ev.get("name"), ev.get("trace_id"), ev.get("span_id"),
               round(t, 6))
        if key in seen:
            continue
        seen.add(key)
        out.append(ev)
    out.sort(key=lambda e: _f(e.get("t_wall")))
    return out


def render_replay_report(path: str, top: int,
                         as_json: bool) -> int:
    """The slowest *top* SLO-missed requests of a
    ``tpu-replay-report/v1`` file (workloads.replay --report),
    attribution plus — where the report embedded the raw spans — the
    stitched tree, re-stitched right here so the post-mortem needs no
    live endpoint.  Exit 0 when the report has no misses at all."""
    with open(path, "r", encoding="utf-8") as f:
        report = json.loads(f.read())
    if not isinstance(report, dict) \
            or report.get("schema") != "tpu-replay-report/v1":
        print(f"obs_query: {path} is not a tpu-replay-report/v1 "
              f"file (schema={report.get('schema')!r})"
              if isinstance(report, dict)
              else f"obs_query: {path}: not a JSON object",
              file=sys.stderr)
        return 2
    missed = report.get("slo_missed")
    rows = [r for r in missed if isinstance(r, dict)] \
        if isinstance(missed, list) else []
    rows = rows[:max(0, top)]
    if as_json:
        out = []
        for row in rows:
            events = row.get("events")
            tree = obs.stitch([e for e in events
                               if isinstance(e, dict)]) \
                if isinstance(events, list) else []
            out.append(dict(row, tree=tree))
        print(json.dumps({"report": path, "slo_missed": out},
                         indent=2))
        return 0
    classes = report.get("classes")
    if isinstance(classes, dict):
        for name in sorted(classes):
            info = classes[name]
            if isinstance(info, dict):
                print(f"class {name}: attainment "
                      f"{info.get('attainment')} "
                      f"({info.get('met')}/{info.get('eligible')} "
                      f"eligible, {info.get('total')} total)")
    if not rows:
        print("no SLO-missed requests in the report")
        return 0
    for row in rows:
        print(f"\n-- {row.get('rid')} class={row.get('class')} "
              f"outcome={row.get('outcome')} "
              f"total={row.get('total_ms')}ms "
              f"ttft={row.get('ttft_ms')}ms "
              f"replica={row.get('replica')} "
              f"trace={str(row.get('trace_id'))[:16]}")
        attribution = row.get("attribution")
        if isinstance(attribution, dict):
            print("   where it went: " + "  ".join(
                f"{k.removesuffix('_ms')}={v:.1f}ms"
                for k, v in attribution.items()
                if isinstance(v, (int, float)) and v > 0))
        events = row.get("events")
        if isinstance(events, list) and events:
            tree = obs.stitch([e for e in events
                               if isinstance(e, dict)])
            print(obs.render_tree(tree))
        else:
            print("   (no spans embedded for this request — raise "
                  "--top-missed on the replay run)")
    return 0


# -- watch mode: live TSDB sparklines + firing alerts ----------------------

SPARK_BLOCKS = "▁▂▃▄▅▆▇█"

# severity colors for TTY watch frames: page red, ticket
# yellow — everything else stays uncolored; NO_COLOR opts out
_SEV_COLOR = {"page": "\x1b[31m", "ticket": "\x1b[33m"}
_RESET = "\x1b[0m"


def _colorize(text: str, severity: str, color: bool) -> str:
    code = _SEV_COLOR.get(severity) if color else None
    return f"{code}{text}{_RESET}" if code else text

# the serving surface's vital signs; families a surface lacks just
# render "(no data)", so the same default set works against the
# router and the exporter too
WATCH_EXPRS = (
    "tpu_slo_goodput_ratio",
    "tpu_slo_error_budget_burn_rate",
    "tpu_serving_pending_requests",
    "tpu_serving_kv_pages_free",
)


def sparkline(values: List[float], width: int = 48) -> str:
    """Unicode block sparkline of the last *width* values, annotated
    with the min/last/max.  NaNs are dropped; empty -> '(no data)'."""
    vals = [float(v) for v in values
            if isinstance(v, (int, float)) and v == v]
    if not vals:
        return "(no data)"
    vals = vals[-width:]
    lo, hi = min(vals), max(vals)
    span = hi - lo
    if span <= 0:
        bar = SPARK_BLOCKS[0] * len(vals)
    else:
        top = len(SPARK_BLOCKS) - 1
        bar = "".join(
            SPARK_BLOCKS[int(round((v - lo) / span * top))]
            for v in vals)
    return f"{bar}  min={lo:g} last={vals[-1]:g} max={hi:g}"


def _series_label(labels: Dict[str, object]) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f"{k}={v}" for k, v
                          in sorted(labels.items())) + "}"


def render_watch_frame(queries: List[Dict[str, object]],
                       alerts: Optional[dict],
                       width: Optional[int] = None,
                       color: bool = False) -> str:
    """One watch frame as text: per-expr sparklines over the
    /debug/query payloads, then the alert table (every rule NOT
    inactive, severity first).  Pure — the watch test feeds it
    captured payloads and pins the rendering; *width* sizes the
    sparklines (None keeps the historical 48) and *color* wraps
    page/ticket alert rows in ANSI red/yellow (both default off so
    the pinned rendering is unchanged)."""
    spark_w = 48 if width is None else max(8, width - 54)
    lines: List[str] = []
    for q in queries:
        expr = str(q.get("expr", ""))
        series = q.get("series")
        series = series if isinstance(series, list) else []
        lines.append(expr)
        if not series:
            lines.append("  (no data)")
        for s in series:
            if not isinstance(s, dict):
                continue
            pts = s.get("points")
            pts = pts if isinstance(pts, list) else []
            values = [p[1] for p in pts
                      if isinstance(p, (list, tuple)) and len(p) == 2
                      and isinstance(p[1], (int, float))]
            labels = s.get("labels")
            labels = labels if isinstance(labels, dict) else {}
            lines.append(f"  {_series_label(labels) or '(all)':24s} "
                         f"{sparkline(values, width=spark_w)}")
    rows = []
    if isinstance(alerts, dict):
        for a in alerts.get("alerts") or []:
            if isinstance(a, dict) and a.get("state") != "inactive":
                rows.append(a)
    lines.append("")
    if rows:
        sev_rank = {"page": 0, "ticket": 1, "info": 2}
        rows.sort(key=lambda a: (
            sev_rank.get(str(a.get("severity")), 9),
            str(a.get("name"))))
        lines.append(f"{'ALERT':32s} {'SEVERITY':8s} {'STATE':8s} "
                     f"{'VALUE':>10s}  SINCE")
        now = time.time()
        for a in rows:
            since = a.get("since")
            age = f"{now - float(since):.0f}s ago" \
                if isinstance(since, (int, float)) and since else "-"
            value = a.get("value")
            vtxt = f"{value:.4g}" \
                if isinstance(value, (int, float)) else "-"
            row = (f"{str(a.get('name', '')):32s} "
                   f"{str(a.get('severity', '')):8s} "
                   f"{str(a.get('state', '')):8s} {vtxt:>10s}  {age}")
            lines.append(_colorize(row, str(a.get("severity", "")),
                                   color))
    else:
        lines.append("no pending or firing alerts")
    return "\n".join(lines)


def watch(endpoint: str, exprs: List[str], range_s: float,
          interval_s: float, iterations: int,
          timeout_s: float = 3.0,
          out: Callable[[str], None] = print) -> int:
    """Poll one endpoint's /debug/query + /alerts and render frames
    until *iterations* run out (0 = forever).  Exit 0 once at least
    one frame rendered real data (a series or an alert payload).

    On a TTY the sparklines stretch to the terminal width and
    page/ticket alert rows go red/yellow; piped output keeps the
    fixed-width, colorless rendering (and NO_COLOR disables color
    even on a TTY, per the convention)."""
    base = endpoint.rstrip("/")
    tty = sys.stdout.isatty()
    width = shutil.get_terminal_size().columns if tty else None
    color = tty and not os.environ.get("NO_COLOR")
    saw_data = False
    i = 0
    while True:
        queries: List[Dict[str, object]] = []
        for expr in exprs:
            url = (f"{base}/debug/query?expr={quote(expr, safe='')}"
                   f"&range={range_s:g}s")
            payload = _fetch_json(url, timeout_s)
            if payload is None:
                payload = {"expr": expr, "series": []}
            if payload.get("series"):
                saw_data = True
            queries.append(payload)
        alerts = _fetch_json(f"{base}/alerts", timeout_s)
        if alerts is not None:
            saw_data = True
        stamp = time.strftime("%H:%M:%S")
        out(f"-- {base} @ {stamp} "
            f"(range {range_s:g}s, every {interval_s:g}s)")
        out(render_watch_frame(queries, alerts, width=width,
                               color=color))
        i += 1
        if iterations and i >= iterations:
            return 0 if saw_data else 1
        time.sleep(interval_s)


# -- incident bundles: offline bundle rendering ----------------------------


def _incident_timeline(bundle: Dict[str, object]) -> List[str]:
    """The alert's transition history, oldest first: when it went
    pending, when it started firing, what the value was each time."""
    lines: List[str] = []
    alert_doc = bundle.get("alert.json")
    trans = alert_doc.get("transitions") \
        if isinstance(alert_doc, dict) else None
    rows = [t for t in trans if isinstance(t, dict)] \
        if isinstance(trans, list) else []
    rows.sort(key=lambda t: _f((t.get("attrs") or {}).get("at"))
              if isinstance(t.get("attrs"), dict) else 0.0)
    for t in rows:
        a = t.get("attrs")
        a = a if isinstance(a, dict) else {}
        value = a.get("value")
        vtxt = f" value={value:.4g}" \
            if isinstance(value, (int, float)) else ""
        lines.append(f"  {_f(a.get('at')):.3f}  "
                     f"{a.get('alert')}: {a.get('state_from')} -> "
                     f"{a.get('state_to')}{vtxt}")
    return lines or ["  (no transitions recorded)"]


def _incident_burn(bundle: Dict[str, object]) -> List[str]:
    """Sparkline every burn-rate series the TSDB snapshot retained —
    the shape of the burn curve is the first thing the page runbook
    asks for."""
    doc = bundle.get("tsdb.json")
    series = doc.get("series") if isinstance(doc, dict) else None
    lines: List[str] = []
    for s in series if isinstance(series, list) else []:
        if not isinstance(s, dict):
            continue
        name = str(s.get("name", ""))
        if "burn_rate" not in name:
            continue
        pts = s.get("points")
        pts = pts if isinstance(pts, list) else []
        values = [p[1] for p in pts
                  if isinstance(p, (list, tuple)) and len(p) == 2
                  and isinstance(p[1], (int, float))]
        labels = s.get("labels")
        labels = labels if isinstance(labels, dict) else {}
        lines.append(f"  {name}{_series_label(labels)}")
        lines.append(f"    {sparkline(values)}")
    return lines or ["  (no burn-rate series in the snapshot)"]


def _incident_stacks(bundle: Dict[str, object],
                     per_phase: int = 5) -> List[str]:
    """Top continuous-profile stacks grouped by scheduler phase:
    where the process actually spent its time in the minutes before
    the page."""
    doc = bundle.get("profile.json")
    stacks = doc.get("stacks") if isinstance(doc, dict) else None
    by_phase: Dict[str, List[dict]] = {}
    for s in stacks if isinstance(stacks, list) else []:
        if isinstance(s, dict):
            by_phase.setdefault(str(s.get("phase", "")), []).append(s)
    lines: List[str] = []
    for phase in sorted(by_phase):
        rows = sorted(by_phase[phase],
                      key=lambda s: -_f(s.get("count")))
        total = sum(_f(s.get("count")) for s in rows)
        lines.append(f"  phase {phase} ({total:g} samples):")
        for s in rows[:per_phase]:
            stack = str(s.get("stack", ""))
            leaf = stack.rsplit(";", 2)[-2:]
            lines.append(f"    {_f(s.get('count')):6g}  "
                         f"{';'.join(leaf)}")
    if isinstance(doc, dict):
        lines.append(f"  ({doc.get('samples')} samples over "
                     f"{doc.get('seconds')}s at {doc.get('hz')}hz, "
                     f"overhead {_f(doc.get('overhead_ratio')):.2%})")
    return lines or ["  (no profile in the bundle)"]


def _incident_misses(bundle: Dict[str, object]) -> List[str]:
    """Stitched span trees of the slowest SLO-missed requests the
    bundle captured — per-miss latency attribution without a live
    endpoint."""
    doc = bundle.get("traces.json")
    misses = doc.get("misses") if isinstance(doc, dict) else None
    lines: List[str] = []
    for m in misses if isinstance(misses, list) else []:
        if not isinstance(m, dict):
            continue
        lines.append(f"  -- {m.get('rid')} "
                     f"class={m.get('slo_class')} "
                     f"outcome={m.get('outcome')} "
                     f"total={_f(m.get('duration_s')) * 1000:.1f}ms "
                     f"trace={str(m.get('trace_id'))[:16]}")
        events = m.get("events")
        if isinstance(events, list) and events:
            tree = obs.stitch([e for e in events
                               if isinstance(e, dict)])
            lines.extend("  " + ln for ln in
                         obs.render_tree(tree).splitlines())
    return lines or ["  (no SLO-missed traces in the bundle)"]


def render_incident(dir_path: str, as_json: bool) -> int:
    """Render one incident bundle directory offline: meta header,
    alert timeline, burn sparkline, top profile stacks by phase, then
    the stitched trees of the slowest SLO-missed requests.  Exit 0 on
    a schema-valid bundle, 2 otherwise."""
    try:
        bundle = obs.read_bundle(dir_path)
    except (OSError, ValueError) as e:
        print(f"obs_query: {e}", file=sys.stderr)
        return 2
    if as_json:
        print(json.dumps(bundle, indent=2, default=str))
        return 0
    meta = bundle["meta"]
    print(f"incident {os.path.basename(dir_path.rstrip(os.sep))}")
    print(f"  alert={meta.get('alert')} "
          f"severity={meta.get('severity')} "
          f"state={meta.get('state_to')} at={_f(meta.get('at')):.3f}")
    value = meta.get("value")
    if isinstance(value, (int, float)):
        print(f"  value at transition: {value:.6g}")
    print(f"  files: {', '.join(meta.get('files', []))}")
    errors = meta.get("errors")
    if isinstance(errors, dict) and errors:
        for rel in sorted(errors):
            print(f"  COLLECT ERROR {rel}: {errors[rel]}")
    desc = meta.get("description")
    if desc:
        print(f"  {desc}")
    print("\nalert timeline:")
    print("\n".join(_incident_timeline(bundle)))
    print("\nerror-budget burn:")
    print("\n".join(_incident_burn(bundle)))
    print("\ntop profile stacks by phase:")
    print("\n".join(_incident_stacks(bundle)))
    print("\nslowest SLO-missed requests:")
    print("\n".join(_incident_misses(bundle)))
    replicas = sorted({rel.split("/", 2)[1] for rel in bundle
                       if rel.startswith("replicas/")
                       and rel.count("/") >= 2})
    if replicas:
        print("\nfleet fragments:")
        for rid in replicas:
            statz = bundle.get(f"replicas/{rid}/statz.json")
            mark = " UNREACHABLE" \
                if isinstance(statz, dict) and statz.get("unreachable") \
                else ""
            print(f"  {rid}{mark}")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="obs-query",
        description="query live /debug endpoints and flight-recorder "
                    "dumps by trace-id or time range")
    p.add_argument("--trace-id", default=None,
                   help="render this trace's stitched span tree")
    p.add_argument("--endpoint", action="append", default=None,
                   metavar="URL",
                   help="live /debug base URL, e.g. "
                        "http://router:8100 (repeatable)")
    p.add_argument("--dump", action="append", default=None,
                   metavar="PATH",
                   help="flight-record dump file, or a directory of "
                        "flight-*.jsonl dumps (repeatable)")
    p.add_argument("--since", type=float, default=0.0,
                   help="only events after this unix timestamp")
    p.add_argument("--until", type=float, default=0.0,
                   help="only events at or before this unix timestamp")
    p.add_argument("--name", default=None,
                   help="only events with this name")
    p.add_argument("--severity", default=None,
                   choices=["page", "ticket", "info"],
                   help="only events carrying this severity tag "
                        "(alert transitions)")
    p.add_argument("--timeout", type=float, default=3.0,
                   help="per-endpoint fetch timeout (seconds)")
    p.add_argument("--json", action="store_true",
                   help="emit JSON instead of the text rendering")
    p.add_argument("--incident", default=None, metavar="DIR",
                   help="render an incident bundle directory "
                        "(written by a firing page alert under "
                        "--incident-dir) instead of querying "
                        "endpoints")
    p.add_argument("--replay-report", default=None, metavar="FILE",
                   help="render the slowest SLO-missed requests of a "
                        "workloads.replay report (tpu-replay-report/"
                        "v1) instead of querying endpoints")
    p.add_argument("--top", type=int, default=5,
                   help="how many SLO-missed requests to render in "
                        "--replay-report mode")
    p.add_argument("--watch", action="store_true",
                   help="live mode: poll ONE --endpoint's "
                        "/debug/query + /alerts and render sparklines "
                        "plus the firing-alert table")
    p.add_argument("--watch-expr", action="append", default=None,
                   metavar="EXPR",
                   help="expression to sparkline in --watch mode "
                        "(repeatable; default: goodput, burn rate, "
                        "queue depth, free KV pages)")
    p.add_argument("--range", type=float, default=300.0,
                   help="--watch query window in seconds")
    p.add_argument("--interval", type=float, default=2.0,
                   help="--watch refresh interval in seconds")
    p.add_argument("--iterations", type=int, default=0,
                   help="--watch frames to render before exiting "
                        "(0 = forever; tests use 1)")
    args = p.parse_args(argv)
    if args.incident:
        return render_incident(args.incident, args.json)
    if args.replay_report:
        return render_replay_report(args.replay_report, args.top,
                                    args.json)
    if args.watch:
        if len(args.endpoint or []) != 1:
            p.error("--watch needs exactly one --endpoint")
        return watch(args.endpoint[0],
                     list(args.watch_expr or WATCH_EXPRS),
                     args.range, args.interval, args.iterations,
                     timeout_s=args.timeout)
    if not args.endpoint and not args.dump:
        p.error("need at least one --endpoint or --dump")
    events = collect(args.trace_id, args.endpoint or [],
                     args.dump or [], args.since, args.until,
                     args.name, args.timeout)
    if args.severity:
        events = [e for e in events
                  if obs.event_severity(e) == args.severity]
    if args.trace_id:
        # source label for the tree: a tagged source (the router's
        # stitcher stamps replica ids) wins; else where we found it
        for ev in events:
            if not ev.get("source"):
                ev["source"] = ev.get("_origin", "")
        tree = obs.stitch(events)
        if args.json:
            print(json.dumps({"trace_id": args.trace_id,
                              "events": len(events), "tree": tree},
                             indent=2))
        else:
            print(f"trace {args.trace_id}: {len(events)} event(s)")
            if events:
                print(obs.render_tree(tree))
        return 0 if events else 1
    if args.json:
        print(json.dumps({"events": events}, indent=2))
        return 0 if events else 1
    t0 = _f(events[0].get("t_wall")) if events else 0.0
    for ev in events:
        dt = _f(ev.get("t_wall")) - t0
        tid = ev.get("trace_id") or "-"
        src = ev.get("source") or ev.get("_origin") or ""
        attrs = ev.get("attrs")
        extra = ""
        if isinstance(attrs, dict) and attrs:
            extra = " " + " ".join(
                f"{k}={v}" for k, v in sorted(attrs.items()))
        # severity tag up front so alert transitions stand out (and
        # grep/sort on the second column just works)
        sev = obs.event_severity(ev)
        sev_tag = f" <{sev}>" if sev else ""
        print(f"+{dt:10.4f}s{sev_tag} [{src}] {ev.get('name')} "
              f"trace={str(tid)[:16]}{extra}")
    return 0 if events else 1


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
