"""alert-smoke: the end-to-end acceptance check for burn-rate alerting,
on the port's server.

A REAL subprocess of the port's server CLI gets a synthetic goodput
collapse (an SLO class whose 1ms completion deadline no request can
meet), and the multi-window multi-burn-rate machinery must prove, from
its own surfaces:

  1. the page alert reaches ``firing`` — and the journal + retained
     burn-rate series show it fired within two evaluation ticks of
     the collapse reaching the burn gauge,
  2. ``/metrics`` stays promlint-clean in BOTH exposition modes with
     the ``tpu_alert_*`` and ``tpu_scrape_*`` families present,
  3. after the collapse stops, the alert traverses to ``resolved``,
  4. the flight-recorder journal carries the full state traversal
     (inactive -> pending -> firing -> resolved) as
     ``tpu_alert_transition`` events.

Windows are shrunk with ``--alert-window-scale`` so the canonical
5m/1h/6h SRE windows run in seconds::

    python -m tpu_k8s_device_plugin_torch.tools.alert_smoke --device cpu

Without ``--device`` the server runs on CUDA, and fails where there is
none.
"""

from __future__ import annotations

import argparse
import sys
import urllib.parse

from ._common import (alert, get, get_json, post_generate, spawn_server,
                      stop, wait_for_state)
from .promlint import lint

ALERT_INTERVAL_S = 0.5
WINDOW_SCALE = 0.0005  # 5m/1h/6h -> 0.15s / 1.8s / 10.8s
PAGE_ALERT = "slo_burn_page_bad"
# class 'bad' can never meet its 1ms deadline: every request misses,
# burn = 1/(1-0.99) = 100x the moment traffic lands on it
SERVER_ARGS = ("--config", "tiny", "--n-slots", "2", "--max-len", "128",
               "--max-new-tokens", "4", "--window", "2",
               "--slo", "bad=0:1", "--slo", "good=0:60000",
               "--slo-window", "3",
               "--alert-interval", str(ALERT_INTERVAL_S),
               "--alert-window-scale", str(WINDOW_SCALE))


def collapse(port: int) -> None:
    """Four guaranteed SLO misses on class 'bad'."""
    for _ in range(4):
        status = post_generate(port, {"tokens": [1, 2, 3],
                                      "slo_class": "bad"})
        assert status == 200, status


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="alert-smoke")
    p.add_argument("--device", default=None,
                   help="the server's torch device (default: cuda)")
    args = p.parse_args(argv)
    proc, port = spawn_server(args.device, SERVER_ARGS, name="alert-smoke")
    try:
        print(f"server up on :{port}")

        # boot state: every derived rule present, all inactive
        status = get_json(port, "/alerts")
        assert alert(status, PAGE_ALERT)["state"] == "inactive"
        assert alert(status, "slo_burn_ticket_bad")["severity"] \
            == "ticket"

        collapse(port)
        print("1. collapse traffic sent (4 guaranteed SLO misses)")

        wait_for_state(port, PAGE_ALERT, "firing", timeout_s=20.0)
        firing = alert(get_json(port, "/alerts"), PAGE_ALERT)
        assert firing["severity"] == "page"
        # the roll-up every statz consumer (the fleet planner) reads
        statz = get_json(port, "/statz")
        assert any(f["name"] == PAGE_ALERT
                   for f in statz["alerts"]["firing"])
        print(f"2. page alert firing (value {firing['value']:.1f})")

        # two-evaluation-tick bound, proven from the server's OWN
        # clock domain: the retained burn series says when the breach
        # first became visible to a tick; the journal says when the
        # rule fired.  No client clock involved.
        expr = urllib.parse.quote(
            'tpu_slo_error_budget_burn_rate{class="bad"}', safe="")
        q = get_json(port, f"/debug/query?expr={expr}&range=60s")
        breach_ts = [t for t, v in q["series"][0]["points"]
                     if v >= 14.4]
        assert breach_ts, f"no breach sample retained: {q}"
        events = get_json(port, "/debug/events")["events"]
        journal = [e for e in events
                   if e["name"] == "tpu_alert_transition"
                   and e["attrs"].get("alert") == PAGE_ALERT]
        fired_at = next(e["attrs"]["at"] for e in journal
                        if e["attrs"]["state_to"] == "firing")
        lag = fired_at - breach_ts[0]
        assert lag <= 2 * ALERT_INTERVAL_S + 0.25, (
            f"firing lagged first visible breach by {lag:.2f}s "
            f"(> 2 ticks of {ALERT_INTERVAL_S}s)")
        print(f"3. fired {lag:.2f}s after first retained breach "
              f"(<= 2 ticks) OK")

        # promlint-clean in both modes, alert + scrape families present
        _, plain = get(port, "/metrics")
        _, om = get(port, "/metrics", headers={
            "Accept": "application/openmetrics-text"})
        for mode, body in (("text", plain), ("openmetrics", om)):
            errs = lint(body)
            assert not errs, f"{mode} fails promlint: {errs[:5]}"
            for fam in ("tpu_alert_state{", "tpu_alert_transitions_total{",
                        "tpu_alert_evaluations_total",
                        "tpu_scrape_duration_seconds_bucket",
                        "tpu_scrape_series{", "tpu_scrape_size_bytes{"):
                assert fam in body, f"{fam} absent from {mode} scrape"
        print("4. both exposition modes promlint-clean with "
              "tpu_alert_*/tpu_scrape_* OK")

        # recovery: the SLO window drains (3s), burn returns to 0, the
        # page windows (0.15s/1.8s) clear, the alert must resolve
        wait_for_state(port, PAGE_ALERT, "resolved", timeout_s=30.0)
        print("5. page alert resolved after recovery")

        # the journal proves the FULL traversal, in order
        events = get_json(port, "/debug/events")["events"]
        path = [(e["attrs"]["state_from"], e["attrs"]["state_to"])
                for e in events
                if e["name"] == "tpu_alert_transition"
                and e["attrs"].get("alert") == PAGE_ALERT]
        assert path[:3] == [("inactive", "pending"),
                            ("pending", "firing"),
                            ("firing", "resolved")], path
        assert all(e["attrs"]["severity"] == "page" for e in events
                   if e["name"] == "tpu_alert_transition"
                   and e["attrs"].get("alert") == PAGE_ALERT)
        print(f"6. journal traversal OK ({path})")
        print("alert-smoke: PASS")
        return 0
    finally:
        stop(proc)


if __name__ == "__main__":
    sys.exit(main())
