"""incident-smoke: end-to-end acceptance check for incident bundles, on
the port's server.

The alert-smoke scenario (a REAL subprocess of the port's server CLI,
an SLO class whose 1ms deadline no request can meet, shrunken
burn-rate windows) extended through the flight data recorder: when the
page fires, the server must write exactly ONE schema-complete incident
bundle to ``--incident-dir``, with no human in the loop —

  1. the page alert reaches ``firing`` and exactly one
     ``incident-<alert>-*`` directory materializes (atomically: no
     ``.incident-tmp-*`` litter, meta.json present),
  2. the bundle is self-contained: alert transition history, full
     flight-recorder journal, TSDB snapshot with the burn-rate series,
     a continuous-profile slice, and stitched spans for at least one
     SLO-missed request,
  3. the profile proves the recorder was ALREADY running when the
     incident started: at least one profile sample is timestamped
     before the firing transition,
  4. the port's ``obs_query --incident DIR`` renders the bundle offline
     and exits 0.

::

    python -m tpu_k8s_device_plugin_torch.tools.incident_smoke --device cpu

Without ``--device`` the server runs on CUDA, and fails where there is
none.
"""
# tpulint: disable-file=R1 -- smoke DRIVER: single-shot requests against a subprocess it just started; a failure IS the test failing, retries would only blur which layer lost the bundle

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
import time

from .. import obs
from ._common import get_json, spawn_env, spawn_server, stop, wait_for_state
from .alert_smoke import PAGE_ALERT, SERVER_ARGS, collapse


def _wait_for_bundle(incident_dir, timeout_s):
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        bundles = [p for p in os.listdir(incident_dir)
                   if p.startswith(obs.BUNDLE_PREFIX)]
        if bundles:
            return bundles
        time.sleep(0.1)
    raise AssertionError(
        f"no incident bundle materialized in {incident_dir} "
        f"({os.listdir(incident_dir)})")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="incident-smoke")
    p.add_argument("--device", default=None,
                   help="the server's torch device (default: cuda)")
    args = p.parse_args(argv)
    incident_dir = tempfile.mkdtemp(prefix="tpu-incident-smoke-")
    proc, port = spawn_server(
        args.device, SERVER_ARGS + ("--incident-dir", incident_dir),
        name="incident-smoke")
    try:
        print(f"server up on :{port}, incident dir {incident_dir}")

        # the continuous profiler is live BEFORE any trouble: its
        # /debug/pprof surface already serves the schema
        prof = get_json(port, "/debug/pprof?format=json")
        assert prof["schema"] == "tpu-profile/v1", prof["schema"]

        collapse(port)
        print("1. collapse traffic sent (4 guaranteed SLO misses)")

        wait_for_state(port, PAGE_ALERT, "firing", timeout_s=20.0)
        print("2. page alert firing")

        # exactly ONE bundle, atomically placed (no tmp litter, and
        # read_bundle validates meta.json + schema below)
        bundles = _wait_for_bundle(incident_dir, timeout_s=15.0)
        assert len(bundles) == 1, bundles
        assert not [p for p in os.listdir(incident_dir)
                    if p.startswith(".incident-tmp-")]
        bundle_dir = os.path.join(incident_dir, bundles[0])
        bundle = obs.read_bundle(bundle_dir)
        meta = bundle["meta"]
        assert meta["alert"] == PAGE_ALERT
        assert meta["severity"] == "page"
        assert meta["errors"] == {}, meta["errors"]
        for rel in ("alert.json", "journal.jsonl", "tsdb.json",
                    "profile.folded", "profile.json", "statz.json",
                    "traces.json"):
            assert rel in meta["files"], (rel, meta["files"])
        print(f"3. one schema-complete bundle: {bundles[0]}")

        # the bundle carries the firing transition in its own history
        firing = [t for t in bundle["alert.json"]["transitions"]
                  if t["attrs"].get("alert") == PAGE_ALERT
                  and t["attrs"].get("state_to") == "firing"]
        assert firing, bundle["alert.json"]["transitions"]
        fired_at = firing[0]["attrs"]["at"]

        # TSDB snapshot retained the burn series that paged
        burn = [s for s in bundle["tsdb.json"]["series"]
                if "burn_rate" in s["name"] and s["points"]]
        assert burn, [s["name"] for s in bundle["tsdb.json"]["series"]]

        # the flight data recorder was already running: at least one
        # profile sample predates the firing transition
        prof = bundle["profile.json"]
        assert prof["samples"] > 0, prof
        early = [sec for sec, n in prof["timeline"]
                 if n > 0 and sec < fired_at]
        assert early, (prof["timeline"], fired_at)
        print(f"4. profile has samples from {fired_at - early[0]:.1f}s "
              f"before the firing transition")

        # stitched spans for at least one SLO-missed request
        misses = bundle["traces.json"]["misses"]
        assert misses and misses[0]["events"], misses
        tree = obs.stitch(misses[0]["events"])
        assert tree, misses[0]
        print(f"5. {len(misses)} SLO-missed trace(s) with spans")

        # offline render: the on-call's first command must just work
        rc = subprocess.call(
            [sys.executable, "-m", __package__ + ".obs_query",
             "--incident", bundle_dir], env=spawn_env())
        assert rc == 0, f"obs_query --incident exited {rc}"
        print("6. obs_query --incident rendered the bundle, exit 0")
        print("incident-smoke: PASS")
        return 0
    finally:
        stop(proc)
        shutil.rmtree(incident_dir, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
