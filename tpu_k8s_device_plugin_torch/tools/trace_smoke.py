"""trace-smoke: the end-to-end acceptance check for request tracing, on
the port's server.

One trace-id issued at the serving front door must be observable in
every layer that tracing wires:

  1. the response headers (X-Trace-Id / traceparent echo),
  2. the span breadcrumbs in /debug/traces (admission, queue wait,
     windows, stream writes, terminal request span),
  3. an OpenMetrics exemplar on the serve histograms,
  4. the plain-text /metrics staying exemplar-free AND promlint-clean,
  5. the flight-record dump written when the server gets SIGTERM.

The server is a REAL subprocess of the port's server CLI (the tiny
config, random weights from seed 0), so the SIGTERM path is the
production path, not a test double::

    python -m tpu_k8s_device_plugin_torch.tools.trace_smoke --device cpu

Without ``--device`` the server runs on CUDA, and fails where there is
none.
"""
# tpulint: disable-file=R1 -- smoke DRIVER: single-shot requests against a subprocess it just started; a failure IS the test failing, retries would only blur which layer dropped the trace

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import sys
import tempfile
import urllib.request

from .. import obs
from ._common import get, spawn_server, stop
from .promlint import lint

SERVER_ARGS = ("--config", "tiny", "--n-slots", "2", "--max-len", "128",
               "--max-new-tokens", "4", "--window", "2")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="trace-smoke")
    p.add_argument("--device", default=None,
                   help="the server's torch device (default: cuda)")
    args = p.parse_args(argv)
    dump_dir = tempfile.mkdtemp(prefix="trace-smoke-")
    proc, port = spawn_server(
        args.device, SERVER_ARGS + ("--flight-record-dir", dump_dir),
        name="trace-smoke")
    try:
        print(f"server up on :{port}")

        root = obs.new_trace()
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/generate",
            data=json.dumps({"tokens": [1, 2, 3]}).encode(),
            headers={"Content-Type": "application/json",
                     "traceparent": root.to_traceparent()})
        with urllib.request.urlopen(req, timeout=120) as resp:
            assert resp.headers["X-Trace-Id"] == root.trace_id, \
                "response header does not echo the trace id"
            resp.read()
        print(f"1. header echo OK ({root.trace_id})")

        _, body = get(port, f"/debug/traces?trace_id={root.trace_id}")
        names = {e["name"] for e in json.loads(body)["events"]}
        for want in ("tpu_serve_queue_wait", "tpu_serve_admit",
                     "tpu_serve_ttft", "tpu_serve_window",
                     "tpu_serve_stream_write", "tpu_serve_request"):
            assert want in names, f"missing {want} in {sorted(names)}"
        print(f"2. /debug/traces spans OK ({sorted(names)})")

        headers, om = get(
            port, "/metrics",
            headers={"Accept": "application/openmetrics-text"})
        assert "openmetrics" in headers["Content-Type"]
        assert f'trace_id="{root.trace_id}"' in om, \
            "trace id absent from OpenMetrics exemplars"
        errs = lint(om)
        assert not errs, f"OpenMetrics body fails promlint: {errs[:5]}"
        print("3. OpenMetrics exemplar OK")

        headers, plain = get(port, "/metrics")
        assert headers["Content-Type"].startswith("text/plain")
        assert "# {" not in plain, \
            "exemplar leaked into the plain-text exposition"
        errs = lint(plain)
        assert not errs, f"plain /metrics fails promlint: {errs[:5]}"
        print("4. plain exposition exemplar-free + promlint-clean OK")

        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=30)
        dumps = [p for p in os.listdir(dump_dir)
                 if p.startswith("flight-") and p.endswith(".jsonl")]
        assert dumps, f"no flight-record dump in {dump_dir}"
        with open(os.path.join(dump_dir, dumps[0]),
                  encoding="utf-8") as f:
            lines = [json.loads(line) for line in f]
        assert lines[0].get("flight_record") is True
        assert any(rec.get("trace_id") == root.trace_id
                   for rec in lines[1:]), \
            "trace id absent from the SIGTERM flight-record dump"
        print(f"5. SIGTERM dump OK ({dumps[0]}, "
              f"{lines[0]['events']} events)")
        print("trace-smoke: PASS")
        return 0
    finally:
        stop(proc)
        shutil.rmtree(dump_dir, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
