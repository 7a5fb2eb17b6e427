"""What the port's acceptance drivers share: the port's server CLI as a
subprocess, and single-shot reads of its HTTP surfaces."""
# tpulint: disable-file=R1 -- DRIVER helpers: single-shot requests against a subprocess the driver just started; a failure IS the check failing, and a retry would only blur which layer broke

from __future__ import annotations

import json
import os
import subprocess
import time
import urllib.request
from typing import Dict, Optional, Sequence, Tuple

from ..workloads import loadclient

# the directory that holds the port's package: first on the spawned
# processes' PYTHONPATH, so ``-m`` finds the port from any directory
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def spawn_env() -> Dict[str, str]:
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


def spawn_server(device: Optional[str], args: Sequence[str],
                 name: str = "smoke", port: Optional[int] = None,
                 boot_s: float = 600.0
                 ) -> Tuple["subprocess.Popen[bytes]", int]:
    """Start the port's server CLI with *args* on *device* (none: CUDA,
    and the server raises where there is none), listening on 127.0.0.1
    at *port* (a free one when none), and wait for ``/healthz``.  A
    server that exits first raises with its exit code."""
    port = loadclient.free_port() if port is None else port
    cmd = loadclient.server_cmd(device, *args, "--host", "127.0.0.1",
                                "--port", str(port))
    proc = loadclient.spawn_replica(cmd, name, env=spawn_env())
    try:
        loadclient.wait_http_ok(port, "/healthz", boot_s, procs=[proc])
    except BaseException:
        stop(proc)
        raise
    return proc, port


def stop(proc: "subprocess.Popen[bytes]") -> None:
    """SIGKILL *proc* if it still runs, and reap it."""
    if proc.poll() is None:
        proc.kill()
    try:
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        pass


def get(port: int, path: str, headers: Optional[Dict[str, str]] = None
        ) -> Tuple[Dict[str, str], str]:
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 headers=headers or {})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return dict(resp.headers), resp.read().decode()


def get_json(port: int, path: str) -> dict:
    return json.loads(get(port, path)[1])


def post_generate(port: int, body: dict) -> int:
    """One ``POST /generate``, read whole; returns the status."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        resp.read()
        return resp.status


def alert(status: dict, name: str) -> dict:
    for a in status["alerts"]:
        if a["name"] == name:
            return a
    raise AssertionError(f"{name} missing from /alerts: "
                         f"{[a['name'] for a in status['alerts']]}")


def wait_for_state(port: int, name: str, want: str,
                   timeout_s: float) -> None:
    deadline = time.time() + timeout_s
    state = None
    while time.time() < deadline:
        state = alert(get_json(port, "/alerts"), name)["state"]
        if state == want:
            return
        time.sleep(0.1)
    raise AssertionError(
        f"{name} never reached {want!r} (last state {state!r})")
