"""The port's three observability smokes, each a subprocess that drives
a subprocess of the port's server CLI (``--device cpu``) through one
contract: tracing (five checks), burn-rate alerting (the page fires
within two ticks, both exposition modes lint clean, it resolves, the
journal holds the traversal) and incident bundles (exactly one,
self-contained, profiled before the firing, rendered by ``obs_query
--incident``)."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKS = {
    "trace_smoke": ["1. header echo OK", "2. /debug/traces spans OK",
                    "3. OpenMetrics exemplar OK",
                    "4. plain exposition exemplar-free + promlint-clean OK",
                    "5. SIGTERM dump OK"],
    "alert_smoke": ["1. collapse traffic sent", "2. page alert firing",
                    "(<= 2 ticks) OK", "4. both exposition modes "
                    "promlint-clean", "5. page alert resolved",
                    "6. journal traversal OK"],
    "incident_smoke": ["2. page alert firing",
                       "3. one schema-complete bundle",
                       "before the firing transition",
                       "SLO-missed trace(s) with spans",
                       "6. obs_query --incident rendered the bundle"],
}


@pytest.mark.parametrize("smoke", sorted(CHECKS))
def test_smoke_passes_on_cpu(smoke):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", f"tpu_k8s_device_plugin_torch.tools.{smoke}",
         "--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    for line in CHECKS[smoke]:
        assert line in out.stdout, (line, out.stdout[-3000:])
    assert out.stdout.rstrip().endswith(
        f"{smoke.replace('_', '-')}: PASS")


def test_smoke_without_a_device_fails():
    """No ``--device``: the server CLI needs CUDA, and where there is
    none the smoke fails; it never serves on the CPU by itself."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "tpu_k8s_device_plugin_torch.tools.trace_smoke"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "PASS" not in out.stdout
