"""The port is clean under the repository's project-invariant linter,
``tools.tpulint``, in strict mode (unused pragmas are findings too), the
acceptance drivers of ``tpu_k8s_device_plugin_torch/tools`` included:
every network and subprocess boundary goes through the resilience layer
or a fault hook, no broad except swallows silently, no lock is held
across a blocking call, and every pragma that excuses a site says why."""

import os

import pytest

from tools.tpulint import lint_paths, render_human

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "tpu_k8s_device_plugin_torch")


def test_port_is_clean_in_strict_mode():
    findings = lint_paths([PORT], strict=True, root=ROOT)
    assert not findings, render_human(findings)


@pytest.mark.parametrize("module", [
    "build.py", "hostinfo/gpuprobe.py", "workloads/tp_driver.py",
    "workloads/server.py"])
def test_repaired_sites_carry_no_pragma_for_their_rule(module):
    """The boundaries and excepts these modules had outside the
    resilience layer were repaired in the code: a fault hook, a log
    line, the suppressed counter.  The one pragma is build.py's C2 (one
    build at a time is the design), so no file-wide pragma hides a new
    boundary here."""
    text = open(os.path.join(PORT, module)).read()
    assert "disable-file" not in text
    assert "disable=R1" not in text and "disable=R2" not in text


def test_drivers_are_linted():
    """The default target set of the CLI misses the port; the gate above
    names it, and so reaches the drivers' own files."""
    tools = os.path.join(PORT, "tools")
    names = sorted(f for f in os.listdir(tools) if f.endswith(".py"))
    assert {"chaos_soak.py", "trace_smoke.py", "alert_smoke.py",
            "incident_smoke.py", "obs_query.py", "promlint.py",
            "fake_kubelet.py"} <= set(names)
    assert not lint_paths([tools], strict=True, root=ROOT)
