"""The port's chaos soak over its node agents (episodes 1-4, 7 and 8 and
the final sweep), held to the reference's soak.

One module-scoped 2-host slice of the port's plugin managers on copies
of ``testdata/nvidia/h100-sxm-8`` runs the agent episodes in the soak's
order, one test each.  Then the reference's ``tools/chaos_soak.py
--skip-serving`` and the port's run whole, in this process, with the
same seed: the ``InjectedFault`` counts by operation and kind must be
equal, and so must the sets of the journaled breaker and watchdog events
by (name, operation, transition).  Two runs of the reference with one
seed can differ in how many probes hang and trip the watchdog (three
runs on an idle host gave 6 each; under the full suite's load one gave
8): that count follows how many pulses the peer needs to see the
demotion, so ``probe:hang`` is held to firing at all and the events are
compared as sets.  Last, the soak's CLI under ``--skip-serving`` passes
and loads no torch."""

import os
import subprocess
import sys

import pytest

from tpu_k8s_device_plugin import obs as ref_obs
from tpu_k8s_device_plugin.manager import manager as ref_manager
from tpu_k8s_device_plugin.resilience import faults as ref_faults
from tpu_k8s_device_plugin_torch import obs
from tpu_k8s_device_plugin_torch.manager import manager as port_manager
from tpu_k8s_device_plugin_torch.resilience import faults
from tpu_k8s_device_plugin_torch.tools import chaos_soak as cs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTDATA = os.path.join(ROOT, "testdata")
SEED = 1


@pytest.fixture(scope="module")
def soak():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_manager, "_REGISTER_RETRY_DELAY_S", 0.05)
        s = cs.Soak(SEED, TESTDATA).form()
        try:
            yield s
        finally:
            s.close()


@pytest.mark.parametrize("episode", cs.AGENT_EPISODES)
def test_agent_episode(soak, episode):
    soak.run(episode)


def test_final_sweep(soak):
    soak.final_sweep()


def _journaled(faults_mod, obs_mod, main, argv, monkeypatch):
    """Run a soak's ``main(argv)`` in this process; returns (the fired
    fault counts by ``op:kind`` over every injector it installed, the
    set of (event, op, transition) of the breaker and watchdog events its
    flight recorders journaled)."""
    injectors, recorders = [], []
    real_install = faults_mod.install

    def install(*a, **kw):
        inj = real_install(*a, **kw)
        injectors.append(inj)
        return inj

    class Recorder(obs_mod.FlightRecorder):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            recorders.append(self)

    monkeypatch.setattr(faults_mod, "install", install)
    monkeypatch.setattr(obs_mod, "FlightRecorder", Recorder)
    assert main(argv) == 0
    fired = {}
    for inj in injectors:
        for key, n in inj.fired.items():
            fired[key] = fired.get(key, 0) + n
    events = {(e["name"], e["attrs"].get("op"), e["attrs"].get("to"))
              for r in recorders for e in r.events()
              if e["name"] in ("tpu_breaker_transition",
                               "tpu_watchdog_trip")}
    return fired, events


def test_fault_counts_and_journal_match_the_reference(monkeypatch):
    from tools import chaos_soak as ref_soak

    monkeypatch.setattr(ref_manager, "_REGISTER_RETRY_DELAY_S",
                        ref_manager._REGISTER_RETRY_DELAY_S)
    monkeypatch.setattr(port_manager, "_REGISTER_RETRY_DELAY_S",
                        port_manager._REGISTER_RETRY_DELAY_S)
    argv = ["--seed", str(SEED), "--skip-serving"]
    theirs = _journaled(ref_faults, ref_obs, ref_soak.main,
                        argv + ["--testdata", TESTDATA], monkeypatch)
    ours = _journaled(faults, obs, cs.main,
                      argv + ["--testdata", TESTDATA], monkeypatch)
    hung = "probe:hang"
    assert ours[0].pop(hung) >= 1 and theirs[0].pop(hung) >= 1
    assert ours[0] == theirs[0]
    assert set(ours[0]) == {"kubelet.register:drop", "slice.join:error",
                            "slice.heartbeat:error"}
    assert ours[1] == theirs[1]
    assert ("tpu_watchdog_trip", "probe", None) in ours[1]
    assert ("tpu_breaker_transition", "slice.heartbeat", "open") in ours[1]


def test_cli_skip_serving_passes_without_torch():
    code = ("import sys\n"
            "from tpu_k8s_device_plugin_torch.tools import chaos_soak\n"
            "rc = chaos_soak.main(['--seed', '2', '--skip-serving'])\n"
            "print(rc, sorted(m for m in sys.modules\n"
            "                 if m.split('.')[0] == 'torch'))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "0 []"
    assert "CHAOS SOAK PASS (seed=2)" in out.stderr


def test_serving_needs_a_device(monkeypatch):
    """Without ``--skip-serving`` and without CUDA, the soak refuses
    before any episode rather than serve on the CPU by itself."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cs.main(["--seed", "1"])
