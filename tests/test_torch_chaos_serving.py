"""The port's chaos soak over one in-process ``EngineServer`` (episodes
5, 6, 9 and 11) on the CPU, with the soak's tiny decoder: a crashed and
a hung scheduler are restarted by the supervisor and answer 200 again, a
tenant burst under KV page pressure lands through preemption, a kill in
a packed prefill ends every request whole.  The restarting episodes
also run three restarts on one server with the card phase's probe
(``chip_smoke.RestartProbe``): after each restart the control request's
ids equal the baseline's."""

import os
import sys

import pytest
import torch

from tpu_k8s_device_plugin_torch.tools import chaos_soak as cs
from tpu_k8s_device_plugin_torch.workloads import inference

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

SEED = 1


@pytest.fixture(scope="module")
def model():
    return cs.tiny_model("cpu", 64)


@pytest.mark.parametrize("episode", [5, 6, 9, 11])
def test_serving_episode(model, episode):
    run = {5: cs.episode_scheduler_crash, 6: cs.episode_scheduler_hang,
           9: cs.episode_tenant_burst_page_pressure,
           11: cs.episode_packed_prefill_kill}[episode]
    run(SEED, "cpu", model)


@pytest.mark.parametrize("episode", [5, 6])
def test_three_restarts_answer_the_baseline(model, episode):
    probe = chip_smoke.RestartProbe(torch, False, inference.CAPTURE_LOCK)
    run = {5: cs.episode_scheduler_crash, 6: cs.episode_scheduler_hang}
    run[episode](SEED, "cpu", model, rounds=3, probe=probe)
    stages = [r["stage"] for r in probe.rows]
    assert stages == ["before", "restart 1", "restart 2", "restart 3"]
    assert all(r["ids_equal"] for r in probe.rows[1:])
    assert all(r["restart_ms"] >= 0 and r["recover_ms"] > 0
               for r in probe.rows[1:])


def test_serving_episodes_refuse_without_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cs.episode_scheduler_crash(SEED)
