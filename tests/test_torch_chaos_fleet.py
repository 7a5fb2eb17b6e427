"""The port's chaos soak over routers, replicas of its server CLI and
fleets (episodes 10 and 12-17) on the CPU.  Each episode spawns the
port's server CLI with ``--device cpu``; the replicas' threads are held
to one (``OMP_NUM_THREADS=1``), as two torch replicas on a few cores
otherwise spin each other's boots.

Episodes 13 and 14 are ``slow``: their goodput floors depend on the
host's speed and load.  Episode 13 (a trace replayed through a replica
kill) passes alone in about 10 s and read an interactive attainment of
0.1351 against its 0.5 floor in the full suite's run with six workers.
Episode 14 (a degraded-slice drain under load): its ramp's
peak (28 requests at 8 a second, 100 output tokens at the median) asks
more of one CPU replica of the tiny model (3.3-3.7 ms a decode step at 2
slots) than it serves within the interactive TTFT target before the
scale-out replica boots (4 s), so its goodput floor of 0.5 held in about
half of this host's runs (0.37-0.54); the reference's episode 14 fails on
the same host, its replicas booting for 27 s."""

import pytest

from tpu_k8s_device_plugin_torch.tools import chaos_soak as cs

SEED = 1


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


@pytest.mark.parametrize("episode", [
    10, 12,
    pytest.param(13, marks=pytest.mark.slow),
    pytest.param(14, marks=pytest.mark.slow),
    15, 16, 17])
def test_fleet_episode(tmp_path, episode):
    {10: lambda: cs.episode_router_replica_kill(SEED, "cpu"),
     12: lambda: cs.episode_prefill_kill_mid_migration(SEED, "cpu"),
     13: lambda: cs.episode_trace_replay_kill(SEED, "cpu"),
     14: lambda: cs.episode_fleet_degraded_drain(str(tmp_path), SEED,
                                                 "cpu"),
     15: lambda: cs.episode_fleet_burn_alert(str(tmp_path), SEED, "cpu"),
     16: lambda: cs.episode_fleet_incident_bundle(SEED, "cpu"),
     17: lambda: cs.episode_session_spill_crash_resume(SEED, "cpu"),
     }[episode]()
