"""``bench_serving``'s HTTP modes at a tiny size on the CPU: the
``--http`` load test drives a live in-process ``EngineServer`` (every
request completes, abandoned ones counted, the burst's 200/429 mix, a
promlint-clean scrape in both exposition modes, nonzero goodput), its
A/B arms (``--prefill-heavy``, ``--decode-heavy``, ``--no-interleave``)
report their figures, and the modes that spawn replicas of the port's
server CLI on the CPU (``--router 2`` with its kill, ``--disagg``,
``--cold-start``) report the reference's keys under its exit codes and
argument checks."""

import pytest

from tools.promlint import lint


def _bench(capsys, *flags):
    from tpu_k8s_device_plugin_torch.workloads import bench_serving

    rc = bench_serving.main(["--config", "tiny", "--device", "cpu",
                             "--prompt-len", "8", "--steps", "4",
                             "--max-len", "32", "--batch", "2", *flags])
    lines = capsys.readouterr().out.splitlines()
    stats = dict(line.split(": ", 1) for line in lines if ": " in line
                 and not line.startswith(("slow-trace", "OK", "FAIL")))
    return rc, stats, lines


def test_bench_http_load_test(capsys, tmp_path):
    """``--http`` drives a live in-process server: every request
    completes, the burst phase reports its 200/429 mix, and the scrape
    written for promlint is clean in both exposition modes."""
    out = str(tmp_path / "m.prom")
    rc, stats, lines = _bench(capsys, "--http", "2", "--requests", "6",
                              "--burst", "6", "--cancel-every", "3",
                              "--metrics-out", out, "--assert-goodput")
    assert rc == 0, lines
    assert float(stats["requests_completed"]) == 4.0
    assert float(stats["requests_abandoned"]) == 2.0
    assert float(stats["tokens_per_sec_http"]) > 0
    assert float(stats["burst_ok"]) + float(stats["burst_429"]) == 6.0
    assert stats["device"] == "cpu"
    for path in (out, out + ".om"):
        with open(path) as f:
            assert lint(f.read()) == []


@pytest.mark.parametrize("mode,key", [
    ("--prefill-heavy", "prefill_tokens_per_sec_on"),
    ("--decode-heavy", "tokens_per_sec_http_on"),
    ("--no-interleave", "tokens_per_sec_http")])
def test_bench_http_arms(capsys, mode, key):
    # four distinct prompts: the warm-up admits two, so the timed
    # phase prefills (the A/B arms' prefill figure counts its tokens)
    rc, stats, lines = _bench(capsys, "--http", "2", "--requests", "4",
                              mode)
    assert rc == 0, lines
    assert float(stats[key]) > 0


# the reference's report keys of each replica mode, and its flags
REPLICA_MODES = {
    "router": (["--http", "2", "--requests", "4", "--router", "2",
                "--router-kill"],
               {"router", "replicas", "tokens_per_sec_router_1",
                "requests_completed_1", "tokens_per_sec_router_n",
                "requests_completed_n", "scaling_x", "scaling_efficiency",
                "share_replica-0", "share_replica-1", "affinity_hit_rate",
                "fleet_statz_replicas", "fleet_statz_healthy",
                "fleet_capacity", "fleet_goodput_rps", "kill_requests",
                "kill_ok", "kill_429", "kill_errors", "kill_recovery_s",
                "failovers_total", "config", "quantized"}),
    "disagg": (["--http", "2", "--requests", "4", "--disagg",
                "--max-len", "128"],
               {"disagg", "long_prompt_len", "short_prompt_len",
                "requests_ok_homog", "wall_s_homog",
                "long_unary_p99_ms_homog", "decode_ttft_p99_ms_homog",
                "decode_tpot_p99_ms_homog", "requests_ok_disagg",
                "wall_s_disagg", "long_unary_p99_ms_disagg",
                "decode_ttft_p99_ms_disagg", "decode_tpot_p99_ms_disagg",
                "migrations_ok", "migrate_mean_ms", "ttft_p99_ratio",
                "tpot_p99_ratio", "config", "quantized"}),
    "cold-start": (["--cold-start"],
                   {"cold_start", "config", "quantized",
                    "compile_cache_dir", "cold_ready_s",
                    "cold_first_completion_s", "warm_ready_s",
                    "warm_first_completion_s", "warm_speedup_x",
                    "warm_faster"}),
}


@pytest.mark.parametrize("mode", sorted(REPLICA_MODES))
def test_bench_replica_modes(capsys, monkeypatch, tmp_path, mode):
    """Each replica mode spawns port replica CLIs with ``--device cpu``
    and prints the reference's keys: the router's two phases and the
    kill with no non-429 error, the disagg pair with a migration, the
    two boots of the cold start (whose exit code is ``warm_faster``'s,
    as in the reference: the port has no cache, so either may win)."""
    from tpu_k8s_device_plugin_torch.workloads import loadclient

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv(loadclient.REPLICA_LOG_DIR_ENV, str(tmp_path))
    flags, keys = REPLICA_MODES[mode]
    rc, stats, lines = _bench(capsys, *flags)
    assert keys <= set(stats), (keys - set(stats), lines)
    # every replica booted and said so in the log its spawn helper kept
    logs = list(tmp_path.glob("*.log"))
    assert len(logs) == (2 if mode == "cold-start" else
                         4 if mode == "disagg" else 2), logs
    assert all("serving tiny" in p.read_text() for p in logs)
    if mode == "router":
        assert rc == 0, lines
        assert float(stats["kill_errors"]) == 0.0
        assert float(stats["fleet_statz_replicas"]) == 2.0
        assert float(stats["tokens_per_sec_router_n"]) > 0
    elif mode == "disagg":
        assert rc == 0, lines
        assert float(stats["migrations_ok"]) >= 1
    else:
        warm_faster = float(stats["warm_faster"])
        assert rc == (0 if warm_faster else 1), lines
        assert ("OK: warm start" if warm_faster else "FAIL: warm start") \
            in "\n".join(lines)


@pytest.mark.parametrize("flags,message", [
    (["--router", "2"], "only apply with --http"),
    (["--disagg"], "only apply with --http"),
    (["--http", "2", "--router-kill"], "need --router"),
    (["--http", "2", "--assert-disagg"], "needs --disagg"),
    (["--compile-cache-dir", "x"], "only applies with --cold-start"),
    (["--cold-start", "--http", "2"], "mutually exclusive"),
    (["--http", "2", "--router", "2", "--burst", "2"], "its own mode"),
    (["--http", "2", "--disagg", "--router", "2"], "its own mode"),
    (["--http", "2", "--router", "2", "--requests", "3"], "too small"),
])
def test_bench_replica_mode_argument_checks(capsys, flags, message):
    """The reference's argument checks: each misuse exits 2 with its
    message before any replica is spawned."""
    from tpu_k8s_device_plugin_torch.workloads import bench_serving

    with pytest.raises(SystemExit) as e:
        bench_serving.main(["--config", "tiny", "--device", "cpu", *flags])
    assert e.value.code == 2
    assert message in capsys.readouterr().err
