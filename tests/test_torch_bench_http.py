"""``bench_serving``'s HTTP modes at a tiny size on the CPU: the
``--http`` load test drives a live in-process ``EngineServer`` (every
request completes, abandoned ones counted, the burst's 200/429 mix, a
promlint-clean scrape in both exposition modes, nonzero goodput), its
A/B arms (``--prefill-heavy``, ``--decode-heavy``, ``--no-interleave``)
report their figures, and the modes that spawn replicas exit naming
their ROADMAP item."""

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


def test_bench_replica_modes_not_yet_ported(capsys):
    from tpu_k8s_device_plugin_torch.workloads import bench_serving

    for flag in (["--router", "2"], ["--disagg"], ["--cold-start"]):
        with pytest.raises(SystemExit):
            bench_serving.main(["--config", "tiny", "--device", "cpu",
                                "--http", "2", *flag])
        assert "item 5.2" in capsys.readouterr().err
