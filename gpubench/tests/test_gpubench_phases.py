"""``gpubench.phases``: the split of a slice's device time and idle by
the program's ``serve.*`` ranges, on synthetic events and on a tiny
chat run."""

import pytest

from gpubench import phases


def _x(name, cat, ts, dur, tid=1, corr=None):
    e = dict(ph="X", name=name, cat=cat, ts=ts, dur=dur, tid=tid)
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


# one traced slice of 1000 us: the harness's iterate holds an admit
# and a dispatch range, then its owner step runs; kernels are launched
# before the slice, under the admit, by a graph launch under the
# dispatch (two kernels, one correlation) and under the owner
EVENTS = [
    _x("gpubench.traced", "user_annotation", 1000, 1000),
    _x("gpubench.iterate", "user_annotation", 1000, 900),
    _x("serve.admit", "user_annotation", 1090, 110),
    _x("serve.dispatch", "user_annotation", 1300, 50),
    _x("gpubench.owner", "user_annotation", 1900, 50),
    _x("serve.other_thread", "user_annotation", 1000, 1000, tid=2),
    _x("serve.dispatch", "gpu_user_annotation", 1310, 50, tid=7),
    _x("cudaLaunchKernel", "cuda_runtime", 950, 5, corr=3),
    _x("cudaLaunchKernel", "cuda_runtime", 1110, 5, corr=1),
    _x("cudaLaunchKernel", "cuda_runtime", 1115, 5, corr=5),
    _x("cudaGraphLaunch", "cuda_runtime", 1310, 20, corr=2),
    _x("cudaMemcpyAsync", "cuda_runtime", 1910, 5, corr=4),
    _x("k_before", "kernel", 990, 60, tid=7, corr=3),
    _x("k_admit", "kernel", 1150, 100, tid=7, corr=1),
    _x("k_inside", "kernel", 1200, 40, tid=8, corr=5),
    _x("k_replay_a", "kernel", 1320, 80, tid=7, corr=2),
    _x("k_replay_b", "kernel", 1400, 100, tid=7, corr=2),
    _x("copy", "gpu_memcpy", 1920, 10, tid=7, corr=4),
]


def test_split_by_launch_range_and_idle_by_innermost_range():
    s = phases.split(EVENTS)
    assert s["window_s"] == pytest.approx(1000e-6)
    assert s["busy_s"] == pytest.approx(340e-6)
    dev = s["device_by_phase"]
    # a replay's kernels go to the range of their graph launch; a kernel
    # another one already covers adds nothing; launches before the
    # slice or outside every serve.* range are outside
    assert dev == pytest.approx({"serve.admit": 100e-6,
                                 "serve.dispatch": 180e-6,
                                 "outside": 60e-6})
    assert sum(dev.values()) == pytest.approx(s["busy_s"])
    # the device-side projection ends before the replay's kernels
    assert s["device_by_projection"].get("serve.dispatch", 0.0) == 0.0
    assert s["unmatched_ops"] == 0
    # idle by the innermost host range (of the traced thread) over each
    # stretch's middle
    assert s["idle_by_phase"] == pytest.approx({
        "serve.admit": 100e-6, "gpubench.iterate": 490e-6,
        "outside": 70e-6})
    assert sum(s["idle_by_phase"].values()) == pytest.approx(
        s["window_s"] - s["busy_s"])
    assert s["idle_gaps"][0] == ["gpubench.iterate", pytest.approx(420e-6)]
    assert s["host_ranges"]["serve.admit"]["n"] == 1
    assert s["host_ranges"]["serve.admit"]["sum_ms"] == pytest.approx(0.11)
    assert "serve.other_thread" not in s["host_ranges"]


def test_split_needs_the_traced_range():
    with pytest.raises(RuntimeError, match="gpubench.traced"):
        phases.split(EVENTS[1:])


def test_a_tiny_chat_run_is_split_and_the_loop_restored(tiny_tree):
    import torch

    from gpubench import serve, trace
    from tpu_k8s_device_plugin_torch.workloads import scheduler

    before = (serve.attach, serve.Owner.on_admit,
              scheduler.IterationScheduler.iterate, trace.Tracer.stop)
    out = phases.cell("tiny.tchat", 2**31 + 7, 1.5, 0.5,
                      device=torch.device("cpu"))
    assert before == (serve.attach, serve.Owner.on_admit,
                      scheduler.IterationScheduler.iterate, trace.Tracer.stop)
    assert out["slice_s"] == 0.5 and out["device"] == "cpu"
    # no device work on the CPU: the whole slice is idle, by phase
    assert out["busy_s"] == 0.0 and out["device_by_phase"] == {}
    assert sum(out["idle_by_phase"].values()) == pytest.approx(
        out["window_s"])
    assert any(k.startswith("serve.") for k in out["idle_by_phase"])
    assert "serve.dispatch" in out["host_ranges"]
    assert out["first_token_wait_ms"]["n"] > 0
    assert out["iterate_host_ms"]["off"]["n"] > 0
    assert out["iterate_host_ms"]["recording"]["n"] > 0
    assert set(out["phase_ms_per_iterate"]["off"]) == set(scheduler.PHASES)
    assert out["slice_counters"]["prefill_chunk_tokens"] >= 0
    assert len(out["range_cost_us"]["off"]) == 3
