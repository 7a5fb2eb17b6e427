"""The port's elastic AlexNet loop (``bench_main.run_elastic``, the
``--checkpoint-dir`` CLI) and ``ReshapeSignal``, on the CPU, against the
JAX package's.

Both packages' loops run at batch 2 with AlexNet cut to 64 px and 10
classes (their ``create_train_state`` and ``synthetic_batch`` patched;
the card runs the full size), under the same membership events, written
in the reference's format: a first run, a reshape, a dissolved slice and
a reshape with ``checkpoint_every=0``.  They must leave the same step
dirs, return the same codes (0, 77) and print the same lines (the loss
value masked).  The port's resumed state equals an uninterrupted run's
bit for bit."""

import functools
import os
import re

import pytest
import torch

import torch_gloo_ranks
from tpu_k8s_device_plugin.slice.state import Membership, save_membership
from tpu_k8s_device_plugin_torch.workloads import alexnet as talex
from tpu_k8s_device_plugin_torch.workloads import bench_main
from tpu_k8s_device_plugin_torch.workloads import checkpoint as tckpt
from tpu_k8s_device_plugin_torch.types import constants

SMALL = dict(image_size=64, num_classes=10)


@pytest.fixture
def small_port(monkeypatch):
    monkeypatch.setattr(bench_main, "create_train_state", functools.partial(
        talex.create_train_state, **SMALL))
    monkeypatch.setattr(bench_main, "synthetic_batch", functools.partial(
        talex.synthetic_batch, **SMALL))


@pytest.fixture
def small_reference(monkeypatch):
    from tpu_k8s_device_plugin.workloads import alexnet as jalex

    # the reference's run_elastic imports these at call time
    monkeypatch.setattr(jalex, "create_train_state", functools.partial(
        jalex.create_train_state, **SMALL))
    monkeypatch.setattr(jalex, "synthetic_batch", functools.partial(
        jalex.synthetic_batch, **SMALL))


def _membership(path, generation, workers, degraded=False):
    hosts = tuple(f"host-{i}" for i in range(workers))
    save_membership(str(path), Membership(
        slice_id=f"slice-{generation}", generation=generation,
        hostnames=hosts, coordinator_address=f"{hosts[0]}:8476",
        degraded=degraded))


def _masked(text):
    return [re.sub(r"(final loss after \d+ steps: )\S+", r"\1<loss>", line)
            for line in text.splitlines() if line]


def _scenario(run_elastic, list_steps, tmp, monkeypatch, capsys, **kw):
    """The membership events, one run_elastic call each: (return code,
    step dirs, printed lines) per call."""
    state = tmp / "membership.json"
    ckpt = str(tmp / "ckpt")
    out = []

    def run(steps, every):
        rc = run_elastic(batch=2, steps=steps, checkpoint_dir=ckpt,
                         checkpoint_every=every, slice_state=str(state),
                         **kw)
        out.append((rc, list_steps(ckpt), _masked(capsys.readouterr().out)))

    capsys.readouterr()
    monkeypatch.setenv(constants.ENV_TPU_SLICE_GENERATION, "1")
    _membership(state, 1, 2)
    run(4, 2)                       # fresh: saves 2, then the final 4
    _membership(state, 2, 1, degraded=True)
    run(8, 2)                       # resumes 4, reshapes after step 5
    monkeypatch.setenv(constants.ENV_TPU_SLICE_GENERATION, "2")
    os.remove(state)
    run(7, 0)                       # dissolved: not a reshape; final 7
    _membership(state, 3, 2)
    run(10, 0)                      # reshape after step 8, every=0
    return out


EXPECTED = [
    (0, [2, 4], ["final loss after 4 steps: <loss>"]),
    (77, [2, 4, 5], [
        "resumed from checkpoint step 4",
        "slice reshaped to gen 2 (1 worker(s), degraded); checkpointed "
        "step 5; exiting 77 for restart under the new identity"]),
    (0, [4, 5, 7], ["resumed from checkpoint step 5",
                    "final loss after 7 steps: <loss>"]),
    (77, [5, 7, 8], [
        "resumed from checkpoint step 7",
        "slice reshaped to gen 3 (2 worker(s)); checkpointed step 8; "
        "exiting 77 for restart under the new identity"]),
]


def test_run_elastic_resumes_reshapes_and_saves(small_port, tmp_path,
                                                monkeypatch, capsys):
    """Resume line, a reshape returning 77 after the step that saw it
    and leaving that step's dir, a dissolved slice that is not a
    reshape, and ``checkpoint_every=0`` saving only at the reshape and
    at the end (no step_6 is ever written)."""
    got = _scenario(bench_main.run_elastic, tckpt.list_steps, tmp_path,
                    monkeypatch, capsys, device="cpu")
    assert got == EXPECTED


def test_run_elastic_matches_reference(small_port, small_reference,
                                       tmp_path, monkeypatch, capsys):
    """The same step dirs, return codes and printed lines as the
    reference's run_elastic under the same events."""
    from tpu_k8s_device_plugin.workloads import bench_main as jbench
    from tpu_k8s_device_plugin.workloads import checkpoint as jckpt

    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    want = _scenario(jbench.run_elastic, jckpt.list_steps,
                     tmp_path / "ref", monkeypatch, capsys)
    got = _scenario(bench_main.run_elastic, tckpt.list_steps,
                    tmp_path / "port", monkeypatch, capsys, device="cpu")
    assert got == want == EXPECTED


def test_resumed_state_equals_uninterrupted(small_port, tmp_path,
                                            monkeypatch, capsys):
    """The state the interrupted runs leave at step 8 (a save, a reshape
    restart, a resume) is the uninterrupted 8-step run's, parameters
    and momentum, bit for bit."""
    _scenario(bench_main.run_elastic, tckpt.list_steps, tmp_path,
              monkeypatch, capsys, device="cpu")
    solo = str(tmp_path / "solo")
    assert bench_main.run_elastic(
        2, 8, solo, 0, str(tmp_path / "none.json"), device="cpu") == 0
    assert tckpt.list_steps(solo) == [8]
    got = tckpt.restore_checkpoint(str(tmp_path / "ckpt"), step=8)
    want = tckpt.restore_checkpoint(solo, step=8)
    for part in ("params", "opt_state"):
        keys = [k for k, _ in tckpt._leaves(want[part])]
        assert keys == [k for k, _ in tckpt._leaves(got[part])]
        for (k, w), (_, g) in zip(tckpt._leaves(want[part]),
                                  tckpt._leaves(got[part])):
            if isinstance(w, torch.Tensor):
                assert torch.equal(g, w), k
            else:
                assert g == w, k


def test_bench_main_cli_routes_to_run_elastic(small_port, tmp_path,
                                              monkeypatch, capsys):
    """``--checkpoint-dir`` runs the elastic loop and returns its code:
    77 on a reshape, after saving the step that saw it."""
    state = tmp_path / "membership.json"
    monkeypatch.setenv(constants.ENV_TPU_SLICE_GENERATION, "1")
    _membership(state, 2, 1)
    ckpt = str(tmp_path / "ckpt")
    rc = bench_main.main(["--device", "cpu", "--batch", "2", "--steps", "3",
                          "--checkpoint-dir", ckpt, "--checkpoint-every",
                          "1", "--slice-state", str(state)])
    assert rc == tckpt.RESHAPE_EXIT_CODE
    assert tckpt.list_steps(ckpt) == [1]
    assert _masked(capsys.readouterr().out) == [
        "slice reshaped to gen 2 (1 worker(s)); checkpointed step 1; "
        "exiting 77 for restart under the new identity"]
    # sharded (item 6.1), on a gloo group of this process alone: the
    # unsharded step_1 restores onto the (1, 1) mesh, the next step sees
    # the reshape, saves and returns 77
    with torch_gloo_ranks.solo_group():
        rc = bench_main.run_elastic(2, 2, ckpt, 0, str(state), sharded=True,
                                    device="cpu")
    assert rc == tckpt.RESHAPE_EXIT_CODE
    assert tckpt.list_steps(ckpt) == [1, 2]
    assert _masked(capsys.readouterr().out) == [
        "resumed from checkpoint step 1",
        "slice reshaped to gen 2 (1 worker(s)); checkpointed step 2; "
        "exiting 77 for restart under the new identity"]


def _signal_case(case, ReshapeSignal, membership_cls, tmp_path,
                 monkeypatch):
    """One ReshapeSignal case; returns what check() gave at each beat."""
    state = tmp_path / "membership.json"
    monkeypatch.delenv(constants.ENV_TPU_SLICE_GENERATION, raising=False)
    seen = []

    def beat(sig):
        m = sig.check()
        seen.append((None if m is None else m.generation, sig.triggered))

    if case == "env_baseline":
        # the env generation is the baseline even when the file moved on
        _membership(state, 3, 2)
        monkeypatch.setenv(constants.ENV_TPU_SLICE_GENERATION, "2")
        sig = ReshapeSignal(str(state))
        assert sig.baseline == 2
        beat(sig)
        _membership(state, 2, 2)    # back at the baseline: still fired
        beat(sig)
    elif case == "explicit_generation":
        monkeypatch.setenv(constants.ENV_TPU_SLICE_GENERATION, "5")
        _membership(state, 1, 2)
        sig = ReshapeSignal(str(state), generation=1)
        assert sig.baseline == 1
        beat(sig)
        _membership(state, 2, 1, degraded=True)
        beat(sig)
    elif case == "fire":
        sig = ReshapeSignal(str(state), generation=0)
        beat(sig)                   # no file, no baseline: nothing
        sig.fire(None, membership_cls(
            slice_id="s", generation=4, hostnames=("a",),
            coordinator_address="a:1"))
        beat(sig)
    elif case == "file_baseline":
        _membership(state, 4, 2)
        sig = ReshapeSignal(str(state))
        assert sig.baseline == 4
        beat(sig)
        os.remove(state)            # dissolved: not a reshape
        beat(sig)
        _membership(state, 5, 1)
        beat(sig)
        fresh = ReshapeSignal(str(tmp_path / "none.json"))
        assert fresh.baseline == 0  # no file, no env: never fires
        _membership(tmp_path / "none.json", 6, 1)
        beat(fresh)
    return seen


SIGNAL_CASES = {
    "env_baseline": [(3, True), (3, True)],
    "explicit_generation": [(None, False), (2, True)],
    "fire": [(None, False), (4, True)],
    "file_baseline": [(None, False), (None, False), (5, True),
                      (None, False)],
}


@pytest.mark.parametrize("package", ["port", "reference"])
@pytest.mark.parametrize("case", sorted(SIGNAL_CASES))
def test_reshape_signal(case, package, tmp_path, monkeypatch):
    """The reference's ReshapeSignal cases, on each package's class: the
    env baseline, an explicit generation, ``fire``, the file baseline
    (and a dissolved slice)."""
    if package == "port":
        from tpu_k8s_device_plugin_torch.slice.state import Membership as m
        cls = tckpt.ReshapeSignal
    else:
        from tpu_k8s_device_plugin.workloads.checkpoint import (
            ReshapeSignal as cls)
        m = Membership
    assert _signal_case(case, cls, m, tmp_path, monkeypatch) == \
        SIGNAL_CASES[case]
