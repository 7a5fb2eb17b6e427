"""The training runner at a tiny size on the CPU: a sound run is
correct, and the faults a training cell can have are not."""

import torch

from gpubench import faults, run, train
from gpubench.tests.conftest import CPU


def _run(**kw):
    return run.run_cell("tiny.ttrain", 2**31 + 5, 1.0, False,
                        torch.device("cpu"), CPU, **kw)


def test_sound_run_is_correct(tiny_tree):
    out = _run()
    assert out["correct"] is True, out["checks"]
    assert out["metrics"]["train_step_ms"]["value"] > 0


def test_a_step_that_leaves_the_state_unchanged_is_not_correct(tiny_tree):
    out = _run(fault=faults.frozen)
    assert out["correct"] is False
    assert out["checks"]["update_gap"]["value"] == 1.0


def test_half_the_batch_left_out_is_not_correct(tiny_tree):
    out = _run(fault=faults.half_batch)
    assert out["correct"] is False


def test_half_the_tokens_left_out_is_not_correct(tiny_tree, monkeypatch):
    # a batch of one sequence: the second half of its labels left out
    import json

    p = tiny_tree / "mixes" / "ttrain.json"
    mix = json.loads(p.read_text())
    mix["train"]["batch"] = 1
    p.write_text(json.dumps(mix))
    out = _run(fault=faults.half_batch)
    assert out["correct"] is False


def test_the_control_in_the_programs_place_is_not_correct(tiny_tree):
    out = _run(control=True)
    assert out["correct"] is False
    c = out["checks"]
    assert c["loss_gap"]["value"] > c["loss_gap"]["limit"]
    assert c["grad_gap"]["value"] > c["grad_gap"]["limit"]


def test_gaps_by_the_worst_leaf():
    ref = {"losses": [2.0, 2.0, 2.0],
           "g1": {"a": 1.0, "b": 1.0, "c": 1e-9},
           "dp": {"a": 0.5, "b": 0.5, "c": 0.5}}
    prog = {"losses": [2.0, 2.002, 2.0],
            "g1": {"a": 1.01, "b": 1.0, "c": 0.5},
            "dp": {"a": 0.5, "b": 0.55, "c": 0.0}}
    g = train.gaps(prog, ref)
    # the first step's loss is compared, the later ones only read
    assert g["loss_gap"] == 0.0 and abs(max(g["loss_gaps"]) - 1e-3) < 1e-12
    # leaf c's gradient is measured against the median leaf's norm
    assert abs(g["grad_gap"] - 0.5) < 1e-6
    # and its change is left out: its gradient is round-off
    assert abs(g["update_gap"] - 0.1) < 1e-6
