"""The port's multi-device dry run (``tpu_k8s_device_plugin_torch.dryrun``,
the counterpart of the repo root's ``__graft_entry__.dryrun_multichip``)
on 4 gloo ranks on the CPU, as its CLI starts them, and at world size 1
in this process: its one line names every check of the reference's
line, with the mesh shapes 4 and 1 ranks give."""

import os
import subprocess
import sys

import pytest

import torch_gloo_ranks
from tpu_k8s_device_plugin_torch import dryrun

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the checks the reference's line names, in its order
CHECKS = ("dryrun_multichip OK: mesh=", "ring attention over",
          "OK (einsum+flash impls, flash fwd+bwd)", "LM dp+ep+sp+tp over",
          "pipeline over", "TP serving engine over model=",
          "exact vs single-device OK",
          "TP serving feature surface (APC hit, sampled+penalties+min_p, "
          "stop, logprobs, run_scan) OK", "TP spec-decode exact vs greedy",
          "TP multi-LoRA (fresh-adapter no-op + mixed batch) OK",
          "TP int4 exact vs single-device OK",
          "TP engine spec-decode rounds exact vs greedy OK",
          "TP grammar-constrained scan + jump_round stay in-grammar OK")


def _in_order(line):
    at = 0
    for check in CHECKS:
        at = line.index(check, at)
    return True


def test_dryrun_on_four_gloo_ranks():
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "tpu_k8s_device_plugin_torch.dryrun",
         "--ranks", "4", "--device", "cpu"], env=env, capture_output=True,
        text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = [ln for ln in out.stdout.splitlines()
             if ln.startswith("dryrun_multichip")]
    assert len(lines) == 1, out.stdout
    line = lines[0]
    assert _in_order(line)
    assert "mesh={'data': 2, 'model': 2}" in line
    assert ("LM dp+ep+sp+tp over {'data': 1, 'expert': 1, 'seq': 2, "
            "'model': 2}") in line
    assert "pipeline over {'data': 1, 'pipe': 4} (8 blocks, 4 stages)" in line
    assert "model=2 exact vs single-device OK (steps eager" in line


def test_dryrun_at_world_size_one():
    with torch_gloo_ranks.solo_group():
        line = dryrun.dryrun_multichip(1, "cpu")
    assert _in_order(line)
    assert "ring attention over 1 ranks" in line
    assert "model=1 exact vs single-device OK (steps eager" in line


def test_dryrun_needs_a_group_of_its_size():
    with pytest.raises(RuntimeError, match="initialised"):
        dryrun.dryrun_multichip(1, "cpu")
    with torch_gloo_ranks.solo_group():
        with pytest.raises(ValueError, match="need 2 ranks"):
            dryrun.dryrun_multichip(2, "cpu")


def test_dryrun_cli_without_launcher_wants_cpu(monkeypatch, capsys):
    for key in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(SystemExit) as exc:
        dryrun.main(["--ranks", "2"])
    assert exc.value.code == 2
    assert "--device cpu" in capsys.readouterr().err
