"""The harness end to end on the CPU at a tiny size (the look for a
card skipped): the result line, the closed loop, a fault planted in
the timed path, a cell added by files alone, and the import
boundaries."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from gpubench import run, spec
from gpubench.tests.conftest import CPU

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run(cell, **kw):
    import torch

    return run.run_cell(cell, 2**31 + 99, 1.5, False, torch.device("cpu"),
                        CPU, **kw)


def test_result_line_keys_and_checks(tiny_tree):
    out = _run("tiny.tchat")
    keys = list(out)
    assert keys[:5] == RESULT_KEYS and keys[-1] == "checks"
    assert set(keys) == set(RESULT_KEYS) | {"checks"}
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    names = {m["name"] for m in spec.metrics_for(
        "tiny.tchat", spec.benchmark(), False)}
    assert set(out["metrics"]) == names
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(out)


def test_closed_loop_cell(tiny_tree):
    out = _run("tiny.tdoc")
    assert out["correct"] is True
    assert out["metrics"]["output_tokens_per_s"]["value"] > 0


def test_an_altered_token_is_not_correct(tiny_tree):
    from gpubench import faults

    out = _run("tiny.tchat", fault=faults.altered_token(256))
    assert out["correct"] is False
    assert out["checks"]["logit_gap"]["value"] > \
        out["checks"]["logit_gap"]["limit"]


def test_the_control_in_the_programs_place_is_not_correct(tiny_tree):
    import torch

    sound = run.run_cell("tiny.tchat", 7, 1.5, False, torch.device("cpu"),
                         CPU)
    low = run.run_cell("tiny.tchat", 7, 1.5, False, torch.device("cpu"),
                       CPU, control=True)
    assert sound["correct"] is True
    assert low["correct"] is False
    assert low["checks"]["logit_gap"]["value"] > \
        low["checks"]["logit_gap"]["limit"]


def test_a_cell_is_files_and_a_workloads_entry(tiny_tree):
    """A throwaway mix (bursty arrivals) and a throwaway per-layer
    metric, added as new files and one ``workloads`` entry."""
    mix = json.loads((tiny_tree / "mixes" / "tchat.json").read_text())
    mix["traffic"]["arrivals"].update(burst_rate=80.0, p_enter_burst=0.2,
                                      p_exit_burst=0.3)
    (tiny_tree / "mixes" / "tburst.json").write_text(json.dumps(mix))
    (tiny_tree / "cells" / "tiny.tburst.json").write_text(
        (tiny_tree / "cells" / "tiny.tchat.json").read_text())
    (tiny_tree / "metrics" / "done_requests.tburst.py").write_text(
        "def read(run):\n"
        "    return float(sum(q['done'] is not None\n"
        "                     for q in run['requests']))\n")
    bench = json.loads((tiny_tree / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny.tburst", "config": "tiny",
                               "traffic": "tburst", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "done_requests.tburst",
                               "unit": "requests", "better": "higher",
                               "source": "program_counter",
                               "layer": "iteration scheduler",
                               "moves": "output_tokens_per_s",
                               "workloads": ["tiny.tburst"]})
    (tiny_tree / "BENCHMARK.json").write_text(json.dumps(bench))
    out = _run_traceless_per_layer("tiny.tburst")
    assert out["metrics"]["done_requests.tburst"]["value"] > 0


def _run_traceless_per_layer(cell):
    """The per-layer metrics of a run without the profiler (the CPU has
    no device trace): the readers that need none still read."""
    import torch

    bench = spec.benchmark()
    c = spec.cell(cell, bench)
    drv = run._runner(spec.mix(c["traffic"])["kind"])
    record = drv.run(spec.config(c["config"], bench), spec.mix(c["traffic"]),
                     5, 1.5, False, torch.device("cpu"), run.T_PROCESS)
    checks = run.checks_of(record, spec.limits(cell), 5,
                           spec.config(c["config"], bench),
                           torch.device("cpu"), False)
    return run.result_line(cell, bench, record, checks, True, CPU)


def test_no_card_no_result():
    proc = subprocess.run(
        [sys.executable, "-m", "gpubench.run", "--workload",
         "mistral-7b-v0.3.chat", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=spec.ROOT, capture_output=True, text=True,
        timeout=120, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin"})
    assert proc.returncode != 0 and proc.stdout == ""


def test_forbidden_names_compare_whole():
    assert run.forbidden_loaded(["tpu_k8s_device_plugin_torch.workloads",
                                 "jaxtyping", "flaxen"]) == []
    assert run.forbidden_loaded(["jax.numpy", "tpu_k8s_device_plugin.x"]) \
        == ["jax", "tpu_k8s_device_plugin"]


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(
    p for p in spec.HERE.rglob("*.py") if "tests" not in p.parts),
    ids=lambda p: str(p.relative_to(spec.HERE)))
def test_no_module_imports_jax_or_the_jax_package(path):
    bad = set(_imports(path)) & set(run.FORBIDDEN)
    assert not bad
    if "reference" in path.parts:
        assert "tpu_k8s_device_plugin_torch" not in set(_imports(path))


def test_knee_sweep_reads_the_backlog(tiny_tree):
    import torch

    from gpubench import knee, serve

    bench = spec.benchmark()
    cell = spec.cell("tiny.tchat", bench)
    cfg = spec.config(cell["config"], bench)
    mix = spec.mix(cell["traffic"])
    _, engine = serve.build(cfg, mix, 1, torch.device("cpu"))
    slow = knee.one_rate(engine, cfg, mix, 2, 2.0, 6.0)
    fast = knee.one_rate(engine, cfg, mix, 3, 1.0, 2000.0)
    assert slow["sustained"] and slow["due"] >= 1
    assert not fast["sustained"] and fast["backlog_last"] > \
        fast["backlog_first"]
    assert not any(engine.active)
