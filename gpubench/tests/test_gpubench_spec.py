"""BENCHMARK.json against its required shape, and every piece it
names found by name."""

import json
import re

import pytest

from gpubench import spec, weights

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert len(BENCH["command"]) <= 32
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_lines():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group in ("end_to_end", "per_layer"), e["name"]))
            for k in ("why", "layer", "source"):
                if k in e and group != "end_to_end" and group != "per_layer":
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])


def test_metric_keys_sources_and_bounds():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        # every cell it lists reports what it moves
        moved = next(e for e in BENCH["end_to_end"]
                     if e["name"] == m["moves"])
        for c in m.get("workloads", CELLS):
            assert c in CELLS
            assert c in moved.get("workloads", CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_setup_another_metric_and_a_layer(cell):
    e2e = [m["name"] for m in spec.metrics_for(cell, BENCH, False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.metrics_for(cell, BENCH, True)


@pytest.mark.parametrize("cell", CELLS)
def test_every_piece_is_found_by_name(cell):
    w = spec.cell(cell, BENCH)
    cfg = spec.config(w["config"], BENCH)
    mix = spec.mix(w["traffic"])
    assert mix["kind"] in ("serve_open", "serve_closed", "train")
    lim = spec.limits(cell)
    assert all("limit" in v for v in lim.values())
    entry = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    assert cfg["reduced"] == entry["reduced"]
    assert cfg["source"] == entry["source"]
    assert (spec.ROOT / entry["file"]).is_file()
    assert weights.n_params(cfg) > 0
    for trace in (False, True):
        for m in spec.metrics_for(cell, BENCH, trace):
            assert callable(spec.reader(m["name"]))


def test_every_configuration_is_used_and_files_are_named_by_names():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for p in spec.HERE.rglob("*"):
        rel = p.relative_to(spec.ROOT).as_posix()
        if "__pycache__" not in rel:
            assert PATH.match(rel), rel
