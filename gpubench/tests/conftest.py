"""A tiny copy of the benchmark's tree (configuration, mixes, limits,
metric readers, BENCHMARK.json) for CPU runs of the harness."""

import json
import shutil

import pytest
import torch

from gpubench import spec

TINY = {"source": "test", "hidden_size": 128, "intermediate_size": 352,
        "num_hidden_layers": 2, "num_attention_heads": 8,
        "num_key_value_heads": 2, "rms_norm_eps": 1e-6,
        "rope_theta": 10000.0, "vocab_size": 256, "reduced": []}


def _tiny_mixes():
    chat = spec.mix("chat")
    tr = chat["traffic"]
    tr.update(prefix_len=64, n_prefixes=4, block=8)
    tr["prompt"].update(median=24, min=4, max=64)
    tr["output"].update(median=8, min=2, max=16)
    tr["arrivals"]["rate"] = 20.0
    chat["engine"] = {"n_slots": 4, "max_len": 256, "kv_paging": True,
                      "kv_page_size": 32}
    chat["ramp_s"] = 0.5
    chat["check"] = {"requests": 4, "tokens": 30}
    doc = spec.mix("longdoc")
    tr = doc["traffic"]
    tr.update(callers=4, pool=400, block=4)
    tr["prompt"].update(median=64, min=32, max=128)
    tr["output"].update(median=8, min=2, max=16)
    doc["engine"] = dict(chat["engine"])
    doc["check"] = {"requests": 2, "tokens": 20}
    train = spec.mix("train-8k")
    train["train"].update(seq=64, batch=2)
    return {"tchat": chat, "tdoc": doc, "ttrain": train}


@pytest.fixture
def tiny_tree(tmp_path, monkeypatch):
    """The benchmark's files for two tiny cells, ``tiny.tchat`` and
    ``tiny.tdoc``, under *tmp_path*, which ``spec`` then reads."""
    for d in ("configs", "mixes", "cells"):
        (tmp_path / d).mkdir()
    shutil.copytree(spec.HERE / "metrics", tmp_path / "metrics")
    (tmp_path / "configs" / "tiny.json").write_text(json.dumps(TINY))
    for name, m in _tiny_mixes().items():
        (tmp_path / "mixes" / f"{name}.json").write_text(json.dumps(m))
        (tmp_path / "cells" / f"tiny.{name}.json").write_text(json.dumps(
            LIMITS[m["kind"] == "train"]))
    bench = spec.benchmark()
    traffic_of = {w["name"]: w["traffic"] for w in bench["workloads"]}
    cells = ["tiny.tchat", "tiny.tdoc", "tiny.ttrain"]
    bench["configs"] = [{"name": "tiny", "source": "test",
                         "file": "configs/tiny.json", "reduced": [],
                         "why": "test"}]
    bench["workloads"] = [{"name": c, "config": "tiny",
                           "traffic": c.split(".")[1], "chips": 1,
                           "why": "test"} for c in cells]
    # each metric in the tiny cells of the same traffic as its own
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = sorted({TINY_CELL[traffic_of[w]]
                                     for w in m["workloads"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(spec, "HERE", tmp_path)
    monkeypatch.setattr(spec, "ROOT", tmp_path)
    torch.set_num_threads(2)
    return tmp_path


CPU = dict(platform="cpu", kind="cpu", count=1)
# the tiny cell that stands for the cells of each traffic mix
TINY_CELL = {"chat": "tiny.tchat", "longdoc": "tiny.tdoc",
             "train-8k": "tiny.ttrain"}
# the tiny cells' limits, between the readings of sound runs and of the
# float8 control on this CPU at three seeds: serving logit_gap 0-0.0092
# against 0.036-0.132 (tiny.tchat); training loss_gap 3.2e-5-1.5e-4
# against 9.4e-4-1.4e-3, grad_gap 4.6e-4-6.5e-4 against 4.9e-3-8.7e-3;
# the control's update_gap (1.4e-3-3.2e-3) is no three times the sound
# runs' (3.5e-4-5.9e-4), so that limit is set against the faults
LIMITS = {False: {"logit_gap": {"limit": 0.015},
                  "checked_tokens": {"limit": 10}},
          True: {"loss_gap": {"limit": 4e-4}, "grad_gap": {"limit": 2e-3},
                 "update_gap": {"limit": 0.1}}}
