"""Finding a cell's pieces by name.

``BENCHMARK.json`` (the checkout's root) lists the cells; a cell names a
configuration (``configs/<config>.json``) and a traffic mix
(``mixes/<traffic>.json``); its correctness limits are
``cells/<cell>.json``; each metric is read by ``metrics/<metric>.py``,
whose ``read(run)`` returns a number or None.  A new cell is new files
and a ``workloads`` entry: nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict:
    return _json(ROOT / "BENCHMARK.json")


def cell(name: str, bench: Dict) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                   f"({', '.join(w['name'] for w in bench['workloads'])})")


def config(name: str, bench: Optional[Dict] = None) -> Dict:
    """The configuration file of *name*: ``BENCHMARK.json``'s ``file``
    where the benchmark lists it, else ``configs/<name>.json``."""
    for c in (bench or {}).get("configs", []):
        if c["name"] == name:
            return _json(ROOT / c["file"])
    return _json(HERE / "configs" / f"{name}.json")


def mix(name: str) -> Dict:
    return _json(HERE / "mixes" / f"{name}.json")


def limits(name: str) -> Dict:
    return _json(HERE / "cells" / f"{name}.json")


def metrics_for(cell_name: str, bench: Dict, trace: bool) -> List[Dict]:
    """The metrics a run of *cell_name* reports: the end-to-end ones
    without ``--trace``, the per-layer ones with it; a metric with a
    ``workloads`` list only in those cells."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if "workloads" not in m or cell_name in m["workloads"]]


def reader(metric: str) -> Callable:
    """``read`` of ``metrics/<metric>.py`` (a metric's name may hold
    dots, so the file is loaded by path)."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "gpubench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
