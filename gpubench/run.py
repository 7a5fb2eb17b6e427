"""One run of one benchmark cell.

    python3 -m gpubench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Builds the cell's program from its configuration and mix, warms it up,
measures for ``--seconds``, checks a sample of what the timed path
produced against the plain reference, and prints one JSON line as the
last line of standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the end-to-end metrics, or with ``--trace 1`` the
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each compared number beside its limit (also the last lines
of standard error).  Without CUDA, with fewer cards than the cell asks
for, or with JAX or the JAX package loaded once the window has closed,
it prints no result and exits non-zero.

``--control`` (not for the benchmark's own runs) puts the
lower-precision control in the program's place in the check: the
control's readings are compared with the cell's limits, and the run
must print ``correct`` false.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

from . import spec  # noqa: E402

# top-level module names that must never be loaded: JAX and the JAX
# package (the port's own name starts with the latter's, so names are
# compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_k8s_device_plugin")
# build and kernel caches, at fixed paths inside the checkout
CACHE = spec.ROOT / ".gpubench_cache"


def forbidden_loaded(modules=None) -> List[str]:
    names = {n.split(".")[0] for n in (modules or sys.modules)}
    return sorted(names & set(FORBIDDEN))


def set_env() -> None:
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def _runner(kind: str):
    if kind in ("serve_open", "serve_closed"):
        from . import serve

        return serve
    if kind == "train":
        from . import train

        return train
    raise ValueError(f"unknown mix kind {kind!r}")


def checks_of(record: Dict, limits: Dict, seed: int, cfg: Dict, device,
              control: bool) -> Dict[str, Dict]:
    """Each compared number with its limit (``{"value", "limit",
    "ok"}``); with *control*, the control's numbers in the program's
    place."""
    if record["kind"] == "serve":
        from . import check

        got = check.served_gaps(cfg, seed, record["samples"], device,
                                control=control)
        gap, n = got["logit_gap"], got["tokens"]
        lim_gap = float(limits["logit_gap"]["limit"])
        lim_n = int(limits["checked_tokens"]["limit"])
        return dict(
            logit_gap=dict(value=gap, limit=lim_gap,
                           ok=gap is not None and gap <= lim_gap),
            checked_tokens=dict(value=n, limit=lim_n, ok=n >= lim_n))
    from . import train

    return train.checks(record, limits, seed, cfg, device, control)


def result_line(cell_name: str, bench: Dict, record: Dict,
                checks: Dict[str, Dict], trace: bool, device_info: Dict
                ) -> Dict:
    metrics = {}
    for m in spec.metrics_for(cell_name, bench, trace):
        v = spec.reader(m["name"])(record)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = dict(device_info, memory_peak_bytes=record["memory_peak_bytes"])
    out = dict(correct=all(c["ok"] for c in checks.values()),
               attempted=record["attempted"], failed=record["failed"],
               metrics=metrics, device=dev)
    if trace and record.get("trace"):
        t = record["trace"]
        dev["busy_s"], dev["window_s"] = t["busy_s"], t["window_s"]
        out["breakdown"] = dict(device_ops=t["device_ops"],
                                idle_gaps=t["idle_gaps"])
    out["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                     for k, c in checks.items()}
    return out


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool,
             device, device_info: Dict, control: bool = False,
             bench: Optional[Dict] = None, fault=None) -> Dict:
    """Everything after the look for a card: the run, the check, the
    result line (as a dict)."""
    bench = bench or spec.benchmark()
    cell = spec.cell(cell_name, bench)
    cfg = spec.config(cell["config"], bench)
    mix = spec.mix(cell["traffic"])
    limits = spec.limits(cell_name)
    runner = _runner(mix["kind"])
    record = runner.run(cfg, mix, seed, seconds, trace, device, T_PROCESS,
                        fault=fault)
    bad = forbidden_loaded()
    if bad:
        raise SystemExit(f"loaded after the window: {', '.join(bad)}")
    checks = checks_of(record, limits, seed, cfg, device, control)
    return result_line(cell_name, bench, record, checks, trace, device_info)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gpubench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)
    set_env()
    bench = spec.benchmark()
    cell = spec.cell(args.workload, bench)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"{cell['name']} needs {cell['chips']} cards, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    info = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                count=int(cell["chips"]))
    try:
        out = run_cell(args.workload, args.seed, args.seconds,
                       bool(args.trace), device, info, control=args.control,
                       bench=bench)
    except SystemExit as e:
        print(e, file=sys.stderr)
        return 3
    bad = forbidden_loaded()
    if bad:
        print(f"loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
