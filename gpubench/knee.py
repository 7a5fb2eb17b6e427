"""The highest rate an open-loop serving cell sustains.

    python3 -m gpubench.knee --workload <cell> --seed <n> --seconds <s> --rates 2,3,4,2,3,4

One process builds the cell's engine once; for each rate it sends the
mix's traffic at that rate (the mix's ramp, then ``--seconds``),
samples the backlog (requests due and not yet handed to the scheduler)
at every harvest, and prints one JSON line: the rate, the backlog's
growth over the window (a least-squares slope, requests a second), its
mean in the window's first and last quarters, and what the run's
readers give.  Between rates the traffic stops and the engine drains.
A rate is sustained while the backlog does not grow: a slope under 2%
of the rate in every window at that rate.  The i-th rate listed runs
with the seed ``--seed + i``, so a rate listed twice is read on two
seeds.  The benchmark's own runs never sweep; the knee found
here is pinned in the mix file.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from typing import Dict, List

import torch

from . import readings, serve, spec, traffic, weights
from .trace import Tracer


def _slope(pts: List[tuple]) -> float:
    n = len(pts)
    if n < 2:
        return 0.0
    mt = sum(t for t, _ in pts) / n
    mb = sum(b for _, b in pts) / n
    var = sum((t - mt) ** 2 for t, _ in pts)
    return sum((t - mt) * (b - mb) for t, b in pts) / var if var else 0.0


def one_rate(engine, cfg: Dict, mix: Dict, seed: int, seconds: float,
             rate: float) -> Dict:
    vocab = weights.dims(cfg)["vocab"]
    span = float(mix["ramp_s"]) + seconds + 2.0
    reqs = traffic.generate(mix, vocab, seed, int(math.ceil(rate * span)),
                            rate=rate)
    owner = serve.Owner(engine, int(mix["engine"]["max_len"]), reqs, 0,
                        Tracer())
    serve.attach(engine, owner)
    owner.start(time.perf_counter())
    ramp_end = owner.t_start + float(mix["ramp_s"])
    t0 = owner.run_until(lambda t: t >= ramp_end)
    pts = []

    def sample(t):
        owner._arrive(t)
        pts.append((t, len(owner.backlog)))
        return t >= t0 + seconds

    t1 = owner.run_until(sample)
    run = dict(kind="serve", t0=t0, t1=t1, dims=weights.dims(cfg),
               requests=[q.record() for q in owner.all], steps=owner.steps)
    q = max(1, len(pts) // 4)
    out = dict(
        rate=rate, slope=_slope(pts),
        backlog_first=sum(b for _, b in pts[:q]) / q,
        backlog_last=sum(b for _, b in pts[-q:]) / q,
        output_tokens_per_s=readings.tokens_in_window(run) / (t1 - t0),
        ttft_p90_ms=readings.p(readings.ttfts(run), 90, 1e3),
        itl_p95_ms=readings.p(readings.itls(run), 95, 1e3),
        due=sum(1 for _ in readings.due_in_window(run)))
    out["sustained"] = out["slope"] < 0.02 * rate
    # drain: no more arrivals; finish what is running
    owner.future.clear()
    owner.backlog.clear()
    owner.stopping = True
    while owner.running or owner.sched.busy():
        owner.step()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gpubench.knee")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rates", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    bench = spec.benchmark()
    cell = spec.cell(args.workload, bench)
    cfg = spec.config(cell["config"], bench)
    mix = spec.mix(cell["traffic"])
    device = torch.device("cuda", 0)
    _, engine = serve.build(cfg, mix, args.seed, device)
    rows = []
    for i, r in enumerate(float(x) for x in args.rates.split(",")):
        rows.append(one_rate(engine, cfg, mix, args.seed + i, args.seconds,
                             r))
        print(json.dumps(rows[-1]), flush=True)
    # a rate given more than once (each time with another seed) is
    # sustained only where every window at it was
    rates = sorted({r["rate"] for r in rows})
    ok = [x for x in rates
          if all(r["sustained"] for r in rows if r["rate"] == x)]
    print(json.dumps({"knee": max(ok) if ok else None}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
