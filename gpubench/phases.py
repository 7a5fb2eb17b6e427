"""Where a serving cell's device time and idle fall, by the program's
``serve.*`` ranges: an analysis beside the benchmark, not part of its
result line.

    python3 -m gpubench.phases --workload <cell> --seed <n> --seconds <s> [--slice <s>]

It runs the cell's serving loop as ``gpubench.run`` does with
``--trace 1`` (``serve.run``: build, ramp, a window of ``--seconds``,
then a traced slice of ``--slice`` seconds, the mix's own
``trace_slice_s`` by default), with no reference check, and prints one
JSON object.  The run record holds neither the scheduler's tickets nor
the engine's counters, so a few of the loop's calls are wrapped for the
run to keep them: each ticket's ``t_splice`` and ``t_done``, each decode
window's steps, each ``iterate``'s host seconds and phase sums, and the
engine's counters at the slice's ends.

``split`` reduces the slice's chrome trace:

* ``device_by_phase``: each device operation's time, the part not
  already covered by an earlier one (so the phases sum to ``busy_s``),
  under the ``serve.*`` range around its launch, found by the
  operation's correlation id (a CUDA graph replay's kernels all carry
  their ``cudaGraphLaunch``'s); launched before the slice or outside
  every ``serve.*`` range: ``outside``;
* ``device_by_projection``: the same by the device-side projection of
  the ``serve.*`` ranges at the operation's middle (graph replays fall
  outside it where the projection ends at the launch's return);
* ``idle_by_phase``: every stretch of the slice with no device
  operation, by the innermost ``serve.*`` or ``gpubench.*`` host range
  over its middle (``outside`` where none), summing to ``window_s -
  busy_s``; ``idle_gaps``, the longest twelve;
* ``host_ranges``: each ``serve.*`` range's count and host
  milliseconds inside the slice.

From these and the wrapped calls: ``decode_ms_per_step`` (device time
under ``serve.dispatch`` over the steps of the windows dispatched in
the slice), ``prefill_ms_per_ktok`` (under ``serve.admit`` and
``serve.splice`` over the engine's ``prefill_chunk_tokens`` in the
slice), ``first_token_wait_ms`` (``t_done - t_splice`` over the
admissions whose first token came in the window, untraced),
``device_idle_sched`` (idle under ``serve.*`` over the slice, in %),
``iterate_host_ms`` and ``phase_ms_per_iterate`` with the profiler off
(the window) and recording (the slice), and ``range_cost_us``, one
``obs.ranges.device_range`` off and recording.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import statistics
import sys
import tempfile
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class _Cover:
    """The innermost of a thread's nested ranges at an instant."""

    def __init__(self, ranges: List[Tuple[float, float, str]]):
        seg: List[Tuple[float, float, str]] = []
        stack: List[Tuple[float, float, str]] = []
        t: Optional[float] = None

        def emit(upto: float) -> None:
            nonlocal t
            if stack and t is not None and upto > t:
                seg.append((t, upto, stack[-1][2]))
            t = upto if t is None else max(t, upto)

        for a, b, n in sorted(ranges, key=lambda r: (r[0], -r[1])):
            while stack and stack[-1][1] <= a:
                emit(stack[-1][1])
                stack.pop()
            emit(a)
            stack.append((a, b, n))
        while stack:
            emit(stack[-1][1])
            stack.pop()
        self.seg = seg
        self.starts = [s[0] for s in seg]

    def at(self, t: float) -> str:
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and self.seg[i][0] <= t < self.seg[i][1]:
            return self.seg[i][2]
        return "outside"


def _add(d: Dict[str, float], k: str, v: float) -> None:
    d[k] = d.get(k, 0.0) + v


def split(events: List[Dict]) -> Dict:
    """The slice's device time and idle by phase (module docstring),
    from a chrome trace's ``traceEvents``; times in seconds."""
    xs = [e for e in events if e.get("ph") == "X"]
    ann = [e for e in xs if e.get("cat") == "user_annotation"]
    traced = [e for e in ann if e["name"] == "gpubench.traced"]
    if not traced:
        raise RuntimeError("the trace holds no gpubench.traced range")
    lo, hi = traced[0]["ts"], traced[0]["ts"] + traced[0]["dur"]
    host = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in ann
            if e["tid"] == traced[0]["tid"] and e["name"] != "gpubench.traced"
            and e["name"].startswith(("serve.", "gpubench."))]
    serve = [r for r in host if r[2].startswith("serve.")]
    cover_all, cover_serve = _Cover(host), _Cover(serve)
    cover_proj = _Cover([(e["ts"], e["ts"] + e["dur"], e["name"])
                         for e in xs if e.get("cat") == "gpu_user_annotation"
                         and e["name"].startswith("serve.")])
    launch = {e["args"]["correlation"]: e["ts"] for e in xs
              if e.get("cat") in LAUNCH_CATS
              and "correlation" in e.get("args", {})}
    by_phase: Dict[str, float] = {}
    by_proj: Dict[str, float] = {}
    union: List[Tuple[float, float]] = []
    unmatched = 0
    cur = lo
    for e in sorted((e for e in xs if e.get("cat") in DEVICE_CATS),
                    key=lambda e: e["ts"]):
        a = max(e["ts"], lo, cur)
        b = min(e["ts"] + e["dur"], hi)
        if b <= a:
            continue
        t = launch.get(e.get("args", {}).get("correlation"))
        unmatched += t is None
        label = cover_serve.at(t) if t is not None and t >= lo else "outside"
        _add(by_phase, label, (b - a) * 1e-6)
        _add(by_proj, cover_proj.at(0.5 * (a + b)), (b - a) * 1e-6)
        if union and a <= union[-1][1]:
            union[-1] = (union[-1][0], b)
        else:
            union.append((a, b))
        cur = b
    idle: Dict[str, float] = {}
    gaps = []
    edges = [lo] + [x for ab in union for x in ab] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            label = cover_all.at(0.5 * (a + b))
            _add(idle, label, (b - a) * 1e-6)
            gaps.append([label, (b - a) * 1e-6])
    gaps.sort(key=lambda g: -g[1])
    ms: Dict[str, List[float]] = {}
    for a, b, n in serve:
        if a >= lo and b <= hi:
            ms.setdefault(n, []).append((b - a) * 1e-3)
    return dict(
        window_s=(hi - lo) * 1e-6,
        busy_s=sum(b - a for a, b in union) * 1e-6,
        device_by_phase=by_phase, device_by_projection=by_proj,
        unmatched_ops=unmatched, idle_by_phase=idle, idle_gaps=gaps[:12],
        host_ranges={n: dict(n=len(v), sum_ms=sum(v),
                             p50_ms=statistics.median(v), max_ms=max(v))
                     for n, v in ms.items()})


def range_cost_us(n: int = 20000) -> Dict[str, List[float]]:
    """Host microseconds of one ``device_range`` with no profiler
    recording, and recording (CPU and, on a card, CUDA activity)."""
    import torch
    from torch import profiler as tprof

    from tpu_k8s_device_plugin_torch.obs.ranges import device_range

    def loop() -> float:
        t = time.perf_counter()
        for _ in range(n):
            with device_range("serve.cost"):
                pass
        return (time.perf_counter() - t) / n * 1e6

    acts = [tprof.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(tprof.ProfilerActivity.CUDA)
    off = [loop() for _ in range(3)]
    with tprof.profile(activities=acts):
        on = [loop() for _ in range(3)]
    return dict(off=off, recording=on)


@contextmanager
def _kept(path: str):
    """Wrap the serving loop's calls so that the run keeps what the
    record lacks (module docstring); every wrap is undone on exit."""
    from tpu_k8s_device_plugin_torch.workloads import scheduler

    from . import serve, trace

    kept: Dict = dict(tickets=[], iters=[], windows=[])
    real = (serve.attach, serve.Owner.on_admit, scheduler.IterationScheduler
            .iterate, trace.Tracer.start, trace.Tracer.stop)
    r_attach, r_admit, r_iterate, r_start, r_stop = real

    def attach(engine, owner):
        sched = r_attach(engine, owner)
        kept["engine"] = engine
        r_dispatch = engine.scan_dispatch

        def scan_dispatch(n):
            kept["windows"].append((time.perf_counter(), n))
            return r_dispatch(n)

        engine.scan_dispatch = scan_dispatch
        return sched

    def on_admit(self, ticket):
        r_admit(self, ticket)
        kept["tickets"].append((ticket.t_splice, ticket.t_done))

    def iterate(self):
        from torch.autograd import profiler

        t = time.perf_counter()
        res = r_iterate(self)
        kept["iters"].append((t, time.perf_counter() - t,
                              bool(profiler._is_profiler_enabled),
                              dict(self._phase_acc)))
        return res

    def counters() -> Dict[str, int]:
        eng = kept["engine"]
        return dict(eng.stats(), prefill_chunk_tokens=eng.prefill_chunk_tokens)

    def start(self):
        kept["ts0"], kept["c0"] = time.perf_counter(), counters()
        r_start(self)

    def stop(self):
        prof = self._prof
        r_stop(self)
        kept["ts1"], kept["c1"] = time.perf_counter(), counters()
        prof.export_chrome_trace(path)

    serve.attach, serve.Owner.on_admit = attach, on_admit
    scheduler.IterationScheduler.iterate = iterate
    trace.Tracer.start, trace.Tracer.stop = start, stop
    try:
        yield kept
    finally:
        (serve.attach, serve.Owner.on_admit,
         scheduler.IterationScheduler.iterate, trace.Tracer.start,
         trace.Tracer.stop) = real


def _per_iterate(iters: List[Tuple]) -> Optional[Dict[str, float]]:
    """Host ms an ``iterate`` by phase, between the first and last."""
    if len(iters) < 2:
        return None
    a, b = iters[0][3], iters[-1][3]
    return {k: 1e3 * (b[k] - a[k]) / (len(iters) - 1) for k in b}


def _ms(xs: List[float]) -> Optional[Dict[str, float]]:
    if not xs:
        return None
    return dict(n=len(xs), p50=1e3 * statistics.median(xs),
                mean=1e3 * statistics.fmean(xs))


def cell(name: str, seed: int, seconds: float,
         slice_s: Optional[float] = None, device=None) -> Dict:
    """One analysed run of the serving cell *name* (module docstring)."""
    import torch

    from . import serve, spec

    bench = spec.benchmark()
    c = spec.cell(name, bench)
    cfg = spec.config(c["config"], bench)
    mix = spec.mix(c["traffic"])
    if slice_s is not None:
        mix["trace_slice_s"] = slice_s
    device = device or torch.device("cuda", 0)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        with _kept(path) as kept:
            rec = serve.run(cfg, mix, seed, seconds, True, device,
                            time.perf_counter())
        with open(path) as f:
            out = split(json.load(f)["traceEvents"])
    finally:
        os.remove(path)
    t0, t1, ts0, ts1 = rec["t0"], rec["t1"], kept["ts0"], kept["ts1"]
    c0, c1 = kept["c0"], kept["c1"]
    steps = sum(n for t, n in kept["windows"] if ts0 <= t < ts1)
    chunk_tok = c1["prefill_chunk_tokens"] - c0["prefill_chunk_tokens"]
    dev = out["device_by_phase"]
    under = dev.get("serve.admit", 0.0) + dev.get("serve.splice", 0.0)
    waits = [d - s for s, d in kept["tickets"] if t0 < d <= t1]
    sched_idle = sum(v for k, v in out["idle_by_phase"].items()
                     if k.startswith("serve."))
    off = [x for x in kept["iters"] if t0 <= x[0] < t1]
    on = [x for x in kept["iters"] if x[2]]
    out.update(
        cell=name, seed=seed, seconds=seconds,
        slice_s=float(mix.get("trace_slice_s", 3.0)),
        device=(torch.cuda.get_device_name(device)
                if device.type == "cuda" else device.type),
        harness_busy_s=rec["trace"]["busy_s"],
        slice_windows=sum(1 for t, _ in kept["windows"] if ts0 <= t < ts1),
        slice_decode_steps=steps,
        decode_ms_per_step=(1e3 * dev.get("serve.dispatch", 0.0) / steps
                            if steps else None),
        slice_prefill_chunk_tokens=chunk_tok,
        prefill_ms_per_ktok=1e3 * under / (chunk_tok / 1e3)
        if chunk_tok else None,
        first_token_wait_ms=_ms(waits),
        device_idle_sched=100.0 * sched_idle / out["window_s"],
        slice_counters={k: c1[k] - c0[k] for k in (
            "prefill_tokens", "prefix_reused_tokens", "prefill_chunk_tokens",
            "decode_steps", "prefix_cache_hits")},
        iterate_host_ms=dict(off=_ms([x[1] for x in off]),
                             recording=_ms([x[1] for x in on])),
        phase_ms_per_iterate=dict(off=_per_iterate(off),
                                  recording=_per_iterate(on)),
        range_cost_us=range_cost_us())
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gpubench.phases")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--slice", type=float, default=None)
    args = p.parse_args(argv)
    from . import run

    run.set_env()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the analysis runs on the card only",
              file=sys.stderr)
        return 2
    print(json.dumps(cell(args.workload, args.seed, args.seconds,
                          args.slice)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
