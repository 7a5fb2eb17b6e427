"""Device time from a torch.profiler trace over a slice of the run.

The slice is taken right after the measured window closes, with the
same traffic or steps still running, so that neither the profiler's
cost nor its reduction of the events lands in the window.

``Tracer`` profiles CPU and CUDA activity between ``start`` and
``stop``; the harness's host loop marks what it is doing with
``phase(name)`` (a ``record_function`` range, ``gpubench.<name>``).
``summary`` reduces the trace to:

* ``busy_s``: the union of every device activity's interval (kernels,
  copies, sets), clipped to the traced window, so that work on two
  streams at once counts once;
* ``window_s``: the traced window, the host-side range from ``start``
  to ``stop`` (which waits for the device first) in the profiler's own
  clock;
* ``device_ops``: device time by name, the ten largest;
* ``idle_gaps``: the ten longest stretches with no device activity,
  each named by the host phase that covers its middle;
* ``ops``: every device interval as ``(name, start_s, end_s)``, for the
  per-layer readers (kernel rooflines match names in it).
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Dict, List, Tuple


class Tracer:
    def __init__(self):
        self._prof = None
        self._range = None
        self.result: Dict = {}

    def phase(self, name: str):
        if self._prof is None:
            return nullcontext()
        import torch

        return torch.profiler.record_function(f"gpubench.{name}")

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._range = torch.profiler.record_function("gpubench.traced")
        self._range.__enter__()

    def stop(self) -> None:
        import torch

        # the traced range ends when the device has finished what the
        # host enqueued in it, so no device work is clipped away
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._range.__exit__(None, None, None)
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        self.result = summarize(prof.events())


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def summarize(events) -> Dict:
    from torch.autograd import DeviceType

    lo = hi = None
    phases: List[Tuple[float, float, str]] = []
    ops: List[Tuple[str, float, float]] = []
    for e in events:
        tr = e.time_range
        if getattr(e, "is_user_annotation", False) or e.name.startswith(
                "gpubench."):
            # record_function ranges (the harness's phases, the
            # optimizer's) show on both timelines; none is device work
            if e.device_type != DeviceType.CUDA:
                if e.name == "gpubench.traced":
                    lo, hi = tr.start * 1e-6, tr.end * 1e-6
                elif e.name.startswith("gpubench."):
                    phases.append((tr.start * 1e-6, tr.end * 1e-6,
                                   e.name[len("gpubench."):]))
            continue
        if e.device_type == DeviceType.CUDA:
            if tr.end > tr.start:
                ops.append((e.name, tr.start * 1e-6, tr.end * 1e-6))
    if lo is None:
        raise RuntimeError("the trace holds no gpubench.traced range")
    clipped = [(max(a, lo), min(b, hi)) for _, a, b in ops
               if b > lo and a < hi]
    union = _union(clipped)
    busy = sum(b - a for a, b in union)
    by_name: Dict[str, float] = {}
    for name, a, b in ops:
        a, b = max(a, lo), min(b, hi)
        if b > a:
            by_name[name] = by_name.get(name, 0.0) + (b - a)
    gaps = []
    edges = [lo] + [x for ab in union for x in ab] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            mid = 0.5 * (a + b)
            cover = [p for p in phases if p[0] <= mid <= p[1]]
            # the innermost phase: the one that started last
            label = max(cover)[2] if cover else "outside"
            gaps.append((label, b - a))
    gaps.sort(key=lambda g: -g[1])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return dict(busy_s=busy, window_s=hi - lo,
                device_ops=[[n, s] for n, s in top],
                idle_gaps=[[n, s] for n, s in gaps[:10]],
                ops=[(n, max(a, lo), min(b, hi)) for n, a, b in ops
                     if b > lo and a < hi])
