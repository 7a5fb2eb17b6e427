"""The reduction of a profiler trace: device intervals are unioned and
clipped to the traced range, annotation ranges are never device work,
and idle gaps are named by the host phase over them."""

from types import SimpleNamespace

from torch.autograd import DeviceType

from gpubench import trace


def _ev(name, a, b, cuda, annotation=False):
    return SimpleNamespace(name=name, device_type=(
        DeviceType.CUDA if cuda else DeviceType.CPU),
        time_range=SimpleNamespace(start=a, end=b),
        is_user_annotation=annotation)


def test_union_clip_annotations_and_gaps():
    evs = [
        _ev("gpubench.traced", 100, 1100, False, True),
        _ev("gpubench.iterate", 100, 700, False, True),
        _ev("gpubench.owner", 700, 1100, False, True),
        # the annotation's device-side twin: not device work
        _ev("gpubench.iterate", 100, 700, True, True),
        _ev("Optimizer.step#Adam.step", 100, 1100, True, True),
        _ev("k1", 50, 300, True),        # clipped to 100..300
        _ev("k2", 200, 400, True),       # overlaps k1: counted once
        _ev("k3", 800, 900, True),
        _ev("k4", 1050, 1300, True),     # clipped to 1050..1100
    ]
    r = trace.summarize(evs)
    assert abs(r["window_s"] - 1000e-6) < 1e-12
    assert abs(r["busy_s"] - (300 + 100 + 50) * 1e-6) < 1e-12
    names = dict((n, s) for n, s in r["device_ops"])
    assert set(names) == {"k1", "k2", "k3", "k4"}
    assert abs(names["k1"] - 200e-6) < 1e-12
    gaps = r["idle_gaps"]
    assert gaps[0][0] == "iterate" and abs(gaps[0][1] - 400e-6) < 1e-12
    assert [g[0] for g in gaps] == ["iterate", "owner"]
