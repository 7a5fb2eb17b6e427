"""Program ranges in a device profiler's trace.

``device_range(name)`` opens a ``torch.profiler.record_function``
range, so that a ``torch.profiler`` trace (the server's
``/debug/profile``, a benchmark's traced slice) shows which part of the
program launched each kernel.  Opening a range costs about 10 us even
while no profiler records, so one is opened only while a profiler
records; otherwise the call reads one flag and returns a shared no-op
context.  Only the serving side imports this module: the rest of
``obs`` stays free of torch, for the node agents.
"""

from __future__ import annotations

from contextlib import nullcontext

from torch.autograd import profiler as _profiler

_NONE = nullcontext()


def device_range(name: str):
    """A context naming what runs inside it *name* in the trace of a
    recording profiler; a no-op context while none records."""
    if not _profiler._is_profiler_enabled:
        return _NONE
    return _profiler.record_function(name)
