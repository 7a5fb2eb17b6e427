"""Iteration scheduler: due to the ``pull`` callback handing the request
to ``IterationScheduler.begin``, p90 over the requests due in the
window (one not yet handed over counts its wait so far)."""

from gpubench import readings


def read(run):
    if not readings.serving(run):
        return None
    return readings.p(readings.queue_waits(run), 90, 1e3)
