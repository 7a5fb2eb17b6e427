"""Serving engine: hand-over to ``IterationScheduler.begin`` to the
first token (chunked, packed admission, prefix cache), median over the
admissions whose first token came in the window."""

from gpubench import readings


def read(run):
    if not readings.serving(run):
        return None
    return readings.p(readings.admit_times(run), 50, 1e3)
