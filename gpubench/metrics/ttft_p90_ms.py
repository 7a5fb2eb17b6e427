"""Time to first token, p90 over every request due in the window: from
when it was due to when the host loop holds its first token; a request
still without one at the window's end counts its time so far."""

from gpubench import readings


def read(run):
    if not readings.serving(run):
        return None
    return readings.p(readings.ttfts(run), 90, 1e3)
