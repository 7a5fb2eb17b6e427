"""Gap between consecutive output tokens of one stream as the host loop
takes them (a decode window's tokens arrive together), p95 over every
gap that ends in the window."""

from gpubench import readings


def read(run):
    if not readings.serving(run):
        return None
    return readings.p(readings.itls(run), 95, 1e3)
