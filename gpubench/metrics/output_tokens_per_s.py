"""Every output token the host loop took in the window, over the
window's seconds (serving cells)."""

from gpubench import readings


def read(run):
    if not readings.serving(run):
        return None
    return readings.tokens_in_window(run) / (run["t1"] - run["t0"])
