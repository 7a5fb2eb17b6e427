"""Model: analytic FLOPs of the window's useful work (``readings.
serve_flops``: prompt tokens prefilled, output tokens decoded, the
prefix cache's tokens counting nothing) over the window and the bf16
peak, in percent."""

from gpubench import peaks, readings


def read(run):
    if not readings.serving(run):
        return None
    f = readings.serve_flops(run)
    if f <= 0:
        return None
    return 100.0 * f / (run["t1"] - run["t0"]) / peaks.BF16_FLOPS
