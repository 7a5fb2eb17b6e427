"""Device: the share of the traced slice with no device activity, 1 -
(union of kernel, copy and set intervals) / slice, in percent."""


def read(run):
    if run.get("kind") != "train" or not run.get("trace"):
        return None
    t = run["trace"]
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
