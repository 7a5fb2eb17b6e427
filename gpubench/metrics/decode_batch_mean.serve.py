"""Iteration scheduler: slots in each decode window, weighted by the
window's steps, over the windows harvested in the window."""


def read(run):
    if run.get("kind") != "serve":
        return None
    t0, t1 = run["t0"], run["t1"]
    ws = [(n, live) for t, n, live in run["steps"] if t0 < t <= t1]
    steps = sum(n for n, _ in ws)
    return sum(n * live for n, live in ws) / steps if steps else None
