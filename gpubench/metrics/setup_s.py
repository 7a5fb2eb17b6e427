"""Process start to the window's first instant: imports, weights,
captures, warm-up and a serving cell's ramp."""


def read(run):
    return run["setup_s"]
