"""The window over the optimizer steps completed in it (the window ends
with a synchronise), training cells."""


def read(run):
    if run.get("kind") != "train" or not run["steps"]:
        return None
    return 1e3 * (run["t1"] - run["t0"]) / run["steps"]
