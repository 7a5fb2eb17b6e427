"""Serving engine: the share of admitted prompt tokens that the prefix
cache served, in percent, over the admissions whose first token came in
the window.  A request's ``reused`` is the engine's own count for its
admission (``AdmitState.auto_src``, what the engine adds to its
``prefix_reused_tokens``); the engine's ``prefill_tokens`` counts the
rest, the tokens its extends ran, so a prompt's length is the two
together and the share is reused over prompt tokens."""

from gpubench import readings


def read(run):
    if not readings.serving(run):
        return None
    t0, t1 = run["t0"], run["t1"]
    qs = [q for q in run["requests"]
          if q["first"] is not None and t0 < q["first"] <= t1]
    total = sum(q["prompt_len"] for q in qs)
    if not total:
        return None
    return 100.0 * sum(q["reused"] for q in qs) / total
