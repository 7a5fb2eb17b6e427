"""What the metric readers share: a serving run's window, its requests
and the analytic FLOPs of its tokens.

A serving run record holds ``t0`` / ``t1`` (the window's two harvests),
``requests`` (each with ``due``, ``pull``, ``first``, ``done``, the
arrival time of every output token in ``times``, ``prompt_len``,
``reused`` prompt tokens served by the prefix cache, ``n_out``),
``steps`` (``(time, decode steps, slots in the window)`` per harvest)
and ``dims`` (the configuration's widths).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional

from .stats import percentile


def serving(run: Dict) -> bool:
    return run.get("kind") == "serve"


def due_in_window(run: Dict) -> Iterator[Dict]:
    t0, t1 = run["t0"], run["t1"]
    return (q for q in run["requests"] if t0 <= q["due"] < t1)


def tokens_in_window(run: Dict) -> int:
    t0, t1 = run["t0"], run["t1"]
    return sum(1 for q in run["requests"] for t in q["times"]
               if t0 < t <= t1)


def ttfts(run: Dict) -> List[float]:
    """Due to first token, for every request due in the window; one
    still without a token at the window's end counts its time so far."""
    t1 = run["t1"]
    return [(q["first"] if q["first"] is not None and q["first"] <= t1
             else t1) - q["due"] for q in due_in_window(run)]


def itls(run: Dict) -> List[float]:
    """Gaps between consecutive tokens of a stream, as the host loop
    takes them, whose later token falls in the window."""
    t0, t1 = run["t0"], run["t1"]
    out = []
    for q in run["requests"]:
        ts = q["times"]
        out += [b - a for a, b in zip(ts, ts[1:]) if t0 < b <= t1]
    return out


def queue_waits(run: Dict) -> List[float]:
    t1 = run["t1"]
    return [(q["pull"] if q["pull"] is not None and q["pull"] <= t1
             else t1) - q["due"] for q in due_in_window(run)]


def admit_times(run: Dict) -> List[float]:
    """Hand-over to first token, for admissions whose first token came
    in the window."""
    t0, t1 = run["t0"], run["t1"]
    return [q["first"] - q["pull"] for q in run["requests"]
            if q["first"] is not None and t0 < q["first"] <= t1]


def p(xs: List[float], q: float, scale: float = 1.0) -> Optional[float]:
    v = percentile(xs, q)
    return None if v is None else v * scale


def matmul_params(dims: Dict) -> Dict[str, int]:
    """Matmul parameters of the blocks and of the LM head."""
    d, f, dh = dims["d"], dims["f"], dims["dh"]
    qkv = (dims["h"] + 2 * dims["hkv"]) * dh
    per_layer = d * qkv + dims["h"] * dh * d + 3 * d * f
    return dict(blocks=dims["layers"] * per_layer, head=d * dims["vocab"])


def serve_flops(run: Dict) -> float:
    """Analytic FLOPs of the useful work taken in the window: 2 per
    block matmul parameter for every prompt token prefilled (the prefix
    cache's tokens count nothing) and every output token decoded, 2 per
    LM-head parameter for every output token, and 4 * head_dim per
    visible (query, key) pair per query head per layer.  A request's
    prefill counts in the window that holds its first token; an output
    token counts where it is taken."""
    dims = run["dims"]
    mp = matmul_params(dims)
    attn = 4 * dims["dh"] * dims["h"] * dims["layers"]
    t0, t1 = run["t0"], run["t1"]
    total = 0.0
    for q in run["requests"]:
        p_len = q["prompt_len"]
        if q["first"] is not None and t0 < q["first"] <= t1:
            a = q["reused"]
            n = p_len - a
            # positions a .. p_len - 1 see a + 1 .. p_len keys
            pairs = (a + 1 + p_len) * n // 2
            total += 2 * mp["blocks"] * n + attn * pairs
        for j, t in enumerate(q["times"]):
            if t0 < t <= t1:
                total += 2 * mp["head"]
                if j > 0:
                    # output token j was decoded at position p_len + j - 1
                    total += 2 * mp["blocks"] + attn * (p_len + j)
    return total
