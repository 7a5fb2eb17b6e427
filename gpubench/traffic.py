"""Seeded traffic from a mix file's parameters.

The arithmetic is the port's ``workloads/trafficgen.py`` (Poisson and
two-state Markov-modulated Poisson arrivals, clamped lognormal
lengths, Zipf-chosen shared prefixes), copied so that the yardstick
does not move when the program's generator does.  One change: every
draw is stratified.  Each block of ``block`` consecutive requests takes
its lengths, its inter-arrival gaps and its prefix choices at the
quantiles ``(j + 0.5) / block``, in an order that the mix's
``order_seed`` shuffles, so every block asks for the same work and
lasts the same time: arrivals are Poisson within a block and regular
from block to block.  The run's seed makes the token ids (and, in the
harness, the weights): every seed sends the same sizes, gaps and prefix
choices in the same order, so two seeds differ in what the model
computes on, not in how much or when.  (With the order drawn from the
run's seed, a window of 51 s held 98-110 chat requests and the
longdoc cell's tokens/s split 25-32 by seed on one H100: PERF.md.)
"""

from __future__ import annotations

import bisect
import math
import random
from dataclasses import dataclass
from statistics import NormalDist
from typing import Dict, List, Optional

_NORMAL = NormalDist()


@dataclass
class Request:
    """One request: when it is due (seconds from the traffic's start;
    0 for a closed loop, whose callers send when they are answered),
    its prompt ids, how many tokens it wants, and the shared prefix it
    starts with (-1 for none)."""

    rid: int
    t_due: float
    prompt: List[int]
    n_out: int
    prefix_id: int = -1


def zipf_cdf(n: int, alpha: float) -> List[float]:
    """trafficgen's ``_zipf_cdf``: the CDF over ranks 1..n of weights
    ``rank ** -alpha``."""
    weights = [1.0 / (rank ** alpha) for rank in range(1, n + 1)]
    total = sum(weights)
    acc = 0.0
    cdf: List[float] = []
    for w in weights:
        acc += w / total
        cdf.append(acc)
    return cdf


def clamped_lognormal(u: float, median: float, sigma: float, lo: int,
                      hi: int) -> int:
    """trafficgen's ``_clamped_lognormal`` at the uniform *u*: the
    lognormal of that median and sigma, rounded and clamped to
    [lo, hi]."""
    z = _NORMAL.inv_cdf(u)
    return max(lo, min(hi, int(round(math.exp(math.log(median)
                                              + sigma * z)))))


def exponential(u: float, rate: float) -> float:
    """An exponential gap of *rate* per second at the uniform *u*."""
    return -math.log(1.0 - u) / rate


def stratified(n: int, block: int, rng: random.Random) -> List[float]:
    """*n* uniforms: each block of *block* holds the quantiles
    ``(j + 0.5) / block`` once each, shuffled by *rng*."""
    out: List[float] = []
    while len(out) < n:
        qs = [(j + 0.5) / block for j in range(block)]
        rng.shuffle(qs)
        out += qs
    return out[:n]


def mmpp_times(gaps_u: List[float], switch_u: List[float],
               base_rate: float, burst_rate: float, p_enter: float,
               p_exit: float) -> List[float]:
    """trafficgen's two-state arrival clock: each request's gap is
    exponential at the current state's rate, then the state switches
    with ``p_enter`` (calm to burst) or ``p_exit`` (burst to calm).
    With equal rates it is a Poisson process."""
    rates = {False: base_rate, True: burst_rate}
    burst = False
    t = 0.0
    out = []
    for u, s in zip(gaps_u, switch_u):
        t += exponential(u, rates[burst])
        out.append(t)
        if burst:
            if s < p_exit:
                burst = False
        elif s < p_enter:
            burst = True
    return out


def _ids(rng: random.Random, n: int, vocab: int) -> List[int]:
    return [rng.randrange(1, vocab) for _ in range(n)]


def generate(mix: Dict, vocab: int, seed: int, n: int,
             rate: Optional[float] = None) -> List[Request]:
    """*n* requests of the mix *mix* (its ``traffic`` block) for a model
    of *vocab* ids, their token ids from *seed*.  *rate* overrides the mix's arrival
    rate (the knee sweep); a closed-loop mix has no arrivals and every
    ``t_due`` is 0."""
    tr = mix["traffic"]
    rng = random.Random(seed)
    order = random.Random(int(tr["order_seed"]))
    block = int(tr.get("block", 32))
    prompt = tr["prompt"]
    out_len = tr["output"]
    n_prefixes = int(tr.get("n_prefixes", 0))
    prefixes = [_ids(rng, int(tr["prefix_len"]), vocab)
                for _ in range(n_prefixes)]
    prompt_u = stratified(n, block, order)
    out_u = stratified(n, block, order)
    if n_prefixes:
        cdf = zipf_cdf(n_prefixes, float(tr["zipf_alpha"]))
        pref_u = stratified(n, block, order)
        pids = [min(bisect.bisect_left(cdf, u), n_prefixes - 1)
                for u in pref_u]
    else:
        pids = [-1] * n
    arrivals = tr.get("arrivals")
    if arrivals is None:
        times = [0.0] * n
    else:
        base = float(rate if rate is not None else arrivals["rate"])
        burst = float(arrivals.get("burst_rate", 0.0)) or base
        gaps_u = stratified(n, block, order)
        switch_u = [order.random() for _ in range(n)]
        times = mmpp_times(gaps_u, switch_u, base, burst,
                           float(arrivals.get("p_enter_burst", 0.0)),
                           float(arrivals.get("p_exit_burst", 1.0)))
    reqs = []
    for i in range(n):
        length = clamped_lognormal(prompt_u[i], prompt["median"],
                                   prompt["sigma"], prompt["min"],
                                   prompt["max"])
        n_out = clamped_lognormal(out_u[i], out_len["median"],
                                  out_len["sigma"], out_len["min"],
                                  out_len["max"])
        head = prefixes[pids[i]] if pids[i] >= 0 else []
        reqs.append(Request(i, times[i], head + _ids(rng, length, vocab),
                            n_out, pids[i]))
    return reqs
