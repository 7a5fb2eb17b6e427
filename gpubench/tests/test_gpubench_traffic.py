"""The traffic generator: the same seed gives the same requests, every
seed the same sizes and gaps, and the sizes follow the mix's
parameters."""

import math
import random
import statistics

from gpubench import spec, traffic


def _chat(rate=4.0):
    mix = spec.mix("chat")
    mix["traffic"]["arrivals"]["rate"] = rate
    return mix


def test_same_seed_same_requests():
    a = traffic.generate(_chat(), 32768, 2**31 + 12345, 96)
    b = traffic.generate(_chat(), 32768, 2**31 + 12345, 96)
    assert [(r.t_due, r.prompt, r.n_out, r.prefix_id) for r in a] == \
        [(r.t_due, r.prompt, r.n_out, r.prefix_id) for r in b]
    c = traffic.generate(_chat(), 32768, 7, 96)
    assert [r.prompt for r in a] != [r.prompt for r in c]


def test_every_seed_sends_the_same_sizes_and_gaps():
    def sizes(seed):
        rs = traffic.generate(_chat(), 32768, seed, 96)
        return [(r.t_due, len(r.prompt), r.n_out, r.prefix_id) for r in rs]

    assert sizes(1) == sizes(2**33 + 5) == sizes(99)
    a = traffic.generate(_chat(), 32768, 1, 16)
    b = traffic.generate(_chat(), 32768, 2, 16)
    assert all(x.prompt != y.prompt for x, y in zip(a, b))


def test_every_block_asks_the_same_work_and_lasts_the_same_time():
    mix = _chat()
    block = mix["traffic"]["block"]
    rs = traffic.generate(mix, 32768, 3, 4 * block)
    for b in range(1, 4):
        part, first = rs[b * block:(b + 1) * block], rs[:block]
        assert sorted(r.n_out for r in part) == sorted(
            r.n_out for r in first)
        assert sorted(len(r.prompt) for r in part) == sorted(
            len(r.prompt) for r in first)
    span = rs[block - 1].t_due
    assert abs(rs[2 * block - 1].t_due - 2 * span) < 1e-9


def test_lengths_follow_the_lognormal_parameters():
    mix = _chat()
    tr = mix["traffic"]
    rs = traffic.generate(mix, 32768, 3, 32 * 8)
    user = [len(r.prompt) - tr["prefix_len"] for r in rs]
    outs = [r.n_out for r in rs]
    # stratified draws: the median is the parameter, up to rounding
    assert abs(statistics.median(user) - tr["prompt"]["median"]) <= 2
    assert abs(statistics.median(outs) - tr["output"]["median"]) <= 1
    assert min(user) >= tr["prompt"]["min"]
    assert max(outs) <= tr["output"]["max"]
    # log sizes spread as sigma says (the clamp trims little here)
    logs = [math.log(n) for n in outs]
    assert abs(statistics.pstdev(logs) - tr["output"]["sigma"]) < 0.08


def test_arrivals_keep_the_rate():
    rs = traffic.generate(_chat(rate=5.0), 32768, 11, 320)
    span = rs[-1].t_due
    assert abs(len(rs) / span - 5.0) / 5.0 < 0.05
    assert all(b.t_due >= a.t_due for a, b in zip(rs, rs[1:]))


def test_zipf_prefix_shares():
    mix = _chat()
    rs = traffic.generate(mix, 32768, 5, 32 * 10)
    cdf = traffic.zipf_cdf(8, mix["traffic"]["zipf_alpha"])
    share0 = sum(r.prefix_id == 0 for r in rs) / len(rs)
    assert abs(share0 - cdf[0]) < 1 / 32 + 1e-9
    same = [r for r in rs if r.prefix_id == 0]
    assert all(r.prompt[:256] == same[0].prompt[:256] for r in same)


def test_mmpp_bursts_shorten_gaps():
    r1, r2 = random.Random(1), random.Random(2)
    gaps = [r1.random() for _ in range(400)]
    sw = [r2.random() for _ in range(400)]
    calm = traffic.mmpp_times(gaps, sw, 2.0, 2.0, 0.0, 1.0)
    bursty = traffic.mmpp_times(gaps, sw, 2.0, 20.0, 0.2, 0.2)
    assert bursty[-1] < calm[-1]


def test_closed_loop_has_no_arrivals():
    rs = traffic.generate(spec.mix("longdoc"), 102400, 9, 48)
    assert all(r.t_due == 0.0 for r in rs)


def test_every_block_spans_the_distribution():
    mix = spec.mix("longdoc")
    block = mix["traffic"]["block"]
    rs = traffic.generate(mix, 102400, 9, 8 * block)
    lens = [len(r.prompt) for r in rs]
    whole = sum(lens) / len(lens)
    for b in range(8):
        part = lens[b * block:(b + 1) * block]
        assert abs(sum(part) / block - whole) / whole < 0.05
        assert min(part) < mix["traffic"]["prompt"]["median"] < max(part)


def test_a_chat_block_reaches_the_clips():
    """One block is as many requests as a chat run sends, and its
    quantiles reach the clipped tails of the lengths."""
    mix = spec.mix("chat")
    tr = mix["traffic"]
    rs = traffic.generate(mix, 32768, 4, tr["block"])
    user = [len(r.prompt) - tr["prefix_len"] for r in rs]
    assert min(user) == tr["prompt"]["min"]
    assert max(user) == tr["prompt"]["max"]
    assert max(r.n_out for r in rs) == tr["output"]["max"]
