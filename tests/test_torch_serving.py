"""The port's continuous-batching engine against the JAX package's.

Two models, both initialised by JAX and converted with
``convert.params_from_jax``: the decoder of tests/test_serving.py
(vocab 128, d_model 64, 4 heads, 2 layers, max_len 64, f32) and
``llama.TINY_LLAMA`` (GQA 4:1, SwiGLU).  Prompts are fixed lists or
come from numpy with a seed.  Greedy scenarios run on the reference
``ServingEngine`` and on the port's, on the CPU, and their token ids,
finish reasons and counters must be identical; logprobs agree to 1e-4
(the frameworks sum in other orders); penalties are held against a
recompute of the whole sequence.  Sampled streams cannot match JAX's
keys, so sampling is held to the port's own invariants."""

import inspect
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_k8s_device_plugin.workloads import llama as jllama
from tpu_k8s_device_plugin.workloads.inference import make_decoder
from tpu_k8s_device_plugin.workloads.serving import ServingEngine as JEngine
from tpu_k8s_device_plugin_torch.convert import params_from_jax
from tpu_k8s_device_plugin_torch.workloads import bench_serving as tbench
from tpu_k8s_device_plugin_torch.workloads import grammar as tgrammar
from tpu_k8s_device_plugin_torch.workloads import inference as tinf
from tpu_k8s_device_plugin_torch.workloads import llama as tllama
from tpu_k8s_device_plugin_torch.workloads import serving as tserve
from tpu_k8s_device_plugin_torch.workloads.serving import ServingEngine

CFG = dict(vocab=128, d_model=64, n_heads=4, n_layers=2, d_ff=128)
MAX_LEN = 64


def _init(model):
    tokens = jnp.zeros((1, 8), jnp.int32)
    pos = jnp.broadcast_to(jnp.arange(8, dtype=jnp.int32), (1, 8))
    return model.init(jax.random.PRNGKey(0), tokens, pos)["params"]


def _convert(tmodel, params):
    tmodel.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return tmodel


@pytest.fixture(scope="module")
def gelu():
    jm = make_decoder(**CFG, max_len=MAX_LEN, dtype=jnp.float32)
    params = _init(jm)
    tm = _convert(tinf.make_decoder(**CFG, max_len=MAX_LEN,
                                    dtype=torch.float32, device="cpu"),
                  params)
    return jm, params, tm


@pytest.fixture(scope="module")
def tiny_llama():
    cfg = jllama.TINY_LLAMA
    jm = jllama.decoder(cfg, max_len=MAX_LEN, dtype=jnp.float32)
    params = _init(jm)
    tm = _convert(tllama.decoder(tllama.TINY_LLAMA, max_len=MAX_LEN,
                                 dtype=torch.float32, device="cpu"),
                  params)
    return jm, params, tm


@pytest.fixture(scope="module", params=["gelu", "tiny_llama"])
def pair(request):
    return request.getfixturevalue(request.param)


def _port(tm, **kw):
    return ServingEngine(tm, device="cpu", **kw)


def _both(models, scenario, **kw):
    """Run *scenario* on a reference engine and on a port engine built
    with the same arguments; returns (reference result, port result)."""
    jm, params, tm = models
    return (scenario(JEngine(jm, params, **kw)),
            scenario(_port(tm, **kw)))


def _assert_same(models, scenario, **kw):
    want, got = _both(models, scenario, **kw)
    assert got == want


def _solo(tm, prompt, n):
    out, _ = tinf.greedy_generate(tm, np.asarray(prompt, np.int32)[None],
                                  n)
    return out[0].tolist()


def _record(eng, slots):
    """Outputs, finish reasons and the counters of *slots*."""
    return ([eng.output(s) for s in slots],
            [eng.finish_reason(s) for s in slots], eng.stats())


PA, PB, PC = [3, 14, 15, 92, 65], [2, 71, 82], [9, 9, 8, 7, 1, 0, 2]


# -- greedy ids identical to the reference engine ---------------------------


def test_different_lengths_match_reference_and_solo(pair):
    def scenario(eng):
        sa, sb = eng.admit(PA), eng.admit(PB)
        eng.run(7)
        return _record(eng, [sa, sb])

    want, got = _both(pair, scenario, n_slots=4)
    assert got == want
    tm = pair[2]
    assert got[0][0][:8] == _solo(tm, PA, 8)
    assert got[0][1][:8] == _solo(tm, PB, 8)


def test_admit_mid_stream_matches_reference(pair):
    def scenario(eng):
        sa = eng.admit(PA)
        eng.step(); eng.step(); eng.step()
        sc = eng.admit(PC)
        eng.run(5)
        return _record(eng, [sa, sc])

    _assert_same(pair, scenario, n_slots=4)


@pytest.mark.parametrize("chunk", [4, None])
def test_chunked_prefill_matches_reference(gelu, chunk):
    prompt = [5, 9, 3, 3, 7, 1, 0, 44, 91, 12]

    def scenario(eng):
        s = eng.admit(prompt)
        eng.run(6)
        return _record(eng, [s])

    want, got = _both(gelu, scenario, n_slots=2, chunk=chunk)
    assert got == want
    assert got[0][0][:6] == _solo(gelu[2], prompt, 6)


def test_slot_reuse_matches_reference(gelu):
    def scenario(eng):
        sa = eng.admit([3, 14, 15])
        eng.run(10)
        sb = eng.admit([7, 7, 2, 1])
        eng.run(10)
        return sa, sb, _record(eng, [sa, sb])

    want, got = _both(gelu, scenario, n_slots=1, max_new_tokens=3)
    assert got == want
    assert got[0] == got[1]


def test_eos_and_stop_finish_like_reference(gelu):
    solo = _solo(gelu[2], PA, 6)

    def scenario(eng):
        s = eng.admit(PA)
        t = eng.admit(PB, stop=[solo[1], 127])
        o = eng.admit(PC, ignore_eos=True)
        eng.run(10)
        return _record(eng, [s, t, o]) + (eng.free_slots(),)

    want, got = _both(gelu, scenario, n_slots=3, eos_id=solo[2],
                      max_new_tokens=8)
    assert got == want
    assert got[0][0] == solo[:3] and got[1][0] == "eos"


def test_ignore_eos_decodes_to_budget_like_reference(gelu):
    solo = _solo(gelu[2], PA, 6)

    def scenario(eng):
        s = eng.admit(PA, ignore_eos=True)
        eng.run(10)
        return _record(eng, [s])

    want, got = _both(gelu, scenario, n_slots=1, eos_id=solo[1],
                      max_new_tokens=5)
    assert got == want
    assert len(got[0][0]) == 5 and got[1] == ["length"]


def test_registered_and_automatic_prefix_reuse_like_reference(pair):
    shared = [7, 3, 9, 12, 5, 8, 1, 2, 44, 6, 91, 30]
    system = [7, 7, 7, 12, 90, 3]

    def scenario(eng):
        h = eng.register_prefix(system)
        s1 = eng.admit(system + [5, 9, 3], prefix=h)
        s2 = eng.admit(system)                       # exact registry hit
        s3 = eng.admit(shared + [5, 9, 3])
        s4 = eng.admit(shared + [44, 1])             # resident slot hit
        eng.run(4)
        eng.release(s3)
        s5 = eng.admit(shared + [5, 9, 3])           # exact parked donor
        eng.run(3)
        return _record(eng, [s1, s2, s3, s4, s5])

    want, got = _both(pair, scenario, n_slots=4, chunk=4,
                      auto_prefix_min=4)
    assert got == want
    stats = got[2]
    assert stats["prefix_cache_hits"] >= 3
    assert stats["prefix_reused_tokens"] > 0


def test_run_scan_matches_step_and_reference(pair):
    prompts = [[3, 14, 15, 92], [9, 8]]

    def stepwise(eng):
        slots = [eng.admit(p) for p in prompts]
        for _ in range(6):
            eng.step()
        return _record(eng, slots)

    def scanned(eng):
        slots = [eng.admit(p) for p in prompts]
        out = eng.run_scan(6)
        return _record(eng, slots), out

    want, got = _both(pair, scanned, n_slots=3)
    assert got == want
    assert stepwise(_port(pair[2], n_slots=3)) == got[0]


def test_fused_matches_unfused_and_reference(gelu):
    def scenario(eng):
        sl = [eng.admit(PA), eng.admit(PB, stop=[94, 22]),
              eng.admit(PC, logprobs=2)]
        out = eng.run_scan(7)
        return _record(eng, sl), out

    for fused in (False, True):
        want, got = _both(gelu, scenario, n_slots=3, eos_id=0,
                          max_new_tokens=5, fused_decode=fused,
                          logprobs_k=2)
        assert got[:1] == want[:1]
        if fused:
            assert got[0][2]["fused_windows"] == 1
        else:
            unfused = got
    assert unfused[0][:2] == got[0][:2] and unfused[1] == got[1]


def test_run_scan_headroom_guard(gelu):
    for eng in (JEngine(gelu[0], gelu[1], n_slots=1),
                _port(gelu[2], n_slots=1)):
        eng.admit(list(range(60)))
        with pytest.raises(ValueError, match="cache rows"):
            eng.run_scan(10)


def test_logit_bias_and_min_tokens_like_reference(gelu):
    solo = _solo(gelu[2], PA, 6)

    def scenario(eng):
        forced = eng.admit([5, 17, 3], logit_bias={42: 100.0})
        banned = eng.admit(PA, logit_bias={solo[0]: -100.0})
        floor = eng.admit(PA, min_tokens=4, stop=[solo[1]])
        eng.run(5)
        eng.run_scan(3)
        return _record(eng, [forced, banned, floor])

    want, got = _both(gelu, scenario, n_slots=3, eos_id=solo[2],
                      max_new_tokens=9)
    assert got == want
    assert got[0][0][:5] == [42] * 5
    assert got[0][1][0] != solo[0]
    assert len(got[0][2]) >= 4


def test_min_tokens_floor_crosses_mid_window_like_reference(gelu):
    """+100 on eos makes it win every pick; the floor holds it off for
    exactly min_tokens tokens, and the floor's gate is per step, so a
    crossing inside a window lifts it where stepping would."""
    eos = 33

    def stepped(eng):
        s = eng.admit([5, 17, 3], logit_bias={eos: 100.0}, min_tokens=5)
        for _ in range(10):
            eng.step()
        return _record(eng, [s])

    def scanned(eng):
        s = eng.admit([5, 17, 3], logit_bias={eos: 100.0}, min_tokens=5)
        eng.run_scan(3)
        eng.run_scan(5)  # the floor is crossed inside this window
        return _record(eng, [s])

    kw = dict(n_slots=1, eos_id=eos, max_new_tokens=8)
    want, got = _both(gelu, stepped, **kw)
    assert got == want
    assert got[0][0][5] == eos and eos not in got[0][0][:5]
    assert got[1] == ["eos"]
    want, got = _both(gelu, scanned, **kw)
    assert got[:2] == want[:2] == stepped(_port(gelu[2], **kw))[:2]


def test_logprobs_match_reference(pair):
    def scenario(eng):
        s = eng.admit([3, 14, 15, 92], logprobs=3)
        o = eng.admit([9, 8])
        eng.run(3)
        eng.run_scan(2)
        return eng.output(s), eng.token_logprobs(s), eng.token_logprobs(o)

    (wt, wlp, wo), (gt, glp, go) = _both(pair, scenario, n_slots=2,
                                         logprobs_k=4)
    assert gt == wt and go == wo == []
    assert len(glp) == len(wlp) == len(gt)
    for (wc, wtop), (gc, gtop) in zip(wlp, glp):
        np.testing.assert_allclose(gc, wc, atol=1e-4, rtol=1e-4)
        assert [t for t, _ in gtop] == [t for t, _ in wtop]
        np.testing.assert_allclose([v for _, v in gtop],
                                   [v for _, v in wtop],
                                   atol=1e-4, rtol=1e-4)


# -- penalties against a recompute of the whole sequence --------------------


def _full_logits(tm, seq):
    toks = torch.as_tensor(seq, dtype=torch.long)[None]
    pos = torch.arange(len(seq), dtype=torch.int32)[None]
    cache = tinf.init_cache(tm, 1)
    with torch.no_grad():
        logits = tm(toks, pos, cache)
    return logits[0].double().numpy()


def test_frequency_penalty_matches_recompute(gelu):
    tm = gelu[2]
    PRES, FREQ = 0.7, 1.3
    eng = _port(tm, n_slots=2)
    s = eng.admit(PA, presence_penalty=PRES, frequency_penalty=FREQ)
    eng.run(4)
    eng.run_scan(3)
    toks = eng.output(s)
    logits = _full_logits(tm, PA + toks)
    counts = np.zeros(tm.vocab)
    for i, tok in enumerate(toks):
        row = logits[len(PA) - 1 + i] - PRES * (counts > 0) - FREQ * counts
        assert tok == int(np.argmax(row)), f"step {i}"
        counts[tok] += 1
    assert toks != _solo(tm, PA, len(toks))  # the penalty bites


def test_repetition_penalty_matches_recompute(gelu):
    tm = gelu[2]
    prompt = [3, 14, 15, 92, 65, 14, 3]
    REP = 1.8
    eng = _port(tm, n_slots=2)
    s = eng.admit(prompt, repetition_penalty=REP)
    eng.run(3)
    eng.run_scan(3)
    toks = eng.output(s)
    logits = _full_logits(tm, prompt + toks)
    seen = np.zeros(tm.vocab, bool)
    seen[prompt] = True
    for i, tok in enumerate(toks):
        row = logits[len(prompt) - 1 + i].copy()
        row[seen] = np.where(row[seen] > 0, row[seen] / REP,
                             row[seen] * REP)
        assert tok == int(np.argmax(row)), f"step {i}"
        seen[tok] = True
    assert toks != _solo(tm, prompt, len(toks))


def test_penalty_knobs_reset_for_the_next_request(gelu):
    tm = gelu[2]
    eng = _port(tm, n_slots=1, max_new_tokens=5)
    eng.admit([5, 17, 3], frequency_penalty=1.0, repetition_penalty=1.5)
    eng.run(6)
    s = eng.admit([3, 14, 15])
    eng.run(10)
    assert eng.output(s) == _solo(tm, [3, 14, 15], 5)


# -- sampling: the port's own invariants ------------------------------------


@pytest.mark.parametrize("kw", [dict(top_k=1), dict(top_p=1e-6),
                                dict(min_p=1.0)])
def test_degenerate_sampling_is_greedy(gelu, kw):
    tm = gelu[2]
    eng = _port(tm, n_slots=2, rng=4)
    s = eng.admit(PA, temperature=1.5, **kw)
    eng.run(3)
    eng.run_scan(3)
    assert eng.output(s) == _solo(tm, PA, 7)


def _step_logits(tm, prompt, toks):
    """The logits row each emitted token was picked from."""
    full = _full_logits(tm, prompt + toks)
    return [full[len(prompt) - 1 + i] for i in range(len(toks))]


def test_sampled_tokens_stay_in_top_k_nucleus_and_support(gelu):
    tm = gelu[2]
    eng = _port(tm, n_slots=3, rng=11)
    T = 1.3
    sk = eng.admit(PA, temperature=T, top_k=5)
    sp = eng.admit(PB, temperature=T, top_p=0.6)
    sm = eng.admit(PC, temperature=T, min_p=0.3)
    eng.run(5)
    eng.run_scan(5)
    for tok, row in zip(eng.output(sk), _step_logits(tm, PA,
                                                     eng.output(sk))):
        assert tok in np.argsort(-row)[:5]
    for tok, row in zip(eng.output(sp), _step_logits(tm, PB,
                                                     eng.output(sp))):
        order = np.argsort(-row)
        p = np.exp((row - row.max()) / T)
        p = p[order] / p.sum()
        n = int(np.searchsorted(np.cumsum(p), 0.6)) + 1
        assert tok in order[:n + 1]  # one token of slack for f32 sums
    for tok, row in zip(eng.output(sm), _step_logits(tm, PC,
                                                     eng.output(sm))):
        assert (row[tok] - row.max()) / T >= np.log(0.3) - 1e-4
    assert len(set(eng.output(sk) + eng.output(sp))) > 2  # it samples


def test_seeded_request_reproducible_and_isolated(gelu):
    tm = gelu[2]
    req = dict(temperature=1.0, top_k=16, seed=1234)

    def run_one(rng, neighbour, scan):
        eng = _port(tm, n_slots=3, rng=rng)
        if neighbour:
            eng.admit([9, 9, 8], temperature=1.0)
            eng.step()
        s = eng.admit([5, 17, 3, 70], **req)
        if scan:
            eng.run_scan(6)
        else:
            eng.run(6)
        return eng.output(s)

    base = run_one(0, False, False)
    assert len(base) == 7
    for args in ((0, False, False), (7, True, False), (3, True, True),
                 (5, False, True)):
        assert run_one(*args) == base, args
    eng = _port(tm, n_slots=1, rng=0)
    other = eng.admit([5, 17, 3, 70], **dict(req, seed=1235))
    eng.run(6)
    assert eng.output(other) != base


def test_run_scan_equals_step_for_sampled_slots(gelu):
    tm = gelu[2]

    def mk():
        eng = _port(tm, n_slots=3, rng=21, max_new_tokens=6)
        slots = [eng.admit([5, 17, 3], temperature=1.0, top_k=16,
                           top_p=0.9),
                 eng.admit(PA, temperature=0.7, seed=5),
                 eng.admit(PB, frequency_penalty=0.5)]
        return eng, slots

    a, sa = mk()
    b, sb = mk()
    for _ in range(5):
        a.step()
    b.run_scan(5)
    assert _record(a, sa) == _record(b, sb)
    assert a._draws == b._draws and a._slot_draws == b._slot_draws


def test_draw_stream_pinned_across_fused_and_per_step(gelu):
    tm = gelu[2]

    def mk(fused):
        return _port(tm, n_slots=2, max_new_tokens=3, fused_decode=fused,
                     rng=5)

    a, b, c = mk(False), mk(True), mk(False)
    for e in (a, b, c):
        e.admit([3, 14, 15])
        e.admit([9, 9, 8], temperature=1.0, top_k=8)
    a.run_scan(6)
    b.run_scan(6)
    for _ in range(6):
        c.step()
    assert a._draws == b._draws == c._draws
    assert a._slot_draws == b._slot_draws == c._slot_draws
    outs = []
    for e in (a, b, c):
        s = e.admit([5, 17, 3], temperature=1.0, top_k=8)
        e.run_scan(2)
        outs.append(e.output(s))
    assert outs[0] == outs[1] == outs[2]


def test_draws_are_a_function_of_key_index_and_slot():
    keys = torch.tensor([tinf.row_keys(tinf.prng_key(3), 5, s)
                         for s in range(4)], dtype=torch.int64)
    g = tinf.gumbel_rows(keys, 4096)
    assert torch.equal(g, tinf.gumbel_rows(keys, 4096))
    assert torch.isfinite(g).all()
    # every row its own stream, and Gumbel(0, 1) in distribution
    assert len({tuple(r[:8].tolist()) for r in g}) == 4
    assert abs(float(g.mean()) - 0.5772) < 0.05
    assert abs(float(g.var()) - np.pi ** 2 / 6) < 0.15
    # the host and tensor forms of the hash agree
    d = torch.arange(6, dtype=torch.int64)
    assert tinf.fold_in(tinf.prng_key(3), d).tolist() == [
        tinf.fold_in(tinf.prng_key(3), int(x)) for x in d]


def test_sample_generate_reproducible_and_top_k_one_greedy(gelu):
    tm = gelu[2]
    prompt = np.random.default_rng(5).integers(0, tm.vocab, (2, 4))
    a = tinf.sample_generate(tm, prompt, 6, 42, temperature=1.5)
    assert torch.equal(a, tinf.sample_generate(tm, prompt, 6, 42,
                                               temperature=1.5))
    assert not torch.equal(a, tinf.sample_generate(tm, prompt, 6, 43,
                                                   temperature=1.5))
    greedy, _ = tinf.greedy_generate(tm, prompt, 6)
    assert torch.equal(tinf.sample_generate(tm, prompt, 6, 42, top_k=1),
                       greedy)


# -- validation and unported arguments ---------------------------------------


@pytest.mark.parametrize("kw,exc", [
    (dict(temperature=-1.0), ValueError),
    (dict(top_k=0), ValueError),
    (dict(top_p=0.0), ValueError),
    (dict(min_p=1.5), ValueError),
    (dict(presence_penalty=3.0), ValueError),
    (dict(repetition_penalty=0.0), ValueError),
    (dict(stop=[128]), ValueError),
    (dict(logprobs=3), ValueError),
    (dict(min_tokens=-1), ValueError),
    (dict(logit_bias={}), ValueError),
    (dict(logit_bias={1: 200.0}), ValueError),
    (dict(logit_bias={True: 1.0}), ValueError),
    (dict(prefix=99), ValueError),
])
def test_validation_errors_match_reference(gelu, kw, exc):
    jm, params, tm = gelu
    for eng in (JEngine(jm, params, n_slots=1, logprobs_k=2),
                _port(tm, n_slots=1, logprobs_k=2)):
        with pytest.raises(exc):
            eng.admit([1, 2], **kw)
        assert eng.free_slots() == [0]


def test_engine_level_errors_match_reference(gelu):
    jm, params, tm = gelu
    for mk in (lambda **kw: JEngine(jm, params, **kw),
               lambda **kw: _port(tm, **kw)):
        for kw in (dict(n_slots=0), dict(n_slots=1, chunk="big"),
                   dict(n_slots=1, prefix_chunk=5),
                   dict(n_slots=1, chunk=4, prefix_chunk=8),
                   dict(n_slots=1, logprobs_k=-1)):
            with pytest.raises(ValueError):
                mk(**kw)
        eng = mk(n_slots=1, max_new_tokens=32)
        with pytest.raises(ValueError, match="max_len"):
            eng.admit(list(range(60)))
        eng.admit([1, 2, 3])
        with pytest.raises(RuntimeError, match="no free slots"):
            eng.admit([4, 5])
        with pytest.raises(RuntimeError, match="outstanding"):
            eng.scan_dispatch(1)
            eng.scan_dispatch(1)


class _ModelAxisOf8:
    """A mesh's face with a model axis of 8 ranks: the engine checks the
    heads against it before it makes any collective."""

    mesh_dim_names = ("data", "model")

    def size(self, dim):
        return (1, 8)[dim]

    def get_group(self, axis):
        return None

    def get_local_rank(self, axis):
        return 0


@pytest.mark.parametrize("kw,item", [
    (dict(mesh=_ModelAxisOf8()), "item 6"),
    (dict(draft="ngram"), "item 1b"),
    (dict(grammar=object()), "item 4.2"),
    (dict(kv_paging=True), "item 4.2"),
    (dict(kv_dtype="int8"), "item 4.2"),
])
def test_unported_engine_arguments_raise(gelu, kw, item):
    """Every argument is ported now.  ``mesh`` (item 6) refuses a model
    axis its 4 heads do not divide with ``ValueError`` naming the model
    axis, as the reference's ``test_tp_engine_rejects_unshardable_kv_heads``
    (``tests/test_torch_tp_serving.py`` serves on real meshes); the
    arguments of items 4.2 (grammars, the paged pool, int8 pages) and 1b
    (a draft) build an engine that decodes."""
    if item == "item 6":
        with pytest.raises(ValueError, match="model"):
            _port(gelu[2], n_slots=1, **kw)
        return
    if item == "item 1b":
        eng = _port(gelu[2], n_slots=1, **kw)
        s = eng.admit([1, 2, 3, 1, 2])
        assert eng.spec_ready()
        eng.spec_round()
        assert len(eng.output(s)) >= 2
        assert eng.stats()["spec_rounds"] == 1
        return
    if "grammar" in kw:
        kw = dict(grammar=tgrammar.token_dfa(
            tgrammar.regex_to_dfa("(ab|cd)+e"),
            [bytes([i]) if i else b"" for i in range(CFG["vocab"])], 0))
    eng = _port(gelu[2], n_slots=1, **dict(kw, kv_paging=True))
    s = eng.admit([1, 2, 3], grammar="grammar" in kw)
    eng.run(3)
    assert len(eng.output(s)) == 4


@pytest.mark.parametrize("kw,item", [
    (dict(adapter=0), "item 1b"),
    (dict(grammar=True), "item 4.2"),
    (dict(grammar=0), "item 4.2"),
    (dict(session="conv"), "item 4.2"),
    (dict(prompt_logprobs=2), "item 4.2"),
])
def test_unported_request_arguments_raise(gelu, kw, item):
    """admit's adapter (item 1b) is ported now: on a model without
    adapters it raises ``ValueError`` and leaves the slot free, as the
    reference's does; the request arguments of item 4.2 are ported and
    admit."""
    eng = _port(gelu[2], n_slots=1, logprobs_k=2)
    if item == "item 4.2":
        if "grammar" in kw:
            eng.register_grammar(tgrammar.token_dfa(
                tgrammar.regex_to_dfa("(ab|cd)+e"),
                [bytes([i]) if i else b"" for i in range(CFG["vocab"])], 0))
        s = eng.admit([1, 2, 3], **kw)
        assert eng.output(s) and eng.free_slots() == []
        if "prompt_logprobs" in kw:
            assert len(eng.prompt_logprobs(s)) == 3
        return
    with pytest.raises(ValueError, match="n_adapters"):
        eng.admit([1, 2, 3], **kw)
    assert eng.free_slots() == [0]
    with pytest.raises(ValueError, match="n_adapters"):
        eng.register_prefix([1, 2], adapter=1)


def test_engine_signature_follows_reference():
    """The reference's arguments in its order, less ``params``, then the
    device."""
    ours = list(inspect.signature(ServingEngine).parameters)
    theirs = [n for n in inspect.signature(JEngine).parameters
              if n != "params"]
    assert ours == theirs + ["device"]
    admit = list(inspect.signature(ServingEngine.admit).parameters)
    assert admit == list(inspect.signature(JEngine.admit).parameters)
    assert set(_port_stats()) == set(_reference_stats())


def _port_stats():
    tm = tinf.make_decoder(**CFG, max_len=16, dtype=torch.float32,
                           device="cpu")
    return _port(tm, n_slots=1).stats()


def _reference_stats():
    jm = make_decoder(**CFG, max_len=16, dtype=jnp.float32)
    return JEngine(jm, _init(jm), n_slots=1).stats()


def test_split_admission_and_abort(gelu):
    tm = gelu[2]
    eng = _port(tm, n_slots=2, chunk=4)
    st = eng.begin_admit(PC + PA)
    assert eng.free_slots() == [1] and not st.ready
    while eng.admit_step(st):
        pass
    eng.abort_admit(st)
    assert eng.free_slots() == [0, 1]
    st = eng.begin_admit(PC + PA)
    while eng.admit_step(st):
        pass
    s = eng.finish_admit(st)
    eng.run(4)
    assert eng.output(s) == _solo(tm, PC + PA, 5)


# -- random interleavings against solo oracles -------------------------------


def _rand_request(rnd, vocab):
    prompt = [rnd.randrange(1, vocab) for _ in range(rnd.randint(2, 9))]
    kw = {}
    if rnd.random() < 0.4:
        kw["temperature"] = rnd.choice([0.7, 1.0])
        kw["seed"] = rnd.randrange(1000)
        if rnd.random() < 0.5:
            kw["top_k"] = rnd.choice([8, 32])
    if rnd.random() < 0.3:
        kw["stop"] = [rnd.randrange(1, vocab)]
    if rnd.random() < 0.25:
        kw["min_tokens"] = rnd.randint(1, 3)
    if rnd.random() < 0.15:
        kw["ignore_eos"] = True
    return prompt, kw


@pytest.mark.parametrize("seed", [0, 1])
def test_random_interleavings_match_solo(gelu, seed):
    """Random admits (greedy, seeded sampling, stop ids, min_tokens,
    ignore_eos) under random step / run_scan / release interleavings:
    every retired request equals the same request alone on a one-slot
    engine."""
    tm = gelu[2]
    rnd = random.Random(seed)
    kw_eng = dict(eos_id=0, max_new_tokens=rnd.randint(4, 7), chunk=4,
                  auto_prefix_min=4, fused_decode=bool(seed))
    eng = _port(tm, n_slots=3, **kw_eng)
    live, done = {}, []
    for _ in range(30):
        op = rnd.random()
        if op < 0.4 and eng.free_slots():
            prompt, kw = _rand_request(rnd, tm.vocab)
            live[eng.admit(prompt, **kw)] = (prompt, kw)
        elif op < 0.85 and any(eng.active):
            n = rnd.randint(1, 4)
            if rnd.random() < 0.5 and all(
                    eng.lens[s] + n <= MAX_LEN
                    for s in range(3) if eng.active[s]):
                eng.run_scan(n)
            else:
                eng.step()
        elif live:
            s = rnd.choice(sorted(live))
            if not eng.finished(s):
                eng.release(s)
                live.pop(s)
        for s in [s for s in live if eng.finished(s)]:
            done.append((live.pop(s), eng.output(s),
                         eng.finish_reason(s)))
    assert done
    for (prompt, kw), out, reason in done:
        solo = _port(tm, n_slots=1, **kw_eng)
        s = solo.admit(prompt, **kw)
        solo.run(16)
        assert (solo.output(s), solo.finish_reason(s)) == (out, reason)


# -- the engine benchmark ----------------------------------------------------


def test_bench_serving_engine_mode():
    stats = tbench.run("tiny", False, 2, 3, 6, 32, engine=True,
                       device="cpu")
    for key in ("tokens_per_sec", "tokens_per_sec_per_seq", "batch",
                "steps", "engine"):
        assert key in stats
    assert stats["engine"] is True and stats["batch"] == 2.0
    assert stats["tokens_per_sec"] > 0 and stats["device"] == "cpu"
    with pytest.raises(ValueError, match="budget"):
        tbench.run("tiny", False, 2, 8, 6, 32, engine=True, device="cpu")


def test_scan_boundary_update_matches_reference():
    from tpu_k8s_device_plugin.workloads import inference as jinf

    rng = np.random.default_rng(7)
    S, K = 6, 4
    fin = np.where(rng.random(S) < 0.3, rng.integers(0, 3, S), -1)
    frs = np.where(fin >= 0, rng.integers(1, 4, S), 0)
    args = dict(fin=fin, frs=frs, nxt=rng.integers(0, 5, S), i=3,
                eos_vec=np.where(rng.random(S) < 0.5, 2, -1),
                stop_mat=np.where(rng.random((S, K)) < 0.4,
                                  rng.integers(0, 5, (S, K)), -1),
                emitted0=rng.integers(0, 5, S), budget=7)
    want = jinf.scan_boundary_update(**{
        k: jnp.asarray(v, jnp.int32) for k, v in args.items()})
    got = tinf.scan_boundary_update(**{
        k: torch.as_tensor(v, dtype=torch.int64) for k, v in args.items()})
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_resolve_chunk_matches_reference():
    from tpu_k8s_device_plugin.workloads import serving as jserve

    for max_len in (7, 16, 64, 100, 2048, 8192):
        for cap in (32, 128):
            assert tserve._resolve_chunk(max_len, cap) == \
                jserve._resolve_chunk(max_len, cap)
