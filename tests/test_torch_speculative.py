"""The port's speculative decoding against the JAX package's, on the CPU,
in f32.

Mirrors tests/test_speculative.py and tests/test_spec_engine.py.  The
target and the draft are initialised by JAX and converted with
``convert.params_from_jax``.  ``speculative_generate`` gives the JAX
``speculative_generate``'s ids and accept rate, which are plain greedy's,
at every gamma, with the target as its own draft (accept rate 1.0) and
with a garbage draft.  The engine's ``spec_round`` (a draft model or
prompt-lookup n-grams) gives each slot the ids of greedy decoding and of
the JAX engine through a stop mid-round, cache exhaustion, admission
between rounds, prefix donors and the donor bound; the guards refuse
what the reference refuses; the port's server serves n-gram spec
through the scheduler's spec branch."""

import http.client
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_k8s_device_plugin.workloads import inference as jinf
from tpu_k8s_device_plugin.workloads import serving as jserving
from tpu_k8s_device_plugin.workloads import speculative as jspec
from tpu_k8s_device_plugin.workloads.serving import (
    _ngram_propose as jngram,
)
from tpu_k8s_device_plugin_torch.convert import params_from_jax
from tpu_k8s_device_plugin_torch.workloads import inference as tinf
from tpu_k8s_device_plugin_torch.workloads import llama as tllama
from tpu_k8s_device_plugin_torch.workloads import serving as tserving
from tpu_k8s_device_plugin_torch.workloads import speculative as tspec
from tpu_k8s_device_plugin_torch.workloads.serving import (
    _ngram_propose as tngram,
)

TARGET_CFG = dict(vocab=96, d_model=64, n_heads=4, n_layers=2, d_ff=128)
DRAFT_CFG = dict(vocab=96, d_model=32, n_heads=2, n_layers=1, d_ff=64)
MAX_LEN = 96


def _init(model, seed):
    tokens = jnp.zeros((1, 8), jnp.int32)
    pos = jnp.broadcast_to(jnp.arange(8, dtype=jnp.int32), (1, 8))
    return jax.tree_util.tree_map(
        np.asarray, model.init(jax.random.PRNGKey(seed), tokens,
                               pos)["params"])


def _port(cfg, params, max_len=MAX_LEN, **kw):
    model = tinf.make_decoder(**cfg, max_len=max_len, dtype=torch.float32,
                              device="cpu", **kw)
    model.load_state_dict(params_from_jax(params))
    return model


@pytest.fixture(scope="module")
def models():
    jt = jinf.make_decoder(**TARGET_CFG, max_len=MAX_LEN,
                           dtype=jnp.float32)
    jd = jinf.make_decoder(**DRAFT_CFG, max_len=MAX_LEN, dtype=jnp.float32)
    tp, dp = _init(jt, 0), _init(jd, 1)
    return (jt, tp, _port(TARGET_CFG, tp)), (jd, dp, _port(DRAFT_CFG, dp))


def _oracle(jt, tp, prompt, n):
    out, _ = jinf.greedy_generate(jt, tp, jnp.asarray([prompt], jnp.int32),
                                  n)
    return np.asarray(out)[0].tolist()


@pytest.mark.parametrize("gamma", [1, 2, 4, 7])
def test_ids_equal_reference_and_greedy_any_gamma(models, gamma):
    (jt, tp, tt), (jd, dp, td) = models
    prompt = [5, 17, 3, 70, 2, 41]
    got, rate = tspec.speculative_generate(tt, td, prompt, n_steps=12,
                                           gamma=gamma)
    want, jrate = jspec.speculative_generate(jt, tp, jd, dp, prompt,
                                             n_steps=12, gamma=gamma)
    assert got.dtype == torch.int32
    assert got.tolist() == np.asarray(want).tolist()
    assert got.tolist() == _oracle(jt, tp, prompt, 12)
    assert rate == jrate and 0.0 <= rate <= 1.0


def test_exact_when_draft_is_target(models):
    (jt, tp, tt), _ = models
    prompt = [9, 1, 44, 23]
    got, rate = tspec.speculative_generate(tt, tt, prompt, n_steps=10,
                                           gamma=4)
    assert got.tolist() == _oracle(jt, tp, prompt, 10)
    assert rate == 1.0


def test_exact_when_draft_is_garbage(models):
    (jt, tp, tt), (jd, _, _) = models
    garbage = _port(DRAFT_CFG, _init(jd, 1234))
    prompt = [9, 1, 44, 23, 8]
    got, _ = tspec.speculative_generate(tt, garbage, prompt, n_steps=9,
                                        gamma=3)
    assert got.tolist() == _oracle(jt, tp, prompt, 9)


def test_n_steps_not_multiple_of_window(models):
    (jt, tp, tt), (_, _, td) = models
    for n in (1, 2, 5, 11):
        got, _ = tspec.speculative_generate(tt, td, [2, 2, 7], n_steps=n,
                                            gamma=4)
        assert got.tolist() == _oracle(jt, tp, [2, 2, 7], n)


def test_llama_gqa_speculative():
    """A GQA/SwiGLU target with a multi-head draft."""
    from tpu_k8s_device_plugin.workloads import llama as jllama

    cfg = jllama.TINY_LLAMA
    jt = jllama.decoder(cfg, dtype=jnp.float32, max_len=96)
    tp = _init(jt, 7)
    tt = tllama.decoder(tllama.TINY_LLAMA, max_len=96, dtype=torch.float32,
                        device="cpu")
    tt.load_state_dict(params_from_jax(tp))
    dcfg = dict(vocab=cfg.vocab, d_model=32, n_heads=2, n_layers=1,
                d_ff=64)
    dp = _init(jinf.make_decoder(**dcfg, max_len=96, dtype=jnp.float32), 8)
    got, _ = tspec.speculative_generate(tt, _port(dcfg, dp), [3, 200, 100,
                                                               50],
                                        n_steps=8, gamma=3)
    assert got.tolist() == _oracle(jt, tp, [3, 200, 100, 50], 8)


def test_max_len_guard(models):
    (_, _, tt), (_, _, td) = models
    with pytest.raises(ValueError, match="max_len"):
        tspec.speculative_generate(tt, td, list(range(90)), n_steps=10,
                                   gamma=2)
    with pytest.raises(ValueError, match="gamma"):
        tspec.speculative_generate(tt, td, [1, 2], n_steps=4, gamma=0)


# -- the engine ----------------------------------------------------------


def _engines(models, max_len=MAX_LEN, draft="model", **kw):
    """(JAX engine, port engine) over the same weights; *draft* "model",
    "ngram" or "target"."""
    (jt, tp, _), (jd, dp, _) = models
    if max_len != MAX_LEN:
        jt = jinf.make_decoder(**TARGET_CFG, max_len=max_len,
                               dtype=jnp.float32)
        jd = jinf.make_decoder(**DRAFT_CFG, max_len=max_len,
                               dtype=jnp.float32)
    tt = _port(TARGET_CFG, tp, max_len)
    jdraft, tdraft = {"model": ((jd, dp), _port(DRAFT_CFG, dp, max_len)),
                      "ngram": ("ngram", "ngram"),
                      "target": ((jt, tp), tt)}[draft]
    return (jserving.ServingEngine(jt, tp, draft=jdraft, **kw),
            tserving.ServingEngine(tt, draft=tdraft, device="cpu", **kw))


def _both(engines, prompts, rounds, **admit_kw):
    out = []
    for eng in engines:
        slots = [eng.admit(p, **admit_kw) for p in prompts]
        eng.run_spec(rounds)
        out.append([eng.output(s) for s in slots])
    return out


@pytest.mark.parametrize("draft", ["model", "ngram"])
def test_spec_rounds_match_plain_greedy_and_reference(models, draft):
    (jt, tp, _), _ = models
    engines = _engines(models, draft=draft, n_slots=2, max_new_tokens=9,
                       gamma=3, ngram_n=2)
    pa, pb = [5, 17, 3, 5, 17, 3, 5, 17], [11, 2, 9]
    want, got = _both(engines, [pa, pb], 12)
    assert got == want
    assert got == [_oracle(jt, tp, pa, 9), _oracle(jt, tp, pb, 9)]
    jeng, teng = engines
    st = teng.stats()
    assert 1 <= st["spec_rounds"] < 9
    assert st["spec_proposed"] >= st["spec_accepted"] >= 0
    for key in ("spec_rounds", "spec_proposed", "spec_accepted"):
        assert st[key] == jeng.stats()[key], key
    assert teng.accept_rate == jeng.accept_rate


def test_draft_equals_target_accepts_everything(models):
    (jt, tp, _), _ = models
    _, eng = _engines(models, draft="target", n_slots=1, max_new_tokens=8,
                      gamma=3)
    s = eng.admit([5, 17, 3, 70])
    eng.run_spec(8)
    assert eng.output(s) == _oracle(jt, tp, [5, 17, 3, 70], 8)
    assert eng.accept_rate == 1.0
    assert eng.stats()["spec_rounds"] == 2


def test_stop_token_mid_round(models):
    (jt, tp, tt), _ = models
    prompt = [5, 17, 3, 70]
    stop = _oracle(jt, tp, prompt, 8)[4]
    plain = tserving.ServingEngine(tt, n_slots=1, max_new_tokens=8,
                                   device="cpu")
    sp = plain.admit(prompt, stop=[stop])
    plain.run(10)
    (want,), (got,) = _both(_engines(models, n_slots=1, max_new_tokens=8,
                                     gamma=4), [prompt], 10, stop=[stop])
    assert got == want == plain.output(sp)
    assert plain.finish_reason(sp) == "stop"


def test_cache_exhaustion_matches_plain(models):
    (_, tp, _), _ = models
    prompt = [5, 17, 3, 70]
    plain = tserving.ServingEngine(_port(TARGET_CFG, tp, 16), n_slots=1,
                                   device="cpu")
    sp = plain.admit(prompt)
    plain.run(20)
    engines = _engines(models, max_len=16, n_slots=1, gamma=3)
    (want,), (got,) = _both(engines, [prompt], 20)
    assert got == want == plain.output(sp)
    assert engines[1].finish_reason(0) == "length"


def test_admission_between_rounds(models):
    (jt, tp, _), _ = models
    pa, pb = [5, 17, 3, 70], [11, 2, 9, 44, 8]
    outs = []
    for eng in _engines(models, n_slots=2, max_new_tokens=7, gamma=3):
        sa = eng.admit(pa)
        eng.spec_round()
        sb = eng.admit(pb)
        eng.run_spec(10)
        outs.append((eng.output(sa), eng.output(sb)))
    assert outs[1] == outs[0] == (_oracle(jt, tp, pa, 7),
                                  _oracle(jt, tp, pb, 7))


def test_spec_with_auto_prefix_and_released_donor(models):
    """A borrower reuses the target's prompt rows (the draft prefills
    cold), and a released donor's rows survive other slots' rounds."""
    (jt, tp, _), _ = models
    shared = [7, 3, 9, 12, 5, 8, 1, 2]
    pa = shared + [5, 9]
    outs = []
    for eng in _engines(models, n_slots=2, chunk=4, auto_prefix_min=4,
                        gamma=3):
        stop_a = _oracle(jt, tp, pa, 8)[2]
        eng.admit([44, 61, 20])
        sa = eng.admit(pa, stop=[stop_a])
        eng.run_spec(8)
        assert eng.finished(sa) and eng.finish_reason(sa) == "stop"
        eng.release(sa)
        for _ in range(3):
            eng.spec_round()
        before = eng.stats()["prefix_cache_hits"]
        sc = eng.admit(shared + [44])
        assert eng.stats()["prefix_cache_hits"] == before + 1
        for _ in range(3):
            eng.spec_round()
        got = eng.output(sc)
        assert len(got) >= 4
        assert got == _oracle(jt, tp, shared + [44], len(got))
        outs.append(got)
    assert outs[0] == outs[1]


def test_spec_donor_bound_rejects_long_prompts(models):
    (_, tp, _), (_, dp, _) = models
    tt, td = _port(TARGET_CFG, tp, 16), _port(DRAFT_CFG, dp, 16)
    eng = tserving.ServingEngine(tt, n_slots=1, draft=td, gamma=3,
                                 device="cpu")
    s = eng.admit(list(range(1, 13)))  # the bound: 16 - 3 - 1 = 12
    eng.release(s)
    with pytest.raises(ValueError, match="donor bound"):
        eng.admit(list(range(1, 14)))
    eng2 = tserving.ServingEngine(tt, n_slots=1, draft="ngram", gamma=3,
                                  device="cpu")
    with pytest.raises(ValueError, match="donor bound"):
        eng2.admit(list(range(1, 14)))
    eng3 = tserving.ServingEngine(tt, n_slots=1, draft="ngram", gamma=3,
                                  auto_prefix=False, device="cpu")
    s3 = eng3.admit(list(range(1, 14)))
    eng3.run_spec(6)
    assert len(eng3.output(s3)) >= 1


def test_guards(models):
    """Greedy only; a proposer needed; the draft's max_len, vocab and
    gamma checked; spec_ready is the scheduler's predicate."""
    (_, tp, tt), (jd, dp, td) = models
    eng = tserving.ServingEngine(tt, n_slots=1, draft=td, device="cpu")
    assert eng.spec_ready()  # a draft, and no knob armed
    eng.admit([5, 17, 3], temperature=0.8)
    assert not eng.spec_ready()
    with pytest.raises(ValueError, match="greedy-only"):
        eng.spec_round()
    plain = tserving.ServingEngine(tt, n_slots=1, device="cpu")
    plain.admit([5, 17, 3])
    assert not plain.spec_ready()
    with pytest.raises(RuntimeError, match="draft"):
        plain.spec_round()
    short = _port(DRAFT_CFG, dp, MAX_LEN // 2)
    with pytest.raises(ValueError, match="max_len"):
        tserving.ServingEngine(tt, n_slots=1, draft=short, device="cpu")
    with pytest.raises(ValueError, match="gamma"):
        tserving.ServingEngine(tt, n_slots=1, draft=td, gamma=0,
                               device="cpu")
    wide = _port(dict(DRAFT_CFG, vocab=128), _init(jinf.make_decoder(
        **dict(DRAFT_CFG, vocab=128), max_len=MAX_LEN,
        dtype=jnp.float32), 3))
    with pytest.raises(ValueError, match="vocab"):
        tserving.ServingEngine(tt, n_slots=1, draft=wide, device="cpu")
    with pytest.raises(ValueError, match="ngram_n"):
        tserving.ServingEngine(tt, n_slots=1, draft="ngram", ngram_n=0,
                               device="cpu")
    # the reference's (model, params) pair is taken, its params ignored
    pair = tserving.ServingEngine(tt, n_slots=1, draft=(td, dp),
                                  device="cpu")
    pair.admit([5, 17, 3])
    assert pair.spec_ready()


@pytest.mark.parametrize("seq,n,g", [
    ([9, 1, 2, 3, 7, 8, 4, 1, 2, 3], 3, 3),
    ([1, 2, 5, 0, 1, 2, 6, 0, 1, 2], 2, 1),
    ([1, 2, 7, 1, 2], 2, 3),
    ([1, 2, 3, 4], 2, 2),
    ([5], 3, 2),
    ([4, 4, 4, 4, 4], 2, 4),
])
def test_ngram_propose_units(seq, n, g):
    seq = np.asarray(seq, np.int32)
    got = tngram(seq, n, g)
    assert got.tolist() == jngram(seq, n, g).tolist()
    assert got.dtype == np.int32 and got.shape == (g,)


def test_ngram_propose_known_answers():
    seq = np.asarray([9, 1, 2, 3, 7, 8, 4, 1, 2, 3], np.int32)
    assert tngram(seq, 3, 3).tolist() == [7, 8, 4]
    seq = np.asarray([1, 2, 5, 0, 1, 2, 6, 0, 1, 2], np.int32)
    assert tngram(seq, 2, 1).tolist() == [6]
    assert tngram(np.asarray([1, 2, 7, 1, 2], np.int32), 2, 3).tolist() \
        == [7, 1, 2]
    assert tngram(np.asarray([1, 2, 3, 4], np.int32), 2, 2).tolist() == \
        [4, 4]


def test_ngram_spec_server(models):
    """The port's server over an n-gram engine: the scheduler takes its
    spec branch, the answer is plain greedy's, and /metrics renders the
    spec counters."""
    from tpu_k8s_device_plugin_torch.workloads.server import EngineServer

    (jt, tp, tt), _ = models
    eng = tserving.ServingEngine(tt, n_slots=2, draft="ngram", gamma=3,
                                 device="cpu")
    srv = EngineServer(eng, max_new_tokens=6, window=4)
    srv.start(host="127.0.0.1", port=0)
    try:
        c = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=120)
        c.request("POST", "/generate", json.dumps(
            {"tokens": [5, 17, 3, 70], "stream": False}),
            {"Content-Type": "application/json"})
        ev = json.loads(c.getresponse().read().decode().strip()
                        .splitlines()[0])
        assert ev["tokens"] == _oracle(jt, tp, [5, 17, 3, 70], 6)
        assert eng.stats()["spec_rounds"] >= 1
        c2 = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
        c2.request("GET", "/metrics")
        body = c2.getresponse().read().decode()
        assert "tpu_serving_spec_rounds" in body
        assert "tpu_serving_tokens_emitted" in body
    finally:
        srv.stop()
