"""The port's paged KV engine against the JAX package's.

The decoder of tests/test_kv_paging.py (vocab 96, d_model 64, 4 heads,
2 layers, max_len 64, f32), initialised by JAX and converted, serves
the same request traces on three engines: the reference's with
``kv_paging=True``, the port's with it, and the port's contiguous one.
Greedy ids, finish reasons and the pool's counters equal the
reference's; every stream (seeded sampled ones too) of the paged port
equals its contiguous port.  Then the pool's mechanics on the port:
page sharing and copy-on-write, exhaustion at ``begin_admit``, parked
donors reclaimed under pressure, the prefix registry's LRU cap, int8
rows, the constructor's messages, the allocator's integrity under a
random trace, and scratch rows that hold large values."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_k8s_device_plugin.workloads import grammar as jg
from tpu_k8s_device_plugin.workloads.inference import make_decoder
from tpu_k8s_device_plugin.workloads.kv_pool import (
    PagePoolExhausted as JExhausted,
)
from tpu_k8s_device_plugin.workloads.serving import ServingEngine as JEngine
from tpu_k8s_device_plugin_torch.convert import params_from_jax
from tpu_k8s_device_plugin_torch.workloads import grammar as tg
from tpu_k8s_device_plugin_torch.workloads import inference as tinf
from tpu_k8s_device_plugin_torch.workloads.kv_pool import PagePoolExhausted
from tpu_k8s_device_plugin_torch.workloads.serving import ServingEngine

CFG = dict(vocab=96, d_model=64, n_heads=4, n_layers=2, d_ff=128)
EOS = 0
MAX_LEN = 64
PATTERN = "(AB|CD)+E"
TB = [bytes([i]) if i else b"" for i in range(CFG["vocab"])]


@pytest.fixture(scope="module")
def setup():
    jm = make_decoder(**CFG, max_len=MAX_LEN, dtype=jnp.float32)
    tokens = jnp.zeros((1, 8), jnp.int32)
    pos = jnp.broadcast_to(jnp.arange(8, dtype=jnp.int32), (1, 8))
    params = jm.init(jax.random.PRNGKey(0), tokens, pos)["params"]
    tm = tinf.make_decoder(**CFG, max_len=MAX_LEN, dtype=torch.float32,
                           device="cpu")
    tm.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, tm


def _kw(kw):
    return dict(n_slots=kw.pop("n_slots", 3), chunk=8,
                eos_id=kw.pop("eos_id", None),
                max_new_tokens=kw.pop("max_new", 6), auto_prefix_min=4,
                **kw)


def _ref(setup, paged=True, **kw):
    jm, params, _ = setup
    return JEngine(jm, params, kv_paging=paged, **_kw(kw))


def _port(setup, paged=True, **kw):
    return ServingEngine(setup[2], kv_paging=paged, device="cpu", **_kw(kw))


def _drain(eng, trace):
    """A trace of admit kwargs through the engine with slot recycling;
    returns the outputs in trace order."""
    out = [None] * len(trace)
    live = {}
    i = 0
    while i < len(trace) or live:
        while i < len(trace) and eng.free_slots():
            s = eng.admit(**trace[i])
            live[s] = i
            i += 1
        eng.step()
        for s in list(live):
            if eng.finished(s):
                out[live.pop(s)] = (eng.output(s), eng.finish_reason(s))
    return out


GREEDY = [
    dict(prompt=list(range(1, 13))),
    dict(prompt=[5, 6, 7, 8, 9], stop=[41]),
    dict(prompt=list(range(1, 13))),                  # exact repeat
    dict(prompt=list(range(40, 56)) + [88, 89, 90]),  # partial prefix
    dict(prompt=list(range(1, 13)), logit_bias={4: 5.0, 9: -4.0}),
    dict(prompt=[70, 71, 72, 73], min_tokens=3, stop=[71]),
]
SAMPLED = [
    dict(prompt=list(range(40, 60)), temperature=0.8, seed=7),
    dict(prompt=[5, 6, 7, 8, 9], temperature=0.5, seed=3,
         presence_penalty=0.4, frequency_penalty=0.2),
    dict(prompt=[11] * 9, repetition_penalty=1.3, temperature=0.6, seed=5),
    dict(prompt=list(range(40, 60)), temperature=0.9),
]
POOL_KEYS = ("kv_pages", "kv_pages_free", "kv_pages_shared",
             "kv_page_size", "kv_cow_copies", "kv_preemptions",
             "kv_sessions_parked", "prefix_cache_hits",
             "prefix_reused_tokens", "prefix_evictions", "prefill_tokens",
             "decode_steps", "tokens_emitted", "finished_requests")


def _pool_stats(eng):
    st = eng.stats()
    return {k: st.get(k) for k in POOL_KEYS}


def test_step_paths_equal_reference_and_contiguous(setup):
    ref, port = _ref(setup), _port(setup)
    want, got = _drain(ref, GREEDY), _drain(port, GREEDY)
    assert got == want
    assert _pool_stats(port) == _pool_stats(ref)
    assert port._pool.tables.tolist() == ref._pool.tables.tolist()
    assert _drain(_port(setup, paged=False), GREEDY) == got
    mixed = GREEDY[:2] + SAMPLED + GREEDY[2:]
    assert _drain(_port(setup), mixed) == _drain(_port(setup, False), mixed)
    port._pool.check()


@pytest.mark.parametrize("fused", [False, True])
def test_run_scan_windows_equal_reference_and_contiguous(setup, fused):
    def scan_drain(eng, sampled):
        s1 = eng.admit(list(range(1, 10)))
        s2 = (eng.admit(list(range(20, 28)), temperature=0.9, seed=11,
                        top_p=0.9) if sampled
              else eng.admit(list(range(20, 28)), stop=[33]))
        outs = [dict(eng.run_scan(4)) for _ in range(3)]
        return outs, eng.output(s1), eng.output(s2), _pool_stats(eng)

    kw = dict(max_new=16, n_slots=2, fused_decode=fused)
    assert (scan_drain(_port(setup, **kw), False)
            == scan_drain(_ref(setup, **kw), False))
    assert (scan_drain(_port(setup, **kw), True)[:3]
            == scan_drain(_port(setup, False, **kw), True)[:3])


def test_grammar_paged_equals_reference_and_contiguous(setup):
    def run(eng):
        s = eng.admit([65, 66], grammar=True)
        u = eng.admit([5, 9, 3])
        while any(eng.active):
            eng.step()
        return eng.output(s), eng.finish_reason(s), eng.output(u)

    jd = jg.token_dfa(jg.regex_to_dfa(PATTERN), TB, eos_id=EOS)
    td = tg.token_dfa(tg.regex_to_dfa(PATTERN), TB, eos_id=EOS)
    want = run(_ref(setup, grammar=jd, eos_id=EOS, max_new=10))
    got = run(_port(setup, grammar=td, eos_id=EOS, max_new=10))
    assert got == want
    assert run(_port(setup, False, grammar=td, eos_id=EOS,
                     max_new=10)) == got


def test_oversubscription_beats_full_reservation(setup):
    """A pool sized for 2 full-length reservations holds 4 concurrent
    shared-prefix requests, with the contiguous engine's ids."""
    prefix = list(range(1, 33))
    engines = (_port(setup, n_slots=4, max_new=8, kv_pages=16),
               _ref(setup, n_slots=4, max_new=8, kv_pages=16),
               _port(setup, False, n_slots=4, max_new=8))
    outs = []
    for eng in engines:
        slots = [eng.admit(prefix + [60 + i, 70 + i]) for i in range(4)]
        assert sum(eng.active) == 4
        eng.run(12)
        outs.append([eng.output(s) for s in slots])
    assert outs[0] == outs[1] == outs[2]
    assert engines[0].stats()["kv_pages_shared"] > 0
    assert _pool_stats(engines[0]) == _pool_stats(engines[1])
    engines[0]._pool.check()


def test_exact_repeat_shares_pages_and_cow_fires(setup):
    p = list(range(1, 12))  # t_p 11: a partial tail page, copied on append
    engines = (_port(setup), _ref(setup))
    trails = []
    for eng in engines:
        a = eng.admit(p)
        b = eng.admit(p)   # the donor stays busy: shared, not in place
        shared = eng.stats()["kv_pages_shared"]
        cow = eng._pool.cow_copies
        eng.step()
        trails.append((shared, eng._pool.cow_copies - cow,
                       _pool_stats(eng)))
        eng.run(10)
        trails.append((eng.output(a), eng.output(b), _pool_stats(eng)))
    assert trails[:2] == trails[2:]
    assert trails[0][0] > 0 and trails[0][1] > 0
    assert trails[1][0] == trails[1][1]
    engines[0]._pool.check()


def test_pool_exhaustion_raises_at_begin(setup):
    port, ref = (_port(setup, max_new=4, kv_pages=8),
                 _ref(setup, max_new=4, kv_pages=8))
    messages = []
    for eng, exc in ((port, PagePoolExhausted), (ref, JExhausted)):
        eng.admit(list(range(1, 30)))
        eng.admit(list(range(40, 64)))
        before = (eng.free_slots(), eng._pool.tables.copy(),
                  eng._pool.free_pages())
        with pytest.raises(exc) as err:
            eng.begin_admit(list(range(60, 90)))
        messages.append(str(err.value))
        assert eng.free_slots() == before[0]
        assert np.array_equal(eng._pool.tables, before[1])
        eng.run(6)
    assert ([port.output(s) for s in (0, 1)]
            == [ref.output(s) for s in (0, 1)])
    assert messages[0] == messages[1]
    port._pool.check()


def test_full_pool_still_shares_exact_repeats(setup):
    eng = _port(setup, max_new=4, kv_pages=8)
    eng.admit(list(range(1, 60)))        # 8 pages: the whole pool
    eng.admit(list(range(1, 60)))        # shares all 8 by reference
    assert sum(eng.active) == 2
    assert eng.stats()["kv_pages_shared"] == 8
    with pytest.raises(PagePoolExhausted):
        eng.admit(list(range(2, 61)))    # cold: no pages left
    eng._pool.check()


def test_parked_donor_pages_reclaimed_under_pressure(setup):
    outs = []
    for eng in (_port(setup, n_slots=2, max_new=4, kv_pages=10),
                _ref(setup, n_slots=2, max_new=4, kv_pages=10)):
        s1 = eng.admit(list(range(1, 25)))
        eng.run(8)
        eng.release(s1)
        assert eng._pool.used_pages() > 0    # the parked donor pins pages
        s2 = eng.admit(list(range(5, 60)))   # needs more than are free
        eng.run(6)
        outs.append((eng.output(s1), eng.output(s2), _pool_stats(eng)))
    assert outs[0] == outs[1]
    assert outs[0][2]["prefix_evictions"] >= 1


def test_prefix_registry_lru_cap(setup):
    def run(eng):
        h1 = eng.register_prefix(list(range(1, 9)))
        h2 = eng.register_prefix(list(range(10, 18)))
        eng.admit(list(range(1, 9)) + [50], prefix=h1)   # h2 is the LRU
        h3 = eng.register_prefix(list(range(20, 28)))
        st = eng.stats()
        with pytest.raises(ValueError, match="unknown prefix"):
            eng.admit(list(range(10, 18)) + [51], prefix=h2)
        return (st["registered_prefixes"], st["prefix_evictions"],
                sorted(eng._prefixes), h1, h3)

    kw = dict(n_slots=2, max_new=4, prefix_registry_max=2)
    assert run(_port(setup, **kw)) == run(_ref(setup, **kw)) == \
        (2, 1, [0, 2], 0, 2)


def _first_logits(eng):
    """The logits of the engine's next decode step, computed on a copy
    of its cache (the engine is not advanced)."""
    cache = {n: {k: t.clone() for k, t in layer.items()}
             for n, layer in eng.cache.items()}
    tok = torch.as_tensor(eng.last_token, dtype=torch.int64)[:, None]
    pos = torch.as_tensor(np.asarray(eng.lens, np.int32))[:, None]
    return eng._pmodel(tok, pos, cache, decode=True,
                       block_tables=eng._bt())[:, -1]


def test_int8_pool_equals_reference_and_stays_close(setup):
    """int8 rows are the lossy option: the port's ids equal the JAX int8
    engine's, and its first-step logits stay within the reference's
    quantized-decode tolerance (atol 0.1, rtol 0.1; tests/
    test_inference.py) of the full-precision pool's."""
    trace = GREEDY[:4]
    port = _port(setup, max_new=6, kv_dtype="int8")
    assert _drain(port, trace) == _drain(_ref(setup, max_new=6,
                                              kv_dtype="int8"), trace)
    q8, f32 = _port(setup, kv_dtype="int8"), _port(setup)
    for eng in (q8, f32):
        eng.admit(list(range(1, 12)))
        eng.admit(list(range(30, 52)))
    np.testing.assert_allclose(_first_logits(q8)[:2].numpy(),
                               _first_logits(f32)[:2].numpy(),
                               atol=0.1, rtol=0.1)
    s1 = q8.admit(list(range(1, 12)))    # shares int8 pages, then CoW
    q8.run(10)
    assert q8.output(s1) == q8.output(0)
    assert q8.cache["block_0"]["cached_k"].dtype == torch.int8
    q8._pool.check()


@pytest.mark.parametrize("kw", [
    dict(kv_page_size=7), dict(kv_page_size=16), dict(kv_dtype="fp8"),
    dict(kv_pages=3), dict(chunk=None),
], ids=["page-7", "page-16", "fp8", "pages-3", "unchunked"])
def test_constructor_messages_equal_reference(setup, kw):
    def message(build):
        with pytest.raises(ValueError) as err:
            build()
        return str(err.value)

    jm, params, tm = setup
    base = dict(n_slots=3, chunk=8, kv_paging=True)
    base.update(kw)
    assert message(lambda: ServingEngine(tm, device="cpu", **base)) == \
        message(lambda: JEngine(jm, params, **base))


def test_trace_fuzz_keeps_the_pool_whole(setup):
    """A long mixed trace through the paged engine, then the allocator
    oracle: nothing leaked, nothing freed twice, and a full drain
    returns every page."""
    seed = int(os.environ.get("ENGINE_FUZZ_SEED", "0") or 0)
    rng = np.random.RandomState(777 + seed)
    eng = _port(setup, max_new=4, kv_pages=18)
    live = []
    for _ in range(60):
        op = rng.randint(3)
        if op == 0 and eng.free_slots():
            base = int(rng.randint(1, 50))
            n = int(rng.randint(4, 20))
            try:
                live.append(eng.admit(list(range(base, base + n)),
                                      temperature=float(rng.rand()),
                                      seed=int(rng.randint(100))))
            except PagePoolExhausted:
                pass
        elif op == 1 and any(eng.active):
            eng.step()
        elif op == 2 and live:
            eng.release(live.pop(int(rng.randint(len(live)))))
        for s in list(live):
            if eng.finished(s):
                live.remove(s)
        eng._pool.check()
    for s in list(live):
        eng.release(s)
    eng._pool.check()


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_large_finite_scratch_rows_do_not_move_ids(setup, kv_dtype):
    """Masked rows of the gathered view come from the scratch page and
    from stale pages: their softmax weight is exactly 0, so large finite
    values there change nothing."""
    outs = []
    for fill in (None, 1e30):
        eng = _port(setup, max_new=12, kv_dtype=kv_dtype)
        if fill is not None:
            for layer in eng.cache.values():
                for key in ("cached_k", "cached_v", "k_scale", "v_scale"):
                    if key in layer:
                        t = layer[key]
                        t[-1] = (fill if t.is_floating_point() else 127)
        outs.append(_drain(eng, GREEDY[:3]))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("call,item", [
    ("spec_round", "item 1b"),
    ("adapter", "item 1b"),
], ids=["spec_round", "adapter"])
def test_lora_spec_and_scheduler_paths_raise(setup, call, item):
    """tests/test_kv_paging.py's LoRA and n-gram speculative cases
    (ROADMAP item 1b, ported now): the paged engine gives the contiguous
    engine's ids and the JAX paged engine's (its packed-prefill and
    scheduler cases run on the port in tests/test_torch_scheduler.py)."""
    jm, params, _ = setup
    if call == "spec_round":
        def run(make, paged):
            eng = make(paged)
            a = eng.admit([7, 8, 9, 7, 8, 9, 7, 8])
            b = eng.admit(list(range(30, 40)))
            while any(eng.active):
                eng.spec_round()
            return eng.output(a), eng.output(b), eng.stats()["spec_rounds"]

        kw = dict(n_slots=2, chunk=8, max_new_tokens=10, draft="ngram",
                  gamma=3, auto_prefix_min=4)
        got = run(lambda p: ServingEngine(setup[2], kv_paging=p,
                                          device="cpu", **kw), True)
        assert got == run(lambda p: ServingEngine(
            setup[2], kv_paging=p, device="cpu", **kw), False)
        assert got == run(lambda p: JEngine(jm, params, kv_paging=p, **kw),
                          True)
        assert got[2] >= 1
        return
    from tpu_k8s_device_plugin.workloads.inference import attach_lora

    jl = make_decoder(**CFG, max_len=MAX_LEN, dtype=jnp.float32,
                      n_adapters=2)
    lparams = jax.tree_util.tree_map(
        np.asarray, attach_lora(params, jl, jax.random.PRNGKey(3)))
    tl = tinf.make_decoder(**CFG, max_len=MAX_LEN, dtype=torch.float32,
                           n_adapters=2, device="cpu")
    tl.load_state_dict(params_from_jax(lparams))

    def run(eng):
        a = eng.admit(list(range(1, 10)), adapter=0)
        b = eng.admit(list(range(1, 10)), adapter=1)
        while any(eng.active):
            eng.step()
        return eng.output(a), eng.output(b)

    kw = dict(n_slots=2, chunk=8, max_new_tokens=6, auto_prefix_min=4)
    got = run(ServingEngine(tl, kv_paging=True, device="cpu", **kw))
    assert got == run(ServingEngine(tl, kv_paging=False, device="cpu", **kw))
    assert got == run(JEngine(jl, lparams, kv_paging=True, **kw))
