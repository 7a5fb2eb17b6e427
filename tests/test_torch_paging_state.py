"""Checkpoints of the port's paged engine: preemption, sessions and the
``migrate`` codec, held against the JAX package.

The decoder of tests/test_kv_paging.py (vocab 96, d_model 64, 4 heads,
2 layers, max_len 64, f32, and a bf16 copy of it), initialised by JAX and
converted.  A preempted and resumed request finishes with the ids of an
uninterrupted run (seeded sampled ones too: the port's own invariant);
the state carries the reference's keys; a JAX checkpoint resumes in the
port and a port checkpoint in the JAX engine, f32 and int8, through each
package's codec; a bf16 checkpoint's payload bytes are the reference's;
sessions park, demote, resume and go as the reference's do; prompt
logprobs equal the reference's."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tpu_k8s_device_plugin.workloads import migrate as jmig
from tpu_k8s_device_plugin.workloads.inference import make_decoder
from tpu_k8s_device_plugin.workloads.serving import ServingEngine as JEngine
from tpu_k8s_device_plugin_torch.convert import params_from_jax
from tpu_k8s_device_plugin_torch.workloads import inference as tinf
from tpu_k8s_device_plugin_torch.workloads import migrate as tmig
from tpu_k8s_device_plugin_torch.workloads.kv_pool import PagePoolExhausted
from tpu_k8s_device_plugin_torch.workloads.serving import ServingEngine

CFG = dict(vocab=96, d_model=64, n_heads=4, n_layers=2, d_ff=128)
MAX_LEN = 64
A, B = list(range(1, 10)), list(range(30, 40))


@pytest.fixture(scope="module")
def setup():
    jm = make_decoder(**CFG, max_len=MAX_LEN, dtype=jnp.float32)
    tokens = jnp.zeros((1, 8), jnp.int32)
    pos = jnp.broadcast_to(jnp.arange(8, dtype=jnp.int32), (1, 8))
    params = jm.init(jax.random.PRNGKey(0), tokens, pos)["params"]
    tree = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    models = {}
    for dtype in (torch.float32, torch.bfloat16):
        tm = tinf.make_decoder(**CFG, max_len=MAX_LEN, dtype=dtype,
                               device="cpu")
        tm.load_state_dict(tree)
        models[dtype] = tm
    return jm, params, models


def _kw(kw):
    return dict(n_slots=kw.pop("n_slots", 2), chunk=8,
                max_new_tokens=kw.pop("max_new", 12), auto_prefix_min=4,
                kv_paging=kw.pop("paged", True), **kw)


def _ref(setup, **kw):
    return JEngine(setup[0], setup[1], **_kw(kw))


def _port(setup, dtype=torch.float32, **kw):
    return ServingEngine(setup[2][dtype], device="cpu", **_kw(kw))


def _finish(eng):
    while any(eng.active):
        eng.step()


SAMPLED = dict(temperature=0.7, seed=13, repetition_penalty=1.2)


def test_preempt_resume_bit_exact(setup):
    """The reference's scenario: a greedy slot and a seeded, penalised
    sampled slot; the sampled one is preempted for two steps and
    resumed.  Both finish with the uninterrupted contiguous engine's
    ids, and the greedy one with the JAX engine's."""
    eng, ref, jeng = _port(setup), _port(setup, paged=False), _ref(setup)
    sa, sb = eng.admit(A), eng.admit(B, **SAMPLED)
    ra, rb = ref.admit(A), ref.admit(B, **SAMPLED)
    ja = jeng.admit(A)
    for _ in range(3):
        for e in (eng, ref, jeng):
            e.step()
    state = eng.preempt(sb)
    assert eng.stats()["kv_preemptions"] == 1 and not eng.active[sb]
    for _ in range(2):
        for e in (eng, ref, jeng):
            e.step()
    sb2 = eng.resume(state)
    for e in (eng, ref, jeng):
        _finish(e)
    assert eng.output(sa) == ref.output(ra) == jeng.output(ja)
    assert eng.output(sb2) == ref.output(rb)
    assert eng.finish_reason(sb2) == ref.finish_reason(rb)
    eng._pool.check()


def _greedy_preempt_trace(eng):
    """Admit two greedy requests (one asks for logprobs, one has a stop
    id and a logit bias), step, preempt the second, step, resume it,
    finish.  Returns the ids, the state's keys and the counters."""
    a = eng.admit(A, logprobs=2)
    b = eng.admit(B, stop=[91], logit_bias={7: 2.0}, min_tokens=2)
    for _ in range(3):
        eng.step()
    state = eng.preempt(b)
    keys = list(state)
    eng.step()
    b2 = eng.resume(state)
    _finish(eng)
    st = eng.stats()
    return ([eng.output(a), eng.output(b2), eng.finish_reason(b2),
             [lp[1] for lp in eng.token_logprobs(a)]], keys,
            {k: st[k] for k in ("kv_preemptions", "kv_pages_free",
                                "decode_steps", "tokens_emitted")})


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_preempt_resume_equals_reference(setup, kv_dtype):
    want = _greedy_preempt_trace(_ref(setup, logprobs_k=2,
                                      kv_dtype=kv_dtype))
    got = _greedy_preempt_trace(_port(setup, logprobs_k=2,
                                      kv_dtype=kv_dtype))
    # logprob ids equal; values to 1e-4 (other summation orders)
    assert got[0][:3] == want[0][:3]
    assert [[t for t, _ in r] for r in got[0][3]] == \
        [[t for t, _ in r] for r in want[0][3]]
    np.testing.assert_allclose(
        [[v for _, v in r] for r in got[0][3]],
        [[v for _, v in r] for r in want[0][3]], atol=1e-4)
    assert got[1] == want[1] and got[2] == want[2]


def _checkpoint_at(eng, prompt, steps):
    """Admit *prompt* alongside a neighbour, step, preempt it."""
    eng.admit([3, 1, 4, 1, 5, 9, 2, 6])
    s = eng.admit(prompt)
    for _ in range(steps):
        eng.step()
    return eng.preempt(s)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_jax_checkpoint_resumes_in_the_port(setup, kv_dtype):
    """JAX ``preempt`` -> reference ``dump_payload`` -> port
    ``load_payload`` -> port ``resume``: the request finishes with the
    JAX engine's uninterrupted ids."""
    solo = _ref(setup, kv_dtype=kv_dtype)
    solo.admit([3, 1, 4, 1, 5, 9, 2, 6])
    s = solo.admit(B)
    _finish(solo)
    want = solo.output(s)
    state = _checkpoint_at(_ref(setup, kv_dtype=kv_dtype), B, 4)
    payload = jmig.dump_payload(state)
    loaded = tmig.load_payload(payload)
    assert list(loaded) == list(state)
    eng = _port(setup, kv_dtype=kv_dtype)
    slot = eng.resume(loaded)
    _finish(eng)
    assert eng.output(slot) == want
    # the port writes the same bytes back out
    assert tmig.dump_payload(loaded) == payload
    eng._pool.check()


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_port_checkpoint_resumes_in_jax(setup, kv_dtype):
    solo = _port(setup, kv_dtype=kv_dtype)
    solo.admit([3, 1, 4, 1, 5, 9, 2, 6])
    s = solo.admit(B)
    _finish(solo)
    state = _checkpoint_at(_port(setup, kv_dtype=kv_dtype), B, 4)
    ref_state = _checkpoint_at(_ref(setup, kv_dtype=kv_dtype), B, 4)
    assert list(state) == list(ref_state)
    assert [type(state[k]) for k in state if k != "record"] == \
        [type(ref_state[k]) for k in ref_state if k != "record"]
    for layer, kv in state["kv"].items():
        for name, arr in kv.items():
            want = np.asarray(ref_state["kv"][layer][name])
            assert (arr.dtype, arr.shape) == (want.dtype, want.shape)
    eng = _ref(setup, kv_dtype=kv_dtype)
    slot = eng.resume(jmig.load_payload(tmig.dump_payload(state)))
    _finish(eng)
    assert eng.output(slot) == solo.output(s)


def test_bf16_checkpoint_payload_bytes_equal_reference(setup):
    """A bf16 pool's snapshot stays torch tensors (numpy has no bf16):
    the port's payload for it is byte for byte the reference codec's
    payload for the same values as ml_dtypes arrays, and it resumes
    with the uninterrupted stream."""
    solo = _port(setup, torch.bfloat16)
    solo.admit([3, 1, 4, 1, 5, 9, 2, 6])
    s = solo.admit(B, **SAMPLED)
    _finish(solo)
    state = _checkpoint_at(_port(setup, torch.bfloat16), B, 3)
    k = state["kv"]["block_0"]["k"]
    assert isinstance(k, torch.Tensor) and k.dtype == torch.bfloat16

    def as_numpy(tree):
        if isinstance(tree, dict):
            return {key: as_numpy(v) for key, v in tree.items()}
        if isinstance(tree, torch.Tensor):
            return tree.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return tree

    payload = tmig.dump_payload(state)
    assert payload == jmig.dump_payload(as_numpy(state))
    back = tmig.load_payload(payload)
    assert torch.equal(back["kv"]["block_0"]["k"], k)
    assert jmig.load_payload(payload)["kv"]["block_0"]["k"].dtype == \
        np.dtype("bfloat16")
    # the seeded sampled request, preempted and resumed through the
    # codec, continues its uninterrupted stream
    eng = _port(setup, torch.bfloat16)
    eng.admit([3, 1, 4, 1, 5, 9, 2, 6])
    sb = eng.admit(B, **SAMPLED)
    for _ in range(3):
        eng.step()
    sb2 = eng.resume(tmig.load_payload(tmig.dump_payload(eng.preempt(sb))))
    _finish(eng)
    assert eng.output(sb2) == solo.output(s)


def test_open_window_skips_the_preempted_slot(setup):
    def run(eng):
        a, b = eng.admit(A), eng.admit(B)
        handle = eng.scan_dispatch(3)
        state = eng.preempt(b)
        out = eng.scan_harvest(handle)
        b2 = eng.resume(state)
        eng.run_scan(3)
        return sorted(out), eng.output(a), eng.output(b2), eng.lens

    assert run(_port(setup)) == run(_ref(setup))


def test_preempt_callback_finishes_every_request(setup):
    """An oversubscribed pool (about half the pages the requests hold at
    their end) with a policy that preempts the newest active slot and
    resumes it when pages free: every request finishes with the ids of
    a pool that holds them all."""
    prompts = [list(range(1 + 5 * i, 20 + 5 * i)) for i in range(4)]
    full = _port(setup, n_slots=4, max_new=16)
    slots = [full.admit(p) for p in prompts]
    _finish(full)
    want = [full.output(s) for s in slots]

    eng = _port(setup, n_slots=4, max_new=16, kv_pages=10,
                auto_prefix=False)
    order, parked, done = [], [], {}
    owner = {}

    def preempt_newest(exclude):
        live = [s for s in order if eng.active[s] and s != exclude]
        if not live:
            return False
        s = live[-1]
        parked.append((owner.pop(s), eng.preempt(s)))
        order.remove(s)
        return True

    eng.set_preempt_cb(preempt_newest)
    queue = list(enumerate(prompts))
    for _ in range(200):
        while parked and eng.free_slots():
            try:
                s = eng.resume(parked[0][1])
            except PagePoolExhausted:
                break
            owner[s] = parked.pop(0)[0]
            order.append(s)
        while queue and eng.free_slots() and not parked:
            try:
                s = eng.admit(queue[0][1])
            except PagePoolExhausted:
                break
            owner[s] = queue.pop(0)[0]
            order.append(s)
        if any(eng.active):
            eng.step()
        for s in list(owner):
            if eng.finished(s):
                done[owner.pop(s)] = eng.output(s)
                order.remove(s)
                eng.release(s)
        if len(done) == len(prompts):
            break
    assert [done[i] for i in range(len(prompts))] == want
    assert eng.stats()["kv_preemptions"] > 0
    eng._pool.check()


def _session_trace(eng, demote):
    """Turn 1, park it as a session, optionally demote and resume it,
    then turn 2 of the same conversation and a stranger's prompt that
    shares its prefix (which must not match the session's rows)."""
    s = eng.admit(A)
    _finish(eng)
    out1 = eng.output(s)
    canon = eng.park_session(s, "conv", kept=len(out1))
    parked = eng.session_slots()
    pages = eng.stats()["kv_pages_free"]
    if demote:
        state = eng.demote_session(s)
        assert eng.session_slots() == {}
        state = type(state)(state)
        s = eng.resume_session(state)
    hits = eng.stats()["prefix_cache_hits"]
    turn2 = A + out1 + [7, 8, 9]
    t2 = eng.admit(turn2, session="conv")
    own_hit = eng.stats()["prefix_cache_hits"] - hits
    _finish(eng)
    stranger = eng.admit(A + out1[:2])
    _finish(eng)
    st = eng.stats()
    return (out1, canon, parked, pages, own_hit, eng.output(t2),
            eng.output(stranger), st["kv_sessions_parked"],
            st["prefix_reused_tokens"])


@pytest.mark.parametrize("demote", [False, True])
def test_sessions_park_demote_resume_like_reference(setup, demote):
    kw = dict(n_slots=3, max_new=6)
    assert _session_trace(_port(setup, **kw), demote) == \
        _session_trace(_ref(setup, **kw), demote)


def test_session_checkpoint_crosses_frameworks_and_discards(setup):
    kw = dict(n_slots=3, max_new=6)
    ref, port = _ref(setup, **kw), _port(setup, **kw)
    outs = []
    for eng in (ref, port):
        s = eng.admit(A)
        _finish(eng)
        outs.append(eng.output(s))
        eng.park_session(s, "conv", kept=len(eng.output(s)))
    state = jmig.load_payload(tmig.dump_payload(
        port.demote_session(port.session_slots()["conv"])))
    fresh = _ref(setup, **kw)
    slot = fresh.resume_session(state)
    assert fresh.session_slots() == {"conv": slot}
    turn2 = A + outs[0] + [7, 8, 9]
    t2 = fresh.admit(turn2, session="conv")
    r2 = ref.admit(turn2, session="conv")
    _finish(fresh)
    _finish(ref)
    assert fresh.output(t2) == ref.output(r2)
    back = _port(setup, **kw)
    slot = back.resume_session(tmig.load_payload(jmig.dump_payload(
        ref.demote_session(ref.session_slots()["conv"]))))
    free = back.stats()["kv_pages_free"]
    back.discard_session(slot)
    assert back.session_slots() == {} and back.stats()[
        "kv_pages_free"] > free
    with pytest.raises(ValueError, match="no parked session"):
        back.discard_session(slot)
    back._pool.check()


@pytest.mark.parametrize("paged", [False, True])
def test_prompt_logprobs_equal_reference(setup, paged):
    def run(eng):
        s = eng.admit(list(range(1, 20)), prompt_logprobs=3, logprobs=2)
        eng.step()
        return eng.prompt_logprobs(s), eng.output(s)

    kw = dict(logprobs_k=3, paged=paged)
    want, got = run(_ref(setup, **kw)), run(_port(setup, **kw))
    assert got[1] == want[1]
    assert got[0][0] is None and want[0][0] is None
    assert len(got[0]) == len(want[0]) == 19
    for g, w in zip(got[0][1:], want[0][1:]):
        assert [t for t, _ in g[1]] == [t for t, _ in w[1]]
        np.testing.assert_allclose(
            [g[0]] + [v for _, v in g[1]], [w[0]] + [v for _, v in w[1]],
            atol=1e-4)
    eng = _port(setup, **kw)
    with pytest.raises(ValueError, match="prefix handle"):
        eng.admit(A, prefix=eng.register_prefix(A[:4]), prompt_logprobs=1)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_bf16_paged_equals_contiguous(setup, kv_dtype):
    """In bf16 too the paged view has the contiguous cache's shape and
    values, so ids and logprobs equal the contiguous engine's bit for
    bit; int8 pages are the lossy option and only run."""
    def run(eng):
        a = eng.admit(A, logprobs=3)
        b = eng.admit(B, **SAMPLED)
        eng.run_scan(4)
        c = eng.admit(A + [7])       # a prefix shared from a busy slot
        _finish(eng)
        return ([eng.output(s) for s in (a, b, c)], eng.token_logprobs(a))

    paged = run(_port(setup, torch.bfloat16, logprobs_k=3,
                      kv_dtype=kv_dtype, n_slots=3))
    if kv_dtype is None:
        assert paged == run(_port(setup, torch.bfloat16, logprobs_k=3,
                                  paged=False, n_slots=3))
    else:
        assert [len(o) for o in paged[0]] == [12, 12, 12]
