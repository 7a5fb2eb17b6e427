"""The port's iteration scheduler, mirroring tests/test_scheduler.py.

The house invariant: with a fixed request trace, token streams are
identical with interleaving, ragged packed prefill and dispatch-ahead
overlap on or off, in every combination (greedy, seeded sampled,
grammar-constrained, APC hit and miss, paged KV, fused decode,
logprobs).  Plus the split-admission API: begin/step/finish is the
one-shot admit, ``admit_step_packed`` lands bit for bit what the serial
chunks land, and the exact-repeat fast paths change only the work done.

The decoder is tests/test_scheduler.py's (vocab 96, d_model 64, 4
heads, 2 layers, max_len 64, f32, chunk 4), initialised by JAX and
converted with ``convert.params_from_jax``; the grammar is
``(AB|CD)+E`` over byte tokens.  The JAX package's scheduler runs the
same greedy and grammar traces on the same weights: the streams are
identical (sampled streams are the port's own counter-hash draws and
are held to the port's toggle matrix only).  Arrivals are keyed to
iteration indices and the dwell is off, so every run is deterministic.
"""

from collections import deque
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tools import promlint
from tpu_k8s_device_plugin import obs as jobs
from tpu_k8s_device_plugin.resilience import faults as jfaults
from tpu_k8s_device_plugin.workloads import grammar as jg
from tpu_k8s_device_plugin.workloads.inference import make_decoder
from tpu_k8s_device_plugin.workloads.scheduler import (
    IterationScheduler as JScheduler,
)
from tpu_k8s_device_plugin.workloads.serving import ServingEngine as JEngine
from tpu_k8s_device_plugin_torch import obs
from tpu_k8s_device_plugin_torch.convert import params_from_jax
from tpu_k8s_device_plugin_torch.resilience import faults
from tpu_k8s_device_plugin_torch.workloads import grammar as tg
from tpu_k8s_device_plugin_torch.workloads import inference as tinf
from tpu_k8s_device_plugin_torch.workloads import scheduler as tsched
from tpu_k8s_device_plugin_torch.workloads.scheduler import (
    DEFAULT_MAX_PACK,
    PHASES,
    IterationScheduler,
    SchedulerSuperseded,
)
from tpu_k8s_device_plugin_torch.workloads.serving import (
    PACK_WIDTH,
    ServingEngine,
)

CFG = dict(vocab=96, d_model=64, n_heads=4, n_layers=2, d_ff=128)
EOS = 0
MAX_LEN = 64
PATTERN = "(AB|CD)+E"  # bytes < 96
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
    dfa = tg.token_dfa(tg.regex_to_dfa(PATTERN), TB, eos_id=EOS)
    return tm, dfa, (jm, params)


def _engine(tm, **kw):
    return ServingEngine(tm, device="cpu", **kw)


def _solo(tm, prompt, n_steps):
    out, _ = tinf.greedy_generate(tm, np.asarray(prompt, np.int32)[None],
                                  n_steps)
    return np.asarray(out)[0].tolist()


def _run_trace(eng, sched_cls, trace, interleave, packed, overlap,
               lp_out=None):
    """Run *trace* -- ``(arrival_iteration, key, kwargs)`` entries --
    through a scheduler of *sched_cls* over *eng*; returns {key:
    tokens}.  *lp_out* collects each key's logprob records."""
    intake: deque = deque()
    tickets, live, results = {}, {}, {}

    def pull():
        if not intake:
            return None
        key, kwargs = intake.popleft()
        t = sched.begin(**kwargs)
        tickets[t] = key
        return t

    sched = sched_cls(eng, window=4, interleave=interleave,
                      prefill_budget=2, pull=pull, packed_prefill=packed,
                      overlap=overlap, sync_dwell_s=0.0)
    arrivals = sorted(trace, key=lambda a: a[0])
    ai = 0
    for i in range(200):
        while ai < len(arrivals) and arrivals[ai][0] <= i:
            intake.append(arrivals[ai][1:])
            ai += 1
        res = sched.iterate()
        for t in res.admitted:
            live[t.slot] = tickets.pop(t)
        for slot in list(live):
            if eng.finished(slot):
                key = live.pop(slot)
                results[key] = eng.output(slot)
                if lp_out is not None:
                    lp_out[key] = eng.token_logprobs(slot)
        if (ai == len(arrivals) and not intake and not live
                and not sched.busy()):
            break
    assert len(results) == len(trace), "trace did not drain"
    return results


def _drive(setup, trace, interleave, max_new=6, n_slots=2,
           grammar=False, packed=False, overlap=False, kv_paging=False,
           fused=False, lp_out=None, logprobs_k=0):
    tm, dfa, _ = setup
    eng = _engine(tm, n_slots=n_slots, chunk=4,
                  eos_id=EOS if grammar else None, max_new_tokens=max_new,
                  auto_prefix_min=4, grammar=dfa if grammar else None,
                  kv_paging=kv_paging, fused_decode=fused,
                  logprobs_k=logprobs_k)
    return _run_trace(eng, IterationScheduler, trace, interleave, packed,
                      overlap, lp_out)


def _assert_equivalent(setup, trace, **kw):
    on = _drive(setup, trace, interleave=True, **kw)
    off = _drive(setup, trace, interleave=False, **kw)
    assert on == off
    return on


def _assert_packed_overlap_equivalent(setup, trace, **kw):
    """The full toggle matrix: every (packed, overlap) combination, with
    interleave on and off, gives the serial baseline's streams."""
    base = _assert_equivalent(setup, trace, **kw)
    for packed in (False, True):
        for overlap in (False, True):
            for interleave in (True, False):
                got = _drive(setup, trace, interleave=interleave,
                             packed=packed, overlap=overlap, **kw)
                assert got == base, (
                    f"streams diverged at packed={packed} "
                    f"overlap={overlap} interleave={interleave}")
    return base


PA = [3, 14, 15, 92, 65, 35, 89, 79]    # 2 chunks of 4
PB = [2, 71, 82, 81, 82]                # miss against PA
PC = [44, 9, 1, 7, 60, 61]
GREEDY_APC = [
    (0, "a0", dict(prompt=PA)),
    (0, "b0", dict(prompt=PB)),
    (0, "c0", dict(prompt=PC)),
    (1, "a1", dict(prompt=PA)),                  # exact repeat: full hit
    (2, "ash", dict(prompt=PA[:4] + [9, 9])),    # shared chunk
    (4, "b1", dict(prompt=PB)),
    (5, "a2", dict(prompt=PA)),
]
SEEDED = [
    (0, "s1", dict(prompt=[3, 14, 15, 92, 65], temperature=1.0, seed=7)),
    (0, "g0", dict(prompt=[2, 71, 82])),
    (0, "s2", dict(prompt=[44, 9, 1, 7], temperature=0.7, top_k=8,
                   seed=41)),
    (3, "s3", dict(prompt=[3, 14, 15, 92, 65], temperature=1.0, seed=7)),
]
GRAMMAR = [
    (0, "g1", dict(prompt=[65, 66], grammar=True)),
    (0, "u1", dict(prompt=[2, 71, 82])),
    (0, "g2", dict(prompt=[67, 68], grammar=True)),
    (2, "g3", dict(prompt=[65, 66, 67, 68], grammar=True)),
]
PAGED = [
    (0, "a0", dict(prompt=PA)),
    (0, "b0", dict(prompt=PB, stop=[22])),
    (1, "a1", dict(prompt=PA)),                  # paged zero-page repeat
    (3, "ash", dict(prompt=PA[:4] + [9, 9])),    # CoW shared chunk
]


def test_equivalence_greedy_apc_hit_and_miss(setup):
    trace = [e for e in GREEDY_APC if e[1] != "c0"]
    on = _assert_equivalent(setup, trace)
    for key, prompt in (("a0", PA), ("a1", PA), ("a2", PA), ("b0", PB)):
        assert on[key] == _solo(setup[0], prompt, 6)


def test_equivalence_seeded_sampled(setup):
    trace = [e for e in SEEDED if e[1] != "s2"]
    on = _assert_equivalent(setup, trace)
    assert on["s1"] == on["s3"]


def test_equivalence_grammar_constrained(setup):
    _assert_equivalent(setup, GRAMMAR[:2] + [(2,) + GRAMMAR[2][1:]],
                       grammar=True, max_new=8)


@pytest.mark.parametrize("name,trace,kw", [
    ("greedy_apc", GREEDY_APC, dict(n_slots=3)),
    ("seeded", SEEDED, dict(n_slots=3)),
    ("grammar", GRAMMAR, dict(grammar=True, max_new=8, n_slots=3)),
], ids=["greedy_apc", "seeded", "grammar"])
def test_packed_overlap_equivalence(setup, name, trace, kw):
    on = _assert_packed_overlap_equivalent(setup, trace, **kw)
    if name == "greedy_apc":
        for key, prompt in (("a0", PA), ("b0", PB), ("c0", PC)):
            assert on[key] == _solo(setup[0], prompt, 6)
    if name == "seeded":
        assert on["s1"] == on["s3"]


def test_packed_overlap_equivalence_kv_paging(setup):
    """Packed prefill runs on B=1 minis and lands through _paged_land as
    serial admission does: paged streams equal the contiguous serial
    baseline in every (packed, overlap) combination."""
    base = _assert_equivalent(setup, PAGED)
    for packed in (False, True):
        for overlap in (False, True):
            got = _drive(setup, PAGED, interleave=True, packed=packed,
                         overlap=overlap, kv_paging=True)
            assert got == base, (packed, overlap)


def _assert_fused_equivalent(setup, trace, **kw):
    """The fused-decode axis: every (packed, overlap, interleave)
    combination with the fused loop gives the serial unfused
    baseline's streams."""
    base = _drive(setup, trace, interleave=False, **kw)
    for packed in (False, True):
        for overlap in (False, True):
            for interleave in (True, False):
                got = _drive(setup, trace, fused=True,
                             interleave=interleave, packed=packed,
                             overlap=overlap, **kw)
                assert got == base, (packed, overlap, interleave)
    return base


@pytest.mark.parametrize("name", ["greedy_apc_stops", "seeded", "grammar"])
def test_fused_equivalence(setup, name):
    if name == "greedy_apc_stops":
        trace = [(0, "a0", dict(prompt=PA)),
                 (0, "b0", dict(prompt=PB, stop=[22])),
                 (1, "a1", dict(prompt=PA)),
                 (2, "ash", dict(prompt=PA[:4] + [9, 9])),
                 (4, "b1", dict(prompt=PB)),
                 (5, "a2", dict(prompt=PA))]
        on = _assert_fused_equivalent(setup, trace, n_slots=3)
        for key in ("a0", "a1", "a2"):
            assert on[key] == _solo(setup[0], PA, 6)
    elif name == "seeded":
        on = _assert_fused_equivalent(setup, SEEDED, n_slots=3)
        assert on["s1"] == on["s3"]
    else:
        _assert_fused_equivalent(setup, GRAMMAR, grammar=True, max_new=8,
                                 n_slots=3)


def test_fused_equivalence_logprobs(setup):
    """The bulk logprob harvest reproduces the per-step records, values
    and count, under packing and overlap."""
    trace = [
        (0, "l1", dict(prompt=[3, 14, 15, 92, 65], logprobs=3)),
        (0, "g0", dict(prompt=[2, 71, 82, 81])),
        (2, "l2", dict(prompt=[2, 71, 82, 81], logprobs=2,
                       temperature=0.9, seed=13)),
    ]
    lp_base: dict = {}
    base = _drive(setup, trace, interleave=False, n_slots=3,
                  lp_out=lp_base, logprobs_k=4)
    for interleave in (True, False):
        lp_got: dict = {}
        got = _drive(setup, trace, fused=True, interleave=interleave,
                     packed=True, overlap=True, n_slots=3, lp_out=lp_got,
                     logprobs_k=4)
        assert got == base
        assert lp_got == lp_base
    assert all(len(lp_base[k]) == len(base[k]) for k in ("l1", "l2"))


def test_fused_equivalence_kv_paging(setup):
    base = _drive(setup, PAGED, interleave=False)
    for packed in (False, True):
        for overlap in (False, True):
            got = _drive(setup, PAGED, interleave=True, packed=packed,
                         overlap=overlap, kv_paging=True, fused=True)
            assert got == base, (packed, overlap)


def test_mid_window_admission_prefills_inside_open_window(setup):
    """A request that arrives while a window is open begins and finishes
    its prefill before that window's harvest."""
    tm = setup[0]
    eng = _engine(tm, n_slots=2, chunk=4, max_new_tokens=12,
                  auto_prefix_min=4)
    seen = {}
    pb = [2, 71, 82, 81, 82, 44, 9, 1]

    def pull():
        if "a" not in seen:
            seen["a"] = sched.begin(prompt=[3, 14, 15, 92, 65])
            return seen["a"]
        if "b" not in seen and eng.scan_inflight:
            seen["b"] = sched.begin(prompt=pb)
            return seen["b"]
        return None

    sched = IterationScheduler(eng, window=8, interleave=True,
                               prefill_budget=8, pull=pull,
                               sync_dwell_s=0.0)
    res1 = sched.iterate()
    res2 = sched.iterate()
    assert "b" in seen
    assert res1.steps > 0
    tb = seen["b"]
    assert tb.mid_window
    assert tb.chunks_done == tb.chunks_total > 0
    assert tb in res1.admitted + res2.admitted
    assert eng.active[tb.slot]
    out_b = None
    for _ in range(30):
        sched.iterate()
        if eng.finished(tb.slot):
            out_b = eng.output(tb.slot)
            break
    assert out_b == _solo(tm, pb, 12)


def test_begin_step_finish_equals_one_shot_admit(setup):
    tm = setup[0]
    prompt = [3, 14, 15, 92, 65, 35, 89]   # 2 chunks
    one = _engine(tm, n_slots=2, chunk=4)
    split = _engine(tm, n_slots=2, chunk=4)
    s1 = one.admit(prompt)
    st = split.begin_admit(prompt)
    assert split.free_slots() == [1]
    steps = 0
    while split.admit_step(st):
        steps += 1
    assert st.chunks_total == 2 and steps == 1
    s2 = split.finish_admit(st)
    assert s1 == s2
    one.run(6)
    split.run(6)
    assert one.output(s1) == split.output(s2)


def test_abort_admit_frees_the_reserved_slot(setup):
    eng = _engine(setup[0], n_slots=1, chunk=4)
    st = eng.begin_admit([3, 14, 15, 92, 65])
    with pytest.raises(RuntimeError):
        eng.begin_admit([1, 2])
    eng.abort_admit(st)
    assert eng.admit([1, 2]) == 0


def test_full_prompt_apc_admits_with_zero_extends(setup):
    tm = setup[0]
    eng = _engine(tm, n_slots=2, chunk=4, auto_prefix_min=4)
    s0 = eng.admit(PA)
    eng.run(6)
    first_run = eng.output(s0)
    eng.release(s0)
    before = eng.stats()["prefill_tokens"]
    s1 = eng.admit(PA)
    assert s1 == s0
    assert eng.stats()["prefill_tokens"] == before
    assert eng.stats()["prefix_reused_tokens"] >= len(PA)
    eng.run(6)
    assert eng.output(s1) == first_run
    assert eng.output(s1)[:6] == _solo(tm, PA, 6)


def test_full_prompt_apc_copy_path_when_donor_slot_busy(setup):
    tm = setup[0]
    eng = _engine(tm, n_slots=2, chunk=4, auto_prefix_min=4)
    s0 = eng.admit(PA)
    before = eng.stats()["prefill_tokens"]
    s1 = eng.admit(PA)
    assert s1 != s0
    assert eng.stats()["prefill_tokens"] == before
    eng.run(6)
    assert eng.output(s0) == eng.output(s1)
    assert eng.output(s0)[:6] == _solo(tm, PA, 6)


def test_supersede_aborts_pending_tickets(setup):
    eng = _engine(setup[0], n_slots=1, chunk=4)
    sched = IterationScheduler(eng, window=4, sync_dwell_s=0.0)
    t = sched.begin(prompt=[3, 14, 15, 92, 65])
    assert sched.busy() and not eng.free_slots()
    sched.supersede()
    assert not sched.busy()
    assert eng.free_slots() == [0]
    with pytest.raises(SchedulerSuperseded):
        sched._check(sched._gen - 1)
    assert t.state.result is None


def _admit_packed(eng, prompts, packed):
    """Begin every prompt, then advance them (packed while two or more
    remain, else serially) and finish; returns the states and slots."""
    sts = [eng.begin_admit(p) for p in prompts]
    while any(st.gen is not None for st in sts):
        group = [st for st in sts if st.gen is not None]
        if packed and len(group) >= 2:
            eng.admit_step_packed(group)
        else:
            eng.admit_step(group[0])
    results = [(st.result[0], st.result[1].clone()) for st in sts]
    return results, [eng.finish_admit(st) for st in sts]


PACK_PROMPTS = ([3, 14, 15, 92, 65, 35, 89, 79, 11],   # 3 chunks
                [2, 71, 82, 81, 82],                   # 2 chunks
                [44, 9, 1, 7, 60, 61, 2])              # 2 chunks


def test_admit_step_packed_equals_serial_chunks(setup):
    """K admissions advanced through packed extends land bit for bit what
    chunk-serial admission lands (each mini's every row and length, and
    the last prompt logits row), decode the same ids, and the packed
    counters account the work."""
    tm = setup[0]
    kw = dict(n_slots=3, chunk=4, max_new_tokens=6, auto_prefix=False)
    serial, packed = _engine(tm, **kw), _engine(tm, **kw)
    want, slots_s = _admit_packed(serial, PACK_PROMPTS, packed=False)
    got, slots_p = _admit_packed(packed, PACK_PROMPTS, packed=True)
    for (wm, wl), (gm, gl) in zip(want, got):
        assert torch.equal(wl, gl)
        for layer in wm:
            for key in wm[layer]:
                assert torch.equal(wm[layer][key], gm[layer][key])
    serial.run(6)
    packed.run(6)
    for s, p in zip(slots_p, PACK_PROMPTS):
        assert packed.output(s) == _solo(tm, p, 6)
        assert packed.output(s) == serial.output(s)
    st = packed.stats()
    assert st["packed_prefill_extends"] == 2
    assert st["packed_prefill_requests"] == 3
    assert st["packed_prefill_rows"] == 6
    # round 2 packs PB's tail (+3) and the third prompt's (+1); PA's tail
    # chunk runs serially (last job standing), so it is not packed waste
    assert st["packed_prefill_pad_tokens"] == 4
    assert serial.stats()["packed_prefill_extends"] == 0


def test_admit_step_packed_logits_match_jax(setup):
    """The last prompt logits rows of a packed admission against the JAX
    engine's packed admission of the same prompts: within 1e-4 (the
    frameworks sum in other orders)."""
    tm, _, (jm, params) = setup
    kw = dict(n_slots=3, chunk=4, max_new_tokens=6, auto_prefix=False)
    got, _ = _admit_packed(_engine(tm, **kw), PACK_PROMPTS, packed=True)
    ref = JEngine(jm, params, **kw)
    sts = [ref.begin_admit(p) for p in PACK_PROMPTS]
    while any(st.gen is not None for st in sts):
        group = [st for st in sts if st.gen is not None]
        if len(group) >= 2:
            ref.admit_step_packed(group)
        else:
            ref.admit_step(group[0])
    for (_, last), st in zip(got, sts):
        want = np.asarray(st.result[1])
        np.testing.assert_allclose(last.numpy(), want, atol=1e-4, rtol=0)


def test_admit_step_packed_in_rounds(setup):
    """One packed session of several rounds lands what one round at a
    time does."""
    tm = setup[0]
    kw = dict(n_slots=2, chunk=4, max_new_tokens=4, auto_prefix=False)
    outs = []
    for per_round in (True, False):
        eng = _engine(tm, **kw)
        sts = [eng.begin_admit(p) for p in PACK_PROMPTS[:2]]
        if per_round:
            eng.admit_step_packed(sts)
            eng.admit_step_packed(sts)
        else:
            eng.admit_step_packed(sts, rounds=2)
        assert sts[1].ready and sts[0].chunks_done == 2
        while eng.admit_step(sts[0]):
            pass
        slots = [eng.finish_admit(st) for st in sts]
        eng.run(4)
        outs.append(([eng.output(s) for s in slots],
                     eng.stats()["packed_prefill_extends"]))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("case,msg", [
    ("serial_state", "needs in-flight packable admissions"),
    ("plp_state", "needs in-flight packable admissions"),
    ("one", "a pack needs >= 2 admissions"),
    ("too_wide", "exceeds the engine's pack_width"),
    ("zero_rounds", "rounds must be >= 1"),
    ("too_many_rounds", "rounds must be >= 1"),
])
def test_admit_step_packed_messages(setup, case, msg):
    tm = setup[0]
    eng = _engine(tm, n_slots=PACK_WIDTH + 1, chunk=4, auto_prefix=False,
                  logprobs_k=2)
    prompts = [[i + 1, i + 2, i + 3, i + 4, i + 5] for i in range(6)]
    if case == "too_wide":
        states = [eng.begin_admit(p) for p in prompts[:PACK_WIDTH + 1]]
    else:
        states = [eng.begin_admit(p) for p in prompts[:2]]
    rounds = 1
    if case == "serial_state":
        while eng.admit_step(states[1]):
            pass
    elif case == "plp_state":
        eng.abort_admit(states[1])
        states[1] = eng.begin_admit(prompts[2], prompt_logprobs=2)
    elif case == "one":
        states = states[:1]
    elif case == "zero_rounds":
        rounds = 0
    elif case == "too_many_rounds":
        rounds = 3
    with pytest.raises(ValueError, match=msg):
        eng.admit_step_packed(states, rounds)


def test_warm_packed_and_pack_width(setup):
    """On the CPU warm_packed captures nothing and touches nothing; sizes
    beyond the engine's pack width raise, and so does a scheduler whose
    max_pack exceeds it."""
    tm = setup[0]
    eng = _engine(tm, n_slots=2, chunk=4)
    assert eng.pack_width == PACK_WIDTH == DEFAULT_MAX_PACK
    eng.warm_packed(range(1, PACK_WIDTH + 1))
    assert eng._batch is None and eng.extend_capture_ms == 0.0
    with pytest.raises(ValueError, match="pack_width"):
        eng.warm_packed([PACK_WIDTH + 1])
    with pytest.raises(ValueError, match="pack_width"):
        IterationScheduler(eng, max_pack=PACK_WIDTH + 1)
    IterationScheduler(eng, max_pack=PACK_WIDTH + 1, packed_prefill=False)
    with pytest.raises(ValueError, match="max_pack"):
        IterationScheduler(eng, max_pack=1)
    _engine(tm, n_slots=1, chunk=None).warm_packed([2, 3])


def test_abort_during_packed_prefill(setup):
    tm = setup[0]
    pa, pb = PACK_PROMPTS[0], [2, 71, 82, 81, 82, 44, 9]
    eng = _engine(tm, n_slots=2, chunk=4, max_new_tokens=6,
                  auto_prefix=False)
    sa = eng.begin_admit(pa)
    sb = eng.begin_admit(pb)
    eng.admit_step_packed([sa, sb])
    eng.abort_admit(sb)
    assert eng.free_slots() == [sb.slot]
    while eng.admit_step(sa):
        pass
    slot_a = eng.finish_admit(sa)
    eng.run(6)
    assert eng.output(slot_a) == _solo(tm, pa, 6)
    slot_b = eng.admit(pb)
    eng.run(6)
    assert eng.output(slot_b) == _solo(tm, pb, 6)


def test_scheduler_cancel_during_packed_prefill(setup):
    tm = setup[0]
    pa, pb = PACK_PROMPTS[0], [2, 71, 82, 81, 82, 44, 9]
    eng = _engine(tm, n_slots=2, chunk=4, max_new_tokens=6,
                  auto_prefix=False)
    sched = IterationScheduler(eng, window=4, packed_prefill=True,
                               overlap=True, sync_dwell_s=0.0)
    ta = sched.begin(prompt=pa)
    tb = sched.begin(prompt=pb)
    sched.cancel(tb)
    assert tb.state.result is None
    done = None
    for _ in range(40):
        res = sched.iterate()
        for t in res.admitted:
            assert t is ta
        if eng.finished(ta.slot):
            done = eng.output(ta.slot)
            break
    assert done == _solo(tm, pa, 6)


def test_overlap_dispatches_ahead_and_falls_back_when_sampled(setup):
    eng = _engine(setup[0], n_slots=2, chunk=4, max_new_tokens=16,
                  auto_prefix_min=4)
    sched = IterationScheduler(eng, window=4, packed_prefill=True,
                               overlap=True, sync_dwell_s=0.0)
    sched.begin(prompt=[3, 14, 15, 92, 65])
    sched.iterate()
    assert sched._ahead is not None and eng.scan_inflight
    sched.iterate()
    assert sched._ahead is not None
    for _ in range(30):
        sched.iterate()
        if not any(eng.active) and not sched.busy():
            break
    assert sched._ahead is None and not eng.scan_inflight
    sched.begin(prompt=[2, 71, 82], temperature=1.0, seed=3)
    sched.iterate()
    assert sched._ahead is None, "sampled window was dispatched ahead"


def test_fused_overlap_dispatches_ahead_when_sampled(setup):
    eng = _engine(setup[0], n_slots=2, chunk=4, max_new_tokens=16,
                  auto_prefix_min=4, fused_decode=True)
    sched = IterationScheduler(eng, window=4, packed_prefill=True,
                               overlap=True, sync_dwell_s=0.0)
    sched.begin(prompt=[2, 71, 82], temperature=1.0, seed=3)
    sched.iterate()
    assert sched._ahead is not None and eng.scan_inflight
    for _ in range(30):
        sched.iterate()
        if not any(eng.active) and not sched.busy():
            break
    assert sched._ahead is None and not eng.scan_inflight
    assert eng.stats()["fused_windows"] > 0


def test_supersede_abandons_ahead_window(setup):
    eng = _engine(setup[0], n_slots=1, chunk=4, max_new_tokens=16)
    sched = IterationScheduler(eng, window=4, overlap=True,
                               sync_dwell_s=0.0)
    sched.begin(prompt=[3, 14, 15, 92, 65])
    sched.iterate()
    assert sched._ahead is not None and eng.scan_inflight
    sched.supersede()
    assert sched._ahead is None and not eng.scan_inflight
    eng.release(0)
    s = eng.admit([2, 71, 82])
    eng.run_scan(4)
    assert len(eng.output(s)) >= 4


def test_crash_in_ahead_iteration_leaves_window_to_supersede(setup):
    """An iteration that crashes (or is abandoned by the watchdog) at its
    fault hook still holds the window dispatched ahead: the supervisor's
    supersede abandons it, so the restarted loop can dispatch again."""
    eng = _engine(setup[0], n_slots=1, chunk=4, max_new_tokens=16)
    sched = IterationScheduler(eng, window=4, overlap=True,
                               sync_dwell_s=0.0)
    sched.begin(prompt=[3, 14, 15, 92, 65])
    sched.iterate()
    assert sched._ahead is not None and eng.scan_inflight
    faults.install("serve.step:error:1", seed=0)
    try:
        with pytest.raises(faults.InjectedFault):
            sched.iterate()
    finally:
        faults.uninstall()
    sched.supersede()
    assert sched._ahead is None and not eng.scan_inflight
    eng.release(0)
    s = eng.admit([2, 71, 82])
    eng.run_scan(4)
    assert len(eng.output(s)) >= 4


def test_packing_conflict_defers_shared_prefix(setup):
    eng = _engine(setup[0], n_slots=2, chunk=4, max_new_tokens=4,
                  auto_prefix_min=4)
    sched = IterationScheduler(eng, window=4, packed_prefill=True,
                               sync_dwell_s=0.0)
    t = sched.begin(prompt=PA)
    assert sched.packing_conflict(PA)
    assert sched.packing_conflict(PA[:4] + [9, 9])
    assert not sched.packing_conflict([2, 71, 82, 81])
    assert not sched.packing_conflict([3, 14])
    sched.cancel(t)
    assert not sched.packing_conflict(PA)
    serial = IterationScheduler(eng, window=4, packed_prefill=False,
                                sync_dwell_s=0.0)
    serial.begin(prompt=PA)
    assert not serial.packing_conflict(PA)


def test_scheduler_metrics_families_render(setup):
    reg = obs.Registry()
    eng = _engine(setup[0], n_slots=1, chunk=4, max_new_tokens=3)
    intake = deque([dict(prompt=[3, 14, 15, 92, 65])])

    def pull():
        return sched.begin(**intake.popleft()) if intake else None

    sched = IterationScheduler(eng, window=4, pull=pull, sync_dwell_s=0.0,
                               registry=reg)
    for _ in range(6):
        sched.iterate()
    with sched.in_phase("stream"):
        pass
    body = reg.render()
    for name in ("tpu_serve_prefill_chunk_seconds",
                 "tpu_serve_admit_to_first_step_seconds",
                 'tpu_serve_scheduler_queue_depth{kind="decode"}',
                 "tpu_serve_overlap_idle_seconds",
                 "tpu_serve_overlap_windows_total",
                 'tpu_serve_window_phase_seconds_count{phase="stream"} 1',
                 "tpu_serve_device_duty_cycle",
                 "tpu_serve_first_token_wait_seconds_count 1",
                 "tpu_serve_prefill_chunk_tokens_total"):
        assert name in body, name
    # admission's phases are children of the same family: the one
    # admission began, ran 2 chunks, spliced and read its first token
    for phase, n in (("begin", 1), ("admit", 2), ("splice", 1),
                     ("first_token", 1), ("idle", 0)):
        assert (f'tpu_serve_window_phase_seconds_count{{phase="{phase}"}} '
                f"{n}") in body, phase
    assert promlint.lint(body) == []
    with pytest.raises(ValueError, match="unknown scheduler phase"):
        with sched.in_phase("nap"):
            pass


# engine calls each phase covers, each with its own cost on a fake clock
# (powers of two, so every phase's sum is exact): (method, cost, phase)
PHASE_CALLS = (("scan_dispatch", 1.0, "dispatch"),
               ("scan_harvest", 2.0, "harvest"),
               ("step", 4.0, "harvest"),
               ("begin_admit", 8.0, "begin"),
               ("admit_step", 16.0, "admit"),
               ("admit_step_packed", 32.0, "admit"),
               ("_finish_admit_dispatch", 64.0, "splice"),
               ("_finish_admit_resolve", 128.0, "first_token"))


@pytest.mark.parametrize("packed,overlap", [(False, False), (True, True)],
                         ids=["serial", "packed-overlap"])
def test_phase_sums_cover_exactly_their_engine_calls(setup, monkeypatch,
                                                     packed, overlap):
    """On a clock that moves only inside the engine's calls, each
    phase's seconds are exactly its calls' cost: dispatch and harvest
    keep the extents the begin/note pair gave them (the window dispatch;
    the harvest or endgame step), and admission's phases cover
    begin_admit, the chunk dispatches, the splice and the first-token
    read.  The owner's phases see nothing here, and the duty cycle is
    dispatch + harvest over the four it always read."""
    clock = [0.0]
    monkeypatch.setattr(tsched, "time", SimpleNamespace(
        perf_counter=lambda: clock[0], sleep=lambda s: None))
    eng = _engine(setup[0], n_slots=2, chunk=4, max_new_tokens=6,
                  auto_prefix_min=4)
    calls = {}
    for name, cost, _ in PHASE_CALLS:
        real = getattr(eng, name)

        def timed(*a, _real=real, _name=name, _cost=cost, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            clock[0] += _cost
            return _real(*a, **kw)

        monkeypatch.setattr(eng, name, timed)
    reg = obs.Registry()
    intake: deque = deque()

    def pull():
        return sched.begin(**intake.popleft()) if intake else None

    sched = IterationScheduler(eng, window=4, prefill_budget=2, pull=pull,
                               packed_prefill=packed, overlap=overlap,
                               sync_dwell_s=0.0, registry=reg)
    arrivals = sorted(GREEDY_APC, key=lambda a: a[0])
    live = 0
    for i in range(60):
        intake.extend(a[2] for a in arrivals if a[0] == i)
        res = sched.iterate()
        live += len(res.admitted)
        for slot in range(eng.n_slots):
            if eng.active[slot] and eng.finished(slot):
                eng.release(slot)
    assert live == len(GREEDY_APC) and not sched.busy()
    want = dict.fromkeys(PHASES, 0.0)
    for name, cost, phase in PHASE_CALLS:
        want[phase] += cost * calls.get(name, 0)
    assert sched._phase_acc == want
    assert calls["scan_dispatch"] > 0 and calls["_finish_admit_resolve"] \
        == len(GREEDY_APC)
    if packed:
        assert calls.get("admit_step_packed", 0) > 0
    body = reg.render()
    assert (f'tpu_serve_window_phase_seconds_count{{phase="dispatch"}} '
            f'{calls["scan_dispatch"]}') in body
    duty = [v for n, _, v in obs.parse_exposition(body)
            if n == "tpu_serve_device_duty_cycle"]
    assert duty == [1.0]        # no owner time: all dispatch + harvest


def _serve_names(prof):
    evs = sorted((e for e in prof.events() if e.name.startswith("serve.")),
                 key=lambda e: e.time_range.start)
    return evs


def test_one_iterate_emits_admission_and_window_ranges_in_order(setup):
    """Under a recording profiler, an iterate that admits a 5-token
    prompt (2 chunks) and runs a window emits begin, admit (twice),
    splice, first_token, dispatch and harvest, in that order, none
    inside another."""
    eng = _engine(setup[0], n_slots=1, chunk=4, max_new_tokens=6)
    intake = deque([dict(prompt=[3, 14, 15, 92, 65])])

    def pull():
        return sched.begin(**intake.popleft()) if intake else None

    sched = IterationScheduler(eng, window=4, pull=pull, overlap=False,
                               sync_dwell_s=0.0)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        res = sched.iterate()
    assert len(res.admitted) == 1 and res.steps == 4
    evs = _serve_names(prof)
    assert [e.name for e in evs] == [
        "serve.begin", "serve.admit", "serve.admit", "serve.splice",
        "serve.first_token", "serve.dispatch", "serve.harvest"]
    for a, b in zip(evs, evs[1:]):
        assert a.time_range.end <= b.time_range.start, (a.name, b.name)


def test_no_profiler_call_while_none_records(setup, monkeypatch):
    """With no profiler recording, neither the scheduler nor the
    engine enters ``torch.profiler``: a drive with admissions (serial
    and packed), windows and the owner's phases runs with
    ``record_function`` made to raise."""
    def boom(*a, **kw):
        raise AssertionError("record_function entered")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    _drive(setup, GREEDY_APC, interleave=True, packed=True, overlap=True)
    sched = IterationScheduler(_engine(setup[0], n_slots=1))
    for phase in ("stream", "idle"):
        with sched.in_phase(phase):
            pass


@pytest.mark.parametrize("packed", [False, True], ids=["serial", "packed"])
def test_ticket_stamps_and_prefill_chunk_tokens(setup, packed):
    """Every admission's stamps keep their order (begin, splice, first
    token), and ``tpu_serve_first_token_wait_seconds`` observes each
    splice-to-first-token wait; the engine's ``prefill_chunk_tokens``
    counts the prompt tokens extended (pad rows and the prefix cache's
    reused tokens left out), the same total as ``prefill_tokens``, and
    ``tpu_serve_prefill_chunk_tokens_total`` renders it."""
    eng = _engine(setup[0], n_slots=2, chunk=4, max_new_tokens=6,
                  auto_prefix_min=4)
    intake: deque = deque()
    tickets = []

    def pull():
        if not intake:
            return None
        t = sched.begin(**intake.popleft())
        tickets.append(t)
        return t

    reg = obs.Registry()
    sched = IterationScheduler(eng, window=4, prefill_budget=2, pull=pull,
                               packed_prefill=packed, sync_dwell_s=0.0,
                               registry=reg)
    arrivals = sorted(GREEDY_APC, key=lambda a: a[0])
    for i in range(60):
        intake.extend(a[2] for a in arrivals if a[0] == i)
        sched.iterate()
        for slot in range(eng.n_slots):
            if eng.active[slot] and eng.finished(slot):
                eng.release(slot)
    assert len(tickets) == len(GREEDY_APC) and not sched.busy()
    extended = 0
    waits = []
    for t in tickets:
        assert t.t_begin <= t.t_splice <= t.t_done
        waits.append(t.t_done - t.t_splice)
        src = t.state.auto_src
        extended += len(t.state.prompt_np[0]) - (src[2] if src else 0)
    st = eng.stats()
    assert st["prefix_reused_tokens"] > 0
    assert eng.prefill_chunk_tokens == extended == st["prefill_tokens"]
    if packed:
        assert st["packed_prefill_pad_tokens"] > 0
    samples = {n: v for n, ls, v in obs.parse_exposition(reg.render())
               if not ls}
    assert samples["tpu_serve_first_token_wait_seconds_count"] \
        == len(tickets)
    assert samples["tpu_serve_first_token_wait_seconds_sum"] \
        == pytest.approx(sum(waits))
    assert samples["tpu_serve_prefill_chunk_tokens_total"] == extended


def test_prefill_chunk_tokens_count_at_each_chunk(setup):
    """The chunk counter moves at each chunk dispatch (its real rows
    only); ``prefill_tokens`` counts the whole prompt at the first."""
    eng = _engine(setup[0], n_slots=1, chunk=4)
    st = eng.begin_admit([3, 14, 15, 92, 65])
    eng.admit_step(st)
    assert (eng.prefill_chunk_tokens, eng.stats()["prefill_tokens"]) \
        == (4, 5)
    eng.admit_step(st)
    assert eng.prefill_chunk_tokens == 5


# -- against the JAX package -------------------------------------------------


PARITY = [
    (0, "a0", dict(prompt=PA)),
    (0, "g1", dict(prompt=[65, 66], grammar=True)),
    (0, "b0", dict(prompt=PB)),
    (1, "a1", dict(prompt=PA)),                  # exact repeat
    (2, "ash", dict(prompt=PA[:4] + [9, 9])),    # shared chunk
    (3, "g2", dict(prompt=[67, 68, 65, 66], grammar=True)),
    (5, "b1", dict(prompt=PB, stop=[22])),
]


@pytest.mark.parametrize("kv_paging", [False, True],
                         ids=["contiguous", "paged"])
def test_streams_equal_jax_scheduler(setup, kv_paging):
    """Greedy, APC-hit and grammar requests through the JAX scheduler and
    the port's, interleave + packed + overlap on, f32 weights converted
    from JAX: identical streams."""
    tm, _, (jm, params) = setup
    kw = dict(n_slots=3, chunk=4, eos_id=EOS, max_new_tokens=8,
              auto_prefix_min=4, kv_paging=kv_paging)
    jdfa = jg.token_dfa(jg.regex_to_dfa(PATTERN), TB, eos_id=EOS)
    want = _run_trace(JEngine(jm, params, grammar=jdfa, **kw), JScheduler,
                      PARITY, True, True, True)
    eng = _engine(tm, grammar=setup[1], **kw)
    got = _run_trace(eng, IterationScheduler, PARITY, True, True, True)
    assert got == want
    assert eng.stats()["packed_prefill_extends"] > 0


def _calls(o, reg):
    """One sequence of registry calls, on either package's obs."""
    c = reg.counter("demo_requests_total", "Requests.", ("code",))
    c.labels(code="200").inc()
    c.labels(code="500").inc(3)
    g = reg.gauge("demo_depth", "Queue depth.")
    g.set(2.5)
    h = reg.histogram("demo_latency_seconds", "Latency.", ("route",),
                      buckets=o.FAST_BUCKETS_S)
    for v in (0.0004, 0.003, 0.07, 2.0):
        h.labels(route='/x"y').observe(v)
    h2 = reg.histogram("demo_slow_seconds", "Slow\nthings.",
                       buckets=o.SLOW_BUCKETS_S)
    h2.observe(12.0)
    reg.on_collect(lambda: g.set(7))
    return reg.render()


def test_obs_copy_renders_reference_bytes():
    assert _calls(obs, obs.Registry()) == _calls(jobs, jobs.Registry())
    assert obs.LATENCY_BUCKETS_S == jobs.LATENCY_BUCKETS_S
    body = _calls(obs, obs.Registry())
    assert obs.parse_exposition(body) == jobs.parse_exposition(body)


@pytest.mark.parametrize("spec", [
    "serve.schedule:error:1",
    "serve.step:error:0.02; serve.schedule:hang:5",
    "probe:hang:5:0.5",
    "kubelet.register:drop:0.5",
    "",
    "serve.schedule:error",
    "serve.schedule:boom:1",
    ":error:1",
    "serve.schedule:error:x",
    "serve.schedule:error:1:0.5",
    "probe:hang:-1",
    "serve.step:error:1.5",
])
def test_fault_spec_parse_matches_reference(spec):
    def parse(mod):
        try:
            return [repr(r) for r in mod.FaultSpec.parse(spec).rules]
        except ValueError as e:
            return ("ValueError", str(e))
    assert parse(faults) == parse(jfaults)


def test_schedule_fault_raises_before_engine_mutation(setup):
    """An installed serve.schedule error fault raises out of iterate
    after admission and before any decode work: the engine's decode
    state is untouched and the request stays ticket-bound."""
    eng = _engine(setup[0], n_slots=1, chunk=4, max_new_tokens=8)
    sched = IterationScheduler(eng, window=4, overlap=False,
                               sync_dwell_s=0.0)
    sched.begin(prompt=[3, 14, 15, 92, 65])
    sched.iterate()                        # admits and runs a window
    before = (eng.stats(), list(eng.lens), eng.output(0))
    faults.install("serve.schedule:error:1", seed=0)
    try:
        with pytest.raises(faults.InjectedFault, match="serve.schedule"):
            sched.iterate()
        assert faults.ACTIVE.fired_count("serve.schedule") == 1
    finally:
        faults.uninstall()
    assert (eng.stats(), list(eng.lens), eng.output(0)) == before
    assert not eng.scan_inflight
