"""Randomized engine fuzz on the port, mirroring tests/test_engine_fuzz.py.

Every request's output is independent of its neighbours, the admission
order and which decode APIs happened to run (``step``, ``run_scan``,
``spec_round`` with n-gram proposals, ``jump_round``).  Random admits (greedy, seeded sampling, grammar
constraints, stop ids, min_tokens, ignore_eos) go into random mixes of
those calls with random releases, and every retired request is checked
token for token against a solo single-slot engine running it alone.
The fused window is held to the unfused one the same way, and random
traces through the iteration scheduler with random toggles to its
serial arm.  The decoder is tests/test_engine_fuzz.py's (vocab 96,
d_model 64, 4 heads, 2 layers, max_len 64, f32, chunk 4), initialised
by JAX and converted; ``ENGINE_FUZZ_SEED`` sweeps other interleavings.
"""

import os
import random
from collections import deque

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_k8s_device_plugin.workloads.inference import make_decoder
from tpu_k8s_device_plugin_torch.convert import params_from_jax
from tpu_k8s_device_plugin_torch.workloads import grammar as tg
from tpu_k8s_device_plugin_torch.workloads import inference as tinf
from tpu_k8s_device_plugin_torch.workloads.scheduler import (
    IterationScheduler,
)
from tpu_k8s_device_plugin_torch.workloads.serving import ServingEngine

CFG = dict(vocab=96, d_model=64, n_heads=4, n_layers=2, d_ff=128)
EOS = 0
MAX_LEN = 64
PATTERN = "(AB|CD)+E"  # bytes < 96
SEED = int(os.environ.get("ENGINE_FUZZ_SEED") or 2026)


@pytest.fixture(scope="module")
def models():
    jm = make_decoder(**CFG, max_len=MAX_LEN, dtype=jnp.float32)
    tokens = jnp.zeros((1, 8), jnp.int32)
    pos = jnp.broadcast_to(jnp.arange(8, dtype=jnp.int32), (1, 8))
    params = jm.init(jax.random.PRNGKey(0), tokens, pos)["params"]
    tm = tinf.make_decoder(**CFG, max_len=MAX_LEN, dtype=torch.float32,
                           device="cpu")
    tm.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    tb = [bytes([i]) if i else b"" for i in range(CFG["vocab"])]
    return tm, tg.token_dfa(tg.regex_to_dfa(PATTERN), tb, eos_id=EOS)


def _engine(model, dfa, n_slots, max_new, **kw):
    return ServingEngine(model, n_slots=n_slots, eos_id=EOS,
                         max_new_tokens=max_new, chunk=4, auto_prefix_min=4,
                         grammar=dfa, device="cpu", **kw)


def _rand_request(rnd):
    """One random request (admit kwargs) from the feature product:
    greedy or seeded sampling, both solo-reproducible by design."""
    kw = {}
    prompt = [rnd.randrange(1, CFG["vocab"])
              for _ in range(rnd.randint(2, 8))]
    if rnd.random() < 0.35:
        kw["grammar"] = True
        prompt = [70, 71, 72][:rnd.randint(1, 3)]
    if rnd.random() < 0.4:
        kw["temperature"] = rnd.choice([0.7, 1.0])
        kw["seed"] = rnd.randrange(1000)
        if rnd.random() < 0.5:
            kw["top_k"] = rnd.choice([8, 32])
    if rnd.random() < 0.3:
        kw["stop"] = [rnd.randrange(1, CFG["vocab"])]
    if rnd.random() < 0.25:
        kw["min_tokens"] = rnd.randint(1, 3)
    if rnd.random() < 0.15:
        kw["ignore_eos"] = True
    return prompt, kw


def test_fused_boundary_fuzz_matches_unfused(models):
    """eos, stop-set and budget cuts landing inside run_scan windows
    leave the fused engine identical to the unfused one: outputs, finish
    reasons, logprob records and draw chains."""
    model, dfa = models

    def arm(fused, trial):
        rnd = random.Random(SEED * 7919 + trial)
        max_new = rnd.randint(4, 7)
        eng = _engine(model, dfa, 3, max_new, logprobs_k=3,
                      fused_decode=fused)
        live, done = {}, []
        for _ in range(50):
            op = rnd.random()
            if op < 0.4 and eng.free_slots():
                prompt, kw = _rand_request(rnd)
                if rnd.random() < 0.3:
                    kw["logprobs"] = rnd.randint(1, 3)
                if rnd.random() < 0.5:
                    kw["stop"] = sorted(set(
                        (kw.get("stop") or [])
                        + [rnd.randrange(1, CFG["vocab"])
                           for _ in range(3)]))
                s = eng.admit(prompt, **kw)
                live[s] = (prompt, kw)
            elif op < 0.85 and any(eng.active):
                n = rnd.randint(1, 5)
                if all(eng.lens[s] + n <= MAX_LEN
                       for s in range(3) if eng.active[s]):
                    eng.run_scan(n)
            elif op < 0.95 and live:
                s = rnd.choice(list(live))
                del live[s]
                eng.release(s)
            for s in list(live):
                if eng.finished(s):
                    prompt, kw = live.pop(s)
                    done.append((prompt, kw, eng.output(s),
                                 eng.finish_reason(s),
                                 eng.token_logprobs(s)))
        return done, eng._draws, list(eng._slot_draws)

    retired = boundary = 0
    for trial in range(2):
        base = arm(False, trial)
        assert arm(True, trial) == base, f"fused diverged (trial {trial})"
        retired += len(base[0])
        boundary += sum(1 for d in base[0] if d[3] in ("eos", "stop"))
    if SEED == 2026:
        assert retired >= 8 and boundary >= 1, (retired, boundary)
    else:
        assert retired >= 1, retired


def _solo(model, dfa, max_new, prompt, kw):
    solo = _engine(model, dfa, 1, max_new)
    s = solo.admit(prompt, **kw)
    solo.run(max_new + 4)
    return solo.output(s), solo.finish_reason(s)


def test_random_interleavings_match_solo_oracles(models):
    model, dfa = models
    rnd = random.Random(SEED)
    checked = jumped = spec = 0
    for trial in range(3):
        max_new = rnd.randint(5, 8)
        eng = _engine(model, dfa, 3, max_new, jump_len=4, draft="ngram",
                      gamma=3)
        live, done = {}, []

        def harvest():
            for s in list(live):
                if eng.finished(s):
                    prompt, kw = live.pop(s)
                    done.append((prompt, kw, eng.output(s),
                                 eng.finish_reason(s)))

        for _ in range(40):
            op = rnd.random()
            if op < 0.35 and eng.free_slots():
                prompt, kw = _rand_request(rnd)
                s = eng.admit(prompt, **kw)
                live[s] = (prompt, kw)
            elif op < 0.5:
                eng.step()
            elif op < 0.7:
                n = rnd.randint(1, 4)
                if any(eng.active) and all(
                        eng.lens[s] + n <= MAX_LEN
                        for s in range(3) if eng.active[s]):
                    eng.run_scan(n)
            elif op < 0.8 and eng.spec_ready():
                eng.spec_round()
                spec += 1
            elif op < 0.9 and eng.forced_pending():
                if eng.jump_round() is not None:
                    jumped += 1
            elif op < 0.95 and live:
                s = rnd.choice(list(live))
                del live[s]
                eng.release(s)
            harvest()
        for _ in range(30):
            if not any(eng.active):
                break
            eng.step()
            harvest()
        for prompt, kw, out, reason in done:
            assert _solo(model, dfa, max_new, prompt, kw) == (out, reason), (
                prompt, kw, trial)
            checked += 1
    assert checked >= (10 if SEED == 2026 else 1), checked
    if SEED == 2026:
        assert jumped >= 1 and spec >= 1, (jumped, spec)


def _sched_run(model, dfa, trace, max_new, interleave, packed, overlap,
               fused, paged):
    eng = _engine(model, dfa, 3, max_new, fused_decode=fused,
                  kv_paging=paged)
    intake: deque = deque()
    keys, live, out = {}, {}, {}

    def pull():
        if not intake:
            return None
        i, (prompt, kw) = intake.popleft()
        t = sched.begin(prompt, **kw)
        keys[t] = i
        return t

    sched = IterationScheduler(eng, window=3, interleave=interleave,
                               prefill_budget=2, pull=pull,
                               packed_prefill=packed, max_pack=3,
                               overlap=overlap, sync_dwell_s=0.0)
    for it in range(300):
        intake.extend((i, req) for i, (at, req) in enumerate(trace)
                      if at == it)
        for t in sched.iterate().admitted:
            live[t.slot] = keys.pop(t)
        for s in list(live):
            if eng.finished(s):
                out[live.pop(s)] = (eng.output(s), eng.finish_reason(s))
        if len(out) == len(trace) and not sched.busy():
            break
    assert len(out) == len(trace), "trace did not drain"
    return out, eng.stats()["packed_prefill_extends"]


def test_scheduler_fuzz_matches_serial(models):
    """Random traces (random arrivals, prompt lengths and knobs, shared
    prefixes) through the scheduler with random interleave, packing,
    overlap, fused and paged toggles give the serial arm's streams."""
    model, dfa = models
    rnd = random.Random(SEED + 1)
    packed_extends = 0
    for trial in range(6):
        max_new = rnd.randint(4, 7)
        trace, at = [], 0
        for _ in range(7):
            at += rnd.choice([0, 0, 1, 2])
            prompt, kw = _rand_request(rnd)
            if rnd.random() < 0.4:
                prompt = [3, 14, 15, 92, 65, 35, 89, 79][
                    :rnd.randint(4, 8)] + prompt
            trace.append((at, (prompt, kw)))
        base, _ = _sched_run(model, dfa, trace, max_new, False, False,
                             False, False, False)
        for _ in range(3):
            toggles = [rnd.random() < 0.5 for _ in range(4)]
            got, n = _sched_run(model, dfa, trace, max_new, True, *toggles)
            assert got == base, (trial, toggles)
            packed_extends += n
    assert packed_extends > 0
