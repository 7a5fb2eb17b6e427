"""The decode step as a CUDA graph, on the card: the captured and
replayed step against the same step run op by op, bit for bit, for
``_decode_loop`` and for the engine's ``run_scan`` in every static
variant; the replay counts; captured addresses that stay valid across
splices and prefix copies between windows; and a capture that fails
raising rather than running eagerly.  Then the paged engine: the paged,
the int8 paged and the grammared steps as replays against their eager
steps; admission, preemption, resumption and copy-on-write landing in
the pool and the block tables between replays of one graph; a grammar
registered within the table's capacity seen by the captured step, and
a growth that recaptures it.

These need a CUDA device; elsewhere they skip.  On the GPU machine:

    python -m pytest tests/test_torch_graph_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from tpu_k8s_device_plugin_torch.workloads import bench_serving as tbench
from tpu_k8s_device_plugin_torch.workloads import grammar as tgrammar
from tpu_k8s_device_plugin_torch.workloads import inference as tinf
from tpu_k8s_device_plugin_torch.workloads import llama as tllama
from tpu_k8s_device_plugin_torch.workloads.serving import ServingEngine

pytestmark = pytest.mark.cuda

MAX_LEN = 128


@pytest.fixture(scope="module", params=[torch.float32, torch.bfloat16],
                ids=["f32", "bf16"])
def model(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    m = tllama.decoder(tllama.TINY_LLAMA, max_len=MAX_LEN,
                       dtype=request.param, device="cuda")
    tbench.random_init_(m, seed=0)
    return m


def _prompt(vocab, shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, vocab, shape)).cuda()


def _prefilled(model, prompt):
    B, T = prompt.shape
    pos = torch.arange(T, dtype=torch.int32, device="cuda").expand(B, T)
    logits, cache = tinf._prefill(model, prompt, pos)
    pos0 = torch.full((B,), T, dtype=torch.int32, device="cuda")
    return logits[:, -1], cache, pos0


def _copy(cache):
    return {n: {k: t.clone() for k, t in layer.items()}
            for n, layer in cache.items()}


@pytest.mark.parametrize("pick,top_k,temperature", [
    (tinf._greedy_pick, None, 1.0), (tinf._sample_pick, None, 1.3),
    (tinf._sample_pick, 8, 0.8)], ids=["greedy", "sampled", "top_k"])
def test_decode_loop_graph_matches_eager(model, pick, top_k, temperature):
    last, cache, pos0 = _prefilled(model, _prompt(model.vocab, (3, 20), 1))
    eager_cache, graph_cache = _copy(cache), _copy(cache)
    want = tinf._decode_loop(model, eager_cache, last, 12, pos0, top_k,
                             pick, temperature, 7, eager=True)
    before = tinf._decode_loop.graph_replays
    got = tinf._decode_loop(model, graph_cache, last, 12, pos0, top_k,
                            pick, temperature, 7)
    assert tinf._decode_loop.graph_replays - before == 11
    assert torch.equal(got, want)
    for name, layer in eager_cache.items():
        for key, t in layer.items():
            assert torch.equal(graph_cache[name][key], t), (name, key)


def test_greedy_generate_runs_through_the_graph(model):
    prompt = _prompt(model.vocab, (2, 9), 2)
    before = tinf._decode_loop.graph_replays
    toks, logits = tinf.greedy_generate(model, prompt, 6)
    assert tinf._decode_loop.graph_replays - before == 5
    assert torch.equal(toks[:, 0].long(), logits[:, -1].argmax(-1))


# one request mix a variant: the static flags each arms
MIXES = {
    "greedy": [dict()],
    "sampled": [dict(), dict(temperature=1.0, top_k=16, top_p=0.9)],
    "seeded": [dict(temperature=0.8, seed=3), dict(min_p=0.1,
                                                   temperature=1.0)],
    "logprobs": [dict(logprobs=3), dict(temperature=1.0)],
    "penalties": [dict(presence_penalty=0.5, frequency_penalty=0.7),
                  dict(repetition_penalty=1.3)],
    "bias_min": [dict(logit_bias={5: 3.0}), dict(min_tokens=6, stop=[7])],
    "fused": [dict(stop=[3, 9, 11, 12, 40]), dict(temperature=1.0,
                                                  seed=9, logprobs=2)],
}


def _engine(model, mix, graphs, **kw):
    eng = ServingEngine(model, n_slots=4, eos_id=1, logprobs_k=3, rng=17,
                        fused_decode=mix == "fused", **kw)
    eng._use_graphs = graphs
    for i, req in enumerate(MIXES[mix]):
        eng.admit(_prompt(model.vocab, (5 + 7 * i,), 10 + i).tolist(),
                  **req)
    return eng


def _state(eng):
    return ([eng.output(s) for s in range(eng.n_slots)],
            [eng.finish_reason(s) for s in range(eng.n_slots)],
            [eng.token_logprobs(s) for s in range(eng.n_slots)],
            eng._draws, eng._slot_draws, eng.stats())


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_run_scan_graph_matches_eager_in_every_variant(model, mix):
    graph, eager = (_engine(model, mix, g) for g in (True, False))
    for eng in (graph, eager):
        eng.run_scan(5)
        eng.step()
        eng.run_scan(4)
    assert _state(graph) == _state(eager)
    # a window after every slot retired dispatches nothing
    assert graph.graph_replays == graph.stats()["decode_steps"] > 0
    assert eager.graph_replays == 0
    assert graph._graphs and not eager._graphs
    # the engine's cache rows match bit for bit too
    for name, layer in eager.cache.items():
        for key, t in layer.items():
            assert torch.equal(graph.cache[name][key], t), (name, key)


def test_step_replays_the_captured_step_once(model):
    eng = _engine(model, "sampled", True)
    eng.step()
    assert eng.graph_replays == 1 and len(eng._graphs) == 1
    eng.step()
    eng.run_scan(3)
    assert eng.graph_replays == 5 and len(eng._graphs) == 1


def test_captured_addresses_survive_splices_between_windows(model):
    """Windows around admissions that copy rows into the cache (a cold
    splice, a registered prefix, a resident-slot prefix, an exact
    repeat in place): the graph captured before them replays after
    them, and the tokens stay those of the eager engine."""
    shared = _prompt(model.vocab, (24,), 20).tolist()
    outs = []
    for graphs in (True, False):
        eng = ServingEngine(model, n_slots=4, chunk=8, auto_prefix_min=8,
                            rng=3)
        eng._use_graphs = graphs
        a = eng.admit(shared + [5, 6])
        eng.run_scan(4)
        captured = dict(eng._graphs)
        h = eng.register_prefix(shared[:16])
        b = eng.admit(shared[:16] + [9, 9, 9], prefix=h)
        c = eng.admit(shared + [7])                  # resident-slot rows
        eng.run_scan(4)
        eng.release(c)
        c2 = eng.admit(shared + [7])                 # exact, in place
        eng.run_scan(4)
        if graphs:
            assert all(eng._graphs[k] is g for k, g in captured.items())
            assert len(eng._graphs) == 1
            assert eng.stats()["prefix_cache_hits"] == 2
        outs.append([eng.output(s) for s in (a, b, c2)])
    assert outs[0] == outs[1]


def test_failed_capture_raises_instead_of_running_eagerly(model):
    eng = _engine(model, "greedy", True)
    real = eng._decode_step

    def syncing_step(flags):
        real(flags)
        if torch.cuda.is_current_stream_capturing():
            eng._w.tok.sum().item()  # a host sync: illegal in a capture

    eng._decode_step = syncing_step
    lens, outs = list(eng.lens), [eng.output(s) for s in range(4)]
    with pytest.raises(RuntimeError):
        eng.run_scan(3)
    assert eng.graph_replays == 0 and not eng._graphs
    assert eng.lens == lens
    assert [eng.output(s) for s in range(4)] == outs


# -- the paged engine --------------------------------------------------------

EOS = 1
PATTERN = "(ab|cd)+e"


def _token_bytes(vocab):
    return [bytes([i]) if 2 <= i < 128 else b"" for i in range(vocab)]


def _dfa(model, pattern=PATTERN):
    return tgrammar.token_dfa(tgrammar.regex_to_dfa(pattern),
                              _token_bytes(model.vocab), eos_id=EOS)


PAGED = {
    "paged": (dict(), MIXES["sampled"] + MIXES["penalties"]),
    "int8": (dict(kv_dtype="int8"), MIXES["seeded"] + MIXES["logprobs"]),
    "grammar": (dict(), [dict(grammar=True), dict(),
                         dict(temperature=1.0, seed=4, grammar=True)]),
}


def _paged_engine(model, variant, graphs, **kw):
    extra, reqs = PAGED[variant]
    eng = ServingEngine(model, n_slots=4, eos_id=EOS, logprobs_k=3, rng=17,
                        chunk=16, kv_paging=True,
                        grammar=_dfa(model) if variant == "grammar" else None,
                        **extra, **kw)
    eng._use_graphs = graphs
    for i, req in enumerate(reqs):
        eng.admit(_prompt(model.vocab, (5 + 9 * i,), 30 + i).tolist(),
                  **req)
    return eng


def _valid_rows(eng):
    """Every active slot's K/V rows below its depth, gathered from the
    pool in storage form."""
    from tpu_k8s_device_plugin_torch.workloads.serving import (
        _paged_gather_raw,
    )

    out = {}
    for s in range(eng.n_slots):
        if not eng.active[s]:
            continue
        raw = _paged_gather_raw(eng.cache, eng._pool.tables[s])
        for layer, kv in raw.items():
            for name, t in kv.items():
                t = torch.as_tensor(t)
                out[(s, layer, name)] = t.reshape(
                    (-1,) + tuple(t.shape[2:]))[:eng.lens[s]]
    return out


def _assert_same_rows(a, b):
    assert a.keys() == b.keys()
    for key, t in a.items():
        assert torch.equal(t, b[key]), key


@pytest.mark.parametrize("variant", sorted(PAGED))
def test_paged_steps_graph_match_eager(model, variant):
    graph, eager = (_paged_engine(model, variant, g) for g in (True, False))
    for eng in (graph, eager):
        eng.run_scan(5)
        eng.step()
        eng.run_scan(4)
    assert _state(graph) == _state(eager)
    assert graph.gstate.tolist() == eager.gstate.tolist()
    assert graph.graph_replays == graph.stats()["decode_steps"] > 0
    assert eager.graph_replays == 0 and not eager._graphs
    # every captured variant is a paged one, grammared where it must be
    assert all(flags[-1] for flags in graph._graphs)
    if variant == "grammar":
        assert any(flags[7] for flags in graph._graphs)
    _assert_same_rows(_valid_rows(graph), _valid_rows(eager))


def test_pool_changes_land_between_replays(model):
    """Admission (a cold one, a shared prefix, an exact repeat that
    copies on write), preemption and resumption between windows: the
    graph captured before them replays after them, reading the pool and
    the block tables the changes wrote in place, and the ids stay the
    eager engine's."""
    shared = _prompt(model.vocab, (40,), 50).tolist()
    outs, rows = [], []
    for graphs in (True, False):
        eng = ServingEngine(model, n_slots=4, chunk=16, rng=3,
                            kv_paging=True, auto_prefix_min=16)
        eng._use_graphs = graphs
        a = eng.admit(shared + [5, 6])
        b = eng.admit(_prompt(model.vocab, (20,), 51).tolist(),
                      temperature=0.9, seed=8)
        eng.run_scan(4)
        captured = dict(eng._graphs)
        state = eng.preempt(b)
        c = eng.admit(shared + [9, 9])                # shares 2 pages
        d = eng.admit(shared + [5, 6])                # exact repeat
        cow = eng._pool.cow_copies
        eng.run_scan(3)
        assert eng._pool.cow_copies > cow
        b2 = eng.resume(state)
        eng.run_scan(4)
        if graphs:
            assert all(eng._graphs[k] is g for k, g in captured.items())
            assert eng.stats()["kv_preemptions"] == 1
        outs.append([eng.output(s) for s in (a, b2, c, d)])
        rows.append(_valid_rows(eng))
        eng._pool.check()
    assert outs[0] == outs[1]
    _assert_same_rows(*rows)


def test_grammar_registration_reaches_the_captured_step(model):
    """A grammar registered within the table's capacity is a copy into
    the table the captured step reads: the same graph decodes under it.
    One past the capacity allocates a new table and recaptures."""
    outs = []
    for graphs in (True, False):
        eng = ServingEngine(model, n_slots=3, eos_id=EOS, chunk=16,
                            kv_paging=True, grammar=_dfa(model),
                            max_new_tokens=20)
        eng._use_graphs = graphs
        eng.admit(_prompt(model.vocab, (9,), 60).tolist(), grammar=True)
        eng.run_scan(2)
        graphs_before = dict(eng._graphs)
        captures = eng.graph_captures
        digits = eng.register_grammar(_dfa(model, r"\d+"))
        s1 = eng.admit(_prompt(model.vocab, (7,), 61).tolist(),
                       grammar=digits)
        eng.run_scan(3)
        if graphs:
            assert eng.graph_captures == captures
            assert all(eng._graphs[k] is g
                       for k, g in graphs_before.items())
        table = eng._gtable
        big = eng.register_grammar(_dfa(model, tgrammar.json_value_regex(1)))
        assert eng._gtable is not table
        s2 = eng.admit(_prompt(model.vocab, (6,), 62).tolist(), grammar=big)
        eng.run_scan(3)
        if graphs:
            assert eng.graph_captures == captures + 1
        outs.append([eng.output(s) for s in range(3)])
        text = bytes(t for t in eng.output(s1) if t >= 2).decode("latin-1")
        assert text.isdigit() or not text
        del s2
    assert outs[0] == outs[1]
