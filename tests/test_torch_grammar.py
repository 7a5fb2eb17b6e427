"""Grammar-constrained decoding in the port against the JAX package.

The port keeps its own copy of ``grammar.py``: over the pattern grid and
the schema fuzz of tests/test_grammar.py its ``regex_to_dfa``,
``token_dfa`` and schema lowering give tables equal to the reference's.
Then the engines: the decoder of tests/test_grammar.py (vocab 128,
d_model 64, 4 heads, 2 layers, max_len 64, f32), initialised by JAX and
converted; ids below 128 are their ASCII byte and 0 is eos.  Greedy
constrained ids equal the JAX engine's (step, windows, per-request
grammars, registration after construction, jump rounds), a window
equals single steps, a capacity growth drops the steps that read the
old table and decodes the same, and the error messages are the
reference's."""

import json
import random
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_k8s_device_plugin.workloads import grammar as jg
from tpu_k8s_device_plugin.workloads.inference import make_decoder
from tpu_k8s_device_plugin.workloads.serving import ServingEngine as JEngine
from tpu_k8s_device_plugin_torch.convert import params_from_jax
from tpu_k8s_device_plugin_torch.workloads import grammar as tg
from tpu_k8s_device_plugin_torch.workloads import inference as tinf
from tpu_k8s_device_plugin_torch.workloads.serving import ServingEngine

CFG = dict(vocab=128, d_model=64, n_heads=4, n_layers=2, d_ff=128)
EOS = 0
PATTERN = "(ab|cd)+e"
TB = [bytes([i]) if i else b"" for i in range(CFG["vocab"])]
SCHEMA = {"type": "object",
          "properties": {"id": {"type": "integer"},
                         "ok": {"type": "boolean"}}}


@pytest.fixture(scope="module")
def setup():
    jm = make_decoder(**CFG, max_len=64, dtype=jnp.float32)
    tokens = jnp.zeros((1, 8), jnp.int32)
    pos = jnp.broadcast_to(jnp.arange(8, dtype=jnp.int32), (1, 8))
    params = jm.init(jax.random.PRNGKey(0), tokens, pos)["params"]
    tm = tinf.make_decoder(**CFG, max_len=64, dtype=torch.float32,
                           device="cpu")
    tm.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, tm


def _dfas(pattern):
    """The reference's and the port's token DFA of *pattern*."""
    return (jg.token_dfa(jg.regex_to_dfa(pattern), TB, eos_id=EOS),
            tg.token_dfa(tg.regex_to_dfa(pattern), TB, eos_id=EOS))


def _engines(setup, pattern=PATTERN, **kw):
    jm, params, tm = setup
    jd, td = _dfas(pattern)
    return (JEngine(jm, params, grammar=jd, **kw),
            ServingEngine(tm, grammar=td, device="cpu", **kw))


def _decode(ids):
    return bytes(t for t in ids if t).decode("latin-1")


def _walk_valid(text, pattern):
    d = tg.regex_to_dfa(pattern)
    cur = 0
    for b in text.encode():
        cur = int(d.table[cur, b])
        if cur < 0:
            return False
    return True


# -- the compiler: the port's tables are the reference's ---------------------


def _random_patterns(n):
    """The pattern generator of the reference's differential fuzz."""
    rnd = random.Random(1234)
    alphabet = "abc01"

    def gen(depth):
        kind = rnd.choice(
            ["lit", "lit", "class", "alt", "cat", "star", "plus",
             "opt"] if depth > 0 else ["lit", "class"])
        if kind == "lit":
            return rnd.choice(alphabet)
        if kind == "class":
            chars = "".join(sorted(set(
                rnd.choice(alphabet) for _ in range(rnd.randint(1, 3)))))
            neg = "^" if rnd.random() < 0.2 else ""
            return f"[{neg}{chars}]"
        if kind == "alt":
            return "(" + gen(depth - 1) + "|" + gen(depth - 1) + ")"
        if kind == "cat":
            return gen(depth - 1) + gen(depth - 1)
        return "(" + gen(depth - 1) + ")" + {
            "star": "*", "plus": "+", "opt": "?"}[kind]

    return [gen(3) for _ in range(n)]


GRID = [PATTERN, r"\d+(\.\d+)?", r"\d+", "(AB|CD)+E", "[^a]b*",
        jg.json_value_regex(1), jg.schema_to_regex(SCHEMA)]


def _same_char_dfa(pattern):
    try:
        want = jg.regex_to_dfa(pattern)
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            tg.regex_to_dfa(pattern)
        return None
    got = tg.regex_to_dfa(pattern)
    assert np.array_equal(got.table, want.table), pattern
    assert np.array_equal(got.accepting, want.accepting), pattern
    return got


PATTERNS = GRID + _random_patterns(60)


@pytest.mark.parametrize("pattern", PATTERNS,
                         ids=[f"p{i}" for i in range(len(PATTERNS))])
def test_char_and_token_dfa_tables_equal_reference(pattern):
    if _same_char_dfa(pattern) is None:
        return
    tb = [bytes([i]) if i else b"" for i in range(64)] + [
        b"ab", b"01", b"c", b"\\d", b"0.", b"1a"]
    try:
        want = jg.token_dfa(jg.regex_to_dfa(pattern), tb, eos_id=0)
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            tg.token_dfa(tg.regex_to_dfa(pattern), tb, eos_id=0)
        return
    got = tg.token_dfa(tg.regex_to_dfa(pattern), tb, eos_id=0)
    assert got.start == want.start
    assert np.array_equal(got.table, want.table)


def test_regex_compiler_grid():
    d = tg.regex_to_dfa(r"\d+(\.\d+)?")

    def m(s):
        cur = 0
        for b in s.encode():
            cur = int(d.table[cur, b])
            if cur < 0:
                return False
        return bool(d.accepting[cur])

    assert m("42") and m("3.14") and m("0")
    assert not m("") and not m(".5") and not m("3.") and not m("a")


def test_schema_lowering_fuzz_equals_reference():
    """The schemas of the reference's schema fuzz lower to the same
    regex, and compile to the same DFA, in both packages."""
    rnd = random.Random(99)

    def gen_schema(depth):
        kinds = ["string", "integer", "boolean", "null", "enum"]
        if depth > 0:
            kinds += ["object", "array"]
        k = rnd.choice(kinds)
        if k == "enum":
            return {"enum": rnd.sample(
                ["a", "b c", 'q"t', 0, 17, True, None], 3)}
        if k == "object":
            return {"type": "object", "properties": {
                name: gen_schema(depth - 1)
                for name in rnd.sample(["x", "y", "z"],
                                       rnd.randint(1, 3))}}
        if k == "array":
            return {"type": "array", "items": gen_schema(depth - 1)}
        return {"type": k}

    for _ in range(30):
        schema = gen_schema(2)
        want = jg.schema_to_regex(schema)
        assert tg.schema_to_regex(schema) == want, schema
        _same_char_dfa(want)
    for depth in (1, 2):
        assert tg.json_value_regex(depth) == jg.json_value_regex(depth)
        assert tg.json_object_regex(depth) == jg.json_object_regex(depth)


def test_json_lowering_is_rfc_strict():
    d = tg.regex_to_dfa(tg.json_value_regex(1))

    def m(s, dfa=d):
        cur = 0
        for b in s.encode():
            cur = int(dfa.table[cur, b])
            if cur < 0:
                return False
        return bool(dfa.accepting[cur])

    assert m('"a\\nb"') and m('"q\\"uo"') and m('"u\\u00e9x"')
    assert not m('"a\nb"') and not m('"a\\qb"') and not m("007")
    assert m("0") and m("0.5") and m("-10e3")
    e = tg.regex_to_dfa(tg.schema_to_regex({"enum": ['say "hi"']}))
    assert m(json.dumps('say "hi"'), e) and not m('"say "hi""', e)


def test_token_bytes_of_matches_reference():
    class Tok:
        all_special_ids = [2]

        def convert_ids_to_tokens(self, i):
            return ["a", "Ġb", "<s>", "Ċ", "<0x41>", "é"][i]

        def __len__(self):
            return 6

    tok = Tok()
    assert tg.token_bytes_of(tok, 8) == jg.token_bytes_of(tok, 8)


# -- the engine: constrained ids equal the JAX engine's ---------------------


def test_constrained_greedy_ids_equal_reference(setup):
    def run(eng):
        s = eng.admit([70, 71, 72], grammar=True)
        u = eng.admit([5, 9, 3])
        eng.run(12)
        return (eng.output(s), eng.finish_reason(s), eng.output(u),
                eng.gstate.tolist())

    want, got = (run(e) for e in _engines(setup, n_slots=2, eos_id=EOS,
                                          max_new_tokens=10))
    assert got == want
    out, reason = got[0], got[1]
    if reason == "eos":
        assert re.fullmatch(PATTERN, _decode(out))
    assert _walk_valid(_decode(out), PATTERN)


@pytest.mark.parametrize("fused", [False, True])
def test_windows_equal_steps_and_reference(setup, fused):
    def mk(eng):
        return eng, eng.admit([70, 71], grammar=True), eng.admit([5, 9, 3])

    ref, port = _engines(setup, n_slots=2, eos_id=EOS, max_new_tokens=10,
                         fused_decode=fused)
    stepped = ServingEngine(setup[2], grammar=_dfas(PATTERN)[1],
                            n_slots=2, eos_id=EOS, max_new_tokens=10,
                            device="cpu")
    outs = []
    for eng in (ref, port):
        e, s, u = mk(eng)
        e.run_scan(4)   # the DFA state must survive the window boundary
        e.run_scan(6)
        outs.append((e.output(s), e.output(u), e.gstate.tolist()))
    e, s, u = mk(stepped)
    for _ in range(12):
        e.step()
    outs.append((e.output(s), e.output(u), e.gstate.tolist()))
    assert outs[1] == outs[0] == outs[2]


def test_per_request_grammars_and_late_registration(setup):
    jd_digits = jg.token_dfa(jg.regex_to_dfa(r"\d+"), TB, eos_id=EOS)
    td_digits = tg.token_dfa(tg.regex_to_dfa(r"\d+"), TB, eos_id=EOS)

    def run(eng, digits):
        with pytest.raises(ValueError, match="grammar"):
            eng.admit([70], grammar=True)
        g0 = eng.register_grammar(_dfa_of(eng, PATTERN))
        g1 = eng.register_grammar(digits)
        assert (g0, g1, eng.n_grammars) == (0, 1, 2)
        s0 = eng.admit([70, 71, 72], grammar=g0)
        s1 = eng.admit([70, 71, 72], grammar=g1)
        eng.run(14)
        return (eng.output(s0), eng.output(s1),
                [eng.grammar_rel(int(g)) for g in eng.gstate],
                eng.grammar_abs(1, 0), eng._gtable_np.dtype.name)

    jm, params, tm = setup
    want = run(JEngine(jm, params, n_slots=2, eos_id=EOS,
                       max_new_tokens=12), jd_digits)
    got = run(ServingEngine(tm, n_slots=2, eos_id=EOS, max_new_tokens=12,
                            device="cpu"), td_digits)
    assert got == want
    assert _walk_valid(_decode(got[0]), PATTERN)
    t1 = _decode(got[1])
    assert t1 and all(c.isdigit() for c in t1)


def _dfa_of(eng, pattern):
    mod = tg if isinstance(eng, ServingEngine) else jg
    return mod.token_dfa(mod.regex_to_dfa(pattern), TB, eos_id=EOS)


def test_capacity_growth_drops_graphs_and_decodes_the_same(setup):
    """A registration within capacity writes into the same device table;
    one past it (64 -> 256 states) allocates a new table and drops the
    captured steps that read the old one, and decoding under the first
    grammar goes on as before."""
    tm = setup[2]
    grown = ServingEngine(tm, grammar=_dfas(PATTERN)[1], n_slots=2,
                          eos_id=EOS, max_new_tokens=10, device="cpu")
    plain = ServingEngine(tm, grammar=_dfas(PATTERN)[1], n_slots=2,
                          eos_id=EOS, max_new_tokens=10, device="cpu")
    table = grown._gtable
    # stand-ins for captured steps, one grammared and one not (the
    # grammared flag is the eighth of the static key)
    grammared = (False, 0, False, False, False, False, False, True,
                 False, 0, False)
    plain_key = grammared[:7] + (False,) + grammared[8:]
    grown._graphs = {grammared: object(), plain_key: object()}
    grown.register_grammar(tg.token_dfa(tg.regex_to_dfa(r"\d+"), TB, EOS))
    assert grown._gtable is table and len(grown._graphs) == 2
    used, before = grown._gstates_used, table.clone()
    gid = grown.register_grammar(tg.token_dfa(
        tg.regex_to_dfa(tg.json_value_regex(1)), TB, EOS))
    assert grown._gtable is not table
    assert grown._gtable.shape[0] == 256 and list(grown._graphs) == \
        [plain_key]
    assert torch.equal(grown._gtable[:used], before[:used])
    for eng in (grown, plain):
        eng.admit([70, 71, 72], grammar=True)
        eng.admit([5, 9, 3])
        eng.run_scan(5)
        eng.run_scan(5)
    assert [grown.output(s) for s in (0, 1)] == \
        [plain.output(s) for s in (0, 1)]
    s = grown.admit([70, 71], grammar=gid)
    grown.run(8)
    assert _walk_valid(_decode(grown.output(s)), tg.json_value_regex(1))


def test_jump_round_equals_step_decoding_and_reference(setup):
    """jump_round commits forced chains (the schema's literal keys) in
    one extend; the ids equal plain steps, and the JAX engine's jumps."""
    jm, params, tm = setup
    pattern = tg.schema_to_regex(SCHEMA)

    def mk(eng):
        return eng, eng.admit([70, 71, 72], grammar=True), eng.admit([5, 9])

    def jumps(eng):
        eng, s, u = mk(eng)
        best = 0
        for _ in range(30):
            if not any(eng.active):
                break
            if eng.forced_pending():
                got = eng.jump_round()
                assert got is not None
                best = max(best, max(len(v) for v in got.values()))
            else:
                eng.step()
        return eng.output(s), eng.output(u), best, eng.stats()

    kw = dict(n_slots=2, eos_id=EOS, max_new_tokens=24, jump_len=6)
    ref = jumps(JEngine(jm, params, grammar=_dfas(pattern)[0], **kw))
    port = jumps(ServingEngine(tm, grammar=_dfas(pattern)[1],
                               device="cpu", **kw))
    stepped, s, u = mk(ServingEngine(tm, grammar=_dfas(pattern)[1],
                                     device="cpu", **kw))
    for _ in range(30):
        if not any(stepped.active):
            break
        stepped.step()
    assert port[:3] == ref[:3]
    assert (port[0], port[1]) == (stepped.output(s), stepped.output(u))
    assert port[2] >= 2
    for key in ("jump_rounds", "jump_forced_tokens", "decode_steps",
                "tokens_emitted"):
        assert port[3][key] == ref[3][key], key
    assert _walk_valid(_decode(port[0]), pattern)


def test_jump_round_guards_and_endgame(setup):
    jm, params, tm = setup
    eng = ServingEngine(tm, grammar=_dfas(PATTERN)[1], n_slots=1,
                        eos_id=EOS, device="cpu")
    eng.admit([70], grammar=True, temperature=0.7)
    assert not eng.jump_ready() and not eng.forced_pending()
    with pytest.raises(ValueError, match="jump_ready"):
        eng.jump_round()
    small = tinf.make_decoder(**CFG, max_len=16, dtype=torch.float32,
                              device="cpu")
    small.load_state_dict(tm.state_dict())
    eng = ServingEngine(small, grammar=_dfas("(AB|CD)+E")[1], n_slots=1,
                        eos_id=EOS, jump_len=8, device="cpu")
    s = eng.admit([70, 71, 72, 73, 74, 75, 76, 77], grammar=True)
    assert eng.jump_round() is None  # 16 - 8 rows < jump_len + 1
    eng.step()
    assert len(eng.output(s)) >= 2


def _message(fn):
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


def test_error_messages_equal_reference(setup):
    jm, params, tm = setup
    ref, port = _engines(setup, n_slots=1, eos_id=EOS)
    assert (_message(lambda: port.admit([70], grammar=3))
            == _message(lambda: ref.admit([70], grammar=3)))
    small_tb = [bytes([i]) if i else b"" for i in range(64)]
    assert _message(lambda: ServingEngine(
        tm, n_slots=1, device="cpu", grammar=tg.token_dfa(
            tg.regex_to_dfa("0+"), small_tb, eos_id=0))) == _message(
        lambda: JEngine(jm, params, n_slots=1, grammar=jg.token_dfa(
            jg.regex_to_dfa("0+"), small_tb, eos_id=0)))
    assert _message(lambda: tg.token_dfa(
        tg.regex_to_dfa("a+"), small_tb, eos_id=0)) == _message(
        lambda: jg.token_dfa(jg.regex_to_dfa("a+"), small_tb, eos_id=0))
    no_grammar = ServingEngine(tm, n_slots=1, device="cpu")
    assert _message(lambda: no_grammar.admit([1, 2], grammar=True)) == \
        _message(lambda: JEngine(jm, params, n_slots=1).admit(
            [1, 2], grammar=True))
    assert "dead-end" in _message(lambda: tg.token_dfa(
        tg.regex_to_dfa("ab"), [b"", b"a", b"c"], eos_id=0))


def test_grammar_composes_with_prefix_reuse(setup):
    def run(eng):
        shared = [7, 3, 9, 12, 5, 8, 1, 2]
        eng.admit(shared + [5, 9])
        sg = eng.admit(shared + [44], grammar=True)
        eng.run(10)
        return eng.output(sg), eng.stats()["prefix_cache_hits"]

    want, got = (run(e) for e in _engines(
        setup, n_slots=2, eos_id=EOS, max_new_tokens=8, chunk=4,
        auto_prefix_min=4))
    assert got == want and got[1] == 1
    assert _walk_valid(_decode(got[0]), PATTERN)


def test_sampled_constrained_stays_in_grammar(setup):
    _, port = _engines(setup, n_slots=1, eos_id=EOS)
    s = port.admit([70, 71, 72], grammar=True, temperature=1.0, seed=7)
    port.run(20)
    assert _walk_valid(_decode(port.output(s)), PATTERN)
