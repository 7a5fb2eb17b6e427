"""Tensor-parallel serving (the port's ``ServingEngine(mesh=)``,
``inference.shard_decoder``, ``bench_serving``'s sharded builders,
``tp_driver`` and the server CLI's ``--tp``) on one ``GlooPool`` of 4
ranks, against the port's single-device engine and the JAX package's
engine on a mesh of its 8 virtual CPU devices, in f32.

Counterparts of ``tests/test_serving.py``'s TP tests (the TP engine
equals the meshless one; unshardable KV heads are refused),
``tests/test_server.py``'s ``EngineServer`` over a TP engine and
``tests/test_bench_serving.py``'s sharded build; and the products the
reference's dry run holds under TP (``__graft_entry__.py:237-413``):
paged int8 pages, APC, sampling with penalties, stop ids, logprobs,
``run_scan``, the engine's speculative rounds, LoRA (a fresh adapter is
a no-op, a trained one in a mixed batch), int4 (at a model axis of 4 the
FFN's row piece has 32 of a 64-wide int4 group), and grammars with
``jump_round``.  Each product's greedy ids are the same on the TP engine,
the port's single-device engine and the reference's TP engine; sampled
ids are the same on every rank and on the single-device engine (the JAX
package's sampling keys differ from the port's).  A session moves
between TP and meshless engines both ways, and the CLI's ``--tp 2
--device cpu`` serves a training checkpoint with the meshless server's
ids."""

import json
import os
import re
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_tp_ranks as ranks
from test_torch_parallel import GlooPool
from tpu_k8s_device_plugin.workloads import grammar as jgrammar
from tpu_k8s_device_plugin.workloads import inference as jinf
from tpu_k8s_device_plugin.workloads import llama as jllama
from tpu_k8s_device_plugin.workloads.serving import ServingEngine as JEngine
from tpu_k8s_device_plugin.workloads.transformer import make_lm_mesh
from tpu_k8s_device_plugin_torch.convert import params_from_jax
from tpu_k8s_device_plugin_torch.workloads import llama as tllama
from tpu_k8s_device_plugin_torch.workloads import server as tserver

WORLD = 4
MAX_LEN = 64
MHA = dict(vocab=96, d_model=64, n_heads=4, n_layers=2, d_ff=128)
DRAFT = dict(vocab=96, d_model=32, n_heads=4, n_layers=1, d_ff=64)
TINY = jllama.TINY_LLAMA
TINY_SPEC = dict(vocab=TINY.vocab, d_model=TINY.d_model,
                 n_heads=TINY.n_heads, n_kv_heads=TINY.n_kv_heads,
                 n_layers=TINY.n_layers, d_ff=TINY.d_ff, ffn="swiglu",
                 rope_theta=TINY.rope_theta)


@pytest.fixture(scope="module")
def pool():
    p = GlooPool(WORLD)
    yield p
    p.close()


def _init(model, seed):
    tokens = jnp.zeros((1, 8), jnp.int32)
    pos = jnp.broadcast_to(jnp.arange(8, dtype=jnp.int32), (1, 8))
    return model.init(jax.random.PRNGKey(seed), tokens, pos)["params"]


def _np(params):
    return {k: v.numpy() for k, v in params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)).items()}


@pytest.fixture(scope="module")
def models():
    """name: (JAX model, JAX params, port spec, port numpy state)."""
    out = {}
    tiny = jllama.decoder(TINY, dtype=jnp.float32, max_len=MAX_LEN)
    tp = _init(tiny, 2)
    out["tiny"] = (tiny, tp, dict(TINY_SPEC, max_len=MAX_LEN), _np(tp))
    mha = jinf.make_decoder(**MHA, max_len=MAX_LEN, dtype=jnp.float32)
    mp = _init(mha, 0)
    out["mha"] = (mha, mp, dict(MHA, max_len=MAX_LEN), _np(mp))
    drf = jinf.make_decoder(**DRAFT, max_len=MAX_LEN, dtype=jnp.float32)
    dp = _init(drf, 1)
    out["draft"] = (drf, dp, dict(DRAFT, max_len=MAX_LEN), _np(dp))
    lora = jinf.make_decoder(**MHA, max_len=MAX_LEN, dtype=jnp.float32,
                             n_adapters=2, lora_rank=4)
    lp = jinf.attach_lora(mp, lora, jax.random.PRNGKey(3))
    # adapter 0 trained (random stacks), adapter 1 fresh (B zero)
    rng = np.random.default_rng(4)
    for block in (b for k, b in lp.items() if k.startswith("block_")):
        for key in [k for k in block if "_lora_" in k]:
            ab = np.asarray(block[key]).copy()
            ab[0] = rng.standard_normal(ab.shape[1:]).astype(np.float32)
            block[key] = jnp.asarray(ab)
    out["lora"] = (lora, lp, dict(MHA, max_len=MAX_LEN, n_adapters=2,
                                  lora_rank=4), _np(lp))
    int4 = jinf.make_decoder(**MHA, max_len=MAX_LEN, dtype=jnp.float32,
                             quantized="int4")
    qp = jinf.quantize_lm_params_int4(mp)
    out["int4"] = (int4, qp, dict(MHA, max_len=MAX_LEN, quantized="int4"),
                   _np(qp))
    return out


def _for(models, model_par):
    """The scenarios' models at a model axis of *model_par*: the main
    model is TINY_LLAMA (2 KV heads) at 2, the 4-head decoder at 4."""
    return {"main": models["tiny" if model_par == 2 else "mha"],
            **{k: models[k] for k in ("mha", "draft", "lora", "int4")}}


def _reference(chosen, name, model_par):
    """The scenario on the JAX package's engine over a (data, model)
    mesh of its 8 virtual devices."""
    fn, key, kw = ranks.SCENARIOS[name]
    kw = dict(kw)
    if kw.pop("draft", False):
        kw["draft"] = chosen["draft"][:2]
    if kw.pop("grammar", False):
        table = [bytes([i]) if i else b"" for i in range(96)]
        kw["grammar"] = jgrammar.token_dfa(
            jgrammar.regex_to_dfa(ranks.GRAMMAR), table, eos_id=0)
    mesh = make_lm_mesh(seq=1, model=model_par, expert=1)
    jm, jp = chosen[key][:2]
    return fn(JEngine(jm, jp, mesh=mesh, **kw))


def _port_side(chosen):
    return {k: v[2:] for k, v in chosen.items()}


# the outputs the reference's sampling keys decide
_SAMPLED = {"sampled", "logprob_steps"}


@pytest.mark.parametrize("model_par", [2, 4])
def test_tp_engine_products_match_single_device_and_reference(
        pool, models, model_par):
    """Every product on a TP engine over a model axis of 2 and of 4:
    the same on every rank, equal to the port's single-device engine,
    and (greedy) to the reference's TP engine."""
    chosen = _for(models, model_par)
    names = list(ranks.SCENARIOS)
    got = pool.run("call", "torch_tp_ranks", "products",
                   _port_side(chosen), model_par, names)
    assert all(g == got[0] for g in got)
    assert got[0]["steps"] == "eager"
    for name in names:
        tp, single = got[0][name]
        assert tp == single, name
        want = _reference(chosen, name, model_par)
        assert {k: v for k, v in tp.items() if k not in _SAMPLED} == \
            {k: v for k, v in want.items() if k not in _SAMPLED}, name
    assert got[0]["features"][0]["hits"] == 1
    lora = got[0]["lora"][0]
    assert lora["fresh"] == lora["base"] != lora["adapted"]


def test_tp_engine_rejects_unshardable_heads(pool, models):
    """A model axis of 4 over TINY_LLAMA's 2 KV heads: the engine, a
    draft and ``shard_decoder`` raise ``ValueError`` naming the model
    axis (the reference: ``test_tp_engine_rejects_unshardable_kv_heads``)."""
    seen = pool.run("call", "torch_tp_ranks", "rejects",
                    _port_side(_for(models, 2)), 4)
    for msgs in seen:
        assert all(m is not None and "model" in m for m in msgs), msgs
        assert msgs[1].startswith("draft ")


def test_tensor_parallel_server_matches_meshless(pool, models):
    """An ``EngineServer`` on rank 0 over a TP engine (model axis 2), the
    other ranks replaying its engine calls: the wire's tokens are the
    meshless engine's."""
    got = pool.run("call", "torch_tp_ranks", "server",
                   _port_side(_for(models, 2)), 2)
    status, tokens, plain, steps = got[0]
    assert status == 200 and tokens == plain and steps == "eager"
    assert got[1:] == [None] * (WORLD - 1)


def test_tp_driver_refuses_unknown_calls_and_divergence(pool, models):
    """Rank 0's ``EngineLeader`` refuses an engine method it neither
    replays nor reads alone; a follower whose outcome of a call differs
    from rank 0's raises naming the call (a server then stops)."""
    got = pool.run("call", "torch_tp_ranks", "driver_checks",
                   _port_side(_for(models, 4)))
    refused, slot = got[0]
    assert "neither replayed" in refused and slot == 0
    assert "diverged at release" in got[1] and "IndexError" in got[1]
    assert got[2] is None and got[3] is None


@pytest.mark.parametrize("quantized", [False, True, "int4"])
def test_build_with_mesh_materializes_sharded(pool, quantized):
    """``build_model_and_params(mesh=)`` keeps only this rank's pieces,
    each equal to its slice of the meshless model from the same seed
    (``tp_piece``), and decodes the same ids."""
    got = pool.run("call", "torch_tp_ranks", "built", quantized, 2)
    ff = TINY.d_ff // 2
    for equal, shapes, same_ids, size in got:
        assert equal and same_ids and size == 2
        if quantized == "int4":
            assert shapes["block_0.mlp_gate.kernel_int4"] == (128, ff // 2)
        elif quantized:
            assert shapes["block_0.mlp_gate.kernel_int8"] == (128, ff)
        else:
            assert shapes["block_0.mlp_gate.weight"] == (ff, 128)


@pytest.fixture(scope="module")
def train_checkpoint(tmp_path_factory):
    """A single-device training checkpoint of TINY_LLAMA (f32 train
    layout, seed 5)."""
    from tpu_k8s_device_plugin_torch.workloads import bench_serving
    from tpu_k8s_device_plugin_torch.workloads.checkpoint import (
        save_checkpoint)

    base = str(tmp_path_factory.mktemp("tp_ckpt"))
    train = tllama.train_model(tllama.TINY_LLAMA, device="cpu")
    bench_serving.random_init_(train, 5)
    save_checkpoint(base, 1, {"params": train.state_dict()})
    return base


@pytest.mark.parametrize("quantized", [False, True, "int4"])
def test_checkpoint_restores_onto_mesh(pool, train_checkpoint, quantized):
    """``load_checkpoint_params(mesh=)``: each rank's pieces equal its
    slices of the meshless restore (quantized first, sliced after)."""
    got = pool.run("call", "torch_tp_ranks", "restored", train_checkpoint,
                   quantized, 2)
    assert all(equal and same for equal, _, same, _ in got)


def test_sessions_move_between_tp_and_meshless_engines(pool, models):
    """A preempted request and a parked session, exported whole (every
    rank's KV heads) by a TP engine, resume on a meshless engine with its
    ids, and the other way round."""
    got = pool.run("call", "torch_tp_ranks", "sessions",
                   _port_side(_for(models, 2)), 2)
    assert all(g == got[0] for g in got)
    res = got[0]
    assert res["tp_to_whole"][0] == res["straight"]
    assert res["whole_to_tp"][0] == res["straight"]
    # the TP pool holds 1 of TINY_LLAMA's 2 KV heads
    assert res["tp_to_whole"][1][2] == 1
    whole = res["session_whole"]
    assert whole[2] == 1
    assert res["session_tp_to_whole"] == whole
    assert res["session_whole_to_tp"] == whole


def _serve(args, env):
    """Start the server CLI; (process, port) once it prints its URL."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu_k8s_device_plugin_torch.workloads.server",
         "--config", "tiny", "--device", "cpu", "--host", "127.0.0.1",
         "--port", "0", "--max-len", "64", "--n-slots", "2", *args],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    deadline = time.time() + 120
    lines = []
    while time.time() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        lines.append(line)
        m = re.search(r"serving .* on http://127\.0\.0\.1:(\d+)", line)
        if m:
            return proc, int(m.group(1)), lines
    proc.kill()
    raise AssertionError("the server did not start:\n" + "".join(lines))


def _generate(port, tokens):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("POST", "/generate", json.dumps(
        {"tokens": tokens, "max_new_tokens": 6, "stream": False}))
    resp = conn.getresponse()
    return resp.status, json.loads(resp.read())


def test_cli_tp_serves_a_checkpoint_like_meshless(train_checkpoint):
    """``--tp 2 --device cpu`` starts its second rank itself, restores the
    training checkpoint's pieces on each rank and answers with the ids
    of the meshless server on the same checkpoint; stopping rank 0 stops
    both ranks."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env.update(PYTHONPATH=root, OMP_NUM_THREADS="1")
    answers = []
    for extra in ([], ["--tp", "2"]):
        proc, port, lines = _serve(["--checkpoint", train_checkpoint,
                                    *extra], env)
        try:
            answers.append([_generate(port, p) for p in
                            (ranks.PROMPTS["a"], ranks.PROMPTS["b"])])
        finally:
            proc.terminate()
            rc = proc.wait(timeout=60)
        if extra:
            assert any("tensor parallel: 2 ranks, steps eager" in line
                       for line in lines), lines
            assert rc == 0
    assert all(s == 200 for s, _ in answers[0] + answers[1])
    assert [b["tokens"] for _, b in answers[1]] == \
        [b["tokens"] for _, b in answers[0]]


@pytest.mark.parametrize("flags,match", [
    (["--tp", "4", "--device", "cpu"], "must divide tiny's 2 KV heads"),
    (["--tp", "2"], "needs 2 visible CUDA devices")])
def test_cli_tp_argparse_errors(flags, match, monkeypatch, capsys):
    """An indivisible head count, or more ranks than visible CUDA devices,
    is an argparse error before any weight is built."""
    from tpu_k8s_device_plugin_torch.workloads import bench_serving

    def no_build(*a, **k):
        raise AssertionError("a model was built")

    monkeypatch.setattr(bench_serving, "build_model_and_params", no_build)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit) as exc:
        tserver.main(["--config", "tiny", "--port", "0", *flags])
    assert exc.value.code == 2
    assert match in capsys.readouterr().err
