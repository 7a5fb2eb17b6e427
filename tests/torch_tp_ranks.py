"""The rank side of ``tests/test_torch_tp_serving.py``: tensor-parallel
serving on the ranks of a ``GlooPool`` (``torch_gloo_ranks.call`` runs
these).  Torch and numpy only, and the port; the reference's side runs
in the pytest process and comes over as numpy arrays and lists.

The scenarios (:data:`SCENARIOS`) use only the engine methods both
packages share, so the test runs the same functions on the reference's
engines."""

from __future__ import annotations

import torch
import torch.distributed as dist

PROMPTS = {"a": [5, 17, 3, 70], "b": [2, 71, 82, 9, 14]}
SHARED = [5, 17, 3, 70, 2, 9, 14, 21]
SPEC_PROMPT = [5, 17, 3, 70]
GRAMMAR = "(AB|CD)+E"


def _base(eng):
    slots = {k: eng.admit(v) for k, v in PROMPTS.items()}
    eng.run(6)
    return {k: eng.output(s) for k, s in slots.items()}


def _features(eng):
    f0 = eng.admit(SHARED + [33], stop=[7])
    f1 = eng.admit(SHARED + [44], temperature=0.9, top_k=16, top_p=0.9,
                   min_p=0.05, presence_penalty=0.5, frequency_penalty=0.5,
                   logprobs=2, seed=3)
    hits = eng.stats()["prefix_cache_hits"]
    eng.run_scan(4)
    return {"greedy": eng.output(f0), "reason": eng.finish_reason(f0),
            "hits": hits, "sampled": eng.output(f1),
            "logprob_steps": len(eng.token_logprobs(f1))}


def _paged(eng):
    return _base(eng)


def _spec(eng):
    s = eng.admit(SPEC_PROMPT)
    eng.run_spec(8)
    return {"spec": eng.output(s)}


def _lora(eng):
    slots = {"adapted": eng.admit(SPEC_PROMPT, adapter=0),
             "fresh": eng.admit(SPEC_PROMPT, adapter=1),
             "base": eng.admit(SPEC_PROMPT)}
    eng.run(8)
    return {k: eng.output(s) for k, s in slots.items()}


def _int4(eng):
    s = eng.admit(PROMPTS["b"])
    eng.run(5)
    return {"int4": eng.output(s)}


def _grammar(eng):
    g = eng.admit(SPEC_PROMPT, grammar=True)
    eng.run_scan(4)
    eng.run_scan(4)
    jumped = eng.jump_round() if eng.forced_pending() else None
    return {"grammar": eng.output(g), "jumped": jumped is not None}


# name: (scenario, model key, engine keywords); "draft" and "grammar"
# in the keywords are filled in by each side
SCENARIOS = {
    "base": (_base, "main", dict(n_slots=2, chunk=4)),
    "features": (_features, "main", dict(n_slots=2, chunk=4, logprobs_k=3,
                                          auto_prefix_min=4)),
    "paged": (_paged, "main", dict(n_slots=2, chunk=4, kv_paging=True,
                                    kv_page_size=4, kv_dtype="int8")),
    "spec": (_spec, "mha", dict(n_slots=2, chunk=4, max_new_tokens=6,
                                 gamma=3, draft=True)),
    "lora": (_lora, "lora", dict(n_slots=3, chunk=4, max_new_tokens=6)),
    "int4": (_int4, "int4", dict(n_slots=1, chunk=4)),
    "grammar": (_grammar, "mha", dict(n_slots=2, chunk=4, max_new_tokens=8,
                                       eos_id=0, grammar=True)),
}


def _model(spec, state):
    """A port decoder (f32, CPU) of *spec* (``make_decoder``'s keywords)
    holding the numpy state dict *state*."""
    from tpu_k8s_device_plugin_torch.workloads.inference import make_decoder

    m = make_decoder(dtype=torch.float32, device="cpu", **spec)
    m.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return m


def _mesh(model_par):
    from tpu_k8s_device_plugin_torch.workloads.transformer import (
        make_lm_mesh)

    return make_lm_mesh(seq=1, model=model_par, expert=1, device="cpu")


def _engine(models, scenario, mesh=None):
    from tpu_k8s_device_plugin_torch.workloads import grammar
    from tpu_k8s_device_plugin_torch.workloads.serving import ServingEngine

    _, key, kw = SCENARIOS[scenario]
    kw = dict(kw)
    if kw.pop("draft", False):
        kw["draft"] = _model(*models["draft"])
    if kw.pop("grammar", False):
        table = [bytes([i]) if i else b"" for i in range(96)]
        kw["grammar"] = grammar.token_dfa(grammar.regex_to_dfa(GRAMMAR),
                                          table, eos_id=0)
    return ServingEngine(_model(*models[key]), mesh=mesh, device="cpu",
                         **kw)


def products(models, model_par, names):
    """Each scenario of *names* on a TP engine over a model axis of
    *model_par* and on a single-device engine: ``{name: (tp, single)}``,
    with the engines' step mode."""
    mesh = _mesh(model_par)
    out = {}
    for name in names:
        fn = SCENARIOS[name][0]
        tp = _engine(models, name, mesh)
        out[name] = (fn(tp), fn(_engine(models, name)))
        out["steps"] = tp.stats()["tp_steps"]
    return out


def rejects(models, model_par):
    """The errors of a mesh the heads do not divide: the engine's, its
    draft's and ``shard_decoder``'s."""
    from tpu_k8s_device_plugin_torch.workloads.inference import (
        shard_decoder)
    from tpu_k8s_device_plugin_torch.workloads.serving import ServingEngine

    mesh = _mesh(model_par)
    seen = []
    for build in (
            lambda: ServingEngine(_model(*models["main"]), n_slots=2,
                                  mesh=mesh, device="cpu"),
            lambda: ServingEngine(_model(*models["mha"]), n_slots=2,
                                  mesh=mesh, device="cpu",
                                  draft=_two_head_draft()),
            lambda: shard_decoder(_model(*models["main"]), mesh)):
        try:
            build()
            seen.append(None)
        except ValueError as e:
            seen.append(str(e))
    return seen


def _two_head_draft():
    from tpu_k8s_device_plugin_torch.workloads.bench_serving import (
        random_init_)
    from tpu_k8s_device_plugin_torch.workloads.inference import make_decoder

    m = make_decoder(vocab=96, d_model=32, n_heads=2, n_layers=1, d_ff=64,
                     max_len=64, dtype=torch.float32, device="cpu")
    random_init_(m, 1)
    return m


def server(models, model_par):
    """An ``EngineServer`` on rank 0 over a TP engine (``tp_driver``; the
    other ranks replay), one request: its tokens and statuses, beside
    the single-device engine's ids of the same prompt."""
    import http.client
    import json

    from tpu_k8s_device_plugin_torch.workloads import tp_driver
    from tpu_k8s_device_plugin_torch.workloads.server import EngineServer
    from tpu_k8s_device_plugin_torch.workloads.serving import ServingEngine

    mesh = _mesh(model_par)
    ctrl = dist.new_group(backend="gloo")
    model = _model(*models["main"])
    eng = ServingEngine(model, n_slots=2, mesh=mesh, device="cpu")
    if dist.get_rank() != 0:
        tp_driver.follow(eng, ctrl)
        return None
    leader = tp_driver.EngineLeader(eng, ctrl)
    srv = EngineServer(leader, max_new_tokens=6, window=3)
    srv.start(host="127.0.0.1", port=0)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=60)
        conn.request("POST", "/generate", json.dumps(
            {"tokens": PROMPTS["a"], "max_new_tokens": 6, "stream": False}))
        resp = conn.getresponse()
        status, body = resp.status, json.loads(resp.read())
    finally:
        srv.stop()
        leader.close()
    plain = ServingEngine(model, n_slots=2, device="cpu")
    s = plain.admit(PROMPTS["a"])
    plain.run(5)
    return status, body["tokens"], plain.output(s), eng.stats()["tp_steps"]


def built(quantized, model_par):
    """``build_model_and_params("tiny", mesh=)``: whether every piece
    equals ``tp_piece`` of the meshless model from the same seed, the
    local shapes of block 0's FFN, and whether greedy ids agree."""
    from tpu_k8s_device_plugin_torch.workloads import bench_serving

    mesh = _mesh(model_par)
    _, whole = bench_serving.build_model_and_params(
        "tiny", 64, "cpu", quantized=quantized, dtype=torch.float32)
    _, split = bench_serving.build_model_and_params(
        "tiny", 64, "cpu", quantized=quantized, dtype=torch.float32,
        mesh=mesh)
    return _held(whole, split, model_par)


def _held(whole, split, model_par):
    from tpu_k8s_device_plugin_torch.workloads import inference

    params = dict(whole.named_parameters())
    r = split.tp_rank
    equal = all(torch.equal(p, inference.tp_piece(whole, n, params[n],
                                                  model_par, r))
                for n, p in split.named_parameters())
    shapes = {n: tuple(p.shape) for n, p in split.named_parameters()
              if n.startswith("block_0.mlp")}
    a = inference.greedy_generate(whole, [PROMPTS["b"]], 6)[0]
    b = inference.greedy_generate(split, [PROMPTS["b"]], 6)[0]
    return equal, shapes, a.tolist() == b.tolist(), split.tp_size


def restored(base, quantized, model_par):
    """``load_checkpoint_params("tiny", mesh=)`` from a training
    checkpoint under *base*: as :func:`built`, against the meshless
    restore."""
    from tpu_k8s_device_plugin_torch.workloads import bench_serving

    whole = bench_serving.load_checkpoint_params(
        "tiny", 64, quantized, base, device="cpu")[1]
    split = bench_serving.load_checkpoint_params(
        "tiny", 64, quantized, base, device="cpu", mesh=_mesh(model_par))[1]
    return _held(whole, split, model_par)


def sessions(models, model_par):
    """A request preempted on a TP engine and resumed on a meshless one
    (through the ``migrate`` codec), and a parked session demoted there
    and resumed with its next turn; then the same states the other way.
    Each result beside the meshless engine's straight run."""
    from tpu_k8s_device_plugin_torch.workloads import migrate
    from tpu_k8s_device_plugin_torch.workloads.serving import ServingEngine

    mesh = _mesh(model_par)
    kw = dict(n_slots=2, chunk=4, kv_paging=True, kv_page_size=4,
              max_new_tokens=8, device="cpu")
    model = _model(*models["main"])

    def codec(state):
        return migrate.load_payload(migrate.dump_payload(state))

    def straight():
        eng = ServingEngine(model, **kw)
        s = eng.admit(SHARED)
        eng.run(10)
        return eng.output(s)

    def moved(src_mesh, dst_mesh):
        src = ServingEngine(model, mesh=src_mesh, **kw)
        s = src.admit(SHARED)
        src.run(3)
        dst = ServingEngine(model, mesh=dst_mesh, **kw)
        slot = dst.resume(codec(src.preempt(s)))
        dst.run(10)
        return dst.output(slot), _shape(src)

    def session(src_mesh, dst_mesh):
        src = ServingEngine(model, mesh=src_mesh, **kw)
        s = src.admit(SHARED)
        src.run(10)
        out1 = src.output(s)
        src.park_session(s, "conv", kept=len(out1))
        state = codec(src.demote_session(src.session_slots()["conv"]))
        dst = ServingEngine(model, mesh=dst_mesh, **kw)
        dst.resume_session(state)
        t2 = dst.admit(SHARED + out1 + [7, 8, 9], session="conv")
        hits = dst.stats()["prefix_cache_hits"]
        dst.run(10)
        return out1, dst.output(t2), hits

    return {"straight": straight(),
            "tp_to_whole": moved(mesh, None),
            "whole_to_tp": moved(None, mesh),
            "session_tp_to_whole": session(mesh, None),
            "session_whole_to_tp": session(None, mesh),
            "session_whole": session(None, None)}


def _shape(eng):
    return tuple(eng.cache["block_0"]["cached_k"].shape)


def driver_checks(models):
    """``tp_driver`` on a model axis of every rank, each rank's engine
    with one slot, but rank 1's own: the leader refuses an engine method
    it neither replays nor knows to be read-only, and releasing slot 1,
    which rank 1's engine lacks, makes rank 1's ``follow`` raise naming
    the call (rank 1 then reads rank 0's close).  A call that one rank
    refuses before its collectives and the others run would hang them
    instead, until the group's timeout."""
    from tpu_k8s_device_plugin_torch.workloads import tp_driver
    from tpu_k8s_device_plugin_torch.workloads.serving import ServingEngine

    mesh = _mesh(dist.get_world_size())
    ctrl = dist.new_group(backend="gloo")
    rank = dist.get_rank()
    eng = ServingEngine(_model(*models["mha"]), n_slots=1 if rank == 1
                        else 2, mesh=mesh, device="cpu")
    if rank == 0:
        leader = tp_driver.EngineLeader(eng, ctrl)
        try:
            leader._reclaim_parked
            refused = None
        except AttributeError as e:
            refused = str(e)
        slot = leader.admit(PROMPTS["a"])
        leader.release(1)
        leader.close()
        return refused, slot
    try:
        tp_driver.follow(eng, ctrl)
        return None
    except RuntimeError as e:
        tp_driver._Channel(ctrl).recv()
        return str(e)
