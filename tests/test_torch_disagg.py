"""Disaggregated prefill/decode across the two packages: a router --
the JAX package's ``RouterServer`` (jax-free) or the port's, each case
runs under both -- fronts a prefill replica of one package and a decode
replica of the other -- a JAX prefill replica with a port decode
replica, then the reverse -- and a migrated request must answer
BYTE-identically to the same request served whole by one mixed JAX
replica (unary bodies compared raw, streams as their ids plus the
terminal event, OpenAI bodies modulo their per-request id and time), as
``tests/test_disagg.py`` holds the reference to.  The checkpoint crosses
from one engine to the other through the migrate codec; the replicas
join the reference's router through their own ``start_registration``
and the port's by registration with it.  Then the router cases of
``tests/test_disagg.py`` that the matrix does not cover, under both
routers in front of port replicas: fallbacks when the decode or the
prefill side is unreachable, short and multi-copy requests that skip
disagg, and the tenant quota held globally.

The JAX prefill replica's scheduler keeps an exported admission in its
first-step list, so after a migration its ``busy()`` stays true and its
loop spins instead of idling (the port's scheduler drops such tickets).
In one process that spin holds the interpreter from the port replica's
threads, so this test gives the reference replica's scheduler the
port's ``busy()`` (``_unspin``); its answers are untouched.

The decoder is ``tests/test_disagg.py``'s (vocab 128, d_model 64, 4
heads, 2 layers, ``max_len`` 128, f32, ``PRNGKey(0)``), converted for
the port with ``convert.params_from_jax``; only greedy and
grammar-constrained greedy requests are compared (a sampled request's
draws differ between the packages)."""

import http.client
import json
import re
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_k8s_device_plugin import obs
from tpu_k8s_device_plugin.workloads import server as jserver
from tpu_k8s_device_plugin.workloads.inference import make_decoder
from tpu_k8s_device_plugin.workloads.router import RouterServer, affinity_key
from tpu_k8s_device_plugin.workloads.qos import parse_tenant_quotas
from tpu_k8s_device_plugin.workloads.serving import ServingEngine as JEngine
from tpu_k8s_device_plugin_torch.convert import params_from_jax
from tpu_k8s_device_plugin_torch.workloads import inference as tinf
from tpu_k8s_device_plugin_torch.workloads import qos as tqos
from tpu_k8s_device_plugin_torch.workloads import router as trouter
from tpu_k8s_device_plugin_torch.workloads import server as tserver
from tpu_k8s_device_plugin_torch.workloads.serving import ServingEngine

CFG = dict(vocab=128, d_model=64, n_heads=4, n_layers=2, d_ff=128)
MAX_LEN = 128
EOS = 0
LONG = [(i * 7) % 126 + 1 for i in range(40)]
TB = [bytes([i]) if i else b"" for i in range(CFG["vocab"])]


class _ByteTok:
    def encode(self, s, **kw):
        return list(s.encode("latin-1"))

    def decode(self, ids, **kw):
        return bytes(int(t) % 256 for t in ids).decode("latin-1")


def _server(side, models, role):
    (jm, params), tm = models
    skw = dict(max_new_tokens=16, window=4, token_bytes=TB,
               tokenizer=_ByteTok(), replica_role=role)
    if side == "jax":
        eng = JEngine(jm, params, n_slots=2, eos_id=EOS, kv_paging=True)
        srv = jserver.EngineServer(eng, **skw)
    else:
        eng = ServingEngine(tm, n_slots=2, eos_id=EOS, kv_paging=True,
                            device="cpu")
        srv = tserver.EngineServer(eng, **skw)
    srv.start(host="127.0.0.1", port=0)
    return srv


def _unspin(srv):
    """The port's ``busy()`` on the reference's scheduler instance."""
    sched = srv._sched
    sched.busy = lambda: bool(sched._pending or sched._ahead is not None
                              or any(sched.engine.active[t.slot]
                                     for t in sched._await_first))


# the two routers: the reference's, and the port's own copy
ROUTERS = {"reference": RouterServer, "port": trouter.RouterServer}
QUOTAS = {"reference": parse_tenant_quotas,
          "port": tqos.parse_tenant_quotas}
KEYS = {"reference": affinity_key, "port": trouter.affinity_key}


def _await_healthy(rt, n=2):
    deadline = time.time() + 30
    while time.time() < deadline and sum(
            r["healthy"] for r in rt.replicas()) < n:
        time.sleep(0.05)
    assert sum(r["healthy"] for r in rt.replicas()) == n


def _stack(models, pre_side, dec_side):
    """A prefill and a decode replica, and both routers in front of
    them: the reference's (which the replicas heartbeat) and the
    port's (with which they are registered)."""
    pre = _server(pre_side, models, "prefill")
    if pre_side == "jax":
        _unspin(pre)
    dec = _server(dec_side, models, "decode")
    routers = {}
    for kind, cls in ROUTERS.items():
        rt = cls(statz_interval_s=0.2, replica_ttl_s=30.0, seed=5,
                 prefill_threshold=16)
        rt.start(host="127.0.0.1", port=0)
        routers[kind] = rt
    for srv, rid, role in ((pre, "pre-0", "prefill"),
                           (dec, "dec-0", "decode")):
        srv.start_registration(
            f"http://127.0.0.1:{routers['reference'].port}",
            replica_id=rid, model="t", interval_s=0.3)
        routers["port"].register({"address": f"127.0.0.1:{srv.port}",
                                  "replica_id": rid, "model": "t",
                                  "role": role})
    for rt in routers.values():
        _await_healthy(rt)
    return pre, dec, routers


@pytest.fixture(scope="module")
def stacks():
    jm = make_decoder(**CFG, max_len=MAX_LEN, dtype=jnp.float32)
    tokens = jnp.zeros((1, 8), jnp.int32)
    pos = jnp.broadcast_to(jnp.arange(8, dtype=jnp.int32), (1, 8))
    params = jm.init(jax.random.PRNGKey(0), tokens, pos)["params"]
    tm = tinf.make_decoder(**CFG, max_len=MAX_LEN, dtype=torch.float32,
                           device="cpu")
    tm.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    models = ((jm, params), tm)
    mixed = _server("jax", models, "mixed")
    out = {"jax->torch": _stack(models, "jax", "torch"),
           "torch->jax": _stack(models, "torch", "jax")}
    yield mixed, out
    for pre, dec, routers in out.values():
        for rt in routers.values():
            rt.stop()
        pre.stop()
        dec.stop()
    mixed.stop()


def _post(port, payload, path="/generate"):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", path, json.dumps(payload),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, dict(resp.headers), resp.read()
    finally:
        conn.close()


def _stream_view(body):
    toks, done = [], None
    for line in body.strip().split(b"\n"):
        ev = json.loads(line)
        if "done" in ev:
            done = ev
        elif "tokens" in ev:
            toks += ev["tokens"]
        elif "token" in ev:
            toks.append(ev["token"])
    return toks, done


def _migrated(rt):
    samples = obs.parse_exposition(rt.registry.render())
    return sum(v for n, lab, v in samples
               if n == "tpu_router_migrations_total"
               and lab.get("outcome") == "ok")


DIRECTIONS = ["jax->torch", "torch->jax"]
ROUTER_KINDS = sorted(ROUTERS)
MATRIX = [
    pytest.param({"tokens": LONG, "max_new_tokens": 10}, id="greedy"),
    pytest.param({"tokens": LONG, "max_new_tokens": 10,
                  "presence_penalty": 0.5, "frequency_penalty": 0.2,
                  "repetition_penalty": 1.1}, id="penalties"),
    pytest.param({"tokens": LONG, "max_new_tokens": 10,
                  "guided_regex": r"\d+"}, id="grammar"),
    pytest.param({"prompt": "y" * 40, "max_new_tokens": 8,
                  "stop": ["zz"]}, id="text"),
]


@pytest.mark.parametrize("payload", MATRIX)
@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("router", ROUTER_KINDS)
def test_unary_byte_identical(stacks, router, direction, payload):
    mixed, by_dir = stacks
    pre, dec, routers = by_dir[direction]
    rt = routers[router]
    body = dict(payload, stream=False)
    before = _migrated(rt)
    st_m, _, out_m = _post(mixed.port, body)
    st_r, hd_r, out_r = _post(rt.port, body)
    assert st_m == st_r == 200, (out_m, out_r)
    assert hd_r.get("X-Replica") == "dec-0"   # decode served it
    assert out_r == out_m                      # byte-identical
    assert _migrated(rt) == before + 1


@pytest.mark.parametrize("payload", MATRIX[:2])
@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("router", ROUTER_KINDS)
def test_stream_identical(stacks, router, direction, payload):
    mixed, by_dir = stacks
    rt = by_dir[direction][2][router]
    st_m, _, out_m = _post(mixed.port, dict(payload))
    st_r, hd_r, out_r = _post(rt.port, dict(payload))
    assert st_m == st_r == 200
    assert hd_r.get("X-Replica") == "dec-0"
    assert _stream_view(out_r) == _stream_view(out_m)


@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("router", ROUTER_KINDS)
def test_openai_unary_identical_modulo_ids(stacks, router, direction):
    mixed, by_dir = stacks
    rt = by_dir[direction][2][router]
    payload = {"prompt": "x" * 80, "max_tokens": 6, "temperature": 0.0}

    def norm(b):
        b = re.sub(rb"cmpl-[0-9a-f]+", b"cmpl-X", b)
        return re.sub(rb'"created": \d+', b'"created": 0', b)

    st_m, _, out_m = _post(mixed.port, payload, path="/v1/completions")
    st_r, hd_r, out_r = _post(rt.port, payload, path="/v1/completions")
    assert st_m == st_r == 200, (out_m, out_r)
    assert hd_r.get("X-Replica") == "dec-0"
    assert norm(out_r) == norm(out_m)


@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("router", ROUTER_KINDS)
def test_registration_and_ledgers(stacks, router, direction):
    """Both replicas (one of each package) registered with their roles,
    and their /statz migration ledgers moved in lock-step with the
    router's."""
    _, by_dir = stacks
    pre, dec, routers = by_dir[direction]
    rt = routers[router]
    roles = {r["replica_id"]: r.get("role") for r in rt.replicas()}
    assert roles == {"pre-0": "prefill", "dec-0": "decode"}
    st, _, _ = _post(rt.port, {"tokens": LONG, "max_new_tokens": 6,
                               "stream": False})
    assert st == 200
    out, into = pre.statz()["migrations"], dec.statz()["migrations"]
    assert out["out"] >= 1 and into["in"] == out["out"]
    assert out["in"] == 0 and into["out"] == 0
    if isinstance(pre, tserver.EngineServer):
        # the port's scheduler idles after an export by itself
        assert not pre._sched.busy()


# -- the remaining router cases of tests/test_disagg.py, port replicas -----


def _port_pair(stacks):
    """(mixed JAX baseline, port prefill replica, port decode replica)."""
    mixed, by_dir = stacks
    return mixed, by_dir["torch->jax"][0], by_dir["jax->torch"][1]


def _dead_port():
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _counter(rt, name, **labels):
    samples = obs.parse_exposition(rt.registry.render())
    vals = [v for n, lab, v in samples if n == name
            and all(lab.get(k) == v2 for k, v2 in labels.items())]
    return vals[0] if vals else 0.0


@pytest.mark.parametrize("router", ROUTER_KINDS)
def test_short_and_multicopy_requests_skip_disagg(stacks, router):
    rt = stacks[1]["jax->torch"][2][router]
    before = _counter(rt, "tpu_router_migrations_total", outcome="ok")
    st, _, _ = _post(rt.port, {"tokens": [1, 2, 3], "max_new_tokens": 4})
    assert st == 200
    st, _, body = _post(rt.port, {"tokens": LONG, "n": 2,
                                  "max_new_tokens": 4, "stream": False})
    assert st == 200
    assert len(json.loads(body)["choices"]) == 2
    assert _counter(rt, "tpu_router_migrations_total",
                    outcome="ok") == before


@pytest.mark.parametrize("router", ROUTER_KINDS)
def test_decode_unreachable_falls_back_before_any_byte(stacks, router):
    """The decode class looks routable but refuses connections: the
    request completes through normal routing on the port prefill
    replica, byte-identical to the baseline, the fallback journaled."""
    mixed, pre, _ = _port_pair(stacks)
    rt2 = ROUTERS[router](statz_interval_s=60.0, replica_ttl_s=60.0,
                          seed=9, prefill_threshold=16,
                          breaker_threshold=10)
    rt2.start(host="127.0.0.1", port=0)
    try:
        rt2.register({"address": f"127.0.0.1:{pre.port}",
                      "replica_id": "pre-0", "role": "prefill"})
        rt2.register({"address": f"127.0.0.1:{_dead_port()}",
                      "replica_id": "dec-dead", "role": "decode"})
        payload = {"tokens": LONG, "max_new_tokens": 6, "stream": False}
        st_m, _, out_m = _post(mixed.port, payload)
        st_r, hd_r, out_r = _post(rt2.port, payload)
        assert st_r == 200
        assert hd_r.get("X-Replica") == "pre-0"
        assert out_r == out_m
        assert _counter(rt2, "tpu_router_migrations_total",
                        outcome="fallback") >= 1
        names = [e["name"] for e in rt2.recorder.events()]
        assert "tpu_router_migrate_fallback" in names
    finally:
        rt2.stop()


@pytest.mark.parametrize("router", ROUTER_KINDS)
def test_prefill_unreachable_falls_back(stacks, router):
    """The prefill class down entirely: the router skips disagg and the
    port decode replica serves the request whole."""
    mixed, _, dec = _port_pair(stacks)
    rt2 = ROUTERS[router](statz_interval_s=60.0, replica_ttl_s=60.0,
                          seed=11, prefill_threshold=16,
                          breaker_threshold=10)
    rt2.start(host="127.0.0.1", port=0)
    try:
        rt2.register({"address": f"127.0.0.1:{_dead_port()}",
                      "replica_id": "pre-dead", "role": "prefill"})
        rt2.register({"address": f"127.0.0.1:{dec.port}",
                      "replica_id": "dec-0", "role": "decode"})
        payload = {"tokens": LONG, "max_new_tokens": 6, "stream": False}
        st_m, _, out_m = _post(mixed.port, payload)
        st_r, hd_r, out_r = _post(rt2.port, payload)
        assert st_r == 200
        assert hd_r.get("X-Replica") == "dec-0"
        assert out_r == out_m
    finally:
        rt2.stop()


@pytest.mark.parametrize("router", ROUTER_KINDS)
def test_tenant_quota_global_not_rate_times_replicas(stacks, router):
    """A tenant quota of RATE on a fleet of two port replicas sheds at
    RATE, not 2 x RATE, under evenly spread load (pinning off): the
    router's bucket is the global arbiter."""
    _, pre, dec = _port_pair(stacks)
    rt2 = ROUTERS[router](statz_interval_s=60.0, replica_ttl_s=60.0,
                          seed=13, disagg=False, tenant_pinning=False,
                          tenant_quotas=QUOTAS[router](["acme=0.001:60"]))
    rt2.start(host="127.0.0.1", port=0)
    key_of = KEYS[router]
    try:
        rt2.register({"address": f"127.0.0.1:{pre.port}",
                      "replica_id": "pre-0", "role": "prefill"})
        rt2.register({"address": f"127.0.0.1:{dec.port}",
                      "replica_id": "dec-0", "role": "decode"})

        def prompt_for(rid, start):
            for i in range(start, start + 500):
                cand = [(i + j) % 126 + 1 for j in range(8)]
                if rt2.affinity_target(key_of(
                        {"tokens": cand}, rt2.prefix_chunk)) == rid:
                    return cand
            raise AssertionError(f"no prompt hashed to {rid}")

        statuses, served_by = [], set()
        for i in range(10):
            rid = "pre-0" if i % 2 == 0 else "dec-0"
            st, hd, _ = _post(rt2.port, {
                "tokens": prompt_for(rid, i * 37 + 1),
                "max_new_tokens": 4, "stream": False, "tenant": "acme"})
            statuses.append(st)
            if st == 200:
                served_by.add(hd.get("X-Replica"))
        assert sum(s == 200 for s in statuses) == 5, statuses
        assert sum(s == 429 for s in statuses) == 5, statuses
        assert served_by == {"pre-0", "dec-0"}, served_by
        assert _counter(rt2, "tpu_router_shed_total",
                        reason="tenant_quota") == 5
        names = [e["name"] for e in rt2.recorder.events()]
        assert "tpu_router_tenant_quota_shed" in names
    finally:
        rt2.stop()
