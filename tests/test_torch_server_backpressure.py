"""Admission backpressure of the port's front door, held against the JAX
server: the scenarios of ``tests/test_server_backpressure.py`` (a
fixed worker pool shedding a burst with 429 + ``Retry-After``, a
bounded admission heap, the slow-client disconnect, a stalled reader
that starves no one, scrapes racing load) run on both servers, each
case for each side, and where the answer does not depend on timing the
two must agree: the shed bodies and headers, the slow-client drop
sequence, the quota verdicts.  Plus tenant quotas (429 with
``reason="quota"``) and crash containment under an injected
``serve.step`` fault (503s, a supervised restart, /healthz still ok).

The decoder is the reference test's (vocab 128, d_model 64, 4 heads,
2 layers, ``max_len`` 512, f32, ``PRNGKey(0)``), converted for the
port with ``convert.params_from_jax``."""

import http.client
import json
import queue
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tools.promlint import lint
from tpu_k8s_device_plugin import obs as jobs
from tpu_k8s_device_plugin.resilience import faults as jfaults
from tpu_k8s_device_plugin.workloads import server as jserver
from tpu_k8s_device_plugin.workloads.inference import make_decoder
from tpu_k8s_device_plugin.workloads.serving import ServingEngine as JEngine
from tpu_k8s_device_plugin_torch import obs as tobs
from tpu_k8s_device_plugin_torch.convert import params_from_jax
from tpu_k8s_device_plugin_torch.resilience import faults as tfaults
from tpu_k8s_device_plugin_torch.workloads import inference as tinf
from tpu_k8s_device_plugin_torch.workloads import server as tserver
from tpu_k8s_device_plugin_torch.workloads.serving import ServingEngine

CFG = dict(vocab=128, d_model=64, n_heads=4, n_layers=2, d_ff=128)
SIDES = ["jax", "torch"]


@pytest.fixture(scope="module")
def models():
    jm = make_decoder(**CFG, max_len=512, dtype=jnp.float32)
    tokens = jnp.zeros((1, 8), jnp.int32)
    pos = jnp.broadcast_to(jnp.arange(8, dtype=jnp.int32), (1, 8))
    params = jm.init(jax.random.PRNGKey(0), tokens, pos)["params"]
    tm = tinf.make_decoder(**CFG, max_len=512, dtype=torch.float32,
                           device="cpu")
    tm.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return {"jax": (jm, params), "torch": tm}


def _server(models, side, n_slots, start=True, **kw):
    if side == "jax":
        jm, params = models["jax"]
        srv = jserver.EngineServer(JEngine(jm, params, n_slots=n_slots),
                                   **kw)
    else:
        srv = tserver.EngineServer(
            ServingEngine(models["torch"], n_slots=n_slots, device="cpu"),
            **kw)
    if start:
        srv.start(host="127.0.0.1", port=0)
    return srv


def _post_full(port, payload, timeout=120):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", "/generate", json.dumps(payload),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        events = [json.loads(line) for line in resp if line.strip()]
        return resp.status, dict(resp.getheaders()), events
    finally:
        conn.close()


def _serve_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("serve-http")]


@pytest.mark.parametrize("side", SIDES)
def test_fixed_pool_sheds_burst_with_429(models, side):
    """12 simultaneous clients against a 2-worker pool and a 2-deep
    heap: every answer is a 200 or a 429 with Retry-After, the pool's
    thread count is flat, and the shed counters cover the 429s."""
    srv = _server(models, side, 2, max_new_tokens=4, window=2,
                  max_connections=2, max_queue=2)
    try:
        _post_full(srv.port, {"tokens": [1, 2], "stream": False})
        before = _serve_threads()
        results = [None] * 12
        lock = threading.Lock()

        def one(i):
            try:
                status, headers, _ = _post_full(
                    srv.port, {"tokens": [3 + i, 5], "stream": False})
            except OSError:
                status, headers = -1, {}
            with lock:
                results[i] = (status, headers)

        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        statuses = [r[0] for r in results]
        assert set(statuses) <= {200, 429}, statuses
        assert 200 in statuses and 429 in statuses, statuses
        for status, headers in results:
            if status == 429:
                assert headers.get("Retry-After") == "1", headers
        assert _serve_threads() == before
        st = srv.stats()
        assert st["http_workers"] == 2
        assert (st["connections_rejected"] + st["requests_throttled"]
                >= statuses.count(429))
    finally:
        srv.stop()


def test_accept_time_429_is_the_reference_bytes():
    """The pre-built 429 the accept thread writes, byte for byte."""
    assert tserver._PooledHTTPServer._REJECT == \
        jserver._PooledHTTPServer._REJECT


@pytest.mark.parametrize("side", SIDES)
def test_queue_overflow_429_retry_after(models, side):
    """max_queue=1 on a 1-slot engine: with the slot busy and one
    request pending, the next admission answers 429 + Retry-After;
    the pending request still completes once the slot frees."""
    srv = _server(models, side, 1, max_new_tokens=400, window=4,
                  max_queue=1)
    try:
        results = {}

        def runner(name, budget):
            results[name] = _post_full(
                srv.port, {"tokens": [7, 8, 9], "max_new_tokens": budget,
                           "stream": False})

        a = threading.Thread(target=runner, args=("a", 400))
        a.start()
        deadline = time.monotonic() + 60
        while srv.stats()["running_copies"] < 1:
            assert time.monotonic() < deadline
            time.sleep(0.005)
        b = threading.Thread(target=runner, args=("b", 2))
        b.start()
        while srv.stats()["pending_requests"] < 1:
            assert time.monotonic() < deadline
            time.sleep(0.005)
        status, headers, events = _post_full(
            srv.port, {"tokens": [1, 2], "stream": False})
        assert status == 429 and headers.get("Retry-After") == "1"
        assert events[0] == {
            "error": "admission queue full (1 requests pending); "
                     "retry later", "code": 429}
        a.join(timeout=120)
        b.join(timeout=120)
        assert results["a"][0] == 200 and results["b"][0] == 200
        assert srv.stats()["requests_throttled"] == 1
        assert srv.statz()["shed"] == {"connections": 0, "queue": 1,
                                       "quota": 0}
    finally:
        srv.stop()


def _drop_sequence(srv):
    req = srv._parse_request({"tokens": [1, 2]})
    pushed = [srv._push(req, {"seq": i}) for i in range(10)]
    drained = []
    while True:
        try:
            drained.append(req.events.get_nowait())
        except queue.Empty:
            break
    return (pushed, req.cancelled, req.dropped, srv._requests_dropped,
            drained, [e["name"] for e in srv.recorder.events()])


def test_slow_client_drop_policy_matches_reference(models):
    """A full bounded event queue cancels the request, drops the oldest
    undelivered event for a terminal 503 and counts the drop once: the
    same pushes give the same sequence on both servers."""
    got = {side: _drop_sequence(_server(models, side, 1, start=False,
                                         max_new_tokens=4, max_events=8))
           for side in SIDES}
    assert got["torch"] == got["jax"]
    pushed, cancelled, dropped, count, drained, _ = got["torch"]
    assert pushed == [True] * 8 + [False, False]
    assert cancelled and dropped and count == 1
    assert drained[0] == {"seq": 1} and drained[-1]["code"] == 503
    assert len(drained) == 8


@pytest.mark.parametrize("side", SIDES)
def test_stalled_reader_does_not_starve_other_clients(models, side):
    srv = _server(models, side, 2, max_new_tokens=300, window=4,
                  max_connections=4, max_events=16)
    stalled = http.client.HTTPConnection("127.0.0.1", srv.port,
                                         timeout=120)
    try:
        stalled.request(
            "POST", "/generate",
            json.dumps({"tokens": [9, 9, 8], "max_new_tokens": 300}),
            {"Content-Type": "application/json"})
        for i in range(3):
            status, _, events = _post_full(
                srv.port, {"tokens": [i + 1, 2, 3], "max_new_tokens": 4,
                           "stream": False})
            assert status == 200 and len(events[-1]["tokens"]) == 4
        assert srv.stats()["requests_served"] >= 3
    finally:
        stalled.close()
        srv.stop()


@pytest.mark.parametrize("side", SIDES)
def test_concurrent_scrape_under_load(models, side):
    """Scrapes racing a burst: every scrape promlint-clean, monotonic
    counters never go backwards, and the last one covers the 200s."""
    import urllib.error
    import urllib.request

    obs = jobs if side == "jax" else tobs
    srv = _server(models, side, 2, max_new_tokens=8, window=2,
                  max_connections=4, max_queue=2)
    try:
        _post_full(srv.port, {"tokens": [1, 2], "stream": False})
        stop = threading.Event()
        errors = []
        monotone = ("tpu_serve_request_seconds_count",
                    "tpu_serving_requests_served_total",
                    "tpu_serve_shed_total", "tpu_serve_ttft_seconds_count")

        def scraper():
            last = {}
            while not stop.is_set():
                try:
                    with urllib.request.urlopen(
                            f"http://127.0.0.1:{srv.port}/metrics",
                            timeout=30) as resp:
                        body = resp.read().decode()
                except urllib.error.HTTPError as e:
                    if e.code == 429:
                        time.sleep(0.01)
                        continue
                    errors.append(str(e))
                    return
                bad = lint(body)
                if bad:
                    errors.append(f"promlint: {bad[:3]}")
                    return
                totals = {}
                for n, _ls, v in obs.parse_exposition(body):
                    if n in monotone:
                        totals[n] = totals.get(n, 0.0) + v
                for k, v in totals.items():
                    if v < last.get(k, 0.0):
                        errors.append(f"{k}: {last[k]} -> {v}")
                        return
                last.update(totals)

        scrapers = [threading.Thread(target=scraper) for _ in range(3)]
        for t in scrapers:
            t.start()
        results = [None] * 10

        def one(i):
            try:
                results[i] = _post_full(
                    srv.port, {"tokens": [3 + i, 5],
                               "max_new_tokens": 8})[0]
            except OSError:
                results[i] = -1

        load = [threading.Thread(target=one, args=(i,)) for i in range(10)]
        for t in load:
            t.start()
        for t in load:
            t.join(timeout=120)
        stop.set()
        for t in scrapers:
            t.join(timeout=30)
        assert not errors, errors
        assert all(s in (200, 429) for s in results), results
        body = srv.render_metrics()
        served = [v for n, _ls, v in obs.parse_exposition(body)
                  if n == "tpu_serving_requests_served_total"]
        assert served and served[0] >= sum(s == 200 for s in results)
    finally:
        srv.stop()


def test_tenant_quota_verdicts_match_reference(models):
    """Over-quota tenants 429 with the reference's body, counted under
    ``tpu_serve_shed_total{reason="quota"}``; a weight-only tenant and
    an unknown tenant (``*`` template) keep being served."""
    got = {}
    for side in SIDES:
        quotas = (jserver if side == "jax" else tserver).parse_tenant_quotas(
            ["tight=0.001:10", "*=0.001:1000", "free=0:0:4"])
        srv = _server(models, side, 2, max_new_tokens=4, window=2,
                      tenant_quotas=quotas)
        try:
            out = []
            for tenant in ("tight", "tight", "free", "free", "other",
                           "other", ""):
                status, headers, events = _post_full(
                    srv.port, {"tokens": [1, 2, 3], "tenant": tenant,
                               "max_new_tokens": 4, "stream": False})
                out.append((status, headers.get("Retry-After"),
                            events[0] if status != 200
                            else len(events[0]["tokens"])))
            out.append(srv.statz()["shed"])
            got[side] = out
        finally:
            srv.stop()
    assert got["torch"] == got["jax"]
    assert got["torch"][0][0] == 200 and got["torch"][1][0] == 429
    assert got["torch"][-1]["quota"] >= 1


@pytest.mark.parametrize("side", SIDES)
def test_scheduler_crash_is_contained(models, side):
    """An injected ``serve.step`` error crashes one iteration: its
    requests answer 503, the supervisor restarts the loop, later
    requests are served and /healthz stays ok."""
    faults = jfaults if side == "jax" else tfaults
    srv = _server(models, side, 2, max_new_tokens=4, window=2)
    try:
        faults.install("serve.step:error:1", seed=0)
        try:
            status, _, events = _post_full(
                srv.port, {"tokens": [1, 2, 3], "stream": False})
        finally:
            faults.uninstall()
        assert status == 503 and "error" in events[0]
        status, _, events = _post_full(
            srv.port, {"tokens": [1, 2, 3], "stream": False})
        assert status == 200 and len(events[0]["tokens"]) == 4
        assert srv.healthy()
        st = srv.render_metrics()
        assert "tpu_serve_scheduler_crashes_total 1" in st
        assert "tpu_serve_scheduler_restarts_total 1" in st
    finally:
        srv.stop()
