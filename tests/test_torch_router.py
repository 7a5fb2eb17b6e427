"""The port's router tier, mirrored from ``tests/test_router.py`` and
held to the reference's router.

Layers 1-3 are the reference's cases on the port's copy:

1. Pure routing units (no sockets, no torch): affinity-key alignment,
   consistent-hash determinism across router restarts and registration
   orders, least-loaded selection off statz snapshots, the overload
   gate, staleness eviction, registration validation, promlint-clean
   metric families.
2. Fake-replica integration (stdlib sockets): pre-stream failover onto
   the live replica with breaker + failover accounting, and the
   mid-stream death path — a WELL-FORMED in-band error frame
   (JSON-lines and SSE framings both), never a silent truncation.
3. Real-engine equivalence on a port ``EngineServer`` over a port
   ``ServingEngine`` (the tiny decoder on the CPU): streams
   BYTE-IDENTICAL through the hop vs direct, traceparent propagation,
   /statz in lock-step with /metrics, the stitched trace and
   /fleet/statz.

Layer 4 holds the port's router to the reference's: with the same seed
and registrations both give the same affinity targets (unfiltered and
by role), tenant homes and session homes over a few hundred keys, and
in front of the same port replica both give byte-identical replies for
unary, JSON-lines and SSE requests.
"""

import http.client
import json
import socket
import threading
import time

import pytest

from tpu_k8s_device_plugin_torch import obs
from tpu_k8s_device_plugin_torch.resilience import (
    BREAKER_CLOSED,
    BREAKER_OPEN,
)
from tpu_k8s_device_plugin_torch.workloads.router import (
    DEFAULT_PREFIX_CHUNK,
    RouterServer,
    affinity_key,
)

# ---------------------------------------------------------------------------
# layer 1: pure routing units


def test_affinity_key_chunk_alignment():
    chunk = 32
    base = list(range(1, 65))             # 64 tokens = 2 chunks
    k64 = affinity_key({"tokens": base}, chunk)
    # extra tokens INSIDE the last partial chunk do not change the key
    assert affinity_key({"tokens": base + [99, 98]}, chunk) == k64
    assert affinity_key({"tokens": base + [1]}, chunk) == k64
    # a full extra chunk DOES
    assert affinity_key(
        {"tokens": base + list(range(100, 132))}, chunk) != k64
    # sub-chunk prompts hash whole (deterministic, never None)
    short = affinity_key({"tokens": [5, 6, 7]}, chunk)
    assert short == affinity_key({"tokens": [5, 6, 7]}, chunk)
    assert short != affinity_key({"tokens": [5, 6, 8]}, chunk)
    # string prompts hash their text; bools are not token ids
    assert affinity_key({"prompt": "hello"}, chunk) is not None
    assert affinity_key({"tokens": [True, False]}, chunk) is None
    assert affinity_key({}, chunk) is None


def _mk_router(**kw):
    kw.setdefault("statz_interval_s", 60.0)  # poller effectively off
    kw.setdefault("replica_ttl_s", 60.0)
    return RouterServer(**kw)


def test_consistent_hash_stable_across_restart_and_order():
    """Same prompt -> same replica: across fresh RouterServer
    instances (a router restart) and across registration orders (the
    ring depends only on the replica-id set)."""
    reps = [{"address": f"127.0.0.1:{9000 + i}",
             "replica_id": f"replica-{i}"} for i in range(4)]
    keys = [affinity_key({"tokens": [i * 7 + j for j in range(64)]},
                         DEFAULT_PREFIX_CHUNK) for i in range(20)]
    rt1 = _mk_router()
    for r in reps:
        rt1.register(dict(r))
    rt2 = _mk_router()                   # "restarted" router
    for r in reversed(reps):             # different order
        rt2.register(dict(r))
    t1 = [rt1.affinity_target(k) for k in keys]
    t2 = [rt2.affinity_target(k) for k in keys]
    assert t1 == t2
    # the hash actually spreads (not everything on one replica)
    assert len(set(t1)) > 1


def test_pick_prefers_affinity_then_least_loaded():
    rt = _mk_router()
    rt.register({"address": "127.0.0.1:9001", "replica_id": "a",
                 "capacity": 4})
    rt.register({"address": "127.0.0.1:9002", "replica_id": "b",
                 "capacity": 4})
    key = next(
        affinity_key({"tokens": [i] * 32}, 32) for i in range(1, 99)
        if rt.affinity_target(
            affinity_key({"tokens": [i] * 32}, 32)) == "a")
    rep, hit = rt.pick(key)
    assert rep is not None and rep.rid == "a" and hit
    # load the affinity target past the overload gate -> least-loaded
    with rt._lock:
        rt._replicas["a"].statz = {
            "queue_depth": 100, "in_flight": 4, "capacity": 4,
            "scheduler_alive": True}
        rt._replicas["b"].statz = {
            "queue_depth": 0, "in_flight": 1, "capacity": 4,
            "scheduler_alive": True}
    rep, hit = rt.pick(key)
    assert rep is not None and rep.rid == "b" and not hit
    # no key at all -> pure least-loaded
    rep, hit = rt.pick(None)
    assert rep is not None and rep.rid == "b" and not hit


def test_pick_skips_dead_scheduler_and_open_breaker():
    rt = _mk_router()
    rt.register({"address": "127.0.0.1:9001", "replica_id": "a"})
    rt.register({"address": "127.0.0.1:9002", "replica_id": "b"})
    with rt._lock:
        rt._replicas["a"].statz = {"scheduler_alive": False}
    rep, _ = rt.pick(None)
    assert rep is not None and rep.rid == "b"
    # open b's breaker too -> nothing routable
    with rt._lock:
        brk = rt._replicas["b"].breaker
    for _ in range(rt.breaker_threshold):
        brk.record_failure()
    rep, _ = rt.pick(None)
    assert rep is None
    assert not rt.healthy()


def test_torn_statz_body_fails_the_poll_and_frees_the_probe_slot():
    """A replica that dies mid-answer tears its /statz body
    (``http.client.IncompleteRead``, not an OSError): the poll records a
    failure, so a half-open probe slot is freed and the poller goes on,
    and the replica is routable again once it answers whole."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(8)
    port = srv.getsockname()[1]
    whole = {"on": False}

    def answer():
        while True:
            try:
                conn, _ = srv.accept()
            except OSError:
                return
            conn.recv(65536)
            body = b'{"scheduler_alive": true}'
            if whole["on"]:
                conn.sendall(b"HTTP/1.1 200 OK\r\nContent-Length: "
                             + str(len(body)).encode() + b"\r\n\r\n"
                             + body)
            else:
                conn.sendall(b"HTTP/1.1 200 OK\r\nContent-Length: 100"
                             b"\r\n\r\n" + body[:10])
            conn.close()

    threading.Thread(target=answer, daemon=True).start()
    rt = _mk_router(breaker_reset_s=0.05)
    try:
        rt.register({"address": f"127.0.0.1:{port}", "replica_id": "a"})
        with rt._lock:
            brk = rt._replicas["a"].breaker
        for _ in range(rt.breaker_threshold):
            rt._poll_once()      # torn bodies: failures, no exception
        assert brk.state == BREAKER_OPEN
        time.sleep(0.1)
        rt._poll_once()          # the half-open probe tears too
        assert brk.state == BREAKER_OPEN
        whole["on"] = True
        time.sleep(0.1)
        rt._poll_once()
        assert brk.state == BREAKER_CLOSED
        rep, _ = rt.pick(None)
        assert rep is not None and rep.rid == "a"
    finally:
        srv.close()


def test_stale_replica_evicted():
    rt = _mk_router(replica_ttl_s=0.2)
    rt.register({"address": "127.0.0.1:9001", "replica_id": "a"})
    assert [r["replica_id"] for r in rt.replicas()] == ["a"]
    time.sleep(0.3)
    rt._poll_once()
    assert rt.replicas() == []
    samples = obs.parse_exposition(rt.registry.render())
    evs = [v for n, lab, v in samples
           if n == "tpu_router_replica_evictions_total"]
    assert evs and evs[0] == 1
    # re-registration resurrects it (fresh breaker, fresh stamp)
    rt.register({"address": "127.0.0.1:9001", "replica_id": "a"})
    assert [r["replica_id"] for r in rt.replicas()] == ["a"]


def test_register_validation():
    rt = _mk_router()
    with pytest.raises(ValueError):
        rt.register({})
    with pytest.raises(ValueError):
        rt.register({"address": "no-port"})
    with pytest.raises(ValueError):
        rt.register({"address": "host:notaport"})
    out = rt.register({"address": "10.0.0.1:8000"})
    assert out["ok"] and out["replica_id"] == "10.0.0.1:8000"


def test_register_role_and_replicas_view():
    rt = _mk_router()
    rt.register({"address": "127.0.0.1:9001", "replica_id": "p",
                 "role": "prefill"})
    rt.register({"address": "127.0.0.1:9002", "replica_id": "d",
                 "role": "decode"})
    rt.register({"address": "127.0.0.1:9003", "replica_id": "m"})
    roles = {r["replica_id"]: r["role"] for r in rt.replicas()}
    assert roles == {"p": "prefill", "d": "decode", "m": "mixed"}
    # re-registration may change the role (a pod restarted with a
    # different flag keeps its identity)
    rt.register({"address": "127.0.0.1:9003", "replica_id": "m",
                 "role": "decode"})
    assert {r["replica_id"]: r["role"] for r in rt.replicas()}["m"] \
        == "decode"
    with pytest.raises(ValueError):
        rt.register({"address": "127.0.0.1:9004", "role": "gpu"})


def test_affinity_target_role_filtered_walk():
    """Role-filtered affinity stays deterministic (same id+role set
    -> same target) and always lands on the requested class."""
    rt = _mk_router()
    for i in range(3):
        rt.register({"address": f"127.0.0.1:{9000 + i}",
                     "replica_id": f"p-{i}", "role": "prefill"})
        rt.register({"address": f"127.0.0.1:{9100 + i}",
                     "replica_id": f"d-{i}", "role": "decode"})
    keys = [affinity_key({"tokens": [i * 3 + j for j in range(64)]},
                         DEFAULT_PREFIX_CHUNK) for i in range(20)]
    pre = [rt.affinity_target(k, role="prefill") for k in keys]
    dec = [rt.affinity_target(k, role="decode") for k in keys]
    assert all(t is not None and t.startswith("p-") for t in pre)
    assert all(t is not None and t.startswith("d-") for t in dec)
    # a restarted router with the same set agrees
    rt2 = _mk_router()
    for i in reversed(range(3)):
        rt2.register({"address": f"127.0.0.1:{9100 + i}",
                      "replica_id": f"d-{i}", "role": "decode"})
        rt2.register({"address": f"127.0.0.1:{9000 + i}",
                      "replica_id": f"p-{i}", "role": "prefill"})
    assert pre == [rt2.affinity_target(k, role="prefill")
                   for k in keys]
    assert dec == [rt2.affinity_target(k, role="decode")
                   for k in keys]
    # unfiltered walk is unchanged by the role machinery
    assert rt.affinity_target(keys[0]) == rt2.affinity_target(keys[0])


def test_pick_role_filter_and_no_cross_class_fallback():
    rt = _mk_router()
    rt.register({"address": "127.0.0.1:9001", "replica_id": "p",
                 "role": "prefill"})
    rt.register({"address": "127.0.0.1:9002", "replica_id": "d",
                 "role": "decode"})
    rep, _ = rt.pick(None, role="prefill")
    assert rep is not None and rep.rid == "p"
    rep, _ = rt.pick(None, role="decode")
    assert rep is not None and rep.rid == "d"
    # the one decode replica excluded -> nothing of that class
    rep, _ = rt.pick(None, role="decode", exclude={"d"})
    assert rep is None


def test_tenant_ring_deterministic_and_pick_pin():
    reps = [{"address": f"127.0.0.1:{9000 + i}",
             "replica_id": f"replica-{i}"} for i in range(4)]
    rt1 = _mk_router()
    for r in reps:
        rt1.register(dict(r))
    rt2 = _mk_router()
    for r in reversed(reps):
        rt2.register(dict(r))
    tenants = [f"tenant-{i}" for i in range(24)]
    t1 = [rt1.tenant_target(t) for t in tenants]
    assert t1 == [rt2.tenant_target(t) for t in tenants]
    assert len(set(t1)) > 1            # the hash actually spreads
    assert rt1.tenant_target("") is None
    # the pin takes precedence over prefix affinity
    pinned = rt1.tenant_target("tenant-0")
    other = next(r for r in t1 if r != pinned)
    key = next(
        affinity_key({"tokens": [i] * 64}, DEFAULT_PREFIX_CHUNK)
        for i in range(1, 200)
        if rt1.affinity_target(
            affinity_key({"tokens": [i] * 64},
                         DEFAULT_PREFIX_CHUNK)) == other)
    rep, hit = rt1.pick(key, pin=pinned)
    assert rep is not None and rep.rid == pinned and not hit
    # without the pin the same key goes to its affinity target
    rep, hit = rt1.pick(key)
    assert rep is not None and rep.rid == other and hit


def test_session_ring_deterministic_and_home_wins():
    reps = [{"address": f"127.0.0.1:{9000 + i}",
             "replica_id": f"replica-{i}"} for i in range(4)]
    rt1 = _mk_router()
    for r in reps:
        rt1.register(dict(r))
    rt2 = _mk_router()
    for r in reversed(reps):
        rt2.register(dict(r))
    sids = [f"user-{i}/chat-{i}" for i in range(24)]
    t1 = [rt1.session_target(s) for s in sids]
    assert t1 == [rt2.session_target(s) for s in sids]
    assert len(set(t1)) > 1            # the hash actually spreads
    assert rt1.session_target("") is None
    # once served somewhere, the recorded home beats the ring
    ring_pick = rt1.session_target("user-0/chat-0")
    other = next(r["replica_id"] for r in reps
                 if r["replica_id"] != ring_pick)
    rt1._note_session_home("user-0/chat-0", other)
    assert rt1.session_target("user-0/chat-0") == other
    # other sessions stay on their ring verdicts
    assert [rt1.session_target(s) for s in sids[1:]] == t1[1:]


def test_session_affinity_off_switch():
    rt = _mk_router(session_affinity=False)
    rt.register({"address": "127.0.0.1:9000", "replica_id": "r0"})
    assert rt.session_target("user-1/c") is None
    rt._note_session_home("user-1/c", "r0")
    assert rt.session_target("user-1/c") is None


def test_session_home_lru_bounded():
    rt = _mk_router(session_home_max=3)
    rt.register({"address": "127.0.0.1:9000", "replica_id": "r0"})
    for i in range(5):
        rt._note_session_home(f"s{i}", "r0")
    assert len(rt._session_home) == 3
    assert set(rt._session_home) == {"s2", "s3", "s4"}
    # re-noting refreshes recency
    rt._note_session_home("s2", "r0")
    rt._note_session_home("s5", "r0")
    assert "s2" in rt._session_home and "s3" not in rt._session_home


def test_session_of_matches_replica_scoping():
    f = RouterServer._session_of
    assert f({"session_id": "abc"}) == "abc"
    assert f({"session": "abc"}) == "abc"
    # native session_id is already fully qualified: tenant present or
    # not, it hashes as-is
    assert f({"session_id": "abc", "tenant": "t"}) == "abc"
    # OpenAI bodies scope session under user — the same string the
    # replica's _openai_to_native builds
    assert f({"session": "chat1", "user": "alice"}) == "alice/chat1"
    assert f({"session_id": "x", "user": "alice"}) == "x"
    assert f({}) == ""
    assert f({"session": ""}) == ""
    assert f({"tokens": [1, 2]}) == ""


def test_router_tenant_quota_charges_and_sheds():
    from tpu_k8s_device_plugin_torch.workloads.qos import (
        parse_tenant_quotas,
    )

    rt = _mk_router(
        tenant_quotas=parse_tenant_quotas(["acme=1:100"]))
    rt.register({"address": "127.0.0.1:9001", "replica_id": "a"})
    # cost = (8 prompt + 42 budget) * 1 = 50: two admits drain the
    # 100-token burst, the third sheds
    body = {"tokens": [1] * 8, "max_new_tokens": 42,
            "tenant": "acme"}
    assert rt._charge_tenant("acme", rt._est_cost(body))
    assert rt._charge_tenant("acme", rt._est_cost(body))
    assert not rt._charge_tenant("acme", rt._est_cost(body))
    # unknown tenants clone the '*' template; absent both, admit
    assert rt._charge_tenant("other", 1e9)
    rt2 = _mk_router(
        tenant_quotas=parse_tenant_quotas(["*=1:10"]))
    assert rt2._charge_tenant("x", 10.0)
    assert not rt2._charge_tenant("x", 1.0)
    assert rt2._charge_tenant("y", 10.0)   # y has its OWN bucket


def test_est_cost_mirrors_server_estimate():
    rt = _mk_router()
    assert rt._est_cost({"tokens": [1] * 10,
                         "max_new_tokens": 5}) == 15.0
    assert rt._est_cost({"tokens": [1] * 10, "max_new_tokens": 5,
                         "n": 3}) == 45.0
    # OpenAI spelling + the string-prompt 4-chars/token heuristic
    assert rt._est_cost({"prompt": "x" * 40, "max_tokens": 6}) == 16.0
    # absent budget falls back to the configured default
    assert rt._est_cost({"tokens": [1] * 4}) \
        == 4.0 + rt.default_budget


def test_prefill_heavy_heuristic():
    rt = _mk_router(prefill_threshold=32)
    assert rt._prefill_heavy({"tokens": [1] * 32})
    assert not rt._prefill_heavy({"tokens": [1] * 31})
    # unary qualifies regardless of length; only an EXPLICIT flag
    assert rt._prefill_heavy({"tokens": [1] * 4, "stream": False})
    assert not rt._prefill_heavy({"tokens": [1] * 4})
    # multi-copy requests never migrate
    assert not rt._prefill_heavy({"tokens": [1] * 64, "n": 2})
    # string prompts use the 4-chars/token heuristic
    assert rt._prefill_heavy({"prompt": "x" * 128})
    assert not rt._prefill_heavy({"prompt": "x" * 64})


def test_disagg_ready_requires_both_classes():
    rt = _mk_router()
    rt.register({"address": "127.0.0.1:9001", "replica_id": "p",
                 "role": "prefill"})
    assert not rt._disagg_ready()
    rt.register({"address": "127.0.0.1:9002", "replica_id": "d",
                 "role": "decode"})
    assert rt._disagg_ready()
    rt.disagg = False
    assert not rt._disagg_ready()


def test_router_metric_families_promlint_clean():
    import sys
    sys.path.insert(0, "tools")
    import promlint

    rt = _mk_router()
    rt.register({"address": "127.0.0.1:9001", "replica_id": "a"})
    rt._m_requests.labels(replica="a", outcome="ok").inc()
    rt._m_route.observe(0.01)
    rt._m_failovers.inc()
    rt._m_affinity.inc()
    rt._m_shed.labels(reason="no_replicas").inc()
    rt._m_shed.labels(reason="tenant_quota").inc()
    rt._m_migrations.labels(outcome="ok").inc()
    rt._m_migrate_s.observe(0.01)
    rt._m_role_requests.labels(role="prefill").inc()
    rt._m_tenant_pins.inc()
    errors = promlint.lint(rt.registry.render())
    assert errors == [], errors


# ---------------------------------------------------------------------------
# layer 2: fake replicas (stdlib sockets, no torch)


class _FakeReplica:
    """A scriptable stand-in replica: answers /statz, and /generate
    with either a complete chunked stream or a deliberate mid-stream
    connection drop (unterminated chunked body)."""

    def __init__(self, frames, die_after=None, content_type=None):
        self.frames = [f if isinstance(f, bytes) else f.encode()
                       for f in frames]
        self.die_after = die_after       # frames sent before dying
        self.content_type = content_type or "application/jsonlines"
        self.requests = 0
        self._sock = socket.socket()
        self._sock.setsockopt(socket.SOL_SOCKET,
                              socket.SO_REUSEADDR, 1)
        self._sock.bind(("127.0.0.1", 0))
        self._sock.listen(8)
        self.port = self._sock.getsockname()[1]
        self._stop = False
        self._thread = threading.Thread(target=self._serve,
                                        daemon=True)
        self._thread.start()

    @property
    def address(self):
        return f"127.0.0.1:{self.port}"

    def _serve(self):
        while not self._stop:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._handle, args=(conn,),
                             daemon=True).start()

    def _handle(self, conn):
        try:
            data = b""
            while b"\r\n\r\n" not in data:
                chunk = conn.recv(65536)
                if not chunk:
                    return
                data += chunk
            head, _, rest = data.partition(b"\r\n\r\n")
            first = head.split(b"\r\n")[0].decode()
            if first.startswith("GET /statz"):
                body = json.dumps({
                    "scheduler_alive": True, "queue_depth": 0,
                    "in_flight": 0, "capacity": 4}).encode()
                conn.sendall(
                    b"HTTP/1.1 200 OK\r\nContent-Type: "
                    b"application/json\r\nContent-Length: %d\r\n\r\n%s"
                    % (len(body), body))
                return
            # POST /generate: drain the body per Content-Length
            length = 0
            for line in head.split(b"\r\n"):
                if line.lower().startswith(b"content-length:"):
                    length = int(line.split(b":")[1])
            while len(rest) < length:
                chunk = conn.recv(65536)
                if not chunk:
                    return
                rest += chunk
            self.requests += 1
            conn.sendall(
                b"HTTP/1.1 200 OK\r\nContent-Type: %s\r\n"
                b"Transfer-Encoding: chunked\r\n\r\n"
                % self.content_type.encode())
            for i, frame in enumerate(self.frames):
                if self.die_after is not None and i >= self.die_after:
                    conn.close()        # mid-stream death, no 0-chunk
                    return
                conn.sendall(b"%x\r\n%s\r\n" % (len(frame), frame))
                time.sleep(0.01)
            conn.sendall(b"0\r\n\r\n")
        except OSError:
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def stop(self):
        self._stop = True
        try:
            self._sock.close()
        except OSError:
            pass


def _wait_samples(rt, predicate, timeout_s=5.0):
    """Poll the router registry until *predicate*(samples) is truthy
    (the handler thread increments outcome counters just AFTER the
    terminator byte the client unblocks on — a scrape immediately
    after the response races it)."""
    deadline = time.time() + timeout_s
    while True:
        samples = obs.parse_exposition(rt.registry.render())
        got = predicate(samples)
        if got or time.time() >= deadline:
            return got, samples


def _post_router(port, payload, path="/generate", headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    hdrs = {"Content-Type": "application/json"}
    hdrs.update(headers or {})
    conn.request("POST", path, json.dumps(payload), hdrs)
    resp = conn.getresponse()
    body = resp.read()
    out_headers = dict(resp.headers)
    conn.close()
    return resp.status, out_headers, body


@pytest.fixture()
def live_router():
    # breaker_threshold=1: one observed failure opens the breaker, so
    # the failover/abort assertions below are deterministic instead of
    # racing the statz poller for the second strike
    rt = RouterServer(statz_interval_s=0.2, replica_ttl_s=30.0,
                      breaker_reset_s=30.0, breaker_threshold=1,
                      seed=7)
    rt.start(host="127.0.0.1", port=0)
    yield rt
    rt.stop()


def _key_for(rt, rid, n=64):
    """A token prompt whose affinity target is *rid*."""
    for i in range(1, 500):
        cand = [(i + j) % 1000 + 1 for j in range(n)]
        if rt.affinity_target(
                affinity_key({"tokens": cand}, rt.prefix_chunk)) == rid:
            return cand
    raise AssertionError(f"no prompt hashed to {rid}")


def test_pre_stream_failover_onto_live_replica(live_router):
    """Affinity target dead before any byte: the request retries on
    the live replica, the breaker opens, the failover is counted."""
    rt = live_router
    ok = _FakeReplica(
        ['{"tokens":[1,2]}\n', '{"done": true, "tokens": [1, 2]}\n'])
    # a dead address: bind a port, close it again
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    dead_port = s.getsockname()[1]
    s.close()
    try:
        rt.register({"address": ok.address, "replica_id": "live"})
        rt.register({"address": f"127.0.0.1:{dead_port}",
                     "replica_id": "dead"})
        prompt = _key_for(rt, "dead")
        status, headers, body = _post_router(
            rt.port, {"tokens": prompt, "max_new_tokens": 2})
        assert status == 200
        assert headers.get("X-Replica") == "live"
        assert body.endswith(b'{"done": true, "tokens": [1, 2]}\n')
        fo, _ = _wait_samples(rt, lambda samples: [
            v for n, lab, v in samples
            if n == "tpu_router_failovers_total" and v >= 1])
        assert fo
        from tpu_k8s_device_plugin import resilience
        with rt._lock:
            state = rt._replicas["dead"].breaker.state
        assert state == resilience.BREAKER_OPEN
        # journal carries the failover + the routed outcome
        names = [e["name"] for e in rt.recorder.events()]
        assert "tpu_router_failover" in names
        assert "tpu_router_routed" in names
    finally:
        ok.stop()


def test_drain_endpoint_takes_replica_out_of_rotation(live_router):
    """POST /drain over HTTP (the fleet reconciler's lever): the
    drained replica stops taking NEW streams but stays registered;
    {"draining": false} puts it back; ghosts 404, junk 400."""
    rt = live_router
    frames = ['{"tokens":[1,2]}\n', '{"done": true, "tokens": [1, 2]}\n']
    a, b = _FakeReplica(frames), _FakeReplica(frames)
    try:
        rt.register({"address": a.address, "replica_id": "a"})
        rt.register({"address": b.address, "replica_id": "b"})
        prompt = _key_for(rt, "a")
        status, _, _ = _post_router(
            rt.port, {"replica_id": "a"}, path="/drain")
        assert status == 200
        st, rows = _raw_get_json(rt.port, "/replicas")
        assert st == 200
        by_rid = {r["replica_id"]: r for r in rows["replicas"]}
        assert by_rid["a"]["draining"] is True
        # draining means not routable: the view says so ...
        assert by_rid["a"]["healthy"] is False
        assert by_rid["b"]["draining"] is False
        # ... and an a-affine request lands on b, no failover needed
        status, headers, _ = _post_router(
            rt.port, {"tokens": prompt, "max_new_tokens": 2})
        assert status == 200
        assert headers.get("X-Replica") == "b"
        # undrain restores the affinity route
        status, _, _ = _post_router(
            rt.port, {"replica_id": "a", "draining": False},
            path="/drain")
        assert status == 200
        status, headers, _ = _post_router(
            rt.port, {"tokens": prompt, "max_new_tokens": 2})
        assert status == 200
        assert headers.get("X-Replica") == "a"
        # caller bugs are loud: unknown replica 404, malformed body 400
        status, _, _ = _post_router(
            rt.port, {"replica_id": "ghost"}, path="/drain")
        assert status == 404
        status, _, _ = _post_router(
            rt.port, {"replica_id": ""}, path="/drain")
        assert status == 400
    finally:
        a.stop()
        b.stop()


def test_unroutable_when_everything_down(live_router):
    rt = live_router
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    dead_port = s.getsockname()[1]
    s.close()
    rt.register({"address": f"127.0.0.1:{dead_port}",
                 "replica_id": "dead"})
    status, headers, body = _post_router(
        rt.port, {"tokens": [1, 2, 3], "max_new_tokens": 2})
    assert status == 503
    err = json.loads(body)
    assert "error" in err and err["code"] == 503
    # and with NO replicas at all, the other 503 flavor
    with rt._lock:
        rt._replicas.clear()
        rt._rebuild_ring_locked()
    status, _, body = _post_router(
        rt.port, {"tokens": [1, 2, 3], "max_new_tokens": 2})
    assert status == 503
    samples = obs.parse_exposition(rt.registry.render())
    shed = [v for n, lab, v in samples
            if n == "tpu_router_shed_total"
            and lab.get("reason") == "no_replicas"]
    assert shed and shed[0] >= 2


def test_mid_stream_death_emits_wellformed_jsonlines_frame(
        live_router):
    """The replica dies after 2 frames: the client's stream must end
    with a parseable JSON error line and a clean chunked terminator
    (http.client raises on a truncated chunked body — reading to EOF
    without an exception IS the well-formedness proof)."""
    rt = live_router
    fake = _FakeReplica(
        ['{"tokens":[1,2]}\n', '{"tokens":[3,4]}\n',
         '{"tokens":[5,6]}\n', '{"done": true}\n'],
        die_after=2)
    try:
        rt.register({"address": fake.address, "replica_id": "dying"})
        status, headers, body = _post_router(
            rt.port, {"tokens": [9] * 64, "max_new_tokens": 8})
        assert status == 200
        lines = body.strip().split(b"\n")
        # the passed-through frames arrive untouched...
        assert lines[0] == b'{"tokens":[1,2]}'
        assert lines[1] == b'{"tokens":[3,4]}'
        # ...and the terminal line is the router's structured error
        last = json.loads(lines[-1])
        assert last["code"] == 502 and "mid-stream" in last["error"]
        got, _ = _wait_samples(rt, lambda samples: [
            v for n, lab, v in samples
            if n == "tpu_router_requests_total"
            and lab.get("replica") == "dying"
            and lab.get("outcome") == "stream_abort"])
        assert got and got[0] == 1
        names = [e["name"] for e in rt.recorder.events()]
        assert "tpu_router_stream_abort" in names
    finally:
        fake.stop()


def test_mid_stream_death_emits_wellformed_sse_frame(live_router):
    """Same death, SSE framing: the terminal frame is a `data:` event
    carrying the OpenAI error shape."""
    rt = live_router
    fake = _FakeReplica(
        ["data: {\"id\":\"cmpl-1\"}\n\n", "data: {\"x\":2}\n\n",
         "data: [DONE]\n\n"],
        die_after=1, content_type="text/event-stream")
    try:
        rt.register({"address": fake.address, "replica_id": "dying"})
        status, headers, body = _post_router(
            rt.port, {"prompt": "hi", "max_tokens": 4},
            path="/v1/completions")
        assert status == 200
        assert body.startswith(b"data: {\"id\":\"cmpl-1\"}\n\n")
        tail = body.split(b"\n\n")[-2]          # last complete event
        assert tail.startswith(b"data: ")
        err = json.loads(tail[len(b"data: "):])
        assert err["error"]["type"] == "server_error"
    finally:
        fake.stop()


def test_router_statz_poll_updates_load(live_router):
    rt = live_router
    fake = _FakeReplica(['{"done": true}\n'])
    try:
        rt.register({"address": fake.address, "replica_id": "a"})
        deadline = time.time() + 5
        while time.time() < deadline:
            with rt._lock:
                snap = dict(rt._replicas["a"].statz)
            if snap:
                break
            time.sleep(0.05)
        assert snap.get("capacity") == 4
        assert snap.get("scheduler_alive") is True
    finally:
        fake.stop()


# ---------------------------------------------------------------------------
# layer 3: real-engine equivalence (the port's engine and server)

import torch  # noqa: E402

from tpu_k8s_device_plugin_torch.workloads.bench_serving import (  # noqa: E402
    random_init_)
from tpu_k8s_device_plugin_torch.workloads.inference import (  # noqa: E402
    make_decoder)
from tpu_k8s_device_plugin_torch.workloads.server import (  # noqa: E402
    EngineServer)
from tpu_k8s_device_plugin_torch.workloads.serving import (  # noqa: E402
    ServingEngine)

CFG = dict(vocab=128, d_model=64, n_heads=4, n_layers=2, d_ff=128)


class _ByteTok:
    def encode(self, s):
        return list(s.encode("latin-1"))

    def decode(self, ids):
        return bytes(int(t) % 256 for t in ids).decode("latin-1")


@pytest.fixture(scope="module")
def engine_stack():
    model = make_decoder(**CFG, max_len=64, dtype=torch.float32,
                         device="cpu")
    random_init_(model, seed=0)
    eng = ServingEngine(model, n_slots=2, device="cpu")
    srv = EngineServer(eng, max_new_tokens=8, window=4,
                       tokenizer=_ByteTok())
    srv.start(host="127.0.0.1", port=0)
    rt = RouterServer(statz_interval_s=0.2, replica_ttl_s=30.0,
                      seed=3)
    rt.start(host="127.0.0.1", port=0)
    srv.start_registration(f"http://127.0.0.1:{rt.port}",
                           replica_id="r0", model="test",
                           interval_s=0.3)
    deadline = time.time() + 10
    while time.time() < deadline and not rt.healthy():
        time.sleep(0.05)
    assert rt.healthy()
    yield srv, rt
    rt.stop()
    srv.stop()


def _raw_post(port, payload, path="/generate", headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    hdrs = {"Content-Type": "application/json"}
    hdrs.update(headers or {})
    conn.request("POST", path, json.dumps(payload), hdrs)
    resp = conn.getresponse()
    body = resp.read()
    out = dict(resp.headers)
    conn.close()
    return resp.status, out, body


def test_jsonlines_stream_byte_identical_through_router(engine_stack):
    srv, rt = engine_stack
    payload = {"tokens": [3, 14, 15, 9, 2, 6], "max_new_tokens": 8}
    # warm both paths once (compile + APC donor) so the compared pair
    # are the same cadence: an APC repeat direct vs through the hop
    _raw_post(srv.port, payload)
    st_d, hd_d, body_d = _raw_post(srv.port, payload)
    st_r, hd_r, body_r = _raw_post(rt.port, payload)
    assert st_d == st_r == 200
    assert body_d == body_r          # BYTE-identical, framing included
    assert hd_r.get("X-Replica") == "r0"
    assert hd_d.get("Content-Type") == hd_r.get("Content-Type")


def test_per_token_stream_byte_identical_through_router(engine_stack):
    srv, rt = engine_stack
    payload = {"tokens": [7, 7, 3], "max_new_tokens": 6,
               "per_token": True}
    _raw_post(srv.port, payload)
    _, _, body_d = _raw_post(srv.port, payload)
    _, _, body_r = _raw_post(rt.port, payload)
    assert body_d == body_r


def test_unary_response_byte_identical_through_router(engine_stack):
    srv, rt = engine_stack
    payload = {"tokens": [5, 17, 3], "max_new_tokens": 5,
               "stream": False}
    _, _, body_d = _raw_post(srv.port, payload)
    _, _, body_r = _raw_post(rt.port, payload)
    assert body_d == body_r
    assert json.loads(body_r)["done"] is True


def test_sse_stream_byte_identical_through_router(engine_stack):
    """OpenAI SSE through the hop: byte-identical modulo the fields
    that are EXPECTED to differ per request (the cmpl-<trace-id> id
    and the created stamp) — so the comparison normalizes those and
    then requires byte equality, and separately pins the raw framing
    (data:/[DONE]) untouched."""
    import re

    srv, rt = engine_stack
    payload = {"prompt": "abc", "max_tokens": 6, "stream": True,
               "temperature": 0.0}
    _raw_post(srv.port, payload, path="/v1/completions")

    def norm(b):
        b = re.sub(rb"cmpl-[0-9a-f]+", b"cmpl-X", b)
        return re.sub(rb'"created": \d+', b'"created": 0', b)

    st_d, _, body_d = _raw_post(srv.port, payload,
                                path="/v1/completions")
    st_r, hd_r, body_r = _raw_post(rt.port, payload,
                                   path="/v1/completions")
    assert st_d == st_r == 200
    assert norm(body_d) == norm(body_r)
    assert body_r.rstrip().endswith(b"data: [DONE]")
    assert hd_r.get("X-Replica") == "r0"


def test_traceparent_propagates_through_hop(engine_stack):
    srv, rt = engine_stack
    trace_id = "ab" * 16
    tp = f"00-{trace_id}-{'cd' * 8}-01"
    st, headers, _ = _raw_post(
        rt.port, {"tokens": [4, 4, 4], "max_new_tokens": 2},
        headers={"traceparent": tp})
    assert st == 200
    # the replica continued OUR trace: same trace-id comes back in
    # both echo headers, through the router hop
    assert headers.get("X-Trace-Id") == trace_id
    assert headers.get("traceparent", "").split("-")[1] == trace_id
    assert headers.get("X-Replica") == "r0"
    # and the replica's journal holds the trace (the hop really
    # carried it, not just echoed it)
    evs = srv.recorder.events(trace_id=trace_id)
    assert evs


def test_affinity_deterministic_across_router_restart(engine_stack):
    """Same prompt -> same replica across a router RESTART with the
    same replica set (the ring is id-derived, not session-derived)."""
    srv, rt = engine_stack
    prompt = [9, 9, 8, 7, 1, 5]
    st1, hd1, _ = _raw_post(rt.port, {"tokens": prompt,
                                      "max_new_tokens": 2})
    rt2 = RouterServer(statz_interval_s=0.2, seed=99)  # fresh router
    rt2.start(host="127.0.0.1", port=0)
    try:
        rt2.register({"address": f"127.0.0.1:{srv.port}",
                      "replica_id": "r0"})
        st2, hd2, _ = _raw_post(rt2.port, {"tokens": prompt,
                                           "max_new_tokens": 2})
        assert st1 == st2 == 200
        assert hd1.get("X-Replica") == hd2.get("X-Replica") == "r0"
        key = affinity_key({"tokens": prompt}, DEFAULT_PREFIX_CHUNK)
        assert rt.affinity_target(key) == rt2.affinity_target(key)
    finally:
        rt2.stop()


def test_statz_lockstep_with_metrics(engine_stack):
    """The /statz snapshot must agree with the tpu_serving_* families
    the SAME server renders — the router's load signal and the
    dashboards must never tell different stories."""
    srv, rt = engine_stack
    # some traffic so the counters are non-trivial
    _raw_post(srv.port, {"tokens": [2, 71, 82], "max_new_tokens": 3})
    conn = http.client.HTTPConnection("127.0.0.1", srv.port,
                                      timeout=30)
    conn.request("GET", "/statz")
    statz = json.loads(conn.getresponse().read())
    conn.close()
    assert set(statz) == {
        "scheduler_alive", "queue_depth", "in_flight", "capacity",
        "kv_pages", "kv_pages_free", "requests_served", "role",
        "migrations", "shed", "kv_tiers", "goodput", "alerts"}
    assert set(statz["alerts"]) == {"firing", "pending", "firing_page"}
    # session tiering off on this server: the block is the fixed
    # empty schema, never absent (fleet aggregation must not branch)
    assert set(statz["kv_tiers"]) == {
        "device", "host", "host_bytes", "disk", "disk_bytes",
        "hits", "demotions", "promotions", "evictions"}
    assert statz["kv_tiers"]["device"] == 0
    assert set(statz["shed"]) == {"connections", "queue", "quota"}
    assert set(statz["goodput"]) == {"window_s", "classes"}
    assert statz["role"] == "mixed"
    assert set(statz["migrations"]) == {"out", "in"}
    samples = obs.parse_exposition(srv.render_metrics())

    def metric(name):
        vals = [v for n, lab, v in samples if n == name]
        return vals[0] if vals else None

    assert statz["scheduler_alive"] is True
    assert statz["queue_depth"] == metric(
        "tpu_serving_pending_requests")
    assert statz["capacity"] == metric("tpu_serving_n_slots")
    # contiguous engine: the kv bridge gauges only exist under
    # --kv-paging, but the tpu_serve_* pool family renders 0 always
    assert statz["kv_pages"] == (metric("tpu_serving_kv_pages") or 0)
    assert statz["kv_pages_free"] == metric(
        "tpu_serve_kv_pages_free")
    assert statz["requests_served"] == metric(
        "tpu_serving_requests_served_total")
    assert statz["in_flight"] == (
        metric("tpu_serving_running_copies")
        + metric("tpu_serving_admitting_copies"))
    shed = {lab.get("reason"): v for n, lab, v in samples
            if n == "tpu_serve_shed_total"}
    for reason in ("connections", "queue", "quota"):
        assert statz["shed"][reason] == shed.get(reason, 0)
    # disagg migration ledger in lock-step with the metric family
    # (both children render from boot — role notwithstanding)
    mig = {lab.get("direction"): v for n, lab, v in samples
           if n == "tpu_serve_migrations_total"}
    assert set(mig) == {"out", "in"}
    for direction in ("out", "in"):
        assert statz["migrations"][direction] == mig[direction]


def test_router_429_passthrough_not_failover(engine_stack):
    """A replica 429 (queue shed) is POLICY, not failure: it passes
    through with its Retry-After instead of being retried onto another
    replica (which would amplify load exactly when shedding)."""
    srv, rt = engine_stack
    old_max = srv.max_queue
    srv.max_queue = 0                      # everything sheds
    try:
        st, headers, body = _raw_post(
            rt.port, {"tokens": [1, 2, 3], "max_new_tokens": 2})
        assert st == 429
        assert "Retry-After" in headers
        assert headers.get("X-Replica") == "r0"
        err = json.loads(body)
        assert err["code"] == 429
    finally:
        srv.max_queue = old_max
    shed, _ = _wait_samples(rt, lambda samples: [
        v for n, lab, v in samples
        if n == "tpu_router_requests_total"
        and lab.get("replica") == "r0"
        and lab.get("outcome") == "shed"])
    assert shed and shed[0] >= 1


def _raw_get_json(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("GET", path)
    resp = conn.getresponse()
    out = json.loads(resp.read())
    conn.close()
    return resp.status, out


def test_router_stitches_trace_across_processes(engine_stack):
    """ONE traceparent driven through router ->
    replica -> scheduler window must come back from the ROUTER's
    /debug/traces as a single stitched span tree — the router's
    route/proxy events as the parent span, the replica's admit/window
    events as its child, in causal order."""
    srv, rt = engine_stack
    trace = obs.new_trace()
    st, headers, _ = _raw_post(
        rt.port, {"tokens": [11, 12, 13], "max_new_tokens": 4},
        headers={"traceparent": trace.to_traceparent()})
    assert st == 200
    st, stitched = _raw_get_json(
        rt.port, f"/debug/traces?trace_id={trace.trace_id}")
    assert st == 200
    assert stitched["trace_id"] == trace.trace_id
    tree = stitched["tree"]
    assert len(tree) == 1                    # ONE root: the router hop
    root = tree[0]
    assert root["source"] == "router"
    root_names = [e["name"] for e in root["events"]]
    assert "tpu_router_routed" in root_names
    assert "tpu_router_proxy" in root_names
    # the replica's span is a CHILD of the router's (the traceparent
    # hop made it so), tagged with the replica id by the stitcher
    assert len(root["children"]) == 1
    kid = root["children"][0]
    assert kid["source"] == "r0"
    assert kid["parent_id"] == root["span_id"]
    kid_names = [e["name"] for e in kid["events"]]
    assert "tpu_serve_admit" in kid_names
    assert "tpu_serve_window" in kid_names
    # causal order in the depth-first flatten: route decision before
    # the replica's admit, admit before its first decode window
    flat = [e["name"] for e in obs.flatten(tree)]
    assert flat.index("tpu_router_routed") \
        < flat.index("tpu_serve_admit") \
        < flat.index("tpu_serve_window")
    # without ?trace_id= the router serves its own recent-trace index
    st, index = _raw_get_json(rt.port, "/debug/traces")
    assert st == 200
    assert any(t["trace_id"] == trace.trace_id
               for t in index["traces"])


def test_fleet_statz_aggregates_replicas(engine_stack):
    """/fleet/statz: per-replica statz plus fleet-level sums and
    goodput re-derived from summed met/total counts."""
    srv, rt = engine_stack
    # traffic so the goodput block is non-trivial, then wait for the
    # poller to refresh the cached statz past it
    _raw_post(srv.port, {"tokens": [21, 22], "max_new_tokens": 2,
                         "slo_class": "interactive"})
    served = srv.statz()["goodput"]["classes"]["interactive"]["met"]
    assert served >= 1
    deadline = time.time() + 10
    fleet = {}
    while time.time() < deadline:
        st, fleet = _raw_get_json(rt.port, "/fleet/statz")
        assert st == 200
        cls = fleet["fleet"]["goodput"].get("interactive", {})
        if cls.get("met", 0) >= served:
            break
        time.sleep(0.1)
    assert fleet["replicas"] == 1
    assert fleet["healthy"] == 1
    assert set(fleet["per_replica"]) == {"r0"}
    assert fleet["per_replica"]["r0"]["healthy"] is True
    # the aggregate re-states the one replica's statz
    statz = srv.statz()
    assert fleet["fleet"]["capacity"] == statz["capacity"]
    assert fleet["fleet"]["requests_served"] <= \
        statz["requests_served"]
    cls = fleet["fleet"]["goodput"]["interactive"]
    assert cls["met"] >= served
    assert 0.0 <= cls["goodput_ratio"] <= 1.0
    assert "burn_rate_max" in cls


# ---------------------------------------------------------------------------
# layer 4: the reference's router, decision for decision and byte for byte

from tpu_k8s_device_plugin.workloads import router as ref_router  # noqa: E402


def _twin_routers(seed, reps):
    out = []
    for cls in (RouterServer, ref_router.RouterServer):
        rt = cls(statz_interval_s=60.0, replica_ttl_s=60.0, seed=seed)
        for r in reps:
            rt.register(dict(r))
        out.append(rt)
    return out


@pytest.mark.parametrize("seed,n", [(0, 2), (7, 3), (11, 5)])
def test_routing_decisions_match_reference(seed, n):
    reps = [{"address": f"127.0.0.1:{9000 + i}",
             "replica_id": f"replica-{i}",
             "role": ("prefill", "decode", "mixed")[i % 3]}
            for i in range(n)]
    port_rt, ref_rt = _twin_routers(seed, reps)
    for i in range(300):
        body = {"tokens": [(i * 31 + j * 7) % 127 + 1
                           for j in range(16 + i % 97)]}
        key = affinity_key(body, port_rt.prefix_chunk)
        assert key == ref_router.affinity_key(body, ref_rt.prefix_chunk)
        for role in (None, "prefill", "decode", "mixed"):
            assert port_rt.affinity_target(key, role=role) \
                == ref_rt.affinity_target(key, role=role), (i, role)
        tenant, sid = f"tenant-{i}", f"user-{i % 50}/chat-{i}"
        assert port_rt.tenant_target(tenant) \
            == ref_rt.tenant_target(tenant)
        assert port_rt.session_target(sid) \
            == ref_rt.session_target(sid)
        assert port_rt._est_cost(body) == ref_rt._est_cost(body)
        assert port_rt._prefill_heavy(body) \
            == ref_rt._prefill_heavy(body)
    def view(rt):   # a replica's age is the clock's, not a decision
        return [{k: v for k, v in r.items() if k != "age_s"}
                for r in rt.replicas()]

    assert view(port_rt) == view(ref_rt)


@pytest.fixture(scope="module")
def twin_stack(engine_stack):
    """The reference's router beside the port's, both fronting the
    port replica of ``engine_stack``."""
    srv, rt = engine_stack
    ref_rt = ref_router.RouterServer(statz_interval_s=0.2,
                                     replica_ttl_s=30.0, seed=3)
    ref_rt.start(host="127.0.0.1", port=0)
    ref_rt.register({"address": f"127.0.0.1:{srv.port}",
                     "replica_id": "r0", "model": "test"})
    deadline = time.time() + 10
    while time.time() < deadline and not ref_rt.healthy():
        time.sleep(0.05)
    assert ref_rt.healthy()
    yield srv, rt, ref_rt
    ref_rt.stop()


TWIN_REQUESTS = [
    pytest.param("/generate", {"tokens": [3, 1, 4, 1, 5],
                               "max_new_tokens": 6, "stream": False},
                 id="unary"),
    pytest.param("/generate", {"tokens": [2, 7, 1, 8, 2, 8],
                               "max_new_tokens": 7}, id="jsonlines"),
    pytest.param("/generate", {"tokens": [6, 6, 6], "max_new_tokens": 5,
                               "per_token": True}, id="per-token"),
    pytest.param("/v1/completions", {"prompt": "xyz", "max_tokens": 6,
                                     "stream": True, "temperature": 0.0},
                 id="sse"),
]


@pytest.mark.parametrize("path,payload", TWIN_REQUESTS)
def test_replies_byte_identical_to_reference_router(twin_stack, path,
                                                    payload):
    import re

    srv, rt, ref_rt = twin_stack
    _raw_post(srv.port, payload, path=path)  # APC donor for both

    def norm(b):
        b = re.sub(rb"cmpl-[0-9a-f]+", b"cmpl-X", b)
        return re.sub(rb'"created": \d+', b'"created": 0', b)

    st_p, hd_p, body_p = _raw_post(rt.port, payload, path=path)
    st_r, hd_r, body_r = _raw_post(ref_rt.port, payload, path=path)
    assert st_p == st_r == 200
    assert hd_p.get("X-Replica") == hd_r.get("X-Replica") == "r0"
    assert hd_p.get("Content-Type") == hd_r.get("Content-Type")
    if path == "/v1/completions":
        assert norm(body_p) == norm(body_r)
    else:
        assert body_p == body_r
