"""Chaos soak: provoke every recovery path of the port, assert
reconvergence.

Drives a REAL 2-host slice (coordinator + two plugin managers on copies
of the 8-GPU fixture ``testdata/nvidia/h100-sxm-8``, each with its own
fake kubelet over real gRPC sockets) plus the port's serving engines,
servers, routers and fleets through a seeded sweep of injected fault
episodes:

  1. kubelet.register drop   — every Register RPC lost; the retry
                               policy burns its budget, then recovery
                               re-registers on the next socket event
  2. slice.join error        — join polls fail transiently; the
                               jittered-backoff loop still forms
  3. slice.heartbeat error   — total heartbeat loss; the breaker opens
                               (fail-fast pulses), then closes on the
                               half-open probe after the faults lift
  4. probe hang              — the GPU probe wedges; the watchdog
                               abandons it, devices demote within one
                               pulse, recovery re-promotes
  5. serve.step error        — the serving scheduler thread crashes;
                               in-flight requests get 503, the
                               supervisor restarts the loop, and the
                               next request answers 200
  6. serve.schedule hang     — an iteration wedges mid-interleave; the
                               schedule watchdog abandons it, in-flight
                               requests drain with 503, the supervisor
                               restarts the loop, and traffic
                               reconverges (the abandoned worker bails
                               on the supersession check instead of
                               racing the restarted loop)
  7. member loss + reshape   -- a slice member dies mid-traffic; the
                               survivor re-forms into a smaller
                               degraded generation and serves Healthy
                               at the reduced shape, journal-proven
  8. member flap in grace    -- the member returns INSIDE the reshape
                               grace window: no reshape, the original
                               generation holds bit-for-bit
  9. tenant burst under KV page pressure (preemption by page eviction)
 10. a replica SIGKILLed under burst behind the router
 11. the scheduler killed mid packed prefill
 12. the prefill replica SIGKILLed mid migration
 13. a seeded trace replayed through a replica kill
 14. a degraded-slice drain under load (the fleet reconciler)
 15. a burn-rate page alert through a replica kill
 16. a SIGKILL mid-burst that writes ONE fleet incident bundle
 17. a session spilled to disk surviving a replica SIGKILL

After every episode the system must reconverge: all devices
re-advertised Healthy, the slice verdict healthy, serving answering
200s — and the flight-recorder journals must contain the
breaker/watchdog transition events that prove the resilience layer
(not luck) did the recovering.  The slice hands out the
``torch.distributed`` env contract (``MASTER_ADDR``/``MASTER_PORT`` on
port 29500, ``WORLD_SIZE``, ``RANK``).

Deterministic: ``--seed`` feeds the fault injector and every backoff
jitter RNG, so a CI failure reproduces locally with the same seed
(the ENGINE_FUZZ_SEED convention).

The serving episodes build the port's engines on ``--device`` (CUDA
unless ``--device cpu``; without CUDA they raise, never fall back) and
spawn the port's server CLI with the same device.  Under
``--skip-serving`` nothing imports torch, and the node agents never
create a CUDA context.

Usage::

    python -m tpu_k8s_device_plugin_torch.tools.chaos_soak --device cpu \\
        --seed 1
    python -m tpu_k8s_device_plugin_torch.tools.chaos_soak --seed 1 \\
        --skip-serving
"""
# tpulint: disable-file=R1 -- chaos DRIVER: these probe requests deliberately hit a faulted server raw; the resilience machinery under test lives on the server side, and wrapping the prober would mask whether recovery actually happened

from __future__ import annotations

import argparse
import concurrent.futures
import http.client
import json
import logging
import os
import queue
import random
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

from .. import obs
from ..gpu import nvml
from ..gpu.device_impl import GpuContainerImpl
from ..health import probe_gpu_states
from ..manager import PluginManager
from ..manager import manager as manager_mod
from ..proto import deviceplugin_pb2 as pluginapi
from ..resilience import faults
from ..slice import SliceClient, SliceCoordinator
from ..types import constants
from ..workloads import loadclient
from ._common import ROOT, spawn_env
from .fake_kubelet import FakeKubelet, ListAndWatchConsumer

log = logging.getLogger("chaos-soak")

FIXTURE = os.path.join("nvidia", "h100-sxm-8")
RESOURCE = "nvidia.com_gpu"
PROBE_WATCHDOG_S = 0.5
BREAKER_RESET_S = 0.2


class ChaosHost:
    """One slice member: fixture tree, impl (in-process GPU probe),
    slice client, fake kubelet, manager — all wired to one registry +
    flight recorder so episodes can assert on the journal."""

    def __init__(self, name, coord, testdata, tmp, rendezvous, seed):
        self.name = name
        root = os.path.join(tmp, name)
        shutil.copytree(os.path.join(testdata, FIXTURE), root,
                        symlinks=True)
        self.roots = tuple(os.path.join(root, d)
                           for d in ("sys", "dev", "proc"))
        self.nvml = nvml.load(os.path.join(root, "nvml.json"))
        self.registry = obs.Registry()
        self.recorder = obs.FlightRecorder(registry=self.registry)
        self.impl = GpuContainerImpl(
            *self.roots, nvml=self.nvml,
            health_fn=self._granular,
            probe_watchdog_s=PROBE_WATCHDOG_S,
        )
        self.client = SliceClient(
            rendezvous_address=rendezvous,
            hostname=name,
            coords=(coord,),
            chip_count=len(self.impl.gpus),
            state_path=os.path.join(tmp, f"{name}-membership.json"),
            local_health_fn=self.impl.local_health,
            registry=self.registry,
            recorder=self.recorder,
            join_backoff_initial_s=0.05,
            join_backoff_max_s=0.2,
            breaker_reset_s=BREAKER_RESET_S,
            seed=seed,
        )
        self.impl.set_slice_client(self.client)
        self.kubelet = FakeKubelet(os.path.join(tmp, f"{name}-dp")).start()
        self.manager = PluginManager(
            self.impl,
            pulse_seconds=0,
            kubelet_dir=self.kubelet.dir,
            kubelet_watch_interval_s=0.1,
            slice_client=self.client,
            registry=self.registry,
            recorder=self.recorder,
        )
        self.consumer = None

    def _granular(self):
        states = probe_gpu_states(*self.roots, nvml=self.nvml)
        return {gid: st.health for gid, st in states.items()}

    def pulse(self):
        """One manual pulse round in the manager loop's order."""
        self.client.heartbeat_now()
        with self.manager._plugins_lock:
            plugins = list(self.manager._plugins.values())
        for sp in plugins:
            sp.plugin.beat()

    def open_stream(self):
        stub = self.kubelet.plugin_stub(RESOURCE)
        self.consumer = ListAndWatchConsumer(stub)
        return self.consumer.next_frame()

    def wait_frame(self, predicate, pulses=10, timeout_s=10.0):
        """Pulse until a ListAndWatch frame satisfies *predicate*."""
        deadline = time.time() + timeout_s
        last = None
        for _ in range(pulses):
            self.pulse()
            while time.time() < deadline:
                try:
                    last = self.consumer.frames.get(timeout=1.0)
                except queue.Empty:
                    break
                if predicate(last):
                    return last
            if time.time() >= deadline:
                break
        raise AssertionError(
            f"{self.name}: no matching frame within {timeout_s}s; "
            f"last: {last}")

    def journal(self, name):
        return self.recorder.events(name=name)

    def stop(self):
        self.manager.stop()
        self.client.stop()
        self.kubelet.stop()


def all_healthy(frame):
    return frame.devices and all(
        d.health == constants.HEALTHY for d in frame.devices)


def all_unhealthy(frame):
    return frame.devices and all(
        d.health == constants.UNHEALTHY for d in frame.devices)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)
    log.info("OK: %s", msg)


def _samples(text, name, **labels):
    """The values of *name*'s samples whose labels include *labels*."""
    return [v for n, lab, v in obs.parse_exposition(text)
            if n == name and all(lab.get(k) == want
                                 for k, want in labels.items())]


def episode_register_drop(hosts, seed):
    """Every Register lost -> retries burn out -> recovery on the next
    kubelet socket event once the faults lift."""
    a = hosts[0]
    inj = faults.install("kubelet.register:drop:1", seed=seed,
                         recorder=a.recorder)
    try:
        a.kubelet.register_event.clear()
        a.kubelet.restart(wipe_dir=False)
        got = a.kubelet.wait_for_registration(timeout=3.0)
        check(not got, "register blackhole: no registration landed")
        check(inj.fired_count("kubelet.register")
              >= manager_mod._REGISTER_RETRIES,
              f"retry policy burned its {manager_mod._REGISTER_RETRIES}-"
              "attempt budget against the blackhole")
        retries = _samples(a.registry.render(),
                           "tpu_resilience_retries_total",
                           op="kubelet.register")
        check(retries and retries[0] >= 1,
              "tpu_resilience_retries_total{op=kubelet.register} counted")
    finally:
        faults.uninstall()
    a.kubelet.restart(wipe_dir=False)
    check(a.kubelet.wait_for_registration(timeout=10.0),
          "re-registered after the faults lifted")


def episode_join_error(hosts, coordinator, tmp, seed):
    """A fresh client (worker restart) joins through transient join
    errors via the shared backoff policy."""
    registry = obs.Registry()
    recorder = obs.FlightRecorder(registry=registry)
    client = SliceClient(
        rendezvous_address=f"127.0.0.1:{coordinator.port}",
        hostname=hosts[0].name,     # same host restarting: rank kept
        coords=(0,),
        chip_count=len(hosts[0].impl.gpus),
        state_path=None,
        registry=registry,
        recorder=recorder,
        join_backoff_initial_s=0.02,
        join_backoff_max_s=0.1,
        seed=seed,
    )
    inj = faults.install("slice.join:error:0.6", seed=seed,
                         recorder=recorder)
    try:
        m = client.join(timeout_s=30.0)
        check(m is not None and m.rank_of(hosts[0].name) == 0,
              "join converged through 60% injected error rate "
              f"({inj.fired_count('slice.join')} faults fired)")
    finally:
        faults.uninstall()
        client.stop()


def episode_heartbeat_loss(hosts, seed):
    """Total heartbeat loss: breakers open (fail-fast pulses, verdict
    frozen), then close via the half-open probe once faults lift."""
    a, b = hosts
    inj = faults.install("slice.heartbeat:error:1", seed=seed,
                         recorder=a.recorder)
    try:
        for _ in range(4):      # > breaker threshold (3)
            a.pulse()
            b.pulse()
        opened = [e for e in a.journal("tpu_breaker_transition")
                  if e["attrs"].get("op") == "slice.heartbeat"
                  and e["attrs"].get("to") == "open"]
        check(opened, "heartbeat breaker opened in the journal")
        check(inj.fired_count("slice.heartbeat") >= 3,
              "injector dropped >= 3 heartbeats")
        overlay = a.client.health_overlay()
        check(overlay is not None and overlay[0],
              "verdict frozen healthy through the outage (no "
              "self-inflicted slice demotion)")
    finally:
        faults.uninstall()
    time.sleep(BREAKER_RESET_S * 1.5)   # let the reset window pass
    for _ in range(2):
        a.pulse()
        b.pulse()
    closed = [e for e in a.journal("tpu_breaker_transition")
              if e["attrs"].get("op") == "slice.heartbeat"
              and e["attrs"].get("to") == "closed"]
    check(closed, "heartbeat breaker closed after recovery")
    a.wait_frame(all_healthy)
    b.wait_frame(all_healthy)
    check(True, "both hosts advertise Healthy after heartbeat recovery")


def episode_probe_hang(hosts, seed):
    """The probe wedges: the watchdog abandons it, the host reports
    itself unhealthy, the slice demotes BOTH members within a pulse
    exchange; recovery re-promotes everything."""
    a, b = hosts
    faults.install(f"probe:hang:{PROBE_WATCHDOG_S * 4}", seed=seed,
                   recorder=a.recorder)
    try:
        t0 = time.monotonic()
        a.pulse()               # watchdog trips inside this pulse
        pulse_dt = time.monotonic() - t0
        check(pulse_dt < PROBE_WATCHDOG_S * 4,
              f"pulse returned in {pulse_dt:.1f}s — the watchdog "
              "failed the hung probe instead of riding it out")
        trips = [e for e in a.journal("tpu_watchdog_trip")
                 if e["attrs"].get("op") == "probe"]
        check(trips, "watchdog trip journaled for the probe")
        b.pulse()               # B learns the slice verdict
        b.wait_frame(all_unhealthy)
        check(True, "peer demoted all devices after the probe hang")
    finally:
        faults.uninstall()
    a.wait_frame(all_healthy)
    b.wait_frame(all_healthy)
    check(True, "both hosts re-advertise Healthy after probe recovery")


# -- serving ----------------------------------------------------------------
#
# The in-process episodes take an optional *model* (default: the tiny
# f32 decoder below on *device*) and *probe*, called as probe(server,
# stage) once the baseline request answered ("before") and after each
# supervised restart ("restart <k>"), before any other request reaches
# the restarted loop: the card's chaos phase checks there that the
# restarted loop replays its captured steps, answers the control
# request as before, and holds its memory.

def tiny_model(device, max_len):
    """The soak's tiny f32 decoder (vocab 128, d_model 64, 4 heads, 2
    layers, d_ff 128) on *device* (none: CUDA, raising without it),
    random weights from seed 0."""
    import torch

    from ..workloads.bench_serving import random_init_
    from ..workloads.inference import make_decoder

    model = make_decoder(vocab=128, d_model=64, n_heads=4, n_layers=2,
                         d_ff=128, max_len=max_len, dtype=torch.float32,
                         device=device)
    random_init_(model, 0)
    return model


def _server(model, device, engine_kw=None, **server_kw):
    from ..workloads.server import EngineServer
    from ..workloads.serving import ServingEngine

    eng = ServingEngine(model, device=device, **(engine_kw or {}))
    return EngineServer(eng, **server_kw)


def _post(port, payload, timeout=120):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", "/generate", json.dumps(payload),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _await_restarts(srv, n, timeout_s=10.0):
    deadline = time.time() + timeout_s
    while time.time() < deadline and srv._m_sched_restarts.value < n:
        time.sleep(0.05)
    return srv._m_sched_restarts.value


def episode_scheduler_crash(seed, device=None, model=None, rounds=1,
                            probe=None):
    """The serving scheduler crashes mid-decode: in-flight requests
    get 503 (not a hang), the supervisor restarts the loop, and the
    next request answers 200 (*rounds* times on one server)."""
    model = tiny_model(device, 64) if model is None else model
    srv = _server(model, device, dict(n_slots=2), max_new_tokens=8,
                  window=4)
    # every window length captured (on CUDA) before traffic, so that a
    # restarted loop has nothing left to capture
    srv.warm_scheduler()
    srv.start(host="127.0.0.1", port=0)
    try:
        status, _ = _post(srv.port, {"tokens": [3, 14, 15],
                                     "max_new_tokens": 4,
                                     "stream": False})
        check(status == 200, "serving baseline request answered 200")
        if probe is not None:
            probe(srv, "before")
        for k in range(1, rounds + 1):
            faults.install("serve.step:error:1", seed=seed,
                           recorder=srv.recorder)
            try:
                status, body = _post(srv.port, {"tokens": [9, 9, 8],
                                                "max_new_tokens": 4,
                                                "stream": False})
                check(status == 503,
                      f"in-flight request got a real 503 on scheduler "
                      f"crash (got {status}: {body[:80]!r})")
            finally:
                faults.uninstall()
            crashes = srv.recorder.events(name="tpu_serve_scheduler_crash")
            check(len(crashes) >= k, "scheduler crash journaled")
            check(_await_restarts(srv, k) >= k,
                  "supervisor restarted the scheduler")
            if probe is not None:
                probe(srv, f"restart {k}")
            status, _ = _get(srv.port, "/healthz")
            check(status == 200, "healthz back to 200 after restart")
            status, body = _post(srv.port, {"tokens": [2, 71, 82],
                                            "max_new_tokens": 4,
                                            "stream": False})
            check(status == 200,
                  f"serving answers 200 again after the crash "
                  f"(got {status}: {body[:80]!r})")
    finally:
        srv.stop()


def episode_scheduler_hang(seed, device=None, model=None, rounds=1,
                           probe=None):
    """An iteration hangs mid-interleave: the schedule watchdog trips
    (WatchdogTimeout -> crash supervisor), in-flight requests drain
    with 503 instead of hanging, the loop restarts, and the next
    request answers 200 (*rounds* times on one server).  The abandoned
    worker must NOT race the restarted loop — the supersession check
    has it bail before any engine work."""
    model = tiny_model(device, 64) if model is None else model
    srv = _server(model, device, dict(n_slots=2), max_new_tokens=8,
                  window=4, schedule_watchdog_s=0.5)
    # the steps are captured (on CUDA) before traffic: the 0.5s
    # watchdog is sized for steady state, not a first capture
    srv.warm_scheduler()
    srv.start(host="127.0.0.1", port=0)
    try:
        status, _ = _post(srv.port, {"tokens": [3, 14, 15],
                                     "max_new_tokens": 4,
                                     "stream": False})
        check(status == 200, "serving baseline request answered 200")
        if probe is not None:
            probe(srv, "before")
        for k in range(1, rounds + 1):
            faults.install("serve.schedule:hang:5", seed=seed,
                           recorder=srv.recorder)
            try:
                status, body = _post(srv.port, {"tokens": [9, 9, 8],
                                                "max_new_tokens": 4,
                                                "stream": False})
                check(status == 503,
                      f"hung iteration drained the in-flight request "
                      f"with a real 503 (got {status}: {body[:80]!r})")
            finally:
                faults.uninstall()
            trips = [e for e in srv.recorder.events(
                name="tpu_watchdog_trip")
                if e["attrs"].get("op") == "serve.schedule"]
            check(len(trips) >= k, "schedule-watchdog trip journaled")
            check(_await_restarts(srv, k) >= k,
                  "supervisor restarted the scheduler after the trip")
            if probe is not None:
                probe(srv, f"restart {k}")
            wd = _samples(srv.render_metrics(), "tpu_watchdog_trips_total",
                          op="serve.schedule")
            check(wd and wd[0] >= k,
                  "tpu_watchdog_trips_total{op=serve.schedule} counted")
            status, body = _post(srv.port, {"tokens": [2, 71, 82],
                                            "max_new_tokens": 4,
                                            "stream": False})
            check(status == 200,
                  f"traffic reconverged after the hang "
                  f"(got {status}: {body[:80]!r})")
    finally:
        srv.stop()


def episode_tenant_burst_page_pressure(seed, device=None, model=None,
                                       batch_new_tokens=8, kv_pages=8):
    """Episode 9: a low-priority batch tenant saturates a small paged
    KV pool, then an interactive tenant bursts.  QoS must hold: the
    interactive requests admit via preemption-by-page-eviction (the
    batch slot checkpoints its pages to host and re-queues), their
    latency stays bounded instead of queueing behind the whole batch
    stream, the PREEMPTED request still completes with its full token
    count after re-admission, and an over-quota tenant 429s — all
    journal/metric-proven.  *batch_new_tokens* and *kv_pages* (pages
    of 8 rows) size the batch stream and the pool: a faster device
    needs a longer stream to still be decoding when the burst lands,
    and the pool grows with it so that the stream fits alone."""
    from ..workloads.qos import parse_tenant_quotas

    model = tiny_model(device, 64) if model is None else model
    # ONE long request owns most of the pool, so the interactive burst
    # can only land through eviction
    srv = _server(model, device,
                  dict(n_slots=2, chunk=8, kv_paging=True,
                       kv_pages=kv_pages),
                  max_new_tokens=8, window=2,
                  tenant_quotas=parse_tenant_quotas(
                      ["interactive=0:0:4", "batch=0:0:1",
                       "greedy=1:20"]))
    eng = srv.engine
    srv.start(host="127.0.0.1", port=0)
    try:
        results = {}
        times = {}

        def fire(key, payload):
            t0 = time.time()
            results[key] = _post(srv.port, payload)
            times[key] = time.time() - t0

        lo = threading.Thread(target=fire, args=("batch", {
            "tokens": list(range(1, 31)),
            "max_new_tokens": batch_new_tokens,
            "priority": 0, "tenant": "batch", "stream": False}))
        lo.start()
        # the batch stream is decoding on the pool before the burst
        deadline = time.time() + 30.0
        while not any(eng.active) and time.time() < deadline:
            time.sleep(0.002)
        burst = [threading.Thread(target=fire, args=(f"i{k}", {
            "tokens": list(range(40 + k, 70 + k)), "max_new_tokens": 8,
            "priority": 5, "tenant": "interactive", "stream": False}))
            for k in range(2)]
        for t in burst:
            t.start()
        for t in burst:
            t.join(timeout=120)
        t_interactive = max(times[f"i{k}"] for k in range(2))
        lo.join(timeout=120)
        for k in range(2):
            st, body = results[f"i{k}"]
            check(st == 200, f"interactive request {k} served 200 "
                             f"under page pressure (got {st})")
        st, body = results["batch"]
        check(st == 200, f"preempted batch request completed after "
                         f"re-admission (got {st})")
        done = json.loads(body.decode().strip().splitlines()[-1])
        check(len(done.get("tokens", [])) == batch_new_tokens,
              f"preempted request kept its FULL {batch_new_tokens}-token "
              "stream across checkpoint/resume")
        check(t_interactive <= times["batch"],
              f"interactive p99 bounded: burst finished in "
              f"{t_interactive:.2f}s, not behind the whole batch "
              f"stream ({times['batch']:.2f}s)")
        preempts = _samples(srv.render_metrics(),
                            "tpu_serve_kv_preemptions_total")
        check(preempts and preempts[0] >= 1,
              "tpu_serve_kv_preemptions_total counted the eviction")
        names = [e["name"] for e in srv.recorder.events()]
        check("tpu_serve_kv_preempt" in names,
              "page eviction journaled")
        check("tpu_serve_kv_resume" in names,
              "checkpoint resume journaled")
        # over-quota tenant: 429 is per-tenant policy
        st, _ = _post(srv.port, {"tokens": list(range(1, 20)),
                                 "max_new_tokens": 8, "tenant": "greedy",
                                 "stream": False})
        st2, _ = _post(srv.port, {"tokens": list(range(1, 20)),
                                  "max_new_tokens": 8, "tenant": "greedy",
                                  "stream": False})
        check(429 in (st, st2),
              f"over-quota tenant throttled with 429 (got {st}/{st2})")
        quota_sheds = _samples(srv.render_metrics(),
                               "tpu_serve_shed_total", reason="quota")
        check(quota_sheds and quota_sheds[0] >= 1,
              "tpu_serve_shed_total{reason=quota} counted")
        eng._pool.check()
    finally:
        srv.stop()


def _victim(device, port, name, *args):
    """A REAL replica subprocess (the port's server CLI, the tiny
    config, on *device*), so a kill is a kill — no graceful drain,
    sockets die mid-chunk."""
    cmd = loadclient.server_cmd(device, "--config", "tiny", *args,
                                "--host", "127.0.0.1", "--port", str(port))
    return loadclient.spawn_replica(cmd, name, env=spawn_env())


def _reap(proc):
    if proc.poll() is None:
        proc.kill()
    try:
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        log.warning("replica pid %d not reaped within 30s", proc.pid)


def _routable(n):
    return lambda b: sum(r["healthy"] for r in b["replicas"]) >= n


def _prompt_for(rt, rng, rid):
    """A 32-token prompt that the router's affinity ring sends to
    *rid*."""
    from ..workloads.router import affinity_key

    while True:
        cand = [rng.randrange(1, 128) for _ in range(32)]
        if rt.affinity_target(affinity_key({"tokens": cand}, 32)) == rid:
            return cand


def episode_router_replica_kill(seed, device=None):
    """Episode 10: a serving replica is SIGKILLed under burst behind
    the router tier.  The surviving replica absorbs the load: only the
    requests mid-stream ON THE DEAD REPLICA error — each with a
    well-formed in-band error frame and a clean chunked terminator,
    never a silent truncation — every post-kill request lands 200 on
    the survivor (pre-stream failover / routing-around), the victim's
    circuit breaker opens, and when the replica comes back under the
    same identity the breaker closes and affinity traffic returns to
    it.  All journal/metric-proven on the router's own surfaces."""
    from ..workloads.router import RouterServer

    rt = RouterServer(statz_interval_s=0.5, replica_ttl_s=5.0,
                      breaker_reset_s=0.5, seed=seed)
    rt.start(host="127.0.0.1", port=0)

    # survivor: in-process tiny engine registered as replica-a
    model = tiny_model(device, 256)
    survivor = _server(model, device, dict(n_slots=2),
                       max_new_tokens=200, window=4)
    survivor.start(host="127.0.0.1", port=0)
    survivor.start_registration(
        f"http://127.0.0.1:{rt.port}", replica_id="replica-a",
        model="chaos-tiny", interval_s=0.3)

    # victim max_len 2048: the burst streams need SECONDS of decode
    # left when the SIGKILL lands (a short stream fits entirely in
    # socket buffers before the kill and aborts nothing)
    victim_port = loadclient.free_port()
    victim = _victim(device, victim_port, "replica-b",
                     "--n-slots", "2", "--max-len", "2048",
                     "--max-new-tokens", "2000", "--window", "4",
                     "--register-with", f"http://127.0.0.1:{rt.port}",
                     "--replica-id", "replica-b",
                     "--register-interval", "0.3")

    revived = None
    try:
        loadclient.wait_http_ok(victim_port, "/healthz", 600,
                                procs=[victim])
        loadclient.wait_http_ok(rt.port, "/replicas", 30, _routable(2))
        check(True, "router sees both replicas healthy")

        # deterministic prompts pinned to each replica via the ring
        rng = random.Random(seed)
        p_victim = _prompt_for(rt, rng, "replica-b")
        p_surv = _prompt_for(rt, rng, "replica-a")

        def stream(prompt, budget):
            """One streaming request through the router; returns
            (status, X-Replica, event lines)."""
            conn = http.client.HTTPConnection("127.0.0.1", rt.port,
                                              timeout=120)
            conn.request("POST", "/generate", json.dumps(
                {"tokens": prompt, "max_new_tokens": budget,
                 "ignore_eos": True}),
                {"Content-Type": "application/json"})
            resp = conn.getresponse()
            replica = resp.headers.get("X-Replica")
            lines = []
            try:
                for line in resp:
                    if line.strip():
                        lines.append(line.strip())
            finally:
                conn.close()
            return resp.status, replica, lines

        # baseline: affinity routes each prompt to its ring target
        st, rep, lines = stream(p_victim, 8)
        check(st == 200 and rep == "replica-b",
              f"affinity routed the victim-bound prompt to replica-b "
              f"(got {st} via {rep})")
        st, rep, lines = stream(p_surv, 8)
        check(st == 200 and rep == "replica-a",
              f"affinity routed the survivor-bound prompt to "
              f"replica-a (got {st} via {rep})")

        # -- burst + kill ---------------------------------------------
        results = {}
        started = threading.Event()

        def burst_one(key, prompt, budget):
            conn = http.client.HTTPConnection("127.0.0.1", rt.port,
                                              timeout=120)
            try:
                conn.request("POST", "/generate", json.dumps(
                    {"tokens": prompt, "max_new_tokens": budget,
                     "ignore_eos": True}),
                    {"Content-Type": "application/json"})
                resp = conn.getresponse()
                replica = resp.headers.get("X-Replica")
                lines = []
                for line in resp:
                    if line.strip():
                        lines.append(line.strip())
                        if replica == "replica-b":
                            started.set()
                results[key] = (resp.status, replica, lines, None)
            # tpulint: disable=R2 -- not a swallow: the exception is captured into results and asserted on by the episode (a truncated stream must FAIL it)
            except Exception as e:
                results[key] = (-1, None, [], e)
            finally:
                conn.close()

        burst = (
            [threading.Thread(target=burst_one,
                              args=(f"v{i}", p_victim, 1500))
             for i in range(2)]
            + [threading.Thread(target=burst_one,
                                args=(f"s{i}", p_surv, 24))
               for i in range(2)])
        for t in burst:
            t.start()
        check(started.wait(timeout=60),
              "victim streams flowing before the kill")
        victim.kill()          # SIGKILL: no drain, sockets die
        victim.wait(timeout=30)
        t_kill = time.monotonic()
        for t in burst:
            t.join(timeout=120)

        aborted = completed = 0
        for key, (st, rep, lines, exc) in sorted(results.items()):
            check(exc is None,
                  f"burst request {key} ended with a parseable "
                  f"stream, not a transport error ({exc})")
            check(st == 200 and lines,
                  f"burst request {key} got headers + frames")
            last = json.loads(lines[-1])
            if "done" in last:
                completed += 1
            else:
                # the well-formed in-band error frame: structured
                # JSON naming the dead replica, code 502
                check("error" in last and last.get("code") == 502
                      and rep == "replica-b",
                      f"aborted stream {key} ended with a well-formed "
                      f"502 error frame on the dead replica ({last})")
                aborted += 1
        check(aborted >= 1,
              f"at least one in-flight stream on the dead replica "
              f"aborted mid-stream ({aborted} did)")
        check(completed >= 2,
              f"streams off the dead replica completed normally "
              f"({completed} did)")

        # post-kill: every new request lands on the survivor, 200
        for i in range(4):
            st, rep, lines = stream(p_victim, 8)
            check(st == 200 and rep == "replica-a",
                  f"post-kill request {i} failed over to the "
                  f"survivor (got {st} via {rep})")
            check(json.loads(lines[-1]).get("done") is True,
                  f"post-kill request {i} completed")
        reconverge_s = time.monotonic() - t_kill
        check(reconverge_s < 60.0,
              f"post-kill traffic reconverged in {reconverge_s:.1f}s")

        # journal + metric proof
        names = [e["name"] for e in rt.recorder.events()]
        check("tpu_router_stream_abort" in names,
              "mid-stream abort journaled")
        opened = [e for e in rt.recorder.events(
            name="tpu_breaker_transition")
            if e["attrs"].get("op") == "router.replica.replica-b"
            and e["attrs"].get("to") == "open"]
        check(opened, "victim breaker opened in the journal")
        text = rt.registry.render()
        aborts = _samples(text, "tpu_router_requests_total",
                          replica="replica-b", outcome="stream_abort")
        check(aborts and aborts[0] >= 1,
              "tpu_router_requests_total{replica-b,stream_abort} "
              "counted")
        healthy = {lab.get("replica"): v
                   for n, lab, v in obs.parse_exposition(text)
                   if n == "tpu_router_replica_healthy"}
        check(healthy.get("replica-a") == 1,
              "tpu_router_replica_healthy{replica-a} = 1")
        check(healthy.get("replica-b", 0) == 0,
              "tpu_router_replica_healthy{replica-b} = 0 after kill")

        # -- revival: same identity, breaker closes, affinity returns -
        revived = _server(model, device, dict(n_slots=2),
                          max_new_tokens=200, window=4)
        revived.start(host="127.0.0.1", port=victim_port)
        revived.start_registration(
            f"http://127.0.0.1:{rt.port}", replica_id="replica-b",
            advertise=f"127.0.0.1:{victim_port}",
            model="chaos-tiny", interval_s=0.3)
        loadclient.wait_http_ok(rt.port, "/replicas", 30, _routable(2))
        closed = [e for e in rt.recorder.events(
            name="tpu_breaker_transition")
            if e["attrs"].get("op") == "router.replica.replica-b"
            and e["attrs"].get("to") == "closed"]
        check(closed, "victim breaker closed after revival")
        st, rep, lines = stream(p_victim, 8)
        check(st == 200 and rep == "replica-b",
              f"affinity traffic returned to the revived replica "
              f"(got {st} via {rep})")
    finally:
        if revived is not None:
            revived.stop()
        survivor.stop()
        rt.stop()
        _reap(victim)


def episode_packed_prefill_kill(seed, device=None, model=None,
                                anchor_new_tokens=40, probe=None):
    """Episode 11: the scheduler is killed (injected hang → schedule
    watchdog → crash supervisor) while RAGGED PACKED PREFILL is in
    flight — several concurrent multi-chunk admissions batching
    through admit_step_packed behind an open decode window.  The
    invariant: every packed request either COMPLETES (a {"done"}
    terminal event) or gets a WELL-FORMED error frame (the
    supervisor's 503 drain) — never a hang, never a truncated stream
    — and after the supervised restart fresh traffic answers 200
    through the re-warmed packed path.  *anchor_new_tokens* sizes the
    decode that keeps the engine active while the hang lands."""
    model = tiny_model(device, 64) if model is None else model
    # chunk 4 so a 40-token prompt is 10 chunks; prefill_chunks=1
    # spreads each admission's prefill over many windows — the packed
    # sessions are still mid-flight when the hang lands
    srv = _server(model, device,
                  dict(n_slots=4, chunk=4, auto_prefix=False),
                  max_new_tokens=24, window=4, prefill_chunks=1,
                  schedule_watchdog_s=0.5)
    # capture scan windows + packed shapes like the CLI does: the
    # 0.5s watchdog is sized for steady state, not first capture
    srv.warm_scheduler()
    srv.start(host="127.0.0.1", port=0)

    def post(payload, out=None, timeout=120):
        conn = http.client.HTTPConnection("127.0.0.1", srv.port,
                                          timeout=timeout)
        try:
            conn.request("POST", "/generate", json.dumps(payload),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            events = []
            for line in resp:
                s = line.strip()
                if s:
                    events.append(json.loads(s))
            result = (resp.status, events)
        except (OSError, ValueError) as e:
            result = (-1, [{"error": f"transport: {e}", "code": -1}])
        finally:
            conn.close()
        if out is not None:
            out.append(result)
        return result

    try:
        status, _ = post({"tokens": [3, 14, 15], "max_new_tokens": 4,
                          "stream": False})
        check(status == 200, "serving baseline request answered 200")
        if probe is not None:
            probe(srv, "before")
        # a long-running decode keeps the engine active, so the wave
        # below rides the mid-window admission path; its 40-token
        # (10-chunk) prompts at prefill_chunks=1 keep the packed
        # sessions pending across MANY windows — the hang lands while
        # they are still mid-flight
        results: list = []
        anchor = threading.Thread(target=post, args=(
            {"tokens": [2, 71, 82], "max_new_tokens": anchor_new_tokens},
            results))
        anchor.start()
        time.sleep(0.02)
        rng = random.Random(seed)
        packed = []
        for i in range(3):
            prompt = [rng.randrange(1, 128) for _ in range(40)]
            th = threading.Thread(target=post, args=(
                {"tokens": prompt, "max_new_tokens": 4}, results))
            th.start()
            packed.append(th)
        time.sleep(0.03)  # tickets pulled, packed rounds under way
        faults.install("serve.schedule:hang:5", seed=seed,
                       recorder=srv.recorder)
        try:
            anchor.join(timeout=60)
            for th in packed:
                th.join(timeout=60)
            check(len(results) == 4,
                  "every request terminated (no hung streams)")
        finally:
            faults.uninstall()
        done = err = 0
        for status, events in results:
            terminal = events[-1] if events else {}
            if status == 200 and terminal.get("done") is True:
                done += 1
            elif "error" in terminal and terminal.get("code") == 503:
                err += 1    # the supervisor's well-formed drain frame
            else:
                check(False,
                      f"request ended without a done/503 terminal "
                      f"event: status={status} last={terminal}")
        check(done + err == 4,
              f"all packed-era requests completed or got well-formed "
              f"503s (done={done} err={err})")
        check(err >= 1, "the hang actually aborted in-flight work")
        check(srv.engine.stats()["packed_prefill_extends"] >= 1,
              "packed prefill dispatches ran before the kill")
        trips = [e for e in srv.recorder.events(name="tpu_watchdog_trip")
                 if e["attrs"].get("op") == "serve.schedule"]
        check(trips, "schedule-watchdog trip journaled")
        check(_await_restarts(srv, 1) >= 1,
              "supervisor restarted the scheduler after the trip")
        if probe is not None:
            probe(srv, "restart 1")
        # reconvergence: the hang may have tripped the watchdog more
        # than once before the uninstall landed (each trip drains
        # 503s), so give the restarted loop a bounded window to serve
        # clean again — the invariant is recovery, not trip count
        status, events = -1, []
        deadline = time.time() + 15.0
        while time.time() < deadline:
            status, events = post({"tokens": [9, 9, 8, 7, 1, 2, 3, 4],
                                   "max_new_tokens": 4,
                                   "stream": False})
            if status == 200 and events and events[0].get("done"):
                break
            time.sleep(0.25)
        check(status == 200 and events and events[0].get("done"),
              f"traffic reconverged after the packed-prefill kill "
              f"(got {status})")
    finally:
        srv.stop()


def episode_prefill_kill_mid_migration(seed, device=None):
    """Episode 12: the PREFILL-class replica is SIGKILLed while
    disagg-routed requests are mid-prefill/mid-migration behind the
    phase-aware router.  Every in-flight request must either complete
    on a surviving replica (the router's disagg fallbacks all fire
    BEFORE any client byte, so the request re-routes whole — the
    decode-class survivor serves it normally) or end in a WELL-FORMED
    502/503 frame; post-kill traffic lands 200 on the survivor, the
    victim's breaker opens, and the router's migration counters +
    journal carry the proof."""
    from ..workloads.bench_serving import build_model_and_params
    from ..workloads.router import RouterServer

    rt = RouterServer(statz_interval_s=0.5, replica_ttl_s=5.0,
                      breaker_reset_s=0.5, seed=seed,
                      prefill_threshold=64)
    rt.start(host="127.0.0.1", port=0)

    # survivor: in-process DECODE-class replica with the SAME model
    # the victim CLI builds (checkpoints only resume onto matching
    # shapes/dtypes — the builder's deterministic seed makes the two
    # processes' weights identical, so migrated decode is exact)
    cfg, model = build_model_and_params("tiny", 512, device)
    survivor = _server(model, device,
                       dict(n_slots=4, eos_id=getattr(cfg, "eos_id", None),
                            kv_paging=True),
                       max_new_tokens=64, window=4, replica_role="decode")
    survivor.start(host="127.0.0.1", port=0)
    survivor.start_registration(
        f"http://127.0.0.1:{rt.port}", replica_id="disagg-decode",
        model="chaos-tiny", interval_s=0.3)

    # victim: a REAL prefill-class replica subprocess — SIGKILL means
    # sockets die mid-prefill/mid-export, no drain
    victim_port = loadclient.free_port()
    victim = _victim(device, victim_port, "disagg-prefill",
                     "--n-slots", "4", "--max-len", "512",
                     "--max-new-tokens", "64", "--window", "4",
                     "--kv-paging", "--replica-role", "prefill",
                     "--register-with", f"http://127.0.0.1:{rt.port}",
                     "--replica-id", "disagg-prefill",
                     "--register-interval", "0.3")

    try:
        loadclient.wait_http_ok(victim_port, "/healthz", 600,
                                procs=[victim])
        loadclient.wait_http_ok(rt.port, "/replicas", 30, _routable(2))
        check(True, "router sees prefill + decode replicas healthy")

        rng = random.Random(seed)

        def long_prompt():
            return [rng.randrange(1, 128) for _ in range(320)]

        def unary(prompt, budget=24):
            """One long-prefill unary request through the router;
            returns (status, X-Replica, parsed body or None, exc)."""
            conn = http.client.HTTPConnection("127.0.0.1", rt.port,
                                              timeout=120)
            try:
                conn.request("POST", "/generate", json.dumps(
                    {"tokens": prompt, "max_new_tokens": budget,
                     "stream": False, "ignore_eos": True}),
                    {"Content-Type": "application/json"})
                resp = conn.getresponse()
                body = resp.read()
                return (resp.status,
                        resp.headers.get("X-Replica"),
                        json.loads(body), None)
            # tpulint: disable=R2 -- not a swallow: the exception is captured into the result tuple and asserted on by the episode (a torn response must FAIL it)
            except Exception as e:
                return (-1, None, None, e)
            finally:
                conn.close()

        # steady state: migration actually engages
        st, rep, body, exc = unary(long_prompt())
        check(exc is None and st == 200 and "done" in (body or {}),
              f"disagg-routed request completed ({st} via {rep})")
        check(rep == "disagg-decode",
              "pre-kill request streamed from the decode replica")
        ok_migs = _samples(rt.registry.render(),
                           "tpu_router_migrations_total", outcome="ok")
        check(ok_migs and ok_migs[0] >= 1,
              "tpu_router_migrations_total{outcome=ok} counted "
              "before the kill")

        # -- burst + kill mid-migration --------------------------------
        results = {}
        started = threading.Event()

        def burst_one(key):
            started.wait(timeout=30)
            results[key] = unary(long_prompt())

        burst = [threading.Thread(target=burst_one, args=(f"r{i}",))
                 for i in range(6)]
        for t in burst:
            t.start()
        started.set()
        time.sleep(0.2)     # let prefills land on the victim
        victim.kill()
        victim.wait(timeout=30)
        t_kill = time.monotonic()
        for t in burst:
            t.join(timeout=180)

        completed = well_formed_errors = 0
        for key, (st, rep, body, exc) in sorted(results.items()):
            check(exc is None,
                  f"burst request {key} got a parseable response, "
                  f"not a transport error ({exc})")
            if st == 200 and body is not None and "done" in body:
                completed += 1
            else:
                # the acceptance contract: a request that could not
                # complete must end in a STRUCTURED 502/503, never a
                # torn body
                check(st in (502, 503) and body is not None
                      and "error" in body,
                      f"burst request {key} ended in a well-formed "
                      f"502/503 frame (got {st}: {body})")
                well_formed_errors += 1
        check(completed >= 1,
              f"requests completed on the surviving replica "
              f"({completed} of {len(results)} did, "
              f"{well_formed_errors} well-formed errors)")

        # post-kill: disagg stands down (one class left) and every
        # new request lands whole on the decode-class survivor
        for i in range(3):
            st, rep, body, exc = unary(long_prompt(), budget=8)
            check(exc is None and st == 200
                  and rep == "disagg-decode",
                  f"post-kill request {i} served by the survivor "
                  f"(got {st} via {rep})")
        reconverge_s = time.monotonic() - t_kill
        check(reconverge_s < 60.0,
              f"post-kill traffic reconverged in {reconverge_s:.1f}s")

        # journal + metric proof
        text = rt.registry.render()
        fallbacks = sum(
            v for n, lab, v in obs.parse_exposition(text)
            if n == "tpu_router_migrations_total"
            and lab.get("outcome") in ("fallback",
                                       "prefill_unavailable",
                                       "prefill_error"))
        migrated_post = _samples(text, "tpu_router_migrations_total",
                                 outcome="ok")
        names = [e["name"] for e in rt.recorder.events()]
        check(fallbacks >= 1 or "tpu_router_migrate_fallback" in names
              or completed == len(results),
              "migration fallback counted or every burst request "
              "completed through a surviving path")
        check("tpu_router_migrated" in names,
              "successful migration journaled")
        opened = [e for e in rt.recorder.events(
            name="tpu_breaker_transition")
            if e["attrs"].get("op")
            == "router.replica.disagg-prefill"
            and e["attrs"].get("to") == "open"]
        stale = [e for e in rt.recorder.events(
            name="tpu_router_replica_evicted")
            if e["attrs"].get("replica") == "disagg-prefill"]
        check(bool(opened or stale),
              "victim breaker opened (or the stale replica was "
              "evicted) in the journal")
        healthy = {lab.get("replica"): v
                   for n, lab, v in obs.parse_exposition(text)
                   if n == "tpu_router_replica_healthy"}
        check(healthy.get("disagg-decode") == 1,
              "tpu_router_replica_healthy{disagg-decode} = 1")
        check(healthy.get("disagg-prefill", 0) == 0,
              "tpu_router_replica_healthy{disagg-prefill} = 0 "
              "after the kill")
        check(migrated_post and migrated_post[0] >= 1,
              "migration ledger intact after the kill")
        statz = survivor.statz()
        check(statz["role"] == "decode",
              "survivor /statz advertises role=decode")
    finally:
        survivor.stop()
        rt.stop()
        _reap(victim)


def episode_trace_replay_kill(seed, device=None):
    """Episode 13: the goodput gate's exact shape, library-driven — a
    seeded production trace (bursty MMPP arrivals, Zipf prefixes, both
    SLO classes) replayed open-loop through the router against two
    real replica subprocesses, with one replica SIGKILLed mid-burst.
    The replay report must carry the whole chaos story on the router's
    own journal/metric surfaces (breaker opened OR failover counted,
    TTL eviction journaled, recovery probes green) AND the client-side
    join: per-class attainment stays above the floor and recovers in
    the post-kill window."""
    from ..workloads import replay
    from ..workloads.trafficgen import TraceConfig, generate

    cfg = TraceConfig(
        n_requests=48, base_rate_rps=8.0, burst_rate_rps=40.0,
        p_enter_burst=0.05, p_exit_burst=0.1, prefix_chunk=16,
        n_prefixes=4, max_prefix_chunks=2, prompt_median=24.0,
        prompt_max=48, output_median=24.0, output_max=64,
        vocab=256, unary_frac=0.25, slow_reader_frac=0.0,
        abandon_frac=0.0)
    requests = generate(cfg, seed)
    # kill mid-trace: a third of the arrivals in, burst or not — the
    # tail must outlive the settle window so recovery is measurable
    kill_ms = requests[len(requests) // 3].t_ms
    policies = obs.default_slo_policies()
    metrics = replay.ReplayMetrics(obs.Registry(), policies)
    args = argparse.Namespace(
        replicas=2, config="tiny", slots=2, max_len=512,
        max_new_tokens=128, prefix_chunk=16, seed=seed,
        kill_replica_at_ms=kill_ms, slo=None, time_scale=1.0,
        late_ms=100.0, timeout_s=120.0, top_missed=3, device=device)
    report = replay.run_fleet(args, requests, policies, metrics,
                              trace_header={"seed": seed})

    chaos = report["chaos"]
    check(chaos["killed_replica"] == "replay-1",
          "report names the SIGKILLed replica")
    check(chaos["breaker_opened"] or chaos["failovers"] > 0,
          "router journaled the death: breaker opened or a request "
          "failed over off the corpse")
    check(chaos["replica_evicted"],
          "statz sweep evicted the silent replica "
          "(tpu_router_replica_evicted journaled)")
    check(chaos["recovery_probes_ok"] == chaos["recovery_probes"],
          "post-trace probes all served by the survivor")
    for cls in ("interactive", "batch"):
        info = report["classes"][cls]
        check(info["eligible"] > 0,
              f"{cls}: trace landed eligible requests")
        check(info["attainment"] >= 0.5,
              f"{cls}: goodput floor held through the kill "
              f"(attainment {info['attainment']})")
        post = chaos["attainment_windows"][cls]["post_kill"]
        check(post is None or post >= 0.5,
              f"{cls}: post-kill attainment recovered ({post})")
    # the replay's own obs families carried the joined accounting
    total = sum(_samples(metrics.registry.render(),
                         "tpu_replay_requests_total"))
    check(total == len(requests),
          "tpu_replay_requests_total accounts every trace request")


def _fleet_args(tmp, seed, device, name, **kw):
    workdir = os.path.join(tmp, f"fleet-{name}-{seed}")
    os.makedirs(workdir, exist_ok=True)
    base = dict(
        mode="episode", seed=seed, max_replicas=2,
        high_watermark=1.0, low_watermark=0.25,
        up_stable_s=0.5, down_stable_s=2.0, cooldown_s=2.0,
        drain_timeout_s=20.0, kill_at_ms=None, degrade_at_ms=None,
        capacity_spec="", workdir=workdir, time_scale=1.0,
        late_ms=100.0, timeout_s=120.0, top_missed=3,
        report=None, metrics_out=None, assert_goodput=None,
        assert_fleet=False, fault_spec=None,
        config="tiny", slots=2, max_len=512, max_new_tokens=128,
        prefix_chunk=16, slo=None, compile_cache_dir=None,
        device=device)
    base.update(kw)
    return argparse.Namespace(**base)


def episode_fleet_degraded_drain(tmp, seed, device=None):
    """Episode 14: degraded-slice drain under load.  The fleet
    reconciler (workloads/fleet.py) runs its full gate episode with the
    SIGKILL arm disabled and the degraded-reshape arm live: mid-peak,
    the capacity file's slice generation bumps with ``degraded: true``
    while the open-loop ramp is still streaming.  The controller must
    execute a rolling drain (router ``POST /drain`` first — no new
    streams, in-flight finishes), stop the stale replica, and respawn
    on the NEW generation, all without a single malformed client
    frame.  Evidence is the episode report (journal + tpu_fleet_*
    metrics), not logs."""
    from ..workloads import fleet

    # a shorter ramp than the fleet gate's: this episode proves the
    # drain choreography under load, not the scaling curve
    args = _fleet_args(tmp, seed, device, "ep14",
                       calm_requests=8, peak_requests=28,
                       tail_requests=6, calm_rate=2.0, peak_rate=8.0,
                       no_kill=True, no_degrade=False, settle_s=20.0)
    report, _ = fleet.run_episode(args)

    f, c = report["fleet"], report["chaos"]
    check(f["degraded_drained"],
          "generation bump drained the stale replica "
          "(tpu_fleet_scale_events_total{direction=down,"
          "reason=degraded})")
    check(f["respawned_on_new_generation"],
          "drain was followed by a respawn placed on generation 2")
    check(f["replicas_stopped"] >= 1,
          "the drained replica was actually stopped "
          "(tpu_fleet_replica_stopped journaled)")
    check(c["frame_errors"] == 0,
          f"zero malformed client frames through the drain "
          f"(got {c['frame_errors']})")
    check(f["final_replicas"] >= 1,
          "fleet settled at/above the floor after the reshape")
    for cls in ("interactive", "batch"):
        info = report["classes"][cls]
        check(info["eligible"] > 0,
              f"{cls}: ramp landed eligible requests")
        check(info["attainment"] >= 0.5,
              f"{cls}: goodput floor held through the rolling drain "
              f"(attainment {info['attainment']})")


def episode_fleet_burn_alert(tmp, seed, device=None):
    """Episode 15: burn-rate page alert through a replica SIGKILL.  The
    fleet episode runs with the kill arm live: mid-burst a replica
    dies, the survivor drowns, the per-class SLO burn gauges the
    replicas publish through /statz roll up into the router's
    ``tpu_router_fleet_burn_rate`` — and the router's multi-window
    multi-burn-rate evaluator must page.  The reconciler replaces the
    dead replica (reason=failure, or reason=alert if the page verdict
    lands first), and once the fleet recovers and the shrunk windows
    drain, the page alert must traverse to ``resolved``.  Every
    asserted fact comes from the episode report: the journaled
    ``tpu_alert_transition`` state machine and the ``tpu_fleet_*``
    spawn evidence — never logs."""
    from ..workloads import fleet

    args = _fleet_args(
        tmp, seed, device, "ep15",
        # the fleet gate's ramp: big enough that pressure reliably
        # scales the fleet to 2 BEFORE the kill hook's routable-fleet
        # gate releases the SIGKILL (ep14's short drain ramp never
        # crosses the watermark, so the kill would time out unarmed)
        calm_requests=16, peak_requests=72, tail_requests=20,
        calm_rate=2.0, peak_rate=10.0,
        no_kill=False, no_degrade=True, settle_s=30.0,
        # a TTFT budget the fleet meets at calm but cannot meet while
        # a kill leaves the survivor queueing the whole burst — the
        # collapse that must drive the burn gauge past 14.4x
        slo=["interactive=1200", "batch=0:20000"],
        # canonical 5m/1h/6h burn windows scaled to 0.6s/7.2s/43.2s
        # and a 0.25s evaluation tick, so the page rule can observe
        # the distress AND resolve inside the episode's wall clock
        alert_interval=0.25, alert_window_scale=0.002,
        # replicas keep only a 3s rolling SLO window: once the burst
        # drains, their burn gauges fall back to zero fast enough for
        # the firing -> resolved transition to land before harvest
        server_extra_args=("--slo-window", "3"),
        settle_on_alerts=True)
    report, _ = fleet.run_episode(args)

    f, c = report["fleet"], report["chaos"]
    check(c["killed_replica"],
          "chaos arm SIGKILLed a managed replica mid-burst")
    transitions = f["alert_transitions"]
    paged = sorted({t["alert"] for t in transitions
                    if t["severity"] == "page"
                    and t["to"] == "firing"})
    check(paged,
          "a page-severity burn-rate alert reached firing "
          "(tpu_alert_transition journal)")
    # the full state machine for one paging rule, in order: the dwell
    # (inactive->pending), the page (pending->firing), the recovery
    # (firing->resolved) — all journaled by the router's evaluator
    path = [(t["from"], t["to"]) for t in transitions
            if t["alert"] == paged[0]]
    want = [("inactive", "pending"), ("pending", "firing"),
            ("firing", "resolved")]
    it = iter(path)
    check(all(step in it for step in want),
          f"{paged[0]} traversed "
          f"inactive->pending->firing->resolved (got {path})")
    check(f["replaced_after_kill"] or f["alert_scale_up_events"] >= 1,
          "reconciler replaced the dead replica (reason=failure) or "
          "scaled on the page verdict (reason=alert)")
    check(f["final_replicas"] >= 1,
          "fleet settled at/above the floor after recovery")


def episode_fleet_incident_bundle(seed, device=None):
    """Episode 16: SIGKILL a replica mid-burst; the page that follows
    must make the router's flight data recorder write ONE fleet
    incident bundle — with the DEAD replica's fragment degraded to its
    ``{"unreachable": true}`` marker (the bundle fan-out must not wedge
    on a corpse), the survivor's fragment real, and the incident
    subscriber still alive afterwards (``/alerts`` answers, traffic
    still proxies 200)."""
    from ..workloads.router import RouterServer

    incident_dir = tempfile.mkdtemp(prefix=f"tpu-chaos-ep16-{seed}-")
    # class 'bad' can never meet its 1ms deadline: once the post-kill
    # traffic lands on the survivor the fleet burn gauge pages
    policies = {
        "bad": obs.SLOPolicy("bad", deadline_ms=1.0),
        "good": obs.SLOPolicy("good", deadline_ms=60000.0),
    }
    # replica_ttl 30s: the victim's row must STILL be in the table
    # when the bundle fans out, so the fragment fetch proves the
    # unreachable-marker path rather than skipping the dead replica
    rt = RouterServer(statz_interval_s=0.25, replica_ttl_s=30.0,
                      breaker_reset_s=0.5, seed=seed,
                      slo_policies=policies,
                      alert_interval_s=0.25,
                      alert_window_scale=0.0005,
                      incident_dir=incident_dir)
    rt.start(host="127.0.0.1", port=0)

    # survivor: in-process tiny engine registered as replica-a, with
    # the SLO accountant live so its /statz publishes the burn the
    # router rolls up into tpu_router_fleet_burn_rate
    model = tiny_model(device, 256)
    survivor = _server(model, device, dict(n_slots=2),
                       max_new_tokens=200, window=4,
                       slo_policies=policies, slo_window_s=30.0)
    survivor.start(host="127.0.0.1", port=0)
    survivor.start_registration(
        f"http://127.0.0.1:{rt.port}", replica_id="replica-a",
        model="chaos-tiny", interval_s=0.3)

    # victim: a REAL replica subprocess; max_len 2048 so the burst
    # stream still has seconds of decode left when the SIGKILL lands
    victim_port = loadclient.free_port()
    victim = _victim(device, victim_port, "replica-b",
                     "--n-slots", "2", "--max-len", "2048",
                     "--max-new-tokens", "2000", "--window", "4",
                     "--register-with", f"http://127.0.0.1:{rt.port}",
                     "--replica-id", "replica-b",
                     "--register-interval", "0.3")

    try:
        loadclient.wait_http_ok(victim_port, "/healthz", 600,
                                procs=[victim])
        loadclient.wait_http_ok(rt.port, "/replicas", 30, _routable(2))
        check(True, "router sees both replicas healthy")

        def post(body):
            req = urllib.request.Request(
                f"http://127.0.0.1:{rt.port}/generate",
                data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as resp:
                return resp.status, resp.read()

        # one long stream pinned to the victim via the affinity ring,
        # so the SIGKILL lands mid-burst, not on an idle replica
        p_victim = _prompt_for(rt, random.Random(seed), "replica-b")
        streaming = threading.Event()

        def burst():
            conn = http.client.HTTPConnection("127.0.0.1", rt.port,
                                              timeout=120)
            try:
                conn.request("POST", "/generate", json.dumps(
                    {"tokens": p_victim, "max_new_tokens": 1500,
                     "ignore_eos": True, "slo_class": "good"}),
                    {"Content-Type": "application/json"})
                resp = conn.getresponse()
                for line in resp:
                    if line.strip():
                        streaming.set()
            # tpulint: disable=R2 -- the SIGKILL is SUPPOSED to abort this stream mid-chunk; the episode's assertions live in the incident bundle, not in this thread's outcome
            except Exception:
                pass
            finally:
                conn.close()

        t = threading.Thread(target=burst, daemon=True)
        t.start()
        check(streaming.wait(60.0),
              "victim-pinned stream is live before the kill")
        victim.kill()
        victim.wait()
        t.join(timeout=30.0)
        check(not t.is_alive(), "aborted stream drained, not hung")

        # goodput collapse on the survivor: every 'bad' request fails
        # over to replica-a and misses its 1ms deadline
        for _ in range(4):
            st, _ = post({"tokens": [1, 2, 3], "max_new_tokens": 4,
                          "slo_class": "bad"})
            check(st == 200,
                  f"post-kill 'bad' request failed over 200 (got {st})")

        # the fleet bundle materializes (page -> subscriber -> write)
        deadline = time.time() + 45.0
        bundles = []
        while time.time() < deadline and not bundles:
            bundles = [p for p in os.listdir(incident_dir)
                       if p.startswith(obs.BUNDLE_PREFIX)]
            time.sleep(0.2)
        check(len(bundles) == 1,
              f"exactly one fleet incident bundle (got {bundles}, "
              f"dir {os.listdir(incident_dir)})")
        bundle = obs.read_bundle(os.path.join(incident_dir, bundles[0]))
        meta = bundle["meta"]
        check(meta["severity"] == "page"
              and meta["alert"].startswith("slo_burn_page"),
              f"bundle is for the page ({meta['alert']}, "
              f"{meta['severity']})")
        dead = bundle.get("replicas/replica-b/statz.json")
        check(isinstance(dead, dict) and dead.get("unreachable") is True,
              f"dead replica's fragment degraded to the unreachable "
              f"marker (got {dead!r})")
        live = bundle.get("replicas/replica-a/statz.json")
        check(isinstance(live, dict) and "unreachable" not in live,
              "survivor's statz fragment is real")
        check(any("burn_rate" in s["name"] and s["points"]
                  for s in bundle["tsdb.json"]["series"]),
              "bundle's TSDB snapshot retained the burn series")

        # the subscriber is NOT wedged: the evaluator still serves
        # /alerts, the worker thread survives, traffic still proxies
        with urllib.request.urlopen(
                f"http://127.0.0.1:{rt.port}/alerts",
                timeout=30) as resp:
            status = json.loads(resp.read().decode())
        check(any(a["name"] == meta["alert"] and a["state"] == "firing"
                  for a in status["alerts"]),
              "router /alerts still answering after the bundle")
        incidents = rt._incidents
        check(incidents is not None and incidents._worker is not None
              and incidents._worker.is_alive(),
              "incident worker thread alive after the bundle")
        st, _ = post({"tokens": [5, 6, 7], "max_new_tokens": 4,
                      "slo_class": "good"})
        check(st == 200, f"router still proxying 200 (got {st})")
    finally:
        _reap(victim)
        survivor.stop()
        rt.stop()
        shutil.rmtree(incident_dir, ignore_errors=True)


def _reshape_slice(tmp, testdata, seed, suffix, grace, hb_timeout):
    """A dedicated 2-host slice with live staleness + reshape grace (the
    main soak coordinator drives heartbeats manually with no timeout, so
    eviction-by-silence needs its own)."""
    registry = obs.Registry()
    recorder = obs.FlightRecorder(registry=registry)
    coordinator = SliceCoordinator(
        expected_workers=2,
        bind_address="127.0.0.1:0",
        master_port=constants.SLICE_MASTER_PORT,
        state_path=os.path.join(tmp, f"coordinator-{suffix}.json"),
        heartbeat_timeout_s=hb_timeout,
        reshape_grace_s=grace,
        registry=registry,
        recorder=recorder,
    ).start()
    rendezvous = f"127.0.0.1:{coordinator.port}"
    hosts = [ChaosHost(f"host-{suffix}{i}", i, testdata, tmp, rendezvous,
                       seed) for i in range(2)]
    _form(hosts)
    for h in hosts:
        h.open_stream()
        h.pulse()
        h.wait_frame(all_healthy)
    return coordinator, recorder, registry, hosts


def _form(hosts):
    """Join every host to the slice, then start each manager and wait
    for its kubelet registration."""
    with concurrent.futures.ThreadPoolExecutor(len(hosts)) as pool:
        for f in [pool.submit(h.client.join, 20.0) for h in hosts]:
            f.result(timeout=30.0)
    for h in hosts:
        h.manager.run(block=False)
        check(h.kubelet.wait_for_registration(timeout=10.0),
              f"{h.name} registered with its kubelet")


def episode_session_spill_crash_resume(seed, device=None, config="tiny",
                                       max_len=256):
    """Episode 17: session KV tiering through a replica SIGKILL.  A
    conversation idles down the full tier chain (device park -> host
    checkpoint -> crash-safe .kvs spill file) on a REAL replica
    subprocess, the replica is SIGKILLed with the session spilled, and
    the respawned generation — same CLI, same --session-dir — serves
    the returning session's next turn BYTE-IDENTICALLY to an
    uninterrupted control replica that kept the conversation
    device-parked the whole time.  An in-process probe replica runs
    the same chain with its flight recorder visible, proving every
    transition journaled (tpu_kv_park / demote / spill / promote);
    the subprocess legs are proven on their /statz + /metrics
    surfaces (tpu_kv_tier_demotions_total{tier=disk} before the kill,
    tpu_kv_tier_{hits,promotions}_total{tier=disk} after respawn).
    *config* and *max_len* are the model every replica serves."""
    from ..workloads.bench_serving import build_model_and_params

    tmp = tempfile.mkdtemp(prefix="chaos-kv-tier-")
    cfg, model = build_model_and_params(config, max_len, device)
    eos = getattr(cfg, "eos_id", None)

    def mk_server(sub, idle_s, host_idle_s):
        return _server(model, device,
                       dict(n_slots=4, eos_id=eos, kv_paging=True),
                       max_new_tokens=64, window=4,
                       session_tier=True,
                       session_dir=os.path.join(tmp, sub),
                       session_idle_s=idle_s,
                       session_host_idle_s=host_idle_s,
                       session_seed=seed)

    # control: generous timers — the conversation never leaves the
    # device tier, so its turn 2 is the uninterrupted oracle
    control = mk_server("ctrl", 3600.0, 3600.0)
    control.start(host="127.0.0.1", port=0)
    # probe: soak-speed timers + a visible flight recorder
    probe = mk_server("probe", 0.3, 0.3)
    probe.start(host="127.0.0.1", port=0)

    # victim: a REAL replica subprocess (the CLI a pod runs) — the
    # SIGKILL is a kill, and only the .kvs files survive it
    victim_port = loadclient.free_port()
    victim_dir = os.path.join(tmp, "victim")

    def spawn_victim():
        cmd = loadclient.server_cmd(
            device, "--config", config, "--n-slots", "4",
            "--max-len", str(max_len), "--max-new-tokens", "64",
            "--window", "4", "--kv-paging",
            "--session-tier", "--session-dir", victim_dir,
            "--session-idle", "0.3", "--session-host-idle", "0.3",
            "--session-seed", str(seed),
            "--host", "127.0.0.1", "--port", str(victim_port))
        return loadclient.spawn_replica(cmd, "kv-victim", env=spawn_env())

    victim = spawn_victim()
    respawn = None

    p1 = [(i * 7) % 255 + 1 for i in range(24)]
    p2 = [9, 8, 7]
    sid = "soak-conv"

    def gen(port, tokens, session=None):
        payload = {"tokens": list(tokens), "max_new_tokens": 12,
                   "stream": False, "ignore_eos": True}
        if session is not None:
            payload["session_id"] = session
        status, body = _post(port, payload)
        return status, json.loads(body).get("tokens")

    def statz(port):
        return json.loads(_get(port, "/statz")[1])

    def tier_metrics(port):
        return _get(port, "/metrics")[1].decode()

    try:
        # -- uninterrupted control conversation ------------------------
        st, out1 = gen(control.port, p1, sid)
        check(st == 200 and out1, "control turn 1 answered 200")
        chain = p1 + out1 + p2
        st, want = gen(control.port, chain, sid)
        check(st == 200 and want, "control turn 2 answered 200")
        check(statz(control.port)["kv_tiers"]["hits"]["device"] >= 1,
              "control turn 2 was a device-tier warm hit")
        check(bool(control.recorder.events(name="tpu_kv_park")),
              "session park journaled on the control replica")

        # -- journal probe: the full tier chain in one process ---------
        st, out1p = gen(probe.port, p1, sid)
        check(st == 200 and out1p == out1,
              "probe turn 1 matches control bit-for-bit")
        deadline = time.monotonic() + 30.0
        while (time.monotonic() < deadline
               and statz(probe.port)["kv_tiers"]["disk"] < 1):
            time.sleep(0.1)
        check(statz(probe.port)["kv_tiers"]["disk"] >= 1,
              "probe session idled down to the disk tier")
        for name in ("tpu_kv_park", "tpu_kv_demote", "tpu_kv_spill"):
            check(bool(probe.recorder.events(name=name)),
                  f"{name} journaled on the probe replica")
        st, got = gen(probe.port, chain, sid)
        check(st == 200 and got == want,
              "probe disk-tier resume byte-identical to the "
              "uninterrupted control")
        promoted = [e for e in probe.recorder.events(
            name="tpu_kv_promote")
            if e["attrs"].get("tier") == "disk"
            and e["attrs"].get("outcome") == "ok"]
        check(bool(promoted), "disk promotion journaled on the probe")

        # -- victim: spill, SIGKILL, respawn from the same dir ---------
        loadclient.wait_http_ok(victim_port, "/healthz", 600,
                                procs=[victim])
        st, out1v = gen(victim_port, p1, sid)
        check(st == 200 and out1v == out1,
              "victim turn 1 matches control (deterministic params "
              "across processes)")
        loadclient.wait_http_ok(victim_port, "/statz", 60,
                                lambda b: b["kv_tiers"]["disk"] >= 1)
        demoted = _samples(tier_metrics(victim_port),
                           "tpu_kv_tier_demotions_total", tier="disk")
        check(bool(demoted) and sum(demoted) >= 1,
              "tpu_kv_tier_demotions_total{tier=disk} counted on the "
              "victim before the kill")
        victim.kill()          # SIGKILL: no drain, no spill_all
        victim.wait(timeout=30)
        spills = [f for f in os.listdir(victim_dir)
                  if f.endswith(".kvs")]
        check(bool(spills), "spill file survived the SIGKILL")

        respawn = spawn_victim()
        loadclient.wait_http_ok(victim_port, "/healthz", 600,
                                procs=[respawn])
        check(statz(victim_port)["kv_tiers"]["disk"] >= 1,
              "respawned generation inherited the spilled session "
              "from the filenames alone")
        st, got = gen(victim_port, chain, sid)
        check(st == 200, "post-crash turn 2 answered 200")
        check(got == want,
              "post-crash resume byte-identical to uninterrupted "
              "serving")
        text = tier_metrics(victim_port)
        hits = _samples(text, "tpu_kv_tier_hits_total", tier="disk")
        check(bool(hits) and sum(hits) >= 1,
              "tpu_kv_tier_hits_total{tier=disk} counted after "
              "respawn")
        promos = _samples(text, "tpu_kv_tier_promotions_total",
                          tier="disk", outcome="ok")
        check(bool(promos) and sum(promos) >= 1,
              "tpu_kv_tier_promotions_total{tier=disk,outcome=ok} "
              "counted after respawn")
    finally:
        control.stop()
        probe.stop()
        for proc in (victim, respawn):
            if proc is not None:
                _reap(proc)
        shutil.rmtree(tmp, ignore_errors=True)


def episode_member_loss_reshape(testdata, tmp, seed):
    """(7) Member loss mid-traffic: staleness demotes the slice
    (demote-all while the member might return), the grace window
    expires, the survivor re-forms into a smaller degraded generation
    and serves Healthy at the reduced shape — within one staleness
    timeout + one grace window + a couple of pulses, journal-proven."""
    hb_timeout, grace = 0.4, 0.6
    coordinator, recorder, registry, hosts = _reshape_slice(
        tmp, testdata, seed, "r", grace, hb_timeout)
    survivor, victim = hosts
    try:
        gen1 = survivor.client.membership
        check(gen1 is not None and gen1.num_workers == 2
              and not gen1.degraded,
              "2-host slice formed whole before the loss")
        t_kill = time.monotonic()
        victim.stop()           # the member dies mid-traffic
        # the survivor's own pulses must first deliver the demote-all
        # verdict (the member might still return), then — at grace
        # expiry — the reshaped generation
        survivor.pulse()
        deadline = time.time() + hb_timeout + grace + 8.0
        while time.time() < deadline:
            survivor.pulse()
            m = survivor.client.membership
            if m is not None and m.generation > gen1.generation:
                break
            time.sleep(0.05)
        adopted_after = time.monotonic() - t_kill
        m = survivor.client.membership
        check(m is not None and m.generation == gen1.generation + 1,
              "survivor adopted the next generation "
              f"({adopted_after:.1f}s after the kill)")
        check(m.hostnames == (survivor.name,),
              "reshaped membership is the survivor alone (rank 0)")
        check(m.reshaped_from == (gen1.slice_id,),
              "lineage carries the original slice id")
        check(m.degraded, "reshaped membership marked degraded")
        check(adopted_after <= hb_timeout + grace + 3.0,
              "reshape landed within one staleness timeout + one grace "
              f"window + pulse slack ({adopted_after:.1f}s)")
        # journal evidence on both sides
        reshaped = recorder.events(name="tpu_slice_reshaped")
        check(reshaped and reshaped[-1]["attrs"]["generation"]
              == m.generation,
              "coordinator journaled tpu_slice_reshaped for gen "
              f"{m.generation}")
        check(reshaped[-1]["attrs"]["degraded"] is True,
              "journal marks the reshaped generation degraded")
        adoptions = [e for e in survivor.journal(
            "tpu_slice_membership_adopted")
            if e["attrs"].get("generation") == m.generation]
        check(adoptions, "survivor journaled the gen-2 adoption")
        text = registry.render()
        reshapes = _samples(text, "tpu_slice_reshape_total",
                            outcome="reshaped")
        check(reshapes and reshapes[0] >= 1,
              "tpu_slice_reshape_total{outcome=reshaped} counted")
        secs = [v for n, lab, v in obs.parse_exposition(text)
                if n == "tpu_slice_reshape_seconds_count" and not lab]
        check(secs and secs[0] >= 1,
              "tpu_slice_reshape_seconds observed the window")
        # the survivor must SERVE at the reduced shape: devices Healthy
        # and the Allocate contract re-emitted for 1 worker
        frame = survivor.wait_frame(all_healthy)
        check(len(frame.devices) == 8,
              "survivor re-advertises all 8 local devices Healthy at "
              "the reduced shape")
        stub = survivor.kubelet.plugin_stub(RESOURCE)
        resp = stub.Allocate(pluginapi.AllocateRequest(
            container_requests=[pluginapi.ContainerAllocateRequest(
                devices_ids=[d.ID for d in frame.devices])]))
        env = dict(resp.container_responses[0].envs)
        check(env.get(constants.ENV_RANK) == "0"
              and env.get(constants.ENV_SLICE_WORKER_HOSTNAMES)
              == survivor.name
              and env.get(constants.ENV_WORLD_SIZE) == "1"
              and env.get(constants.ENV_MASTER_PORT)
              == str(constants.SLICE_MASTER_PORT)
              and env.get(constants.ENV_TPU_SLICE_GENERATION)
              == str(m.generation),
              "survivor serves the re-emitted torch.distributed "
              "contract at the reduced shape")
    finally:
        survivor.stop()
        coordinator.stop()


def episode_member_flap_no_reshape(testdata, tmp, seed):
    """(8) The member goes silent past the staleness timeout (verdict
    demotes, reshape window opens) but flaps BACK inside the grace
    window: no reshape — the original generation holds bit-for-bit."""
    # grace must comfortably exceed the bounded demote-frame wait below
    # plus pulse slack on a loaded CI box: the point of this episode is
    # the member returning INSIDE the window
    hb_timeout, grace = 0.4, 10.0
    coordinator, recorder, registry, hosts = _reshape_slice(
        tmp, testdata, seed, "f", grace, hb_timeout)
    a, b = hosts
    try:
        gen1 = a.client.membership
        # b goes silent past the staleness timeout; a's pulse trips it
        time.sleep(hb_timeout * 2)
        a.pulse()
        overlay = a.client.health_overlay()
        check(overlay is not None and not overlay[0],
              "verdict demoted while the member is silent (demote-all "
              "inside the grace window)")
        a.wait_frame(all_unhealthy, pulses=5, timeout_s=3.0)
        check(True, "survivor demoted all devices during the window")
        # the member flaps back BEFORE the grace expires
        b.pulse()
        a.pulse()
        for h in (a, b):
            h.wait_frame(all_healthy)
        m = a.client.membership
        check(m == gen1,
              "original generation holds bit-for-bit after the flap "
              f"(gen {m.generation}, {len(m.hostnames)} workers)")
        check(not recorder.events(name="tpu_slice_reshaped"),
              "no reshape journaled for an in-grace flap")
        text = registry.render()
        cancelled = _samples(text, "tpu_slice_reshape_total",
                             outcome="cancelled")
        check(cancelled and cancelled[0] >= 1,
              "tpu_slice_reshape_total{outcome=cancelled} counted")
        check(not _samples(text, "tpu_slice_reshape_total",
                           outcome="reshaped"),
              "no reshape outcome counted")
    finally:
        for h in hosts:
            h.stop()
        coordinator.stop()


# -- the sweep ----------------------------------------------------------------

EPISODE_TITLES = {
    1: "kubelet register drop",
    2: "slice join error",
    3: "slice heartbeat loss",
    4: "probe hang",
    5: "serving scheduler crash",
    6: "scheduler hang mid-interleave",
    7: "member loss -> reshape",
    8: "member flap inside the grace window",
    9: "tenant burst under KV page pressure",
    10: "replica kill under burst through the router",
    11: "scheduler killed mid-packed-prefill",
    12: "prefill replica killed mid-migration",
    13: "seeded trace replayed through a kill",
    14: "degraded-slice drain under load",
    15: "burn-rate page alert through a replica kill",
    16: "SIGKILL mid-burst writes the fleet incident bundle",
    17: "session spill survives a replica SIGKILL",
}
AGENT_EPISODES = (1, 2, 3, 4, 7, 8)
SERVING_EPISODES = (5, 6, 9, 10, 11, 12, 13, 14, 15, 16, 17)


class Soak:
    """The main slice (coordinator + hosts a and b) and the episodes by
    number, for the sweep and for tests that run some of them."""

    def __init__(self, seed, testdata, device=None):
        self.seed = seed
        self.testdata = testdata
        self.device = device
        self.tmp = tempfile.mkdtemp(prefix="chaos-soak-")
        self.coordinator = None
        self.hosts = []

    def form(self):
        """Form the main 2-host slice, pulses driven by hand."""
        self.coordinator = SliceCoordinator(
            expected_workers=2,
            bind_address="127.0.0.1:0",
            master_port=constants.SLICE_MASTER_PORT,
            state_path=os.path.join(self.tmp,
                                    "coordinator-membership.json"),
            heartbeat_timeout_s=0.0,    # pulses are driven explicitly
        ).start()
        rendezvous = f"127.0.0.1:{self.coordinator.port}"
        self.hosts = [ChaosHost(name, i, self.testdata, self.tmp,
                                rendezvous, self.seed)
                      for i, name in enumerate(("host-a", "host-b"))]
        _form(self.hosts)
        for h in self.hosts:
            frame = h.open_stream()
            check(len(frame.devices) == 8,
                  f"{h.name} advertises 8 devices")
        for h in self.hosts:
            h.pulse()
        for h in self.hosts:
            h.wait_frame(all_healthy)
        return self

    def run(self, n):
        """Episode *n* (1-17)."""
        s, d, hosts = self.seed, self.device, self.hosts
        episodes = {
            1: lambda: episode_register_drop(hosts, s),
            2: lambda: episode_join_error(hosts, self.coordinator,
                                          self.tmp, s),
            3: lambda: episode_heartbeat_loss(hosts, s),
            4: lambda: episode_probe_hang(hosts, s),
            5: lambda: episode_scheduler_crash(s, d),
            6: lambda: episode_scheduler_hang(s, d),
            7: lambda: episode_member_loss_reshape(self.testdata,
                                                   self.tmp, s),
            8: lambda: episode_member_flap_no_reshape(self.testdata,
                                                      self.tmp, s),
            9: lambda: episode_tenant_burst_page_pressure(s, d),
            10: lambda: episode_router_replica_kill(s, d),
            11: lambda: episode_packed_prefill_kill(s, d),
            12: lambda: episode_prefill_kill_mid_migration(s, d),
            13: lambda: episode_trace_replay_kill(s, d),
            14: lambda: episode_fleet_degraded_drain(self.tmp, s, d),
            15: lambda: episode_fleet_burn_alert(self.tmp, s, d),
            16: lambda: episode_fleet_incident_bundle(s, d),
            17: lambda: episode_session_spill_crash_resume(s, d),
        }
        log.info("=== episode %d: %s ===", n, EPISODE_TITLES[n])
        episodes[n]()

    def final_sweep(self):
        """Every device Healthy, the slice formed with stable ranks, and
        the journal holding the resilience layer's transitions."""
        for h in self.hosts:
            h.pulse()
        for h in self.hosts:
            h.wait_frame(all_healthy)
        m = self.hosts[0].client.membership
        check(m is not None and m.hostnames == ("host-a", "host-b"),
              "slice still formed with stable ranks")
        transitions = (self.hosts[0].journal("tpu_breaker_transition")
                       + self.hosts[0].journal("tpu_watchdog_trip"))
        check(transitions,
              "flight recorder journaled breaker/watchdog transitions")

    def close(self):
        faults.uninstall()
        for h in self.hosts:
            h.stop()
        if self.coordinator is not None:
            self.coordinator.stop()
        shutil.rmtree(self.tmp, ignore_errors=True)




def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="chaos-soak")
    p.add_argument("--seed", type=int,
                   default=int(os.environ.get("ENGINE_FUZZ_SEED", "0")
                               or 0),
                   help="fault + jitter RNG seed (ENGINE_FUZZ_SEED "
                        "env honored)")
    p.add_argument("--testdata",
                   default=os.path.join(ROOT, "testdata"))
    p.add_argument("--skip-serving", action="store_true",
                   help="skip the serving episodes (no torch needed)")
    p.add_argument("--device", default=None,
                   help="torch device of the serving episodes (default: "
                        "cuda, required; pass cpu to serve on the CPU)")
    p.add_argument("-v", "--verbose", action="store_true")
    args = p.parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(levelname).1s %(name)s: %(message)s")
    log.info("chaos soak, seed=%d", args.seed)
    if not args.skip_serving:
        # before any episode: no CUDA and no --device is an error here,
        # not a sweep that falls back to the CPU
        from ..workloads.transformer import resolve_device

        resolve_device(args.device)
    manager_mod._REGISTER_RETRY_DELAY_S = 0.05  # soak-speed retries

    soak = Soak(args.seed, args.testdata, args.device)
    try:
        soak.form()
        for n in sorted(EPISODE_TITLES):
            if args.skip_serving and n in SERVING_EPISODES:
                continue
            soak.run(n)
        soak.final_sweep()
        log.info("CHAOS SOAK PASS (seed=%d)", args.seed)
        return 0
    finally:
        soak.close()


if __name__ == "__main__":
    sys.exit(main())
