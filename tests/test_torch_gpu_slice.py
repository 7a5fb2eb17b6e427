"""The port's multi-host slice coordination held to the reference's.

- **State machine**: the reference's own fuzz and reshape sequences
  (``test_slice_fuzz``, ``test_slice_reshape``, ``test_slice``'s state
  tests) run with the port's ``SliceState`` in place of the reference's,
  and a differential fuzz drives both machines in lockstep through one
  random event sequence, comparing every answer and membership file.
- **Wire**: a port client joins a reference coordinator and a reference
  client a port coordinator; membership files load across packages.
- **Two hosts**: two port plugin managers on copies of the 8-GPU fixture
  form a slice over real gRPC, hand out a consistent ``torch.distributed``
  env, propagate a fault slice-wide and back, and survive coordinator
  and worker restarts.
- **Env map and labels**: each key of the reference's ``slice_env`` has
  its counterpart with the same values, and the slice labels equal the
  reference's on the same membership file.
"""

import concurrent.futures
import dataclasses
import inspect
import json
import os
import random
import shutil
import threading
import time

import pytest

import test_slice
import test_slice_fuzz
import test_slice_reshape
from fake_kubelet import FakeKubelet, ListAndWatchConsumer
from tpu_k8s_device_plugin.labeller.generators import (
    LabelContext as RefLabelContext,
    generate_labels as ref_generate_labels,
)
from tpu_k8s_device_plugin.slice import (
    SliceClient as RefSliceClient,
    SliceCoordinator as RefSliceCoordinator,
    SliceState as RefSliceState,
    load_membership as ref_load_membership,
    save_membership as ref_save_membership,
)
from tpu_k8s_device_plugin.types import constants as ref_constants
from tpu_k8s_device_plugin_torch import obs
from tpu_k8s_device_plugin_torch.gpu import nvml
from tpu_k8s_device_plugin_torch.gpu.device_impl import GpuContainerImpl
from tpu_k8s_device_plugin_torch.health import probe_gpu_states
from tpu_k8s_device_plugin_torch.labeller import LabelContext, generate_labels
from tpu_k8s_device_plugin_torch.manager import PluginManager
from tpu_k8s_device_plugin_torch.observability import manager_status
from tpu_k8s_device_plugin_torch.proto import deviceplugin_pb2 as pluginapi
from tpu_k8s_device_plugin_torch.slice import (
    Membership,
    SliceClient,
    SliceCoordinator,
    SliceState,
    load_membership,
    save_membership,
)
from tpu_k8s_device_plugin_torch.types import constants
from tpu_k8s_device_plugin_torch.workloads.checkpoint import ReshapeSignal

# one port number for both packages, so their coordinator addresses agree
PORT = 29500


def port_state(*args, jax_port=None, **kwargs):
    """The port's SliceState under the reference's keyword."""
    if jax_port is not None:
        kwargs["master_port"] = jax_port
    return SliceState(*args, **kwargs)


def ref_reads_port_file(path):
    """The reference's reader on a file the port wrote, as the port's
    record (so the reference's assertions compare like with like)."""
    m = ref_load_membership(path)
    return None if m is None else Membership(**dataclasses.asdict(m))


def _use_port(monkeypatch, module):
    monkeypatch.setattr(module, "SliceState", port_state)
    if hasattr(module, "load_membership"):
        monkeypatch.setattr(module, "load_membership", ref_reads_port_file)


# ---------------------------------------------------------------------------
# The state machine
# ---------------------------------------------------------------------------

def _call(fn, tmp_path):
    kwargs = {"tmp_path": tmp_path} if "tmp_path" in \
        inspect.signature(fn).parameters else {}
    fn(**kwargs)


_RESHAPE = sorted(n for n in dir(test_slice_reshape.TestStateMachine)
                  if n.startswith("test_"))
_STATE = ["test_stale_member_drags_slice_unhealthy",
          "test_slice_metrics_move_across_member_death"]


@pytest.mark.parametrize("name", ["test_rendezvous_fuzz",
                                  "test_reshape_determinism_fuzz"])
def test_reference_fuzz_sequences(monkeypatch, tmp_path, name):
    """The reference's fuzz sweeps, their assertions unchanged, on the
    port's machine (the reference's ``load_membership`` reads the port's
    files where they check crash recovery)."""
    _use_port(monkeypatch, test_slice_fuzz)
    _call(getattr(test_slice_fuzz, name), tmp_path)


@pytest.mark.parametrize("name", _RESHAPE)
def test_reference_reshape_sequences(monkeypatch, tmp_path, name):
    _use_port(monkeypatch, test_slice_reshape)
    _call(getattr(test_slice_reshape.TestStateMachine(), name), tmp_path)


@pytest.mark.parametrize("name", _STATE)
def test_reference_state_sequences(monkeypatch, tmp_path, name):
    _use_port(monkeypatch, test_slice)
    _call(getattr(test_slice, name), tmp_path)


def _views_equal(a, b):
    assert a.slice_healthy == b.slice_healthy
    assert a.unhealthy_hostnames == b.unhealthy_hostnames
    _same(a.membership, b.membership)


def _same(mine, theirs):
    if theirs is None:
        assert mine is None
    else:
        assert mine is not None and mine.to_dict() == theirs.to_dict()


@pytest.mark.parametrize("seed", range(4))
def test_lockstep_fuzz_matches_reference(tmp_path, seed):
    """Both machines, one random sequence of joins, leaves, restarts,
    heartbeats, silences, coordinator crashes and reshapes: every join
    result, health view and membership file agrees."""
    rnd = random.Random(seed)
    for round_i in range(12):
        n = rnd.randint(2, 5)
        hosts = [f"host-{i:02d}" for i in range(n)] + ["host-zz"]
        coords = {h: ((rnd.randrange(10),) if rnd.random() < 0.6 else ())
                  for h in hosts}
        kw = dict(heartbeat_timeout_s=rnd.choice([0.0, 4.0]),
                  reshape_grace_s=rnd.choice([0.0, 0.0, 3.0]))
        paths = (str(tmp_path / f"p{seed}-{round_i}.json"),
                 str(tmp_path / f"r{seed}-{round_i}.json"))
        mine = SliceState(n, PORT, paths[0], **kw)
        theirs = RefSliceState(n, PORT, paths[1], **kw)
        now = 0.0
        for _ in range(120):
            now += rnd.choice([0.5, 1.0, 2.5])
            roll = rnd.random()
            h = rnd.choice(hosts)
            if roll < 0.35:
                session = f"{h}-{rnd.randrange(3)}"
                a = mine.join(h, coords[h], 8, session, now)
                b = theirs.join(h, coords[h], 8, session, now)
                assert (a.formed, a.rank, a.joined, a.expected,
                        bool(a.error)) == (b.formed, b.rank, b.joined,
                                           b.expected, bool(b.error))
                _same(a.membership, b.membership)
            elif roll < 0.45:
                mine.leave(h)
                theirs.leave(h)
            elif roll < 0.85:
                healthy = rnd.random() < 0.75
                _views_equal(mine.heartbeat(h, healthy, "", now),
                             theirs.heartbeat(h, healthy, "", now))
            elif roll < 0.95:
                _views_equal(mine.health(now), theirs.health(now))
            else:
                # coordinator crash: each reloads its own file
                mine = SliceState(n, PORT, paths[0], **kw)
                theirs = RefSliceState(n, PORT, paths[1], **kw)
            _same(mine.membership, theirs.membership)
            assert mine.joined == theirs.joined
        m = load_membership(paths[0])
        _same(m, ref_load_membership(paths[1]))
        if m is not None:
            # the files themselves: same keys, same values
            assert json.load(open(paths[0])) == json.load(open(paths[1]))


def test_membership_files_cross_both_ways(tmp_path):
    m = Membership(slice_id="abc", generation=3, hostnames=("h0", "h1"),
                   coordinator_address=f"h0:{PORT}",
                   reshaped_from=("x1", "x2"), degraded=True)
    save_membership(str(tmp_path / "port.json"), m,
                    member_coords={"h0": (0,), "h1": (1,)},
                    evicted={"h2"})
    theirs = ref_load_membership(str(tmp_path / "port.json"))
    assert theirs is not None and theirs.to_dict() == m.to_dict()
    ref_save_membership(str(tmp_path / "ref.json"), theirs)
    assert load_membership(str(tmp_path / "ref.json")) == m
    # a reference coordinator revives from the port's crash-recovery keys
    revived = RefSliceState(2, PORT, str(tmp_path / "port.json"),
                            reshape_grace_s=1.0)
    assert revived.membership.to_dict() == m.to_dict()
    assert revived._evicted == {"h2"}


# ---------------------------------------------------------------------------
# The wire
# ---------------------------------------------------------------------------

def _client(cls, port, name, coord, tmp_path, **kw):
    return cls(rendezvous_address=f"127.0.0.1:{port}", hostname=name,
               coords=(coord,), chip_count=8,
               state_path=str(tmp_path / f"{name}-{cls.__module__}.json"),
               join_backoff_initial_s=0.05, join_backoff_max_s=0.2, **kw)


def _join_all(clients):
    with concurrent.futures.ThreadPoolExecutor(len(clients)) as pool:
        return [f.result(timeout=20.0) for f in
                [pool.submit(c.join, 15.0) for c in reversed(clients)]][::-1]


@pytest.mark.parametrize("side", ["port-coordinator", "reference-coordinator"])
def test_clients_of_either_package_join_either_coordinator(tmp_path, side):
    if side == "port-coordinator":
        coord = SliceCoordinator(2, bind_address="127.0.0.1:0",
                                 master_port=PORT, heartbeat_timeout_s=0.0,
                                 state_path=str(tmp_path / "coord.json"))
    else:
        coord = RefSliceCoordinator(2, bind_address="127.0.0.1:0",
                                    jax_port=PORT, heartbeat_timeout_s=0.0,
                                    state_path=str(tmp_path / "coord.json"))
    coord.start()
    mine = _client(SliceClient, coord.port, "host-b", 1, tmp_path,
                   local_health_fn=lambda: (True, ""))
    health = {"ok": True}
    theirs = _client(RefSliceClient, coord.port, "host-a", 0, tmp_path,
                     local_health_fn=lambda: (health["ok"], "wedged"))
    try:
        m_mine, m_theirs = _join_all([mine, theirs])
        assert m_mine.to_dict() == m_theirs.to_dict()
        assert m_mine.hostnames == ("host-a", "host-b")
        assert m_mine.coordinator_address == f"host-a:{PORT}"
        # each side's membership file loads in the other package
        assert ref_load_membership(mine._state_path).to_dict() == \
            m_mine.to_dict()
        assert load_membership(theirs._state_path) == m_mine
        # health crosses the wire both ways
        health["ok"] = False
        theirs.heartbeat_now()
        mine.heartbeat_now()
        assert mine.health_overlay() == (False, ["host-a"])
        health["ok"] = True
        theirs.heartbeat_now()
        mine.heartbeat_now()
        assert mine.health_overlay() == (True, [])
        # one contract: the same coordinator, world and generation
        env, ref_env = mine.slice_env(), theirs.slice_env()
        assert (f"{env[constants.ENV_MASTER_ADDR]}:"
                f"{env[constants.ENV_MASTER_PORT]}") == \
            ref_env[ref_constants.ENV_JAX_COORDINATOR_ADDRESS]
        assert env[constants.ENV_WORLD_SIZE] == \
            ref_env[ref_constants.ENV_JAX_NUM_PROCESSES] == "2"
        assert (env[constants.ENV_RANK],
                ref_env[ref_constants.ENV_JAX_PROCESS_ID]) == ("1", "0")
    finally:
        mine.stop()
        theirs.stop()
        coord.stop()


def _env_maps(env, ref_env):
    """Each reference key has its counterparts, holding the same value
    (the coordinator address splits into MASTER_ADDR and MASTER_PORT)."""
    assert set(constants.REFERENCE_SLICE_ENV) == set(ref_env)
    for key, ours in constants.REFERENCE_SLICE_ENV.items():
        got = [env[k] for k in ours]
        if key == ref_constants.ENV_JAX_COORDINATOR_ADDRESS:
            assert ":".join(got) == ref_env[key]
        else:
            assert all(v == ref_env[key] for v in got), (key, got)
    assert len(env) == len({k for v in constants.REFERENCE_SLICE_ENV.values()
                            for k in v})


def test_env_map_names_every_reference_key():
    """The map covers every variable the reference's slice_env sets,
    and names only what torch.distributed and torchrun read."""
    m = Membership(slice_id="s", generation=2, hostnames=("a", "b", "c"),
                   coordinator_address=f"a:{PORT}")
    for host, rank in (("a", 0), ("c", 2)):
        env = SliceClient("x:1", hostname=host, state_path=None)
        env._membership = m
        ref = RefSliceClient("x:1", hostname=host, state_path=None)
        ref._membership = ref_load_membership.__globals__["Membership"](
            **{k: getattr(m, k) for k in ("slice_id", "generation",
                                          "hostnames",
                                          "coordinator_address")})
        ours = env.slice_env()
        _env_maps(ours, ref.slice_env())
        assert ours[constants.ENV_RANK] == ours[
            constants.ENV_PET_NODE_RANK] == str(rank)
        assert ours[constants.ENV_MASTER_ADDR] == "a"
        assert ours[constants.ENV_MASTER_PORT] == str(PORT)
        assert ours[constants.ENV_WORLD_SIZE] == "3"
        assert ours[constants.ENV_TPU_SLICE_GENERATION] == "2"
    stranger = SliceClient("x:1", hostname="z", state_path=None)
    stranger._membership = m
    assert stranger.slice_env() == {}


def test_grpc_reshape_survivor_reforms(tmp_path):
    """The reference's reshape end to end on the port: a member dies,
    the survivor adopts generation 2 alone, re-emits its env, flips
    back healthy, and a ReshapeSignal on its membership file fires."""
    coord = SliceCoordinator(2, bind_address="127.0.0.1:0",
                             master_port=PORT, heartbeat_timeout_s=0.3,
                             reshape_grace_s=0.4,
                             state_path=str(tmp_path / "coord.json"),
                             registry=obs.Registry()).start()
    a = _client(SliceClient, coord.port, "host-a", 0, tmp_path)
    b = _client(SliceClient, coord.port, "host-b", 1, tmp_path)
    signal = ReshapeSignal(a._state_path, generation=0)
    try:
        gen1, _ = _join_all([a, b])
        signal.baseline = gen1.generation
        a.set_reshape_callback(signal.fire)
        assert a.slice_env()[constants.ENV_WORLD_SIZE] == "2"
        b.stop()
        _beat_until(a, lambda: a.membership.generation > 1)
        m = a.membership
        assert (m.generation, m.hostnames, m.reshaped_from, m.degraded) == (
            2, ("host-a",), (gen1.slice_id,), True)
        env = a.slice_env()
        assert env[constants.ENV_WORLD_SIZE] == "1"
        assert env[constants.ENV_RANK] == "0"
        assert env[constants.ENV_TPU_SLICE_GENERATION] == "2"
        _beat_until(a, lambda: a.health_overlay() == (True, []))
        assert signal.triggered and signal.check().generation == 2
        assert load_membership(a._state_path) == m
    finally:
        a.stop()
        b.stop()
        coord.stop()


def test_evicted_client_standalone_then_rejoins(tmp_path):
    """A faulty member is evicted: it learns so on its next heartbeat,
    answers standalone health (no overlay, no slice env) and rejoins the
    next generation once its GPUs recover, as the reference's does."""
    coord = SliceCoordinator(2, bind_address="127.0.0.1:0",
                             master_port=PORT, heartbeat_timeout_s=0.3,
                             reshape_grace_s=0.4,
                             state_path=str(tmp_path / "coord.json")).start()
    health = {"ok": True}
    a = _client(SliceClient, coord.port, "host-a", 0, tmp_path)
    b = _client(SliceClient, coord.port, "host-b", 1, tmp_path,
                local_health_fn=lambda: (health["ok"], "GPU faulty"))
    try:
        gen1, _ = _join_all([a, b])
        health["ok"] = False
        b.heartbeat_now()
        _beat_until(a, lambda: a.membership.generation > 1)
        gen2 = a.membership
        assert gen2.hostnames == ("host-a",)
        b.heartbeat_now()
        assert b.membership.rank_of("host-b") is None
        assert b.health_overlay() is None and b.slice_env() == {}
        health["ok"] = True
        _beat_until(b, lambda: b.membership.rank_of("host-b") is not None)
        gen3 = b.membership
        assert (gen3.generation, gen3.hostnames, gen3.reshaped_from,
                gen3.degraded) == (3, ("host-a", "host-b"),
                                   (gen1.slice_id, gen2.slice_id), False)
        _beat_until(a, lambda: a.membership == gen3)
        assert a.slice_env()[constants.ENV_WORLD_SIZE] == "2"
    finally:
        a.stop()
        b.stop()
        coord.stop()


def _beat_until(client, predicate, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        client.heartbeat_now()
        if predicate():
            return
        time.sleep(0.05)
    raise AssertionError(f"not reached; membership={client.membership}")


# ---------------------------------------------------------------------------
# Two plugin hosts
# ---------------------------------------------------------------------------

FIXTURE = os.path.join("nvidia", "h100-sxm-8")
FAULTY = "0000:13:00.0"


class SliceHost:
    """One member: a copy of the 8-GPU fixture, its container impl fed
    by the port's own probe, a slice client, a fake kubelet and a plugin
    manager pulsed by hand (as the reference's test_slice.SliceHost)."""

    def __init__(self, name, testdata, tmp_path, rendezvous, coord):
        self.name = name
        self.root = str(tmp_path / name)
        shutil.copytree(os.path.join(testdata, FIXTURE), self.root,
                        symlinks=True)
        self.nvml = nvml.load(os.path.join(self.root, "nvml.json"))
        roots = [os.path.join(self.root, d) for d in ("sys", "dev", "proc")]
        self.impl = GpuContainerImpl(
            *roots, nvml=self.nvml,
            health_fn=lambda: {k: v.health for k, v in
                               probe_gpu_states(*roots,
                                                nvml=self.nvml).items()})
        self.client = SliceClient(
            rendezvous_address=rendezvous, hostname=name, coords=(coord,),
            chip_count=len(self.impl.gpus),
            state_path=str(tmp_path / f"{name}-membership.json"),
            local_health_fn=self.impl.local_health,
            join_backoff_initial_s=0.05, join_backoff_max_s=0.2)
        self.impl.set_slice_client(self.client)
        self.kubelet = FakeKubelet(str(tmp_path / f"{name}-dp")).start()
        self.manager = PluginManager(
            self.impl, pulse_seconds=0, kubelet_dir=self.kubelet.dir,
            kubelet_watch_interval_s=0.1, slice_client=self.client)

    def pulse(self):
        """One pulse round in the manager loop's order: the slice
        heartbeat first, then every plugin's beat."""
        self.client.heartbeat_now()
        with self.manager._plugins_lock:
            plugins = list(self.manager._plugins.values())
        for sp in plugins:
            sp.plugin.beat()

    def fault(self, count):
        """A fatal AER count on one GPU (0 clears it)."""
        path = os.path.join(self.root, "sys", "bus", "pci", "devices",
                            FAULTY, constants.SYSFS_AER_DEV_FATAL)
        lines = open(path).read().splitlines()
        lines[-1] = f"{constants.AER_TOTAL_FATAL} {count}"
        open(path, "w").write("\n".join(lines) + "\n")

    def allocate_all(self):
        assert self.kubelet.wait_for_registration()
        stub = self.kubelet.plugin_stub("nvidia.com_gpu")
        consumer = ListAndWatchConsumer(stub)
        ids = [d.ID for d in consumer.next_frame().devices]
        resp = stub.Allocate(pluginapi.AllocateRequest(container_requests=[
            pluginapi.ContainerAllocateRequest(devices_ids=ids)]))
        sub = stub.Allocate(pluginapi.AllocateRequest(container_requests=[
            pluginapi.ContainerAllocateRequest(devices_ids=ids[:4])]))
        return (consumer, dict(resp.container_responses[0].envs),
                dict(sub.container_responses[0].envs))

    def stop(self):
        self.manager.stop()
        self.client.stop()
        self.kubelet.stop()


@pytest.fixture
def coordinator(tmp_path):
    c = SliceCoordinator(2, bind_address="127.0.0.1:0", master_port=PORT,
                         state_path=str(tmp_path / "coordinator.json"),
                         heartbeat_timeout_s=0.0).start()
    yield c
    c.stop()


@pytest.fixture
def hosts(coordinator, testdata, tmp_path):
    rendezvous = f"127.0.0.1:{coordinator.port}"
    pair = [SliceHost("host-a", testdata, tmp_path, rendezvous, 0),
            SliceHost("host-b", testdata, tmp_path, rendezvous, 1)]
    yield pair
    for h in pair:
        h.stop()


def _form(hosts):
    _join_all([h.client for h in hosts])


def test_two_hosts_form_slice_with_consistent_env(hosts):
    _form(hosts)
    a, b = hosts
    assert a.client.rank == 0 and b.client.rank == 1
    assert b.client.membership == a.client.membership
    a.manager.run(block=False)
    b.manager.run(block=False)
    _, env_a, sub_a = a.allocate_all()
    _, env_b, _ = b.allocate_all()
    for env in (env_a, env_b):
        assert env[constants.ENV_MASTER_ADDR] == "host-a"
        assert env[constants.ENV_MASTER_PORT] == str(PORT)
        assert env[constants.ENV_WORLD_SIZE] == \
            env[constants.ENV_PET_NNODES] == "2"
        assert env[constants.ENV_SLICE_WORKER_HOSTNAMES] == "host-a,host-b"
        assert env[constants.ENV_TPU_SLICE_GENERATION] == "1"
        assert len(env[constants.ENV_NVIDIA_VISIBLE_DEVICES].split(",")) == 8
    assert env_a[constants.ENV_RANK] == env_a[constants.ENV_PET_NODE_RANK] \
        == "0"
    assert env_b[constants.ENV_RANK] == env_b[constants.ENV_PET_NODE_RANK] \
        == "1"
    # a sub-host grant is a standalone job: no slice env
    assert constants.ENV_MASTER_ADDR not in sub_a
    st = manager_status(b.manager)["slice"]
    assert st["formed"] and st["rank"] == 1
    assert st["hostnames"] == ["host-a", "host-b"]


def test_allocate_before_formation_has_no_slice_env(coordinator, testdata,
                                                    tmp_path):
    h = SliceHost("host-b", testdata, tmp_path,
                  f"127.0.0.1:{coordinator.port}", 1)
    try:
        h.manager.run(block=False)
        _, env, _ = h.allocate_all()
        assert constants.ENV_MASTER_ADDR not in env
        assert constants.ENV_RANK not in env
    finally:
        h.stop()


def test_wedged_chip_propagates_slice_wide_and_recovers(hosts):
    """A fatal error on one GPU of host A reaches host B's kubelet as
    all-Unhealthy within one pulse, and recovery the same way."""
    _form(hosts)
    a, b = hosts
    a.manager.run(block=False)
    b.manager.run(block=False)
    consumer_a, _, _ = a.allocate_all()
    consumer_b, _, _ = b.allocate_all()
    a.pulse()
    b.pulse()
    for c in (consumer_a, consumer_b):
        assert all(d.health == constants.HEALTHY
                   for d in c.next_frame().devices)
    a.fault(1)
    a.pulse()
    b.pulse()
    assert all(d.health == constants.UNHEALTHY
               for d in consumer_b.next_frame().devices)
    assert all(d.health == constants.UNHEALTHY
               for d in consumer_a.next_frame().devices)
    a.fault(0)
    a.pulse()
    b.pulse()
    assert all(d.health == constants.HEALTHY
               for d in consumer_b.next_frame().devices)


def test_coordinator_restart_recovers_membership(coordinator, hosts):
    _form(hosts)
    before = hosts[0].client.membership
    coordinator.stop()
    revived = SliceCoordinator(
        2, bind_address=f"127.0.0.1:{coordinator.port}", master_port=PORT,
        state_path=coordinator.state.state_path,
        heartbeat_timeout_s=0.0).start()
    try:
        assert hosts[0].client.join(timeout_s=10.0) == before
        assert revived.state.membership.generation == before.generation
    finally:
        revived.stop()


def test_worker_restart_recovers_rank_from_state_file(hosts):
    _form(hosts)
    b = hosts[1]
    reborn = SliceClient(rendezvous_address=b.client._address,
                         hostname=b.name, state_path=b.client._state_path)
    try:
        assert reborn.rank == 1
        assert reborn.join(timeout_s=10.0) == b.client.membership
    finally:
        reborn.stop()


# ---------------------------------------------------------------------------
# Labels
# ---------------------------------------------------------------------------

SLICE_LABELS = ("slice-id", "slice-rank", "slice-generation",
                "slice-workers", "slice-degraded")


@pytest.mark.parametrize("host,degraded", [("h1", False), ("h0", True),
                                           ("stranger", False)])
def test_slice_labels_equal_the_reference(testdata, tmp_path, host,
                                          degraded):
    path = str(tmp_path / "membership.json")
    save_membership(path, Membership(
        slice_id="9f2c1ab3de45", generation=3, hostnames=("h0", "h1"),
        coordinator_address=f"h0:{PORT}", reshaped_from=("a1",),
        degraded=degraded))
    gpu_root = os.path.join(testdata, "nvidia", "h100-sxm-8")
    ctx = LabelContext.collect(
        sysfs_root=os.path.join(gpu_root, "sys"),
        dev_root=os.path.join(gpu_root, "dev"),
        proc_root=os.path.join(gpu_root, "proc"), slice_state_path=path)
    ctx.hostname = host
    tpu_root = os.path.join(testdata, "v5e-16-host0")
    ref = RefLabelContext.collect(
        sysfs_root=os.path.join(tpu_root, "sys"),
        dev_root=os.path.join(tpu_root, "dev"),
        tpu_env_path=os.path.join(tpu_root, "run", "tpu", "tpu-env"),
        slice_state_path=path)
    ref.hostname = host

    def suffixes(labels, prefix):
        return {k[len(prefix) + 1:]: v for k, v in labels.items()
                if k.startswith(prefix + ".")}

    ours = suffixes(generate_labels(ctx, list(SLICE_LABELS)),
                    constants.LABEL_PREFIX)
    theirs = suffixes(ref_generate_labels(ref, list(SLICE_LABELS)),
                      ref_constants.LABEL_PREFIX)
    assert ours == theirs
    assert ours["slice-generation"] == "3"
    rank = {"h0": "0", "h1": "1"}.get(host)
    both = generate_labels(ctx, ["worker-id", "num-workers"])
    assert both.get(f"{constants.LABEL_PREFIX}.worker-id") == rank
    assert both[f"{constants.LABEL_PREFIX}.num-workers"] == "2"
