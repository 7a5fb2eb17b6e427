"""The port's plugin adapter and PluginManager end to end, registering
with the reference's fake kubelet (``tests/fake_kubelet.py``, built on
the reference's proto: the wire is the same) and driven as the kubelet
drives it: ListAndWatch, GetPreferredAllocation and Allocate over the
wire, kubelet restarts, resource diffing, health transitions."""

import functools
import os
import queue
import shutil
import threading
import time

import pytest

from fake_kubelet import FakeKubelet, ListAndWatchConsumer
from tpu_k8s_device_plugin.proto import deviceplugin_pb2 as refapi
from tpu_k8s_device_plugin_torch.gpu import nvml
from tpu_k8s_device_plugin_torch.gpu.device_impl import GpuContainerImpl
from tpu_k8s_device_plugin_torch.health import GpuHealthServer, get_gpu_health
from tpu_k8s_device_plugin_torch.manager import PluginManager
from tpu_k8s_device_plugin_torch.manager import manager as manager_mod
from tpu_k8s_device_plugin_torch.types import constants

PCIE4 = ["0000:31:00.0", "0000:32:00.0", "0000:b1:00.0", "0000:b2:00.0"]
ENDPOINT = "nvidia.com_gpu"


def make_impl(root, **kwargs):
    return GpuContainerImpl(
        sysfs_root=os.path.join(root, "sys"),
        dev_root=os.path.join(root, "dev"),
        proc_root=os.path.join(root, "proc"),
        nvml=nvml.load(os.path.join(root, "nvml.json")), **kwargs)


@pytest.fixture
def root(testdata):
    return os.path.join(testdata, "nvidia", "h100-pcie-4")


@pytest.fixture
def impl(root):
    return make_impl(root)


@pytest.fixture
def kubelet(tmp_path):
    k = FakeKubelet(str(tmp_path / "device-plugins")).start()
    yield k
    k.stop()


@pytest.fixture
def manager(impl, kubelet):
    m = PluginManager(impl, pulse_seconds=0, kubelet_dir=kubelet.dir,
                      kubelet_watch_interval_s=0.1)
    m.run(block=False)
    yield m
    m.stop()


@pytest.fixture(autouse=True)
def fast_register_retries(monkeypatch):
    monkeypatch.setattr(manager_mod, "_REGISTER_RETRY_DELAY_S", 0.05)


def test_registration_request_shape(kubelet, manager):
    assert kubelet.wait_for_registration()
    [reg] = kubelet.registrations
    assert reg.version == "v1beta1"
    assert reg.resource_name == "nvidia.com/gpu"
    assert reg.endpoint == ENDPOINT
    assert reg.options.get_preferred_allocation_available
    assert os.path.exists(os.path.join(kubelet.dir, ENDPOINT))


def test_list_and_watch_and_allocate_over_wire(root, kubelet, manager):
    assert kubelet.wait_for_registration()
    stub = kubelet.plugin_stub(ENDPOINT)
    consumer = ListAndWatchConsumer(stub)
    frame = consumer.next_frame()
    assert [d.ID for d in frame.devices] == PCIE4
    assert [d.topology.nodes[0].ID for d in frame.devices] == [0, 0, 1, 1]
    assert all(d.health == constants.HEALTHY for d in frame.devices)

    pref = stub.GetPreferredAllocation(refapi.PreferredAllocationRequest(
        container_requests=[refapi.ContainerPreferredAllocationRequest(
            available_deviceIDs=PCIE4[1:], allocation_size=2)]))
    chosen = list(pref.container_responses[0].deviceIDs)
    assert chosen == PCIE4[2:]  # the intact bridged pair

    alloc = stub.Allocate(refapi.AllocateRequest(container_requests=[
        refapi.ContainerAllocateRequest(devices_ids=chosen)]))
    car = alloc.container_responses[0]
    assert [d.container_path for d in car.devices] == [
        "/dev/nvidia2", "/dev/nvidia3", "/dev/nvidiactl", "/dev/nvidia-uvm",
        "/dev/nvidia-uvm-tools"]
    assert car.envs[constants.ENV_NVIDIA_VISIBLE_DEVICES].count("GPU-") == 2
    assert constants.ENV_CUDA_VISIBLE_DEVICES not in car.envs
    consumer.cancel()


def test_heartbeat_triggers_resend(kubelet, manager):
    assert kubelet.wait_for_registration()
    consumer = ListAndWatchConsumer(kubelet.plugin_stub(ENDPOINT))
    consumer.next_frame()
    for sp in manager._plugins.values():
        sp.plugin.beat()
    assert len(consumer.next_frame().devices) == 4
    consumer.cancel()


def test_kubelet_restart_triggers_reregistration(kubelet, manager):
    assert kubelet.wait_for_registration()
    kubelet.restart()
    assert kubelet.wait_for_registration(timeout=10.0)
    assert len(kubelet.registrations) == 2


def assert_wipe_restart_recovers(kubelet, n_devices=4):
    kubelet.register_event.clear()
    kubelet.restart(wipe_dir=True)
    assert kubelet.wait_for_registration(timeout=10.0)
    sock = os.path.join(kubelet.dir, ENDPOINT)
    deadline = time.time() + 5.0
    while not os.path.exists(sock) and time.time() < deadline:
        time.sleep(0.05)
    assert os.path.exists(sock)
    stub = kubelet.plugin_stub(ENDPOINT)
    assert len(next(iter(stub.ListAndWatch(refapi.Empty()))).devices) == \
        n_devices


def test_kubelet_restart_wiping_dp_dir_reserves_sockets(kubelet, manager):
    assert kubelet.wait_for_registration()
    assert_wipe_restart_recovers(kubelet)


def test_resource_diffing_stops_removed_plugins(kubelet, manager):
    assert kubelet.wait_for_registration()
    sock = os.path.join(kubelet.dir, ENDPOINT)
    assert os.path.exists(sock)
    manager.update_resources([])
    assert not os.path.exists(sock)
    manager.update_resources(["gpu"])
    assert kubelet.wait_for_registration()
    assert os.path.exists(sock)


def test_stop_removes_sockets(kubelet, impl):
    m = PluginManager(impl, kubelet_dir=kubelet.dir)
    m.run(block=False)
    sock = os.path.join(kubelet.dir, ENDPOINT)
    assert os.path.exists(sock)
    m.stop()
    assert not os.path.exists(sock)
    assert m._threads == []


def test_teardown_leaves_no_thread_running(testdata, tmp_path):
    """A kubelet, the exporter, the manager with its pulse and a
    ListAndWatch stream over the wire, then stop(): every thread they
    started ends."""
    root = os.path.join(testdata, "nvidia", "h100-pcie-4")
    before = threading.active_count()
    kubelet = FakeKubelet(str(tmp_path / "device-plugins")).start()
    sock = str(tmp_path / "exporter.sock")
    exporter = GpuHealthServer(
        sock, *(os.path.join(root, d) for d in ("sys", "dev", "proc")),
        nvml=nvml.load(os.path.join(root, "nvml.json"))).start()
    impl = make_impl(root, health_fn=functools.partial(get_gpu_health, sock,
                                                       timeout_s=5.0))
    m = PluginManager(impl, pulse_seconds=0.2, kubelet_dir=kubelet.dir,
                      kubelet_watch_interval_s=0.1)
    m.run(block=False)
    try:
        assert kubelet.wait_for_registration()
        consumer = ListAndWatchConsumer(kubelet.plugin_stub(ENDPOINT))
        consumer.next_frame()
        consumer.next_frame()
        assert threading.active_count() > before
        consumer.cancel()
    finally:
        m.stop()
        exporter.stop()
        kubelet.stop()
    deadline = time.monotonic() + 5.0
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before, [
        t.name for t in threading.enumerate()]


def test_status_snapshot(kubelet, manager):
    assert kubelet.wait_for_registration()
    snap = manager.status_snapshot()["gpu"]
    assert snap["healthy"] == 4 and snap["unhealthy"] == 0
    assert snap["preferred_allocation_enabled"] is True
    assert snap["endpoint"].endswith(ENDPOINT)


def wait_for_frame(consumer, predicate, timeout=15.0):
    deadline = time.time() + timeout
    last = None
    while time.time() < deadline:
        try:
            last = consumer.next_frame(timeout=max(0.1, deadline - time.time()))
        except queue.Empty:
            break
        if predicate(last):
            return last
    raise AssertionError(f"no matching frame within {timeout}s; last: {last}")


def test_health_transition_observed_over_wire(testdata, tmp_path, kubelet):
    """Exporter probes sysfs -> pulse -> the next ListAndWatch frame to
    the kubelet flips the GPU Unhealthy on an AER fatal error, then back
    to Healthy once the count clears, over real gRPC sockets."""
    tree = str(tmp_path / "h100-pcie-4")
    shutil.copytree(os.path.join(testdata, "nvidia", "h100-pcie-4"), tree,
                    symlinks=True)
    source = nvml.load(os.path.join(tree, "nvml.json"))
    sysr, devr, procr = (os.path.join(tree, d) for d in ("sys", "dev", "proc"))
    sock = str(tmp_path / "exporter.sock")
    exporter = GpuHealthServer(sock, sysr, devr, procr, nvml=source).start()
    impl = make_impl(tree, health_fn=functools.partial(get_gpu_health, sock,
                                                       timeout_s=5.0))
    m = PluginManager(impl, pulse_seconds=0.2, kubelet_dir=kubelet.dir,
                      kubelet_watch_interval_s=0.1)
    m.run(block=False)
    sick = PCIE4[2]
    attr = os.path.join(os.path.realpath(os.path.join(
        sysr, "bus", "pci", "devices", sick)), constants.SYSFS_AER_DEV_FATAL)
    clean = open(attr).read()
    try:
        assert kubelet.wait_for_registration()
        consumer = ListAndWatchConsumer(kubelet.plugin_stub(ENDPOINT))
        assert all(d.health == constants.HEALTHY
                   for d in consumer.next_frame().devices)
        open(attr, "w").write(clean.replace(
            f"{constants.AER_TOTAL_FATAL} 0", f"{constants.AER_TOTAL_FATAL} 2"))
        frame = wait_for_frame(consumer, lambda fr: any(
            d.ID == sick and d.health == constants.UNHEALTHY
            for d in fr.devices))
        # only the faulted GPU is demoted
        assert sum(d.health == constants.HEALTHY for d in frame.devices) == 3
        open(attr, "w").write(clean)
        wait_for_frame(consumer, lambda fr: all(
            d.health == constants.HEALTHY for d in fr.devices))
        consumer.cancel()
    finally:
        m.stop()
        exporter.stop()


def test_lost_node_readvertised_without_restart(testdata, tmp_path, kubelet):
    """Runtime rediscovery: a GPU whose device node disappears leaves the
    advertised list on the next pulse, through the running manager."""
    tree = str(tmp_path / "h100-pcie-4")
    shutil.copytree(os.path.join(testdata, "nvidia", "h100-pcie-4"), tree,
                    symlinks=True)
    m = PluginManager(make_impl(tree), pulse_seconds=0.2,
                      kubelet_dir=kubelet.dir, kubelet_watch_interval_s=0.1)
    m.run(block=False)
    try:
        assert kubelet.wait_for_registration()
        consumer = ListAndWatchConsumer(kubelet.plugin_stub(ENDPOINT))
        assert len(consumer.next_frame().devices) == 4
        os.remove(os.path.join(tree, "dev", "nvidia3"))
        frame = wait_for_frame(consumer, lambda fr: len(fr.devices) == 3)
        assert [d.ID for d in frame.devices] == PCIE4[:3]
        consumer.cancel()
    finally:
        m.stop()


def test_kubelet_socket_flap_stress(kubelet, impl):
    """Rapid kubelet re-creates: one re-registration each, no leaked
    endpoint sockets or threads."""
    m = PluginManager(impl, pulse_seconds=0, kubelet_dir=kubelet.dir,
                      kubelet_watch_interval_s=0.05)
    try:
        m.run(block=False)
        assert kubelet.wait_for_registration()
        baseline = threading.active_count()
        cycles = 3
        for i in range(cycles):
            kubelet.register_event.clear()
            kubelet.restart(wipe_dir=True)
            assert kubelet.wait_for_registration(timeout=10.0), i
        assert len(kubelet.registrations) == cycles + 1
        deadline = time.time() + 5.0
        while time.time() < deadline and sorted(os.listdir(kubelet.dir)) \
                != sorted(["kubelet.sock", ENDPOINT]):
            time.sleep(0.05)
        assert sorted(os.listdir(kubelet.dir)) == sorted(["kubelet.sock", ENDPOINT])
        assert threading.active_count() <= baseline + cycles - 1
    finally:
        m.stop()
    assert m._threads == []


def test_concurrent_lifecycle_stress(kubelet, impl):
    """Resource diffing, kubelet restarts and pulse beats from concurrent
    threads leave the manager consistent and serving."""
    m = PluginManager(impl, pulse_seconds=0.2, kubelet_dir=kubelet.dir,
                      kubelet_watch_interval_s=0.05)
    try:
        m.run(block=False)
        assert kubelet.wait_for_registration()
        errors = []

        def diff_loop():
            try:
                for _ in range(5):
                    m.update_resources([])
                    m.update_resources(["gpu"])
            except Exception as e:  # pragma: no cover
                errors.append(e)

        def restart_loop():
            try:
                for _ in range(3):
                    kubelet.restart(wipe_dir=True)
                    time.sleep(0.05)
            except Exception as e:  # pragma: no cover
                errors.append(e)

        threads = [threading.Thread(target=diff_loop),
                   threading.Thread(target=restart_loop)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        assert not errors, errors
        assert_wipe_restart_recovers(kubelet)
    finally:
        m.stop()


def test_registration_survives_kubelet_downtime(impl, tmp_path):
    """Plugin up before the kubelet: retries fail, then the watch loop
    registers once the socket appears."""
    dp_dir = str(tmp_path / "device-plugins")
    os.makedirs(dp_dir)
    m = PluginManager(impl, kubelet_dir=dp_dir, kubelet_watch_interval_s=0.1)
    try:
        m.run(block=False)
        time.sleep(0.3)
        k = FakeKubelet(dp_dir).start()
        try:
            assert k.wait_for_registration(timeout=10.0)
        finally:
            k.stop()
    finally:
        m.stop()
