"""The port's debug endpoint against a live manager on a fixture: the
health check, the status snapshot with the GPU topology, the thread
dump, the Prometheus route with the RPC and impl counters, and 404."""

import json
import os
import urllib.error
import urllib.request

import pytest

from fake_kubelet import FakeKubelet
from tpu_k8s_device_plugin.proto import deviceplugin_pb2 as refapi
from tpu_k8s_device_plugin_torch.gpu import nvml
from tpu_k8s_device_plugin_torch.gpu.device_impl import GpuContainerImpl
from tpu_k8s_device_plugin_torch.manager import PluginManager
from tpu_k8s_device_plugin_torch.observability import DebugServer

PCIE4 = ["0000:31:00.0", "0000:32:00.0", "0000:b1:00.0", "0000:b2:00.0"]


@pytest.fixture
def served(testdata, tmp_path):
    root = os.path.join(testdata, "nvidia", "h100-pcie-4")
    impl = GpuContainerImpl(
        sysfs_root=os.path.join(root, "sys"),
        dev_root=os.path.join(root, "dev"),
        proc_root=os.path.join(root, "proc"),
        nvml=nvml.load(os.path.join(root, "nvml.json")))
    kubelet = FakeKubelet(str(tmp_path / "device-plugins")).start()
    manager = PluginManager(impl, kubelet_dir=kubelet.dir,
                            kubelet_watch_interval_s=0.1)
    manager.run(block=False)
    debug = DebugServer(manager, port=0).start()
    assert kubelet.wait_for_registration()
    yield manager, debug, kubelet
    debug.stop()
    manager.stop()
    kubelet.stop()


def get(debug, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{debug.port}{path}",
                                timeout=5) as resp:
        return resp.status, resp.read().decode()


def allocate(kubelet, ids):
    kubelet.plugin_stub("nvidia.com_gpu").Allocate(refapi.AllocateRequest(
        container_requests=[refapi.ContainerAllocateRequest(
            devices_ids=ids)]))


def test_healthz(served):
    assert get(served[1], "/healthz") == (200, "ok\n")


def test_status_reports_resources_topology_and_counters(served):
    _, debug, kubelet = served
    allocate(kubelet, PCIE4[:1])
    status, body = get(debug, "/debug/status")
    data = json.loads(body)
    res = data["resources"]["gpu"]
    assert res["healthy"] == 4 and res["unhealthy"] == 0
    assert res["rpc_counts"]["allocate"] == 1
    assert res["preferred_allocation_enabled"] is True
    assert data["topology"] == {
        "product": "H100-PCIe-80GB", "gpus": 4, "nvlink_topology": "2x2",
        "cliques": [PCIE4[:2], PCIE4[2:]]}
    assert data["impl_counters"] == {"cross_clique_allocations": 0}


def test_thread_dump_shows_manager_threads(served):
    status, body = get(served[1], "/debug/threads")
    assert status == 200 and "kubelet-watch" in body and "MainThread" in body


def test_metrics_route(served):
    _, debug, kubelet = served
    allocate(kubelet, PCIE4[:2])
    allocate(kubelet, [PCIE4[1], PCIE4[2]])  # spans the two bridges
    status, body = get(debug, "/metrics")
    series = {}
    for line in body.splitlines():
        if line and not line.startswith("#"):
            key, _, val = line.rpartition(" ")
            series[key] = float(val)
    assert series['tpu_plugin_rpc_total{resource="gpu",rpc="allocate"}'] == 2
    assert series['tpu_plugin_devices_healthy{resource="gpu"}'] == 4
    assert series["tpu_plugin_cross_clique_allocations_total"] == 1
    assert series['tpu_plugin_allocate_seconds_count{resource="gpu"}'] == 2


def test_unknown_path_404(served):
    with pytest.raises(urllib.error.HTTPError) as ei:
        get(served[1], "/nope")
    assert ei.value.code == 404
