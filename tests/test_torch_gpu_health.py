"""The port's health subsystem: the probe (an AER fatal count, a failed
row remapping, a missing device node), the errno policy, the health
server read by the port's client AND the reference's client over a unix
socket (the same map), and the exporter's Prometheus surface."""

import errno
import glob
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest

from tpu_k8s_device_plugin.health.client import get_tpu_health as ref_client
from tpu_k8s_device_plugin_torch.gpu import nvml
from tpu_k8s_device_plugin_torch.health import (
    GpuHealthServer,
    get_gpu_health,
    probe_gpu_states,
)
from tpu_k8s_device_plugin_torch.health import server as health_server
from tpu_k8s_device_plugin_torch.health.metrics import (
    MetricsHTTPServer,
    render_metrics,
)
from tpu_k8s_device_plugin_torch.types import constants

SXM8 = ["0000:13:00.0", "0000:14:00.0", "0000:23:00.0", "0000:24:00.0",
        "0000:93:00.0", "0000:94:00.0", "0000:c3:00.0", "0000:c4:00.0"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def sxm8(testdata, tmp_path):
    """A mutable copy of h100-sxm-8 (relative symlinks survive)."""
    dst = tmp_path / "h100-sxm-8"
    shutil.copytree(os.path.join(testdata, "nvidia", "h100-sxm-8"), dst,
                    symlinks=True)
    return str(dst)


def roots(root):
    return (os.path.join(root, "sys"), os.path.join(root, "dev"),
            os.path.join(root, "proc"))


def source(root):
    return nvml.load(os.path.join(root, "nvml.json"))


def set_aer_fatal(root, bus, count):
    path = os.path.join(root, "sys", "bus", "pci", "devices", bus,
                        constants.SYSFS_AER_DEV_FATAL)
    text = open(path).read().replace(
        f"{constants.AER_TOTAL_FATAL} 0", f"{constants.AER_TOTAL_FATAL} {count}")
    open(path, "w").write(text)


def test_probe_gpu_states(testdata):
    root = os.path.join(testdata, "nvidia", "h100-sxm-8")
    states = probe_gpu_states(*roots(root), nvml=source(root))
    assert sorted(states) == SXM8
    s = states[SXM8[0]]
    assert s.health == constants.HEALTHY and s.accel_index == 0
    assert s.device.endswith(os.path.join("dev", "nvidia0"))


def test_nonzero_aer_fatal_is_unhealthy(sxm8):
    set_aer_fatal(sxm8, SXM8[2], 3)
    states = probe_gpu_states(*roots(sxm8))
    assert states[SXM8[2]].health == constants.UNHEALTHY
    assert sum(s.health == constants.HEALTHY for s in states.values()) == 7
    assert health_server.read_aer_fatal(os.path.realpath(os.path.join(
        sxm8, "sys", "bus", "pci", "devices", SXM8[2]))) == 3


def test_failed_row_remapping_is_unhealthy(sxm8):
    path = os.path.join(sxm8, "nvml.json")
    data = json.load(open(path))
    data["devices"][4]["remapped_rows_failure"] = True
    json.dump(data, open(path, "w"))
    states = probe_gpu_states(*roots(sxm8), nvml=source(sxm8))
    assert states[SXM8[4]].health == constants.UNHEALTHY
    assert sum(s.health == constants.HEALTHY for s in states.values()) == 7


def test_missing_device_node_is_unhealthy(sxm8):
    os.remove(os.path.join(sxm8, "dev", "nvidia6"))
    states = probe_gpu_states(*roots(sxm8))
    assert states[SXM8[6]].health == constants.UNHEALTHY
    assert sum(s.health == constants.HEALTHY for s in states.values()) == 7


def test_gpu_bound_elsewhere_is_left_out(sxm8):
    os.remove(os.path.join(sxm8, "sys", "bus", "pci", "drivers", "nvidia",
                           SXM8[1]))
    os.remove(os.path.join(os.path.realpath(os.path.join(
        sxm8, "sys", "bus", "pci", "devices", SXM8[1])), "driver"))
    assert SXM8[1] not in probe_gpu_states(*roots(sxm8))


def test_missing_aer_attrs_are_no_verdict_but_logged_once(sxm8, caplog):
    for f in glob.glob(os.path.join(sxm8, "sys", "bus", "pci", "devices",
                                    "*", constants.SYSFS_AER_DEV_FATAL)):
        os.remove(f)
    with caplog.at_level("WARNING"):
        states = probe_gpu_states(*roots(sxm8))
        probe_gpu_states(*roots(sxm8))
    assert all(s.health == constants.HEALTHY for s in states.values())
    assert sum("granular health unavailable" in r.message
               for r in caplog.records) == 1


class TestNodeErrnoPolicy:
    def _probe_with_rc(self, monkeypatch, rc):
        class FakeProbe:
            @staticmethod
            def probe_device_node(path):
                return rc
        monkeypatch.setattr(health_server, "_NATIVE", FakeProbe)
        return health_server._node_present("/dev/nvidia0")

    def test_busy_node_is_healthy(self, monkeypatch):
        assert self._probe_with_rc(monkeypatch, -errno.EBUSY) is True

    def test_permission_denied_is_healthy(self, monkeypatch):
        assert self._probe_with_rc(monkeypatch, -errno.EACCES) is True

    @pytest.mark.parametrize("err", [errno.ENOENT, errno.ENXIO, errno.ENODEV,
                                     errno.EIO])
    def test_gone_node_is_unhealthy(self, monkeypatch, err):
        assert self._probe_with_rc(monkeypatch, -err) is False

    def test_char_device_is_healthy(self, monkeypatch):
        assert self._probe_with_rc(monkeypatch, 0) is True


def test_reference_client_reads_the_port_server(sxm8, tmp_path):
    """The wire is the reference's: its client and the port's read the
    same map from the port's exporter, healthy and with a fault."""
    set_aer_fatal(sxm8, SXM8[5], 1)
    sock = str(tmp_path / "exporter.sock")
    server = GpuHealthServer(sock, *roots(sxm8), nvml=source(sxm8)).start()
    try:
        mine = get_gpu_health(sock, timeout_s=5.0)
        theirs = ref_client(sock, timeout_s=5.0)
        assert mine == theirs
        assert sorted(mine) == SXM8
        assert mine[SXM8[5]] == constants.UNHEALTHY
        assert sum(v == constants.HEALTHY for v in mine.values()) == 7
    finally:
        server.stop()
    assert not os.path.exists(sock)


def test_get_state_of_one_gpu_and_unknown(testdata, tmp_path):
    import grpc

    from tpu_k8s_device_plugin_torch.proto import (
        tpuhealth_pb2 as hpb, tpuhealth_pb2_grpc as hpb_grpc)

    root = os.path.join(testdata, "nvidia", "h100-pcie-4")
    sock = str(tmp_path / "exporter.sock")
    server = GpuHealthServer(sock, *roots(root)).start()
    try:
        with grpc.insecure_channel(f"unix://{sock}") as ch:
            stub = hpb_grpc.TpuHealthServiceStub(ch)
            state = stub.GetTpuState(hpb.GetTpuStateRequest(
                id="0000:b1:00.0"), timeout=5).state
            assert state.accel_index == 2 and state.health == "Healthy"
            with pytest.raises(grpc.RpcError) as ei:
                stub.GetTpuState(hpb.GetTpuStateRequest(id="nope"),
                                 timeout=5)
            assert ei.value.code() == grpc.StatusCode.NOT_FOUND
    finally:
        server.stop()


def test_client_missing_socket_returns_empty(tmp_path):
    assert get_gpu_health(str(tmp_path / "nope.sock")) == {}


def test_client_dead_socket_returns_empty(tmp_path):
    sock = str(tmp_path / "dead.sock")
    open(sock, "w").close()
    assert get_gpu_health(sock, timeout_s=0.5) == {}


def _series(body):
    out = {}
    for line in body.splitlines():
        if line and not line.startswith("#"):
            key, _, val = line.rpartition(" ")
            out[key] = float(val)
    return out


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=5) as resp:
        return resp.status, resp.read().decode()


def test_render_all_healthy(sxm8):
    s = _series(render_metrics(*roots(sxm8), nvml=source(sxm8), scrapes=1))
    gauges = {k: v for k, v in s.items() if k.startswith("tpu_device_health{")}
    assert len(gauges) == 8 and all(v == 1 for v in gauges.values())
    assert s["tpu_exporter_gpus"] == 8
    assert s["tpu_exporter_unhealthy_gpus"] == 0
    assert s["tpu_exporter_scrapes_total"] == 1
    assert s["tpu_exporter_granular_health"] == 1
    assert s["tpu_exporter_nvml_available"] == 1
    assert s['tpu_device_uncorrectable_errors_total{gpu="0000:13:00.0"}'] == 0


def test_nvml_absent_gauge(testdata):
    root = os.path.join(testdata, "nvidia", "h100-sxm-1")
    s = _series(render_metrics(*roots(root)))
    assert s["tpu_exporter_nvml_available"] == 0
    assert s["tpu_exporter_gpus"] == 1


def test_gauge_transitions_when_a_gpu_faults(sxm8):
    srv = MetricsHTTPServer(port=0, host="127.0.0.1", sysfs_root=roots(sxm8)[0],
                            dev_root=roots(sxm8)[1], proc_root=roots(sxm8)[2],
                            nvml=source(sxm8)).start()
    try:
        status, body = _get(srv.port, "/metrics")
        key = next(k for k in _series(body)
                   if k.startswith(f'tpu_device_health{{gpu="{SXM8[2]}"'))
        assert status == 200 and _series(body)[key] == 1
        set_aer_fatal(sxm8, SXM8[2], 5)
        after = _series(_get(srv.port, "/metrics")[1])
        assert after[key] == 0
        assert after["tpu_exporter_unhealthy_gpus"] == 1
        assert after[
            f'tpu_device_uncorrectable_errors_total{{gpu="{SXM8[2]}"}}'] == 5
        assert after["tpu_exporter_scrapes_total"] == 2
        assert _get(srv.port, "/healthz") == (200, "ok\n")
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(srv.port, "/nope")
        assert ei.value.code == 404
    finally:
        srv.stop()


def test_exporter_cli_serves_metrics_and_exits_on_sigterm(sxm8, tmp_path):
    sock = str(tmp_path / "hm.sock")
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    sysr, devr, procr = roots(sxm8)
    proc = subprocess.Popen(
        [sys.executable, "-m",
         "tpu_k8s_device_plugin_torch.cmd.metrics_exporter",
         "--socket", sock, "--metrics-port", str(port),
         "--sysfs-root", sysr, "--dev-root", devr, "--proc-root", procr,
         "--nvml-json", os.path.join(sxm8, "nvml.json")], cwd=REPO)
    try:
        body = None
        for _ in range(200):
            try:
                _, body = _get(port, "/metrics")
                break
            except OSError:
                time.sleep(0.1)
        assert body is not None, "CLI never served /metrics"
        s = _series(body)
        assert s["tpu_exporter_gpus"] == 8
        assert s["tpu_exporter_nvml_available"] == 1
        assert get_gpu_health(sock, timeout_s=5.0) == {
            g: constants.HEALTHY for g in SXM8}
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=10) == 143
        assert not os.path.exists(sock), "SIGTERM left a stale socket"
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
