"""The port's agent CLIs: flag validation, device-impl selection (the
passthrough modes, mixed naming and the slice flags refuse, naming their ROADMAP
items), and ``python -m tpu_k8s_device_plugin_torch.cmd.device_plugin``
end to end on a fixture root behind the reference's fake kubelet."""

import os
import signal
import subprocess
import sys

import pytest

from fake_kubelet import FakeKubelet, ListAndWatchConsumer
from tpu_k8s_device_plugin.proto import deviceplugin_pb2 as refapi
from tpu_k8s_device_plugin_torch.cmd.device_plugin import (
    build_parser,
    check_slice_flags,
    main,
    select_device_impl,
)
from tpu_k8s_device_plugin_torch.gpu.device_impl import GpuContainerImpl
from tpu_k8s_device_plugin_torch.types import constants

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def fixture_flags(testdata, name):
    root = os.path.join(testdata, "nvidia", name)
    flags = ["--sysfs-root", os.path.join(root, "sys"),
             "--dev-root", os.path.join(root, "dev"),
             "--proc-root", os.path.join(root, "proc")]
    if os.path.exists(os.path.join(root, "nvml.json")):
        flags += ["--nvml-json", os.path.join(root, "nvml.json")]
    return flags


def args_for(testdata, name, *extra):
    return build_parser().parse_args(fixture_flags(testdata, name)
                                     + list(extra))


class TestSelection:
    def test_autodetect_selects_container(self, testdata):
        impl, driver_type = select_device_impl(args_for(testdata,
                                                        "h100-sxm-1"))
        assert isinstance(impl, GpuContainerImpl)
        assert driver_type == "container"
        assert impl.get_resource_names() == ["gpu"]

    def test_single_naming_names_whole_gpus(self, testdata):
        impl, _ = select_device_impl(args_for(
            testdata, "h100-sxm-1", "--resource-naming-strategy", "single"))
        assert impl.get_resource_names() == ["gpu"]

    def test_mixed_naming_names_its_item(self, testdata):
        with pytest.raises(NotImplementedError, match="item 8.2"):
            select_device_impl(args_for(
                testdata, "h100-sxm-1", "--resource-naming-strategy",
                "mixed"))

    def test_explicit_container(self, testdata):
        impl, driver_type = select_device_impl(
            args_for(testdata, "h100-sxm-1", "--driver-type", "container"))
        assert driver_type == "container" and len(impl.gpus) == 1

    @pytest.mark.parametrize("mode", ["vf-passthrough", "pf-passthrough"])
    def test_passthrough_names_its_item(self, testdata, mode):
        with pytest.raises(NotImplementedError, match="item 8.2"):
            select_device_impl(args_for(testdata, "h100-sxm-1",
                                        "--driver-type", mode))

    def test_no_gpus_anywhere_exits(self, tmp_path):
        (tmp_path / "sys").mkdir()
        args = build_parser().parse_args([
            "--sysfs-root", str(tmp_path / "sys"),
            "--dev-root", str(tmp_path / "dev"),
            "--proc-root", str(tmp_path / "proc")])
        with pytest.raises(SystemExit, match="no usable NVIDIA"):
            select_device_impl(args)

    def test_explicit_container_fails_loudly(self, tmp_path):
        (tmp_path / "sys").mkdir()
        args = build_parser().parse_args([
            "--sysfs-root", str(tmp_path / "sys"), "--driver-type",
            "container"])
        with pytest.raises(RuntimeError):
            select_device_impl(args)


class TestFlags:
    def test_negative_pulse_rejected(self, testdata):
        assert main(["--pulse", "-1"] + fixture_flags(testdata,
                                                      "h100-sxm-1")) == 2

    def test_unknown_driver_type_rejected(self):
        with pytest.raises(SystemExit):
            build_parser().parse_args(["--driver-type", "tpu"])

    def test_unknown_strategy_rejected(self):
        with pytest.raises(SystemExit):
            build_parser().parse_args(["--resource-naming-strategy", "both"])

    @pytest.mark.parametrize("flags", [
        ["--slice-rendezvous", "h0:8475"], ["--slice-workers", "2"],
        ["--slice-reshape-grace", "5"], ["--slice-state-file", "/x"]])
    def test_slice_flags_name_their_item(self, flags):
        with pytest.raises(NotImplementedError, match="item 8.3"):
            check_slice_flags(build_parser().parse_args(flags))

    def test_slice_env_override_is_refused_too(self, monkeypatch):
        monkeypatch.setenv(constants.ENV_SLICE_RENDEZVOUS, "h0:8475")
        with pytest.raises(NotImplementedError, match="item 8.3"):
            check_slice_flags(build_parser().parse_args([]))

    def test_defaults_are_off(self):
        check_slice_flags(build_parser().parse_args([]))


def test_cli_end_to_end_on_a_fixture_root(testdata, tmp_path):
    """The CLI as a process: it registers nvidia.com/gpu with the fake
    kubelet, answers ListAndWatch and Allocate, and leaves no socket
    behind after SIGTERM."""
    kubelet = FakeKubelet(str(tmp_path / "device-plugins")).start()
    proc = subprocess.Popen(
        [sys.executable, "-m",
         "tpu_k8s_device_plugin_torch.cmd.device_plugin",
         "--kubelet-dir", kubelet.dir, "--pulse", "1"]
        + fixture_flags(testdata, "h100-sxm-8"), cwd=REPO)
    try:
        assert kubelet.wait_for_registration(timeout=30.0)
        [reg] = kubelet.registrations
        assert reg.resource_name == "nvidia.com/gpu"
        stub = kubelet.plugin_stub(reg.endpoint)
        consumer = ListAndWatchConsumer(stub)
        frame = consumer.next_frame(timeout=10.0)
        assert len(frame.devices) == 8
        ids = [d.ID for d in frame.devices]
        pref = stub.GetPreferredAllocation(refapi.PreferredAllocationRequest(
            container_requests=[refapi.ContainerPreferredAllocationRequest(
                available_deviceIDs=ids, allocation_size=4)]))
        assert list(pref.container_responses[0].deviceIDs) == ids[:4]
        alloc = stub.Allocate(refapi.AllocateRequest(container_requests=[
            refapi.ContainerAllocateRequest(devices_ids=ids[:4])]))
        car = alloc.container_responses[0]
        assert [d.container_path for d in car.devices][:4] == [
            f"/dev/nvidia{i}" for i in range(4)]
        assert len(car.envs[constants.ENV_NVIDIA_VISIBLE_DEVICES]
                   .split(",")) == 4
        # the pulse resends
        assert len(consumer.next_frame(timeout=10.0).devices) == 8
        consumer.cancel()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=15) == 143
        assert not os.path.exists(os.path.join(kubelet.dir, reg.endpoint))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        kubelet.stop()
