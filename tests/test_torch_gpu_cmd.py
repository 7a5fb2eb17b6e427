"""The port's agent CLIs: flag validation (the slice flags with the
reference's rules and exit code 2), device-impl selection (the
reference's chain: container, then vf-passthrough, then pf-passthrough;
mixed naming with MIG profiles), and ``python -m
tpu_k8s_device_plugin_torch.cmd.device_plugin`` end to end on a fixture
root behind the reference's fake kubelet, alone and as two members of a
slice."""

import os
import signal
import subprocess
import sys
import time

import pytest

from fake_kubelet import FakeKubelet, ListAndWatchConsumer
from tpu_k8s_device_plugin.proto import deviceplugin_pb2 as refapi
from tpu_k8s_device_plugin_torch.cmd.device_plugin import (
    build_parser,
    check_slice_flags,
    main,
    select_device_impl,
    setup_slice,
)
from tpu_k8s_device_plugin_torch.gpu import nvml
from tpu_k8s_device_plugin_torch.gpu.device_impl import GpuContainerImpl
from tpu_k8s_device_plugin_torch.gpu.device_impl_vfio import (
    GpuPfImpl,
    GpuVfImpl,
)
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
        """mixed names whole GPUs nvidia.com/gpu, and each MIG profile
        nvidia.com/mig-<profile>; single refuses the heterogeneous MIG
        node, as the reference refuses mixed partition modes."""
        impl, _ = select_device_impl(args_for(
            testdata, "h100-sxm-1", "--resource-naming-strategy", "mixed"))
        assert impl.get_resource_names() == ["gpu"]
        mig_nvml = nvml.load(os.path.join(testdata, "nvidia", "h100-mig-4",
                                          "nvml.json"))
        impl, driver_type = select_device_impl(args_for(
            testdata, "h100-mig-4", "--resource-naming-strategy", "mixed"),
            mig_nvml)
        assert driver_type == "container"
        assert impl.get_resource_names() == ["gpu", "mig-1g.10gb",
                                             "mig-3g.40gb"]
        with pytest.raises(RuntimeError, match="mixed"):
            select_device_impl(args_for(testdata, "h100-mig-4",
                                        "--driver-type", "container"),
                               mig_nvml)

    def test_explicit_container(self, testdata):
        impl, driver_type = select_device_impl(
            args_for(testdata, "h100-sxm-1", "--driver-type", "container"))
        assert driver_type == "container" and len(impl.gpus) == 1

    @pytest.mark.parametrize("mode", ["vf-passthrough", "pf-passthrough"])
    def test_passthrough_names_its_item(self, testdata, mode):
        """Each passthrough host autodetects its mode (container and, on
        a PF host, vf found nothing), the explicit flag selects the same
        impl, and the mode is no chain: on a container host it fails
        loudly."""
        tree, cls = {"vf-passthrough": ("sriov-vf", GpuVfImpl),
                     "pf-passthrough": ("vfio-pf", GpuPfImpl)}[mode]
        impl, driver_type = select_device_impl(args_for(testdata, tree))
        assert isinstance(impl, cls) and driver_type == mode
        assert impl.get_resource_names() == ["gpu"]
        impl, driver_type = select_device_impl(args_for(
            testdata, tree, "--driver-type", mode,
            "--resource-naming-strategy", "mixed"))
        assert isinstance(impl, cls) and driver_type == mode
        assert impl.get_resource_names() == [
            "gpu_vf" if mode == "vf-passthrough" else "gpu_pf"]
        with pytest.raises(RuntimeError, match="no devices"):
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
    def test_slice_flags_name_their_item(self, testdata, tmp_path, flags):
        """The reference's slice-flag rules: workers or a grace without a
        rendezvous exit 2 before any device is touched; a rendezvous
        with fewer than 2 workers stops setup_slice; a state file alone
        is harmless."""
        args = build_parser().parse_args(flags)
        problem = check_slice_flags(args)
        if flags[0] in ("--slice-workers", "--slice-reshape-grace"):
            assert "without --slice-rendezvous" in problem
            assert main(flags + fixture_flags(testdata, "h100-sxm-1")) == 2
            return
        assert problem == ""
        if flags[0] == "--slice-rendezvous":
            impl, driver_type = select_device_impl(
                args_for(testdata, "h100-sxm-1"))
            with pytest.raises(SystemExit, match="slice-workers must be"):
                setup_slice(args, impl, driver_type)

    def test_slice_env_override_is_refused_too(self, monkeypatch,
                                               testdata):
        """The env overrides feed the same rules: a rendezvous from the
        environment still needs --slice-workers, a negative grace from
        the environment exits 2, and a passthrough impl refuses a
        slice."""
        monkeypatch.setenv(constants.ENV_SLICE_RENDEZVOUS, "h0:8475")
        monkeypatch.setenv(constants.ENV_SLICE_WORKERS, "2")
        monkeypatch.setenv(constants.ENV_SLICE_RESHAPE_GRACE, "-1")
        args = build_parser().parse_args([])
        assert (args.slice_rendezvous, args.slice_workers,
                args.slice_reshape_grace) == ("h0:8475", 2, -1.0)
        assert "must be >= 0" in check_slice_flags(args)
        assert main(fixture_flags(testdata, "h100-sxm-1")) == 2
        impl, driver_type = select_device_impl(args_for(testdata,
                                                        "vfio-pf"))
        with pytest.raises(SystemExit, match="container driver type"):
            setup_slice(args, impl, driver_type)

    def test_defaults_are_off(self):
        args = build_parser().parse_args([])
        assert check_slice_flags(args) == ""
        assert args.slice_rendezvous == "" and args.slice_workers == 0
        assert args.slice_master_port == constants.SLICE_MASTER_PORT


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


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_two_members_form_a_slice(testdata, tmp_path):
    """Two CLI processes on one box, each under its own hostname (the
    coordinator's is 127.0.0.1, so it self-elects and is dialable): both
    register, and a full-host Allocate on each hands out one
    torch.distributed contract with ranks 0 and 1."""
    port = _free_port()
    procs, kubelets = [], []
    try:
        for name in ("127.0.0.1", "host-b"):
            kubelet = FakeKubelet(str(tmp_path / f"{name}-dp")).start()
            kubelets.append(kubelet)
            argv = (["--kubelet-dir", kubelet.dir, "--pulse", "1",
                     "--slice-rendezvous", f"127.0.0.1:{port}",
                     "--slice-workers", "2", "--slice-master-port", "29555",
                     "--slice-state-file",
                     str(tmp_path / f"{name}-membership.json")]
                    + fixture_flags(testdata, "h100-sxm-8"))
            code = ("import socket, sys\n"
                    f"socket.gethostname = lambda: {name!r}\n"
                    "from tpu_k8s_device_plugin_torch.cmd.device_plugin "
                    "import main\n"
                    f"sys.exit(main({argv!r}))")
            procs.append(subprocess.Popen([sys.executable, "-c", code],
                                          cwd=REPO))
        envs = []
        for kubelet in kubelets:
            assert kubelet.wait_for_registration(timeout=30.0)
            stub = kubelet.plugin_stub(kubelet.registrations[0].endpoint)
            ids = [d.ID for d in
                   ListAndWatchConsumer(stub).next_frame(timeout=10.0).devices]
            env = {}
            for _ in range(100):  # the slice forms within a few polls
                env = dict(stub.Allocate(refapi.AllocateRequest(
                    container_requests=[refapi.ContainerAllocateRequest(
                        devices_ids=ids)])).container_responses[0].envs)
                if constants.ENV_RANK in env:
                    break
                time.sleep(0.2)
            envs.append(env)
        for rank, env in enumerate(envs):
            assert env[constants.ENV_MASTER_ADDR] == "127.0.0.1"
            assert env[constants.ENV_MASTER_PORT] == "29555"
            assert env[constants.ENV_WORLD_SIZE] == "2"
            assert env[constants.ENV_RANK] == str(rank)
            assert env[constants.ENV_SLICE_WORKER_HOSTNAMES] == \
                "127.0.0.1,host-b"
        for proc in procs:
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=15) == 143
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for kubelet in kubelets:
            kubelet.stop()
