"""The port's ``GpuContainerImpl`` on the NVIDIA fixtures: what it
advertises (only GPUs bound to nvidia with a device node), Enumerate's
NUMA hints, Allocate's nodes, control nodes and env, the preferred
allocation, the health overlays and verdicts, the cross-clique counter
and rediscovery."""

import json
import os
import shutil
import time

import pytest

from tpu_k8s_device_plugin_torch.allocator import BestEffortPolicy
from tpu_k8s_device_plugin_torch.gpu import nvml
from tpu_k8s_device_plugin_torch.gpu.device_impl import GpuContainerImpl
from tpu_k8s_device_plugin_torch.proto import deviceplugin_pb2 as pluginapi
from tpu_k8s_device_plugin_torch.types import DevicePluginContext, constants

SXM8 = ["0000:13:00.0", "0000:14:00.0", "0000:23:00.0", "0000:24:00.0",
        "0000:93:00.0", "0000:94:00.0", "0000:c3:00.0", "0000:c4:00.0"]
PCIE4 = ["0000:31:00.0", "0000:32:00.0", "0000:b1:00.0", "0000:b2:00.0"]
CONTROL = ["/dev/nvidiactl", "/dev/nvidia-uvm", "/dev/nvidia-uvm-tools"]


def make_impl(root, with_nvml=True, **kwargs):
    source = nvml.load(os.path.join(root, "nvml.json")) \
        if with_nvml and os.path.exists(os.path.join(root, "nvml.json")) \
        else None
    return GpuContainerImpl(sysfs_root=os.path.join(root, "sys"),
                            dev_root=os.path.join(root, "dev"),
                            proc_root=os.path.join(root, "proc"),
                            nvml=source, **kwargs)


def tree(testdata, name):
    return os.path.join(testdata, "nvidia", name)


@pytest.fixture
def copy_of(testdata, tmp_path):
    def copy(name):
        dst = tmp_path / name
        shutil.copytree(tree(testdata, name), dst, symlinks=True)
        return str(dst)
    return copy


def ctx_for(impl):
    ctx = DevicePluginContext(impl.get_resource_names()[0],
                              BestEffortPolicy())
    impl.start(ctx)
    return ctx


def allocate(impl, ctx, *groups):
    return impl.allocate(ctx, pluginapi.AllocateRequest(container_requests=[
        pluginapi.ContainerAllocateRequest(devices_ids=list(g))
        for g in groups]))


def uuid_of(root, bus):
    info = os.path.join(root, "proc", "driver", "nvidia", "gpus", bus,
                        "information")
    return {k.strip(): v.strip() for k, _, v in
            (line.partition(":") for line in open(info))}["GPU UUID"]


class TestContainerImpl:
    def test_resource_names(self, testdata):
        impl = make_impl(tree(testdata, "h100-sxm-8"))
        assert impl.get_resource_names() == ["gpu"]

    def test_enumerate_with_numa_topology(self, testdata):
        impl = make_impl(tree(testdata, "h100-sxm-8"))
        devs = impl.enumerate(ctx_for(impl))
        assert [d.ID for d in devs] == SXM8
        assert all(d.health == constants.HEALTHY for d in devs)
        assert [d.topology.nodes[0].ID for d in devs] == [0] * 4 + [1] * 4

    def test_allocate_nodes_control_nodes_and_env(self, testdata):
        root = tree(testdata, "h100-sxm-8")
        impl = make_impl(root)
        car = allocate(impl, ctx_for(impl), [SXM8[5], SXM8[2]]) \
            .container_responses[0]
        assert [(d.host_path, d.container_path) for d in car.devices] == [
            (os.path.join(root, "dev", "nvidia5"), "/dev/nvidia5"),
            (os.path.join(root, "dev", "nvidia2"), "/dev/nvidia2"),
        ] + [(os.path.join(root, "dev", os.path.basename(c)), c)
             for c in CONTROL]
        assert all(d.permissions == "rw" for d in car.devices)
        # UUIDs in allocation order; no CUDA_VISIBLE_DEVICES
        assert dict(car.envs) == {constants.ENV_NVIDIA_VISIBLE_DEVICES: ",".join(
            [uuid_of(root, SXM8[5]), uuid_of(root, SXM8[2])])}

    def test_control_nodes_once_per_container(self, testdata):
        impl = make_impl(tree(testdata, "h100-pcie-4"))
        resp = allocate(impl, ctx_for(impl), PCIE4[:2], PCIE4[2:3])
        for car, gpus in zip(resp.container_responses, (2, 1)):
            paths = [d.container_path for d in car.devices]
            assert paths[gpus:] == CONTROL
            assert len(set(paths)) == len(paths)

    def test_missing_control_node_is_not_mounted(self, copy_of):
        root = copy_of("h100-sxm-1")
        os.remove(os.path.join(root, "dev", "nvidia-uvm-tools"))
        impl = make_impl(root)
        car = allocate(impl, ctx_for(impl), ["0000:18:00.0"]) \
            .container_responses[0]
        assert [d.container_path for d in car.devices] == [
            "/dev/nvidia0", "/dev/nvidiactl", "/dev/nvidia-uvm"]

    def test_allocate_unknown_device(self, testdata):
        impl = make_impl(tree(testdata, "h100-sxm-8"))
        with pytest.raises(RuntimeError, match="unknown device"):
            allocate(impl, ctx_for(impl), ["bogus"])

    def test_preferred_allocation_uses_policy(self, testdata):
        impl = make_impl(tree(testdata, "h100-pcie-4"))
        ctx = ctx_for(impl)
        resp = impl.get_preferred_allocation(
            ctx, pluginapi.PreferredAllocationRequest(container_requests=[
                pluginapi.ContainerPreferredAllocationRequest(
                    available_deviceIDs=PCIE4[1:], allocation_size=2)]))
        assert list(resp.container_responses[0].deviceIDs) == PCIE4[2:]

    def test_options_and_first_fit_when_the_policy_fails(self, testdata):
        impl = make_impl(tree(testdata, "h100-pcie-4"))
        ctx = ctx_for(impl)
        assert impl.get_options(ctx).get_preferred_allocation_available
        ctx.set_allocator_error(True)
        assert not impl.get_options(ctx).get_preferred_allocation_available
        resp = impl.get_preferred_allocation(
            ctx, pluginapi.PreferredAllocationRequest(container_requests=[
                pluginapi.ContainerPreferredAllocationRequest(
                    available_deviceIDs=[PCIE4[1], PCIE4[2], PCIE4[3]],
                    allocation_size=2)]))
        assert list(resp.container_responses[0].deviceIDs) == PCIE4[1:3]

    def test_cross_clique_allocation_counted_and_warned(self, testdata,
                                                        caplog):
        impl = make_impl(tree(testdata, "h100-pcie-4"))
        ctx = ctx_for(impl)
        allocate(impl, ctx, PCIE4[:2])
        assert impl.counters() == {"cross_clique_allocations": 0}
        with caplog.at_level("WARNING",
                             logger="tpu_k8s_device_plugin_torch.gpu."
                                    "device_impl"):
            allocate(impl, ctx, [PCIE4[1], PCIE4[2]])
        assert impl.counters() == {"cross_clique_allocations": 1}
        assert any("spans 2 NVLink cliques" in r.message
                   for r in caplog.records)
        # four GPUs cannot fit one clique of two: not fragmentation
        allocate(impl, ctx, PCIE4)
        assert impl.counters() == {"cross_clique_allocations": 1}

    def test_no_nvlink_means_no_cross_clique_count(self, testdata):
        impl = make_impl(tree(testdata, "h100-sxm-8"), with_nvml=False)
        allocate(impl, ctx_for(impl), [SXM8[0], SXM8[7]])
        assert impl.counters() == {"cross_clique_allocations": 0}


class TestWhatIsAdvertised:
    def test_gpu_bound_to_vfio_is_not_advertised(self, copy_of):
        root = copy_of("h100-pcie-4")
        sysr = os.path.join(root, "sys")
        pci = os.path.realpath(os.path.join(sysr, "bus", "pci", "devices",
                                            PCIE4[3]))
        os.remove(os.path.join(sysr, "bus", "pci", "drivers", "nvidia",
                               PCIE4[3]))
        vfio = os.path.join(sysr, "bus", "pci", "drivers", "vfio-pci")
        os.makedirs(vfio)
        os.remove(os.path.join(pci, "driver"))
        os.symlink(os.path.relpath(vfio, pci), os.path.join(pci, "driver"))
        impl = make_impl(root)
        assert list(impl.gpus) == PCIE4[:3]
        # its bridge partner is a clique of one now
        assert impl.topology.topology_str == "1x2_1x1"

    def test_gpu_without_device_node_is_not_advertised(self, copy_of):
        """In a container sysfs lists every GPU of the host while only
        the allocated /dev/nvidiaN exists."""
        root = copy_of("h100-sxm-8")
        for i in range(8):
            if i != 6:
                os.remove(os.path.join(root, "dev", f"nvidia{i}"))
        impl = make_impl(root)
        assert list(impl.gpus) == [SXM8[6]]

    def test_no_node_at_all_raises(self, copy_of):
        root = copy_of("h100-sxm-1")
        os.remove(os.path.join(root, "dev", "nvidia0"))
        with pytest.raises(RuntimeError, match="device node"):
            make_impl(root)

    def test_no_gpu_raises(self, tmp_path):
        (tmp_path / "sys").mkdir()
        with pytest.raises(RuntimeError, match="no NVIDIA GPU"):
            make_impl(str(tmp_path), with_nvml=False)

    def test_nvml_only_node(self, testdata, tmp_path):
        """No PCI tree (a sandboxed container): NVML's GPU is advertised
        under its minor, and NVIDIA_VISIBLE_DEVICES names its UUID."""
        data = json.load(open(os.path.join(tree(testdata, "h100-sxm-8"),
                                           "nvml.json")))
        dev = dict(data["devices"][0], bus_id="", minor=3, index=0)
        (tmp_path / "nvml.json").write_text(json.dumps(
            {"driver_version": "580.159.03", "devices": [dev]}))
        (tmp_path / "sys").mkdir()
        (tmp_path / "dev").mkdir()
        for name in ("nvidia0", "nvidia3", "nvidiactl"):
            (tmp_path / "dev" / name).write_text("")
        impl = make_impl(str(tmp_path))
        assert list(impl.gpus) == ["nvidia3"]
        car = allocate(impl, ctx_for(impl), ["nvidia3"]) \
            .container_responses[0]
        assert [d.container_path for d in car.devices] == [
            "/dev/nvidia3", "/dev/nvidiactl"]
        assert car.envs[constants.ENV_NVIDIA_VISIBLE_DEVICES] == dev["uuid"]
        assert impl.simple_health_check()


class TestHealth:
    def test_update_health_simple_check(self, testdata):
        impl = make_impl(tree(testdata, "h100-sxm-8"))
        devs = impl.update_health(ctx_for(impl))
        assert all(d.health == constants.HEALTHY for d in devs)

    def test_exporter_overlay(self, testdata):
        impl = make_impl(tree(testdata, "h100-sxm-8"),
                         health_fn=lambda: {SXM8[3]: constants.UNHEALTHY})
        health = {d.ID: d.health for d in impl.update_health(ctx_for(impl))}
        assert health[SXM8[3]] == constants.UNHEALTHY
        assert health[SXM8[0]] == constants.HEALTHY

    def test_exporter_failure_degrades_to_node_check(self, testdata):
        def boom():
            raise RuntimeError("exporter down")
        impl = make_impl(tree(testdata, "h100-sxm-8"), health_fn=boom)
        assert all(d.health == constants.HEALTHY
                   for d in impl.update_health(ctx_for(impl)))

    def test_missing_node_demotes_the_node(self, copy_of):
        root = copy_of("h100-pcie-4")
        impl = make_impl(root)
        ctx = ctx_for(impl)
        os.remove(os.path.join(root, "dev", "nvidia2"))
        assert not impl.simple_health_check()
        assert all(d.health == constants.UNHEALTHY
                   for d in impl.update_health(ctx))

    def test_unbound_gpu_demotes_the_node(self, copy_of):
        root = copy_of("h100-pcie-4")
        impl = make_impl(root)
        os.remove(os.path.join(root, "sys", "bus", "pci", "drivers",
                               "nvidia", PCIE4[0]))
        assert not impl.simple_health_check()

    def test_hung_probe_demotes_every_device_then_recovers(self, testdata):
        gate = {"hang": True}

        def probe():
            if gate["hang"]:
                time.sleep(0.5)
            return {}
        impl = make_impl(tree(testdata, "h100-pcie-4"), health_fn=probe,
                         probe_watchdog_s=0.05)
        ctx = ctx_for(impl)
        assert all(d.health == constants.UNHEALTHY
                   for d in impl.update_health(ctx))
        gate["hang"] = False
        assert all(d.health == constants.HEALTHY
                   for d in impl.update_health(ctx))


class TestRediscovery:
    def test_no_change_is_noop(self, testdata):
        assert make_impl(tree(testdata, "h100-sxm-8")).rediscover() is False

    def test_lost_node_shrinks_the_list(self, copy_of):
        root = copy_of("h100-pcie-4")
        impl = make_impl(root)
        ctx = ctx_for(impl)
        os.remove(os.path.join(root, "dev", "nvidia1"))
        assert impl.rediscover() is True
        assert [d.ID for d in impl.enumerate(ctx)] == [
            PCIE4[0], PCIE4[2], PCIE4[3]]
        assert impl.topology.topology_str == "1x2_1x1"
        assert impl.rediscover() is False  # idempotent

    def test_unusable_host_keeps_the_last_state(self, copy_of):
        root = copy_of("h100-sxm-1")
        impl = make_impl(root)
        os.remove(os.path.join(root, "dev", "nvidia0"))
        assert impl.rediscover() is False
        assert list(impl.gpus) == ["0000:18:00.0"]
