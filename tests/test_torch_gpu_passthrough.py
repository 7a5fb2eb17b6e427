"""The port's VM-passthrough impls held to the reference's.

``testdata/nvidia/vfio-pf`` and ``sriov-vf`` are the reference's
``vfio-pf`` and ``vfio-vf`` trees with NVIDIA's vendor, device and
driver names (``testdata/nvidia/make_fixtures.py``): the same PCI
addresses, IOMMU groups and NUMA nodes.  So each impl must answer what
the reference's answers there — the same devices in the same IOMMU-group
order, the same Allocate device specs, the same PCI addresses in the
env (only the variable's name differs), the same health — and the raw
PCI scan, the labeller and the CLI must see the passthrough host.
"""

import os
import shutil

import pytest

from tpu_k8s_device_plugin.proto import deviceplugin_pb2 as refapi
from tpu_k8s_device_plugin.tpu import vfio as ref_vfio
from tpu_k8s_device_plugin.tpu.device_impl_vfio import TpuPfImpl, TpuVfImpl
from tpu_k8s_device_plugin.types import DevicePluginContext as RefContext
from tpu_k8s_device_plugin_torch.gpu import discovery, vfio
from tpu_k8s_device_plugin_torch.gpu.device_impl_vfio import (
    GpuPfImpl,
    GpuVfImpl,
)
from tpu_k8s_device_plugin_torch.labeller import LabelContext, generate_labels
from tpu_k8s_device_plugin_torch.proto import deviceplugin_pb2 as pluginapi
from tpu_k8s_device_plugin_torch.types import DevicePluginContext, constants

PAIRS = {"pf": ("vfio-pf", "vfio-pf", TpuPfImpl, GpuPfImpl),
         "vf": ("vfio-vf", "sriov-vf", TpuVfImpl, GpuVfImpl)}


def roots(testdata, kind):
    ref, ours, _, _ = PAIRS[kind]
    return (os.path.join(testdata, ref, "sys"),
            os.path.join(testdata, "nvidia", ours, "sys"))


def impls(testdata, kind, strategy="single", ref_health=None,
          health=None, sysfs=None):
    ref_cls, cls = PAIRS[kind][2:]
    ref_root, root = roots(testdata, kind)
    return (ref_cls(resource_naming_strategy=strategy, sysfs_root=ref_root,
                    dev_root="/dev", health_fn=ref_health),
            cls(resource_naming_strategy=strategy, sysfs_root=sysfs or root,
                dev_root="/dev", health_fn=health))


def test_pf_mapping_equals_the_reference(testdata):
    ref_root, root = roots(testdata, "pf")
    assert {g: (i.pci_address, i.numa_node)
            for g, i in vfio.get_pf_mapping(root).items()} == \
        {g: (i.pci_address, i.numa_node)
         for g, i in ref_vfio.get_pf_mapping(ref_root).items()}
    assert len(vfio.get_pf_mapping(root)) == 4


def test_vf_mapping_equals_the_reference(testdata):
    ref_root, root = roots(testdata, "vf")
    ours = vfio.get_vf_mapping(root)
    theirs = ref_vfio.get_vf_mapping(ref_root)
    assert {g: (i.pci_address, i.pf_pci_address, i.numa_node)
            for g, i in ours.items()} == \
        {g: (i.pci_address, i.pf_pci_address, i.numa_node)
         for g, i in theirs.items()}
    assert len(ours) == 4  # 2 PFs x 2 VFs
    # the PFs of a PF host are not VFs, and a VF host has no vfio PFs
    assert vfio.get_vf_mapping(roots(testdata, "pf")[1]) == {}
    assert vfio.get_pf_mapping(root) == {}


def test_module_versions(testdata):
    v = vfio.get_nvidia_module_versions(roots(testdata, "vf")[1])
    assert v["version"] == "550.54.15" and v["srcversion"]


@pytest.mark.parametrize("kind", ["pf", "vf"])
@pytest.mark.parametrize("strategy", ["single", "mixed"])
def test_enumerate_and_allocate_equal_the_reference(testdata, kind,
                                                    strategy):
    ref, ours = impls(testdata, kind, strategy)
    [ref_res] = ref.get_resource_names()
    [res] = ours.get_resource_names()
    assert res == {"single": "gpu", "mixed": f"gpu_{kind}"}[strategy]
    assert ref_res.replace("tpu", "gpu") == res
    ref_ctx, ctx = RefContext(ref_res), DevicePluginContext(res)
    ref.start(ref_ctx)
    ours.start(ctx)
    # no topology allocator for passthrough, as in the reference
    assert ctx.get_allocator_error() and ref_ctx.get_allocator_error()
    assert not ours.get_options(ctx).get_preferred_allocation_available
    devs = ours.enumerate(ctx)
    assert [(d.ID, d.health, [n.ID for n in d.topology.nodes])
            for d in devs] == \
        [(d.ID, d.health, [n.ID for n in d.topology.nodes])
         for d in ref.enumerate(ref_ctx)]
    # the reference's IOMMU-group order: numeric
    assert [d.ID for d in devs] == sorted((d.ID for d in devs), key=int)
    ids = [d.ID for d in devs]
    for pick in (ids[:1], ids[1:3], ids):
        car = ours.allocate(ctx, pluginapi.AllocateRequest(
            container_requests=[pluginapi.ContainerAllocateRequest(
                devices_ids=pick)])).container_responses[0]
        ref_car = ref.allocate(ref_ctx, refapi.AllocateRequest(
            container_requests=[refapi.ContainerAllocateRequest(
                devices_ids=pick)])).container_responses[0]
        assert [(d.host_path, d.container_path, d.permissions)
                for d in car.devices] == \
            [(d.host_path, d.container_path, d.permissions)
             for d in ref_car.devices]
        assert car.devices[-1].host_path == "/dev/vfio/vfio"
        [(key, value)] = car.envs.items()
        [(ref_key, ref_value)] = ref_car.envs.items()
        assert value == ref_value
        assert key == f"PCI_RESOURCE_NVIDIA_COM_{res.upper()}"
        assert ref_key == f"PCI_RESOURCE_GOOGLE_COM_{ref_res.upper()}"
    with pytest.raises(RuntimeError, match="unknown IOMMU group"):
        ours.allocate(ctx, pluginapi.AllocateRequest(container_requests=[
            pluginapi.ContainerAllocateRequest(devices_ids=["999"])]))


@pytest.mark.parametrize("kind", ["pf", "vf"])
def test_health_equals_the_reference(testdata, tmp_path, kind):
    """The same per-PCI-address health map gives the same verdicts (a
    VF takes its PF's); without the host driver, every device is
    Unhealthy."""
    bad = {"0000:00:04.0": constants.UNHEALTHY}
    ref, ours = impls(testdata, kind, ref_health=lambda: dict(bad),
                      health=lambda: dict(bad))
    ctx, ref_ctx = DevicePluginContext("gpu"), RefContext("tpu")
    got = {d.ID: d.health for d in ours.update_health(ctx)}
    assert got == {d.ID: d.health for d in ref.update_health(ref_ctx)}
    assert sum(h == constants.UNHEALTHY for h in got.values()) == \
        (1 if kind == "pf" else 2)
    # the host driver unbound: the node check demotes everything
    root = str(tmp_path / "tree")
    shutil.copytree(os.path.dirname(roots(testdata, kind)[1]), root,
                    symlinks=True)
    ours = impls(testdata, kind, sysfs=os.path.join(root, "sys"))[1]
    driver = constants.VFIO_DRIVER_NAME if kind == "pf" \
        else constants.NVIDIA_DRIVER_NAME
    shutil.rmtree(os.path.join(root, "sys", "bus", "pci", "drivers",
                               driver))
    assert {d.health for d in ours.update_health(ctx)} == {
        constants.UNHEALTHY}


def test_wrong_host_raises(testdata):
    with pytest.raises(RuntimeError, match="no devices"):
        GpuVfImpl(sysfs_root=roots(testdata, "pf")[1])
    with pytest.raises(RuntimeError, match="no devices"):
        GpuPfImpl(sysfs_root=roots(testdata, "vf")[1])


def test_raw_scan_finds_the_vfio_bound_gpus(testdata):
    """Nothing bound to nvidia: discovery falls back to the raw scan by
    vendor, as the reference's falls back off the accel class."""
    root = os.path.join(testdata, "nvidia", "vfio-pf")
    gpus, topo = discovery.get_gpus(os.path.join(root, "sys"), "/dev",
                                    os.path.join(root, "proc"))
    assert sorted(gpus) == [f"0000:00:0{4 + i}.0" for i in range(4)]
    assert {(g.source, g.minor, g.dev_path)
            for g in gpus.values()} == {("pci", -1, "")}
    assert [g.index for g in gpus.values()] == [0, 1, 2, 3]
    assert topo.spec is not None and topo.spec.product == "H100-SXM5-80GB"


@pytest.mark.parametrize("kind,mode", [("pf", "pf-passthrough"),
                                       ("vf", "vf-passthrough")])
def test_labels_on_passthrough_hosts(testdata, tmp_path, kind, mode):
    root = os.path.dirname(roots(testdata, kind)[1])
    labels = generate_labels(LabelContext.collect(
        driver_type=mode, sysfs_root=os.path.join(root, "sys"),
        dev_root=os.path.join(root, "dev"),
        proc_root=os.path.join(root, "proc"),
        slice_state_path=str(tmp_path / "none.json")))
    short = {k.split(".", 2)[-1]: v for k, v in labels.items()
             if k.startswith(constants.LABEL_PREFIX + ".")}
    assert short["mode"] == mode
    assert short["device-id"] == "0x2330"
    assert short["count"] == ("4" if kind == "pf" else "2")
    assert short["driver-version"] == "550.54.15"
