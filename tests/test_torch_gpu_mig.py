"""MIG partitions, the port's counterpart of the reference's TensorCore
partitions.

Stated values on ``testdata/nvidia/h100-mig-4`` (GPUs 0 and 1 whole,
GPU 2 in seven 1g.10gb devices, GPU 3 in two 3g.40gb), and the
reference's core-partition rules on an equivalent tree: the
``v5p-8-hetero`` host (chips 0-1 whole, chips 2-3 in two cores each)
against the MIG tree with GPUs 2-3 in two 3g.40gb devices each — the
same expansion, the same mixed resource set, the same refusal under
``single``, and the same allocator picks where partitions share
parents.
"""

import json
import os
import random
import shutil
import subprocess

import pytest

from test_torch_gpu_discovery import STUB_NVML
from tpu_k8s_device_plugin.allocator import (
    BestEffortPolicy as RefPolicy,
    devices_from_discovery as ref_devices_from_discovery,
)
from tpu_k8s_device_plugin.tpu.device_impl import TpuContainerImpl
from tpu_k8s_device_plugin.tpu.discovery import (
    get_tpu_chips,
    unique_partition_config_count as ref_counts,
)
from tpu_k8s_device_plugin.types import DevicePluginContext as RefContext
from tpu_k8s_device_plugin_torch.allocator import (
    BestEffortPolicy,
    devices_from_discovery,
)
from tpu_k8s_device_plugin_torch.gpu import discovery, nvml
from tpu_k8s_device_plugin_torch.gpu.device_impl import GpuContainerImpl
from tpu_k8s_device_plugin_torch.labeller import LabelContext, generate_labels
from tpu_k8s_device_plugin_torch.proto import deviceplugin_pb2 as pluginapi
from tpu_k8s_device_plugin_torch.types import DevicePluginContext, constants

MIG3 = "mig-3g.40gb"
MIG1 = "mig-1g.10gb"


def tree(testdata):
    return os.path.join(testdata, "nvidia", "h100-mig-4")


def make_impl(root, strategy="mixed", **kw):
    return GpuContainerImpl(
        os.path.join(root, "sys"), os.path.join(root, "dev"),
        os.path.join(root, "proc"),
        nvml.load(os.path.join(root, "nvml.json")),
        resource_naming_strategy=strategy, **kw)


def ctx_for(impl, resource):
    ctx = DevicePluginContext(resource, BestEffortPolicy())
    impl.start(ctx)
    return ctx


def allocate(impl, ctx, ids):
    return impl.allocate(ctx, pluginapi.AllocateRequest(container_requests=[
        pluginapi.ContainerAllocateRequest(devices_ids=ids)
    ])).container_responses[0]


def equivalent_tree(testdata, tmp_path, profile=(3, 40192), gpus=(2, 3)):
    """A copy of the MIG tree with GPUs *gpus* in two devices of one
    profile each and the others whole."""
    root = str(tmp_path / "mig")
    shutil.copytree(tree(testdata), root, symlinks=True)
    path = os.path.join(root, "nvml.json")
    data = json.load(open(path))
    for i, dev in enumerate(data["devices"]):
        if i in gpus:
            dev["mig_mode"] = "enabled"
            dev["mig_devices"] = [
                {"index": k, "uuid": f"MIG-{k:08x}-0000-0000-0000-{i:012x}",
                 "gpu_instance_id": gi, "compute_instance_id": 0,
                 "gpu_slices": profile[0], "compute_slices": profile[0],
                 "memory_mb": profile[1]} for k, gi in enumerate((1, 2))]
        else:
            dev["mig_mode"] = "disabled"
            dev.pop("mig_devices", None)
    json.dump(data, open(path, "w"))
    return root


# ---------------------------------------------------------------------------
# Stated values
# ---------------------------------------------------------------------------

def test_nvml_fixture_reads_the_mig_devices(testdata):
    gpus = nvml.load(os.path.join(tree(testdata), "nvml.json")).gpus()
    assert [g.mig_mode for g in gpus] == ["disabled", "disabled",
                                          "enabled", "enabled"]
    assert [m.profile for m in gpus[2].mig_devices] == ["1g.10gb"] * 7
    assert [m.gpu_instance_id for m in gpus[2].mig_devices] == list(
        range(7, 14))
    assert [(m.profile, m.gpu_instance_id, m.compute_instance_id)
            for m in gpus[3].mig_devices] == [("3g.40gb", 1, 0),
                                              ("3g.40gb", 2, 0)]
    assert all(m.uuid.startswith("MIG-") for m in gpus[3].mig_devices)


def test_discovery_resolves_capability_minors(testdata):
    root = tree(testdata)
    minors = discovery.read_mig_minors(os.path.join(root, "proc"))
    assert minors[(0, 0, -1)] == 3 and minors[(0, 0, 0)] == 4
    assert minors[(3, 1, -1)] == 3 + 3 * 135 + 9
    gpus, _ = discovery.get_gpus(
        os.path.join(root, "sys"), os.path.join(root, "dev"),
        os.path.join(root, "proc"),
        nvml.load(os.path.join(root, "nvml.json")))
    g2, g3 = gpus["0000:b1:00.0"], gpus["0000:b2:00.0"]
    assert g2.partitioned and g3.partitioned
    assert not gpus["0000:31:00.0"].partitioned
    assert [m.id for m in g3.mig] == ["0000:b2:00.0#mig1.0",
                                      "0000:b2:00.0#mig2.0"]
    assert [(m.gi_cap_minor, m.ci_cap_minor) for m in g3.mig] == [
        (417, 418), (426, 427)]
    assert g2.mig[0].gi_cap_minor == 3 + 2 * 135 + 7 * 9
    assert discovery.unique_partition_config_count(gpus) == {
        "gpu": 2, MIG1: 1, MIG3: 1}
    assert not discovery.is_homogeneous(gpus)


def test_mixed_names_gpu_and_each_profile(testdata):
    impl = make_impl(tree(testdata))
    assert impl.get_resource_names() == ["gpu", MIG1, MIG3]
    assert len(impl.enumerate(ctx_for(impl, "gpu"))) == 2
    assert len(impl.enumerate(ctx_for(impl, MIG1))) == 7
    assert [d.ID for d in impl.enumerate(ctx_for(impl, MIG3))] == [
        "0000:b2:00.0#mig1.0", "0000:b2:00.0#mig2.0"]
    numa = {d.topology.nodes[0].ID
            for d in impl.enumerate(ctx_for(impl, MIG1))}
    assert numa == {1}


def test_single_refuses_a_heterogeneous_node(testdata):
    with pytest.raises(RuntimeError, match="resource_naming_strategy=mixed"):
        make_impl(tree(testdata), strategy="single")


def test_single_names_uniform_mig_devices_gpu(testdata, tmp_path):
    root = equivalent_tree(testdata, tmp_path, gpus=(0, 1, 2, 3))
    impl = make_impl(root, strategy="single")
    assert impl.get_resource_names() == ["gpu"]
    devs = impl.enumerate(ctx_for(impl, "gpu"))
    assert len(devs) == 8 and all("#mig" in d.ID for d in devs)
    # under mixed the same node names its one profile
    assert make_impl(root).get_resource_names() == [MIG3]


def test_allocate_a_mig_device(testdata):
    root = tree(testdata)
    impl = make_impl(root)
    ctx = ctx_for(impl, MIG3)
    car = allocate(impl, ctx, ["0000:b2:00.0#mig2.0"])
    dev = os.path.join(root, "dev")
    assert [(d.host_path, d.container_path) for d in car.devices] == [
        (os.path.join(dev, "nvidia3"), "/dev/nvidia3"),
        (os.path.join(dev, "nvidiactl"), "/dev/nvidiactl"),
        (os.path.join(dev, "nvidia-uvm"), "/dev/nvidia-uvm"),
        (os.path.join(dev, "nvidia-uvm-tools"), "/dev/nvidia-uvm-tools"),
        (os.path.join(dev, "nvidia-caps", "nvidia-cap426"),
         "/dev/nvidia-caps/nvidia-cap426"),
        (os.path.join(dev, "nvidia-caps", "nvidia-cap427"),
         "/dev/nvidia-caps/nvidia-cap427")]
    want = json.load(open(os.path.join(root, "nvml.json")))[
        "devices"][3]["mig_devices"][1]["uuid"]
    assert car.envs[constants.ENV_NVIDIA_VISIBLE_DEVICES] == want
    assert constants.ENV_CUDA_VISIBLE_DEVICES not in car.envs
    # two MIG devices of one GPU: its node once, both devices' caps
    car = allocate(impl, ctx, ["0000:b2:00.0#mig1.0", "0000:b2:00.0#mig2.0"])
    paths = [d.container_path for d in car.devices]
    assert paths.count("/dev/nvidia3") == 1 and len(paths) == 8
    assert len(car.envs[constants.ENV_NVIDIA_VISIBLE_DEVICES].split(",")) == 2
    # whole GPUs are unchanged
    car = allocate(impl, ctx_for(impl, "gpu"), ["0000:31:00.0"])
    assert car.devices[0].container_path == "/dev/nvidia0"
    assert car.envs[constants.ENV_NVIDIA_VISIBLE_DEVICES].startswith("GPU-")


def test_mig_device_health_is_its_parent_gpu(testdata):
    impl = make_impl(tree(testdata), health_fn=lambda: {
        "0000:b1:00.0": constants.UNHEALTHY})
    health = {d.ID: d.health for d in impl.update_health(ctx_for(impl,
                                                                 MIG1))}
    assert len(health) == 7
    assert set(health.values()) == {constants.UNHEALTHY}
    assert {d.health for d in impl.update_health(ctx_for(impl, MIG3))} \
        == {constants.HEALTHY}


def test_mig_mode_label_mixed(testdata, tmp_path):
    root = tree(testdata)
    labels = generate_labels(LabelContext.collect(
        sysfs_root=os.path.join(root, "sys"),
        dev_root=os.path.join(root, "dev"),
        proc_root=os.path.join(root, "proc"),
        nvml=nvml.load(os.path.join(root, "nvml.json")),
        slice_state_path=str(tmp_path / "none.json")))
    assert labels[f"{constants.LABEL_PREFIX}.mig-mode"] == "mixed"
    assert labels[f"{constants.LABEL_PREFIX}.partitioning-supported"] == \
        "true"


def test_ctypes_binding_reads_mig_devices(tmp_path):
    """The real binding's MIG calls (handles, instance ids, the
    attributes struct) against a stub libnvidia-ml built here."""
    cc = shutil.which("gcc") or shutil.which("cc")
    if cc is None:
        pytest.skip("no C compiler to build the stub NVML")
    src = STUB_NVML.replace("*cur = 0; *pend = 0;", "*cur = 1; *pend = 1;")
    src += r"""
typedef struct { unsigned mp, ce, dec, enc, jpg, ofa, gis, cis;
                 unsigned long long mem; } attrs_t;
static int mig[3];
int nvmlDeviceGetMaxMigDeviceCount(void *h, unsigned *n) {
  H(h); *n = 7; return 0; }
int nvmlDeviceGetMigDeviceHandleByIndex(void *h, unsigned i, void **m) {
  H(h); if (i > 2 || i == 1) return 6; *m = &mig[i]; return 0; }
int nvmlDeviceGetGpuInstanceId(void *m, unsigned *id) {
  *id = (int *)m == &mig[0] ? 1 : 2; return 0; }
int nvmlDeviceGetComputeInstanceId(void *m, unsigned *id) {
  *id = 0; return 0; }
int nvmlDeviceGetAttributes_v2(void *m, attrs_t *a) {
  a->gis = 3; a->cis = (int *)m == &mig[0] ? 3 : 1;
  a->mem = 40192; return 0; }
"""
    src = src.replace(
        'int nvmlDeviceGetUUID(void *h, char *b, unsigned n) {\n'
        '  H(h); snprintf',
        'int nvmlDeviceGetUUID(void *h, char *b, unsigned n) {\n'
        '  if ((int *)h == &mig[0]) { snprintf(b, n, '
        '"MIG-11111111-2222-3333-4444-555555555555"); return 0; }\n'
        '  if ((int *)h == &mig[2]) return 2;\n'
        '  H(h); snprintf')
    # the MIG handles are declared after the UUID call; declare first
    src = src.replace("static int dev = 7;",
                      "static int dev = 7;\nstatic int mig[3];")
    src = src.replace("\nstatic int mig[3];\nint nvmlDeviceGetMax",
                      "\nint nvmlDeviceGetMax")
    (tmp_path / "stub.c").write_text(src)
    lib = tmp_path / "libnvidia-ml-stub.so"
    subprocess.run([cc, "-shared", "-fPIC", "-o", str(lib),
                    str(tmp_path / "stub.c")], check=True, timeout=60)
    [g] = nvml.Nvml(str(lib)).gpus()
    assert g.mig_mode == "enabled"
    assert [(m.index, m.uuid, m.gpu_instance_id, m.compute_instance_id,
             m.profile) for m in g.mig_devices] == [
        (0, "MIG-11111111-2222-3333-4444-555555555555", 1, 0, "3g.40gb"),
        (2, "", 2, 0, "1c.3g.40gb")]


# ---------------------------------------------------------------------------
# The reference's core-partition rules on an equivalent tree
# ---------------------------------------------------------------------------

def ref_impl(testdata, strategy="mixed"):
    root = os.path.join(testdata, "v5p-8-hetero")
    return TpuContainerImpl(
        resource_naming_strategy=strategy,
        sysfs_root=os.path.join(root, "sys"),
        dev_root=os.path.join(root, "dev"),
        tpu_env_path=os.path.join(root, "run", "tpu", "tpu-env"))


def _key(devices):
    """Devices as (parent ordinal, partition index, partitioned)."""
    return [(d.chip_index if hasattr(d, "chip_index") else d.index,
             d.core_index if hasattr(d, "core_index") else d.part_index,
             "#" in d.id) for d in devices]


def test_expansion_follows_the_reference(testdata, tmp_path):
    root = os.path.join(testdata, "v5p-8-hetero")
    chips, _ = get_tpu_chips(os.path.join(root, "sys"),
                             os.path.join(root, "dev"),
                             os.path.join(root, "run", "tpu", "tpu-env"))
    ours = make_impl(equivalent_tree(testdata, tmp_path)).gpus
    for part in (None, True, False):
        assert _key(devices_from_discovery(ours, partitioned=part)) == \
            _key(ref_devices_from_discovery(chips, partitioned=part))
    assert sorted(ref_counts(chips).values()) == sorted(
        discovery.unique_partition_config_count(ours).values()) == [2, 2]


def test_naming_and_refusal_follow_the_reference(testdata, tmp_path):
    root = equivalent_tree(testdata, tmp_path)
    ref, ours = ref_impl(testdata), make_impl(root)
    rename = {"tpu": "gpu", "tpucore": MIG3}
    assert [rename[r] for r in ref.get_resource_names()] == \
        ours.get_resource_names()
    for r in ref.get_resource_names():
        assert len(ref.enumerate(RefContext(r))) == \
            len(ours.enumerate(DevicePluginContext(rename[r])))
    with pytest.raises(RuntimeError, match="mixed"):
        ref_impl(testdata, "single")
    with pytest.raises(RuntimeError, match="mixed"):
        make_impl(root, "single")


def test_allocator_picks_follow_the_reference(testdata, tmp_path):
    """The partition resource of both nodes: two parents with two
    partitions each.  For every size and a seeded sweep of availability
    and required sets, the picks agree once ids are mapped by (parent
    ordinal, partition index): same-parent partitions first, then the
    least-free parent."""
    root = os.path.join(testdata, "v5p-8-hetero")
    chips, topo = get_tpu_chips(os.path.join(root, "sys"),
                                os.path.join(root, "dev"),
                                os.path.join(root, "run", "tpu", "tpu-env"))
    ref_devs = ref_devices_from_discovery(chips, partitioned=True)
    impl = make_impl(equivalent_tree(testdata, tmp_path))
    devs = devices_from_discovery(impl.gpus, partitioned=True)
    to_ours = {r.id: d.id for r, d in zip(ref_devs, devs)}
    assert _key(ref_devs) == _key(devs)
    ref_policy, policy = RefPolicy(), BestEffortPolicy()
    ref_policy.init(ref_devs, topo)
    policy.init(devs, impl.topology)
    rnd = random.Random(0)
    ids = [d.id for d in ref_devs]
    cases = 0
    for _ in range(200):
        available = rnd.sample(ids, rnd.randint(1, len(ids)))
        size = rnd.randint(1, len(available))
        required = rnd.sample(available, rnd.randint(0, min(1, size)))
        want = [to_ours[i] for i in ref_policy.allocate(available, required,
                                                        size)]
        got = policy.allocate([to_ours[i] for i in available],
                              [to_ours[i] for i in required], size)
        assert got == want, (available, required, size)
        cases += 1
    assert cases == 200
