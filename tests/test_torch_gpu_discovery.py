"""Discovery, NVML and topology of the port's NVIDIA agents, held to
stated values on the fixture trees under ``testdata/nvidia/``: bus ids,
minors, UUIDs, NUMA nodes, device ids, the driver version, link levels
and NVLink cliques; the edge cases (no GPU bound to nvidia, no NVML, no
PCI tree at all); and ``/proc`` parsed by key."""

import json
import os
import shutil

import pytest

from tpu_k8s_device_plugin_torch.gpu import discovery, nvml, topology
from tpu_k8s_device_plugin_torch.gpu.device_impl import GpuContainerImpl
from tpu_k8s_device_plugin_torch.gpu.discovery import get_gpus
from tpu_k8s_device_plugin_torch.gpu.topology import (
    LEVEL_HOST_BRIDGE,
    LEVEL_NUMA,
    LEVEL_NVLINK,
    LEVEL_PCIE_SWITCH,
    LEVEL_SYSTEM,
)

SXM8 = ["0000:13:00.0", "0000:14:00.0", "0000:23:00.0", "0000:24:00.0",
        "0000:93:00.0", "0000:94:00.0", "0000:c3:00.0", "0000:c4:00.0"]
PCIE4 = ["0000:31:00.0", "0000:32:00.0", "0000:b1:00.0", "0000:b2:00.0"]


def roots(testdata, tree):
    root = os.path.join(testdata, "nvidia", tree)
    return (os.path.join(root, "sys"), os.path.join(root, "dev"),
            os.path.join(root, "proc"))


def fixture_nvml(testdata, tree):
    return nvml.load(os.path.join(testdata, "nvidia", tree, "nvml.json"))


def discover(testdata, tree, with_nvml=True):
    source = fixture_nvml(testdata, tree) if with_nvml else None
    return get_gpus(*roots(testdata, tree), source)


@pytest.fixture
def sxm8_copy(testdata, tmp_path):
    dst = tmp_path / "h100-sxm-8"
    shutil.copytree(os.path.join(testdata, "nvidia", "h100-sxm-8"), dst,
                    symlinks=True)
    return str(dst)


def info_uuid(testdata, tree, bus):
    path = os.path.join(testdata, "nvidia", tree, "proc", "driver",
                        "nvidia", "gpus", bus, "information")
    return discovery.sysfs.read_keyed(path)["GPU UUID"]


def test_sxm8_inventory(testdata):
    gpus, topo = discover(testdata, "h100-sxm-8")
    assert list(gpus) == SXM8
    assert [g.minor for g in gpus.values()] == list(range(8))
    assert [g.index for g in gpus.values()] == list(range(8))
    assert [g.numa_node for g in gpus.values()] == [0] * 4 + [1] * 4
    g0 = gpus[SXM8[0]]
    assert g0.device_id == "0x2330"
    assert g0.uuid == info_uuid(testdata, "h100-sxm-8", SXM8[0])
    assert g0.uuid.startswith("GPU-") and nvml.looks_like_uuid(g0.uuid)
    assert g0.name == "NVIDIA H100 80GB HBM3"
    assert g0.vbios == "96.00.99.00.0D"
    assert g0.memory_bytes == 85520809984
    assert g0.mig_mode == "disabled"
    assert g0.source == discovery.SOURCE_SYSFS
    assert g0.pci_path.endswith(SXM8[0]) and os.path.isdir(g0.pci_path)
    assert g0.dev_path.endswith(os.path.join("dev", "nvidia0"))
    assert g0.container_path == "/dev/nvidia0"
    assert len(g0.nvlinks) == 18
    assert len({g.uuid for g in gpus.values()}) == 8
    assert topo.spec.product == "H100-SXM5-80GB"
    assert topo.spec.sm_count == 132


def test_pcie4_inventory(testdata):
    gpus, topo = discover(testdata, "h100-pcie-4")
    assert list(gpus) == PCIE4
    assert [g.numa_node for g in gpus.values()] == [0, 0, 1, 1]
    assert {g.device_id for g in gpus.values()} == {"0x2331"}
    assert topo.spec.product == "H100-PCIe-80GB" and topo.spec.sm_count == 114


def test_driver_version_sources(testdata, tmp_path):
    sysr, _, procr = roots(testdata, "h100-sxm-8")
    assert discovery.get_driver_version(sysr, procr) == "550.54.15"
    # no /sys/module/nvidia: NVML's, then /proc's
    empty = str(tmp_path)
    fake = fixture_nvml(testdata, "h100-sxm-8")
    assert discovery.get_driver_version(empty, empty, fake) == "550.54.15"
    assert discovery.get_driver_version(empty, procr) == "550.54.15"
    assert discovery.get_driver_version(empty, empty) == ""


def test_sxm1_without_nvml(testdata):
    """No NVML: the inventory comes from sysfs and /proc alone, memory
    from the spec table, and every GPU is its own clique."""
    gpus, topo = discover(testdata, "h100-sxm-1", with_nvml=False)
    [g] = gpus.values()
    assert g.id == "0000:18:00.0" and g.minor == 0
    assert g.uuid == info_uuid(testdata, "h100-sxm-1", g.id)
    assert g.name == "NVIDIA H100 80GB HBM3"
    assert g.memory_bytes == topology.GPU_SPECS["0x2330"].memory_bytes
    assert g.mig_mode == "" and g.nvlinks == ()
    assert topo.topology_str == "1x1"


class TestLinkLevels:
    def test_sxm8_nvswitch_clique(self, testdata):
        gpus, topo = discover(testdata, "h100-sxm-8")
        assert topo.topology_str == "1x8"
        assert topo.cliques == [tuple(SXM8)]
        # 18 links into the NVSwitches on each side
        assert topo.nvlink_count(SXM8[0], SXM8[7]) == 18
        assert all(topo.link_level(a, b) == LEVEL_NVLINK
                   for a in SXM8 for b in SXM8 if a != b)

    def test_sxm8_pci_levels_without_nvlink(self, testdata):
        gpus, topo = discover(testdata, "h100-sxm-8", with_nvml=False)
        assert topo.topology_str == "8x1"
        level = topo.link_level
        assert level(SXM8[0], SXM8[1]) == LEVEL_PCIE_SWITCH   # one switch
        assert level(SXM8[0], SXM8[2]) == LEVEL_HOST_BRIDGE   # one root
        assert level(SXM8[4], SXM8[6]) == LEVEL_NUMA          # one node
        assert level(SXM8[0], SXM8[4]) == LEVEL_SYSTEM        # across

    def test_pcie4_bridged_pairs(self, testdata):
        gpus, topo = discover(testdata, "h100-pcie-4")
        assert topo.topology_str == "2x2"
        assert topo.cliques == [tuple(PCIE4[:2]), tuple(PCIE4[2:])]
        assert topo.nvlink_count(PCIE4[0], PCIE4[1]) == 12
        assert topo.nvlink_count(PCIE4[0], PCIE4[2]) == 0
        assert topo.link_level(PCIE4[2], PCIE4[3]) == LEVEL_NVLINK
        assert topo.link_level(PCIE4[0], PCIE4[2]) == LEVEL_SYSTEM
        assert topo.clique_of(PCIE4[3]) == 1 and topo.largest_clique == 2

    def test_pci_level_of_paths(self):
        root = "/sys/devices/pci0000:10"
        a = f"{root}/0000:10:01.0/0000:11:00.0/0000:12:00.0/0000:13:00.0"
        b = f"{root}/0000:10:01.0/0000:11:00.0/0000:12:01.0/0000:14:00.0"
        c = f"{root}/0000:10:02.0/0000:21:00.0"
        d = "/sys/devices/pci0000:90/0000:90:01.0/0000:91:00.0"
        assert topology.pci_level(a, b) == LEVEL_PCIE_SWITCH
        assert topology.pci_level(a, c) == LEVEL_HOST_BRIDGE
        assert topology.pci_level(a, d) is None
        assert topology.pci_level(a, "") is None

    def test_uneven_cliques_string(self):
        topo = topology.GpuTopology(cliques=[("a", "b"), ("c",), ("d",)])
        assert topo.topology_str == "1x2_2x1"


class TestSpecTable:
    def test_entries_cite_their_source(self):
        for device_id, spec in topology.GPU_SPECS.items():
            assert device_id.startswith("0x") and spec.source
            assert spec.peak_bf16_flops > 0 and spec.sm_count > 0

    def test_lookup_by_name_where_ids_are_hidden(self):
        device_id, spec = topology.spec_for_name("NVIDIA H100 80GB HBM3")
        assert device_id == "0x2330" and spec.sm_count == 132
        assert topology.spec_for_name("NVIDIA A100-SXM4-80GB") is None


class TestFallbacks:
    def test_unbound_gpus_are_not_inventoried(self, sxm8_copy):
        """No nvidia binding at all, with a PCI tree: the raw PCI scan
        finds the eight GPUs (not the NVSwitches) as the reference's
        raw fallback finds its chips, with no minor and no device node,
        and NVML is not asked to stand in: they are not inventoried as
        container GPUs (the passthrough impls serve them)."""
        shutil.rmtree(os.path.join(sxm8_copy, "sys", "bus", "pci",
                                   "drivers", "nvidia"))
        gpus, topo = get_gpus(
            os.path.join(sxm8_copy, "sys"), os.path.join(sxm8_copy, "dev"),
            os.path.join(sxm8_copy, "proc"),
            nvml.load(os.path.join(sxm8_copy, "nvml.json")))
        assert len(gpus) == 8 and topo.spec is not None
        for g in gpus.values():
            assert g.source == discovery.SOURCE_PCI
            assert g.minor == -1 and g.dev_path == "" and g.uuid == ""
            assert g.device_id == "0x2330" and g.pci_path
        with pytest.raises(RuntimeError, match="device node"):
            GpuContainerImpl(os.path.join(sxm8_copy, "sys"),
                             os.path.join(sxm8_copy, "dev"),
                             os.path.join(sxm8_copy, "proc"))

    def test_no_pci_tree_inventories_from_nvml(self, testdata, tmp_path):
        """A sandboxed container: no PCI tree in sysfs, no /proc gpus,
        NVML refusing PCI information; NVML's inventory is the node's."""
        data = json.load(open(os.path.join(
            testdata, "nvidia", "h100-sxm-8", "nvml.json")))
        dev = data["devices"][5]
        dev.update(bus_id="", pci_device_id="")
        path = tmp_path / "nvml.json"
        path.write_text(json.dumps({"driver_version": "580.159.03",
                                    "devices": [dev]}))
        (tmp_path / "sys").mkdir()
        (tmp_path / "dev").mkdir()
        (tmp_path / "dev" / "nvidia5").write_text("")
        gpus, topo = get_gpus(str(tmp_path / "sys"), str(tmp_path / "dev"),
                              str(tmp_path / "proc"), nvml.load(str(path)))
        [g] = gpus.values()
        assert g.id == "nvidia5" and g.minor == 5 and g.index == 5
        assert g.source == discovery.SOURCE_NVML
        assert g.pci_address == "" and g.device_id == ""
        assert g.uuid == dev["uuid"]
        assert g.dev_path == str(tmp_path / "dev" / "nvidia5")
        # the spec is found by the driver's model name
        assert topo.spec.product == "H100-SXM5-80GB"

    def test_a_pci_tree_without_gpus_is_not_replaced_by_nvml(
            self, testdata, tmp_path):
        (tmp_path / "sys" / "bus" / "pci" / "devices").mkdir(parents=True)
        gpus, _ = get_gpus(str(tmp_path / "sys"), str(tmp_path),
                           str(tmp_path), fixture_nvml(testdata,
                                                       "h100-sxm-8"))
        assert gpus == {}

    def test_placeholder_uuid_is_not_a_uuid(self, sxm8_copy):
        info = os.path.join(sxm8_copy, "proc", "driver", "nvidia", "gpus",
                            SXM8[0], "information")
        text = open(info).read()
        uuid = discovery.sysfs.read_keyed(info)["GPU UUID"]
        open(info, "w").write(text.replace(uuid, "GPU-REDACTED"))
        gpus, _ = get_gpus(os.path.join(sxm8_copy, "sys"),
                           os.path.join(sxm8_copy, "dev"),
                           os.path.join(sxm8_copy, "proc"))
        assert gpus[SXM8[0]].uuid == ""
        assert gpus[SXM8[0]].visible_id == "0"
        assert gpus[SXM8[1]].visible_id == gpus[SXM8[1]].uuid


def test_information_is_parsed_by_key(sxm8_copy):
    """Drivers add lines: a reordered file with unknown keys reads the
    same."""
    info = os.path.join(sxm8_copy, "proc", "driver", "nvidia", "gpus",
                        SXM8[2], "information")
    lines = open(info).read().splitlines()
    open(info, "w").write("\n".join(
        ["Firmware Model: \t GSP", "Bus Location: \t 0000:23:00.0"]
        + list(reversed(lines)) + ["Extra Key:\t value: with colon"]))
    gpus, _ = get_gpus(os.path.join(sxm8_copy, "sys"),
                       os.path.join(sxm8_copy, "dev"),
                       os.path.join(sxm8_copy, "proc"))
    assert gpus[SXM8[2]].minor == 2
    assert gpus[SXM8[2]].name == "NVIDIA H100 80GB HBM3"


class TestNvml:
    def test_bus_id_normalisation(self):
        assert nvml.normalize_bus_id("00000000:3B:00.0") == "0000:3b:00.0"
        assert nvml.normalize_bus_id("0000:3b:00.0") == "0000:3b:00.0"
        assert nvml.normalize_bus_id("") == ""

    def test_uuid_shape(self):
        assert nvml.looks_like_uuid(
            "GPU-9eb25673-a32a-b5fb-4470-68d8102c4032")
        assert not nvml.looks_like_uuid("GPU-REDACTED")
        assert not nvml.looks_like_uuid("")

    def test_fixture_answers(self, testdata):
        source = fixture_nvml(testdata, "h100-pcie-4")
        assert source.driver_version() == "550.54.15"
        g = source.gpu_by_bus_id("00000000:B1:00.0")
        assert g.index == 2 and g.minor == 2 and g.pci_device_id == "0x2331"
        assert {l.remote_bus_id for l in g.nvlinks} == {PCIE4[3]}
        assert source.gpu_by_bus_id("0000:ff:00.0") is None

    def test_absent_library_is_none_and_logged_once(self, monkeypatch,
                                                    caplog):
        monkeypatch.setattr(nvml, "_warned_absent", False)
        with caplog.at_level("WARNING", logger=nvml.__name__):
            assert nvml.load(library="libnvidia-ml-absent.so.1") is None
            assert nvml.load(library="libnvidia-ml-absent.so.1") is None
        assert sum("NVML unavailable" in r.message
                   for r in caplog.records) == 1


STUB_NVML = r"""
#include <stdio.h>
#include <string.h>
typedef struct { char busIdLegacy[16]; unsigned domain, bus, device,
                 pciDeviceId, pciSubSystemId; char busId[32]; } pci_t;
typedef struct { unsigned long long total, free, used; } mem_t;
static int dev = 7;  /* the one handle */
#define H(h) if ((int *)(h) != &dev) return 2
int nvmlInit_v2(void) { return 0; }
int nvmlSystemGetDriverVersion(char *b, unsigned n) {
  snprintf(b, n, "580.159.03"); return 0; }
int nvmlDeviceGetCount_v2(unsigned *n) { *n = 1; return 0; }
int nvmlDeviceGetHandleByIndex_v2(unsigned i, void **h) {
  if (i) return 2; *h = &dev; return 0; }
int nvmlDeviceGetHandleByPciBusId_v2(const char *id, void **h) {
  if (strcmp(id, "0000:3b:00.0")) return 6; *h = &dev; return 0; }
int nvmlDeviceGetIndex(void *h, unsigned *i) { H(h); *i = 0; return 0; }
int nvmlDeviceGetMinorNumber(void *h, unsigned *m) { H(h); *m = 5; return 0; }
int nvmlDeviceGetPciInfo_v3(void *h, pci_t *p) {
  H(h); memset(p, 0, sizeof *p); strcpy(p->busId, "00000000:3B:00.0");
  p->pciDeviceId = 0x233010de; return 0; }
int nvmlDeviceGetUUID(void *h, char *b, unsigned n) {
  H(h); snprintf(b, n, "GPU-9eb25673-a32a-b5fb-4470-68d8102c4032"); return 0; }
int nvmlDeviceGetName(void *h, char *b, unsigned n) {
  H(h); snprintf(b, n, "NVIDIA H100 80GB HBM3"); return 0; }
int nvmlDeviceGetVbiosVersion(void *h, char *b, unsigned n) {
  H(h); snprintf(b, n, "96.00.99.00.0D"); return 0; }
int nvmlDeviceGetMemoryInfo(void *h, mem_t *m) {
  H(h); m->total = 85520809984ULL; m->free = 1; m->used = 2; return 0; }
int nvmlDeviceGetMigMode(void *h, unsigned *cur, unsigned *pend) {
  H(h); *cur = 0; *pend = 0; return 0; }
int nvmlDeviceGetNvLinkState(void *h, unsigned link, unsigned *on) {
  H(h); if (link >= 18) return 2; *on = link < 4; return 0; }
int nvmlDeviceGetNvLinkRemotePciInfo_v2(void *h, unsigned link, pci_t *p) {
  H(h); memset(p, 0, sizeof *p);
  snprintf(p->busId, 32, "00000000:0%u:00.0", 5 + link % 2); return 0; }
int nvmlDeviceGetNvLinkRemoteDeviceType(void *h, unsigned link, int *t) {
  H(h); *t = 2; return 0; }
int nvmlDeviceGetRemappedRows(void *h, unsigned *c, unsigned *u,
                              unsigned *p, unsigned *f) {
  H(h); *c = 1; *u = 0; *p = 0; *f = 1; return 0; }
"""


def test_ctypes_binding_against_a_stub_library(tmp_path):
    """The real binding (argument types, struct layouts, bus-id and
    device-id decoding) against a stub libnvidia-ml built here."""
    cc = shutil.which("gcc") or shutil.which("cc")
    if cc is None:
        pytest.skip("no C compiler to build the stub NVML")
    import subprocess

    src = tmp_path / "stub.c"
    src.write_text(STUB_NVML)
    lib = tmp_path / "libnvidia-ml-stub.so"
    subprocess.run([cc, "-shared", "-fPIC", "-o", str(lib), str(src)],
                   check=True, timeout=60)
    source = nvml.Nvml(str(lib))
    assert source.driver_version() == "580.159.03"
    [g] = source.gpus()
    assert (g.index, g.minor, g.bus_id, g.pci_device_id) == (
        0, 5, "0000:3b:00.0", "0x2330")
    assert g.uuid == "GPU-9eb25673-a32a-b5fb-4470-68d8102c4032"
    assert g.name == "NVIDIA H100 80GB HBM3" and g.vbios == "96.00.99.00.0D"
    assert g.memory_total == 85520809984 and g.mig_mode == "disabled"
    assert [(l.link, l.remote_bus_id, l.remote_type) for l in g.nvlinks] == [
        (0, "0000:05:00.0", "switch"), (1, "0000:06:00.0", "switch"),
        (2, "0000:05:00.0", "switch"), (3, "0000:06:00.0", "switch")]
    assert g.remapped_rows_failure is True
    assert source.gpu_by_bus_id("0000:3b:00.0") == g
    assert source.gpu_by_bus_id("0000:ff:00.0") is None
