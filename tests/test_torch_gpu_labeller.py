"""The port's node labeller: each label on the NVIDIA fixtures and per
flag, value validity, and the controller and API client held against the
reference's (the same deltas modulo the label prefix, the same PATCH
bodies to the same local fake API server, the same watch semantics)."""

import json
import os
import random
import shutil
import string
import threading
import time

import pytest

from test_labeller import FakeApiServer
from tpu_k8s_device_plugin.labeller import NodeClient as RefNodeClient
from tpu_k8s_device_plugin.labeller import (
    NodeLabelController as RefController,
)
from tpu_k8s_device_plugin.labeller.controller import (
    label_delta as ref_label_delta,
)
from tpu_k8s_device_plugin.labeller.generators import (
    is_valid_label_value as ref_is_valid,
)
from tpu_k8s_device_plugin.types import constants as ref_constants
from tpu_k8s_device_plugin_torch.gpu import nvml
from tpu_k8s_device_plugin_torch.labeller import (
    LabelContext,
    NodeClient,
    NodeLabelController,
    generate_labels,
    label_delta,
)
from tpu_k8s_device_plugin_torch.labeller import generators
from tpu_k8s_device_plugin_torch.labeller.generators import (
    is_valid_label_value,
)
from tpu_k8s_device_plugin_torch.types import constants

P, B = constants.LABEL_PREFIX, constants.LABEL_PREFIX_BETA

EXPECTED = {
    "h100-sxm-8": {
        "mode": "container", "product": "H100-SXM5-80GB",
        "product-name": "NVIDIA-H100-80GB-HBM3", "device-id": "0x2330",
        "count": "8", "memory": "81559Mi", "sm-count": "132",
        "compute-capability": "9.0", "firmware": "96.00.99.00.0D",
        "driver-version": "550.54.15", "nvlink-topology": "1x8",
        "partitioning-supported": "true", "mig-mode": "disabled"},
    "h100-pcie-4": {
        "mode": "container", "product": "H100-PCIe-80GB",
        "product-name": "NVIDIA-H100-PCIe", "device-id": "0x2331",
        "count": "4", "memory": "81559Mi", "sm-count": "114",
        "compute-capability": "9.0", "firmware": "96.00.30.00.01",
        "driver-version": "550.54.15", "nvlink-topology": "2x2",
        "partitioning-supported": "true", "mig-mode": "disabled"},
    # no NVML: memory from the spec table, no MIG mode, no NVLink
    "h100-sxm-1": {
        "mode": "container", "product": "H100-SXM5-80GB",
        "product-name": "NVIDIA-H100-80GB-HBM3", "device-id": "0x2330",
        "count": "1", "memory": "81920Mi", "sm-count": "132",
        "compute-capability": "9.0", "firmware": "96.00.99.00.0D",
        "driver-version": "550.54.15", "nvlink-topology": "1x1",
        "partitioning-supported": "true"},
}


def collect(root):
    path = os.path.join(root, "nvml.json")
    return LabelContext.collect(
        sysfs_root=os.path.join(root, "sys"),
        dev_root=os.path.join(root, "dev"),
        proc_root=os.path.join(root, "proc"),
        nvml=nvml.load(path) if os.path.exists(path) else None,
        # no slice on the fixture hosts: the slice labels stay absent
        slice_state_path=os.path.join(root, "membership.json"))


def tree(testdata, name):
    return os.path.join(testdata, "nvidia", name)


def short(labels):
    return {k[len(P) + 1:]: v for k, v in labels.items()
            if k.startswith(P + ".")}


class TestGenerators:
    @pytest.mark.parametrize("name", sorted(EXPECTED))
    def test_fixture_labels(self, testdata, name):
        labels = generate_labels(collect(tree(testdata, name)))
        assert short(labels) == EXPECTED[name]
        for key, val in list(labels.items()):
            if key.startswith(P + "."):
                assert labels[B + key[len(P):]] == val

    @pytest.mark.parametrize("label", constants.SUPPORTED_LABELS)
    def test_each_flag_alone(self, testdata, label):
        labels = generate_labels(collect(tree(testdata, "h100-sxm-8")),
                                 enabled=[label])
        want = EXPECTED["h100-sxm-8"].get(label)
        assert labels == ({f"{P}.{label}": want, f"{B}.{label}": want}
                          if want is not None else {})

    def test_vfio_bound_gpu_is_not_counted(self, testdata, tmp_path):
        root = str(tmp_path / "h100-pcie-4")
        shutil.copytree(tree(testdata, "h100-pcie-4"), root, symlinks=True)
        os.remove(os.path.join(root, "sys", "bus", "pci", "drivers",
                               "nvidia", "0000:b2:00.0"))
        labels = short(generate_labels(collect(root)))
        assert labels["count"] == "3"
        assert labels["nvlink-topology"] == "1x2_1x1"

    def test_mixed_mig_modes(self, testdata, tmp_path):
        root = str(tmp_path / "h100-pcie-4")
        shutil.copytree(tree(testdata, "h100-pcie-4"), root, symlinks=True)
        path = os.path.join(root, "nvml.json")
        data = json.load(open(path))
        data["devices"][1]["mig_mode"] = "enabled"
        json.dump(data, open(path, "w"))
        assert short(generate_labels(collect(root)))["mig-mode"] == "mixed"

    def test_empty_host_has_only_the_mode(self, tmp_path):
        (tmp_path / "sys").mkdir()
        labels = generate_labels(collect(str(tmp_path)))
        assert short(labels) == {"mode": "container"}

    def test_every_reference_label_has_a_counterpart_or_an_item(self):
        assert set(constants.REFERENCE_LABELS) == set(
            ref_constants.SUPPORTED_LABELS)
        for theirs, ours in constants.REFERENCE_LABELS.items():
            assert ours in constants.SUPPORTED_LABELS, theirs


class TestLabelValueValidity:
    def test_validity_equals_the_reference(self):
        rng = random.Random(0)
        alphabet = string.ascii_letters + string.digits + "-_. ,()/"
        values = ["", "a", "x" * 63, "x" * 64, "-lead", "trail-",
                  "has space", "NVIDIA H100 80GB HBM3", "1x2_2x1"]
        values += ["".join(rng.choice(alphabet)
                           for _ in range(rng.randint(0, 70)))
                   for _ in range(500)]
        for v in values:
            assert is_valid_label_value(v) == ref_is_valid(v), v

    def test_slug_makes_names_valid(self):
        assert generators.slug("NVIDIA H100 80GB HBM3") == \
            "NVIDIA-H100-80GB-HBM3"
        assert generators.slug("NVIDIA H100 (PCIe)") == "NVIDIA-H100-PCIe"

    def test_long_device_id_join_capped(self):
        from tpu_k8s_device_plugin_torch.gpu.discovery import GpuDevice

        gpus = {str(i): GpuDevice(id=str(i), minor=i, index=i,
                                  device_id=f"0x{0x2300 + i:04x}")
                for i in range(20)}
        val = generators._device_id(LabelContext(constants.CONTAINER,
                                                 gpus=gpus))
        assert is_valid_label_value(val) and val.endswith("-more")

    def test_invalid_generated_value_dropped_not_fatal(self, testdata,
                                                        monkeypatch):
        bad = dict(generators.LABEL_GENERATORS)
        bad["firmware"] = lambda ctx: "has spaces!"
        monkeypatch.setattr(generators, "LABEL_GENERATORS", bad)
        labels = generate_labels(collect(tree(testdata, "h100-sxm-8")))
        assert f"{P}.firmware" not in labels
        assert labels[f"{P}.nvlink-topology"] == "1x8"


def _delta_case(rng):
    """Abstract labels: ('own', suffix) under the package's prefixes or
    ('foreign', key) elsewhere."""
    suffixes = ["product", "count", "memory", "stale", "old", "mode"]
    current, desired = {}, {}
    for s in rng.sample(suffixes, rng.randint(0, len(suffixes))):
        current[("own", rng.choice([0, 1]), s)] = rng.choice("abc")
    for s in rng.sample(suffixes, rng.randint(0, len(suffixes))):
        desired[("own", 0, s)] = rng.choice("abc")
    for k in rng.sample(["kubernetes.io/hostname", "team", "zone"],
                        rng.randint(0, 3)):
        current[("foreign", 0, k)] = rng.choice("xy")
    return current, desired


def _concrete(labels, prefixes):
    out = {}
    for (kind, beta, key), val in labels.items():
        out[f"{prefixes[beta]}.{key}" if kind == "own" else key] = val
    return out


def test_label_delta_equals_the_reference_modulo_prefix():
    ours = (P, B)
    theirs = (ref_constants.LABEL_PREFIX, ref_constants.LABEL_PREFIX_BETA)
    rng = random.Random(1)
    for _ in range(300):
        current, desired = _delta_case(rng)
        mine = label_delta(_concrete(current, ours),
                           _concrete(desired, ours))
        ref = ref_label_delta(_concrete(current, theirs),
                              _concrete(desired, theirs))
        renamed = {k.replace(theirs[1], ours[1]).replace(theirs[0], ours[0]):
                   v for k, v in ref.items()}
        assert mine == renamed


def test_delta_leaves_foreign_labels_and_removes_stale_ones():
    current = {f"{P}.count": "8", f"{P}.stale": "x", f"{B}.stale": "x",
               "kubernetes.io/hostname": "n1"}
    desired = {f"{P}.count": "4", f"{P}.product": "H100-SXM5-80GB"}
    assert label_delta(current, desired) == {
        f"{P}.count": "4", f"{P}.product": "H100-SXM5-80GB",
        f"{P}.stale": None, f"{B}.stale": None}


@pytest.fixture
def fake_api():
    srv = FakeApiServer(labels={"kubernetes.io/hostname": "test-node"})
    yield srv
    srv.stop()


def test_patch_bodies_equal_the_reference(testdata):
    """For the same desired labels, the port's controller and client send
    the reference's PATCH bodies to the same fake API server."""
    desired = generate_labels(collect(tree(testdata, "h100-sxm-8")))
    bodies = []
    for client, controller in ((NodeClient, NodeLabelController),
                               (RefNodeClient, RefController)):
        srv = FakeApiServer(labels={"kubernetes.io/hostname": "test-node"})
        try:
            c = controller(client(base_url=srv.url), "test-node",
                           lambda: dict(desired))
            first = c.reconcile()
            second = c.reconcile()
            client(base_url=srv.url).patch_node_labels(
                "test-node", {f"{P}.count": None, f"{P}.memory": "1Mi"})
            bodies.append((srv.patches, first, second,
                           srv.node["metadata"]["labels"]))
        finally:
            srv.stop()
    assert bodies[0] == bodies[1]
    patches, first, second, labels = bodies[0]
    assert first == desired and second == {}
    assert len(patches) == 2 and f"{P}.count" not in labels


class TestController:
    def test_reconcile_applies_and_cleans(self, testdata, fake_api):
        fake_api.node["metadata"]["labels"][f"{P}.stale"] = "gone"
        c = NodeLabelController(
            NodeClient(base_url=fake_api.url), "test-node",
            lambda: generate_labels(collect(tree(testdata, "h100-sxm-8"))))
        delta = c.reconcile()
        assert delta[f"{P}.stale"] is None
        assert delta[f"{P}.nvlink-topology"] == "1x8"
        applied = fake_api.node["metadata"]["labels"]
        assert f"{P}.stale" not in applied
        assert applied["kubernetes.io/hostname"] == "test-node"
        n = len(fake_api.patches)
        assert c.reconcile() == {} and len(fake_api.patches) == n

    def test_reconcile_recomputes(self, testdata, fake_api):
        state = {"tree": "h100-sxm-8"}
        c = NodeLabelController(
            NodeClient(base_url=fake_api.url), "test-node",
            lambda: generate_labels(collect(tree(testdata, state["tree"]))))
        c.reconcile()
        assert fake_api.node["metadata"]["labels"][f"{P}.count"] == "8"
        state["tree"] = "h100-sxm-1"
        c.reconcile()
        labels = fake_api.node["metadata"]["labels"]
        assert labels[f"{P}.count"] == "1"
        assert f"{P}.mig-mode" not in labels  # no NVML there: removed

    def test_event_filter_skips_in_sync_events(self):
        desired = {f"{P}.count": "8"}
        assert not NodeLabelController._event_needs_reconcile(
            {"type": "MODIFIED",
             "object": {"metadata": {"labels": dict(desired)}}}, desired)
        assert NodeLabelController._event_needs_reconcile(
            {"type": "MODIFIED", "object": {"metadata": {"labels": {}}}},
            desired)
        assert not NodeLabelController._event_needs_reconcile(
            {"type": "DELETED", "object": {}}, desired)


class TestWatch:
    def _controller(self, testdata, fake_api):
        return NodeLabelController(
            NodeClient(base_url=fake_api.url), "test-node",
            lambda: generate_labels(collect(tree(testdata, "h100-sxm-8"))),
            interval_s=0.3)

    def _run_until(self, c, fake_api, n_watches, timeout=10.0):
        t = threading.Thread(target=c.run, daemon=True)
        t.start()
        deadline = time.time() + timeout
        while (time.time() < deadline
               and len(fake_api.watch_requests) < n_watches):
            time.sleep(0.05)
        c.stop()
        t.join(timeout=5)
        assert not t.is_alive()
        assert len(fake_api.watch_requests) >= n_watches

    def test_watch_resumes_from_resource_version(self, testdata, fake_api):
        fake_api.watch_script = [[], []]
        self._run_until(self._controller(testdata, fake_api), fake_api, 2)
        for req in fake_api.watch_requests[:2]:
            assert "resourceVersion=101" in req

    @pytest.mark.parametrize("gone", ["event", "http"])
    def test_410_triggers_clean_relist(self, testdata, fake_api, gone):
        fake_api.watch_script = [
            [{"type": "ERROR", "object": {"kind": "Status", "code": 410}}]
            if gone == "event" else "http-410", []]
        t0 = time.time()
        self._run_until(self._controller(testdata, fake_api), fake_api, 2)
        assert len(fake_api.list_requests) >= 2
        assert "resourceVersion=101" in fake_api.watch_requests[1]
        assert time.time() - t0 < 5.0

    def test_drifted_event_reconciles(self, testdata, fake_api):
        c = self._controller(testdata, fake_api)
        desired = c.compute_labels()
        c._process_event({"type": "MODIFIED", "object": {"metadata": {
            "labels": {}, "resourceVersion": "205"}}}, desired)
        assert c._last_rv is not None
        assert fake_api.node["metadata"]["labels"][
            f"{P}.nvlink-topology"] == "1x8"


class TestCli:
    def test_oneshot_on_a_fixture(self, testdata, fake_api):
        from tpu_k8s_device_plugin_torch.cmd import node_labeller

        root = tree(testdata, "h100-sxm-8")
        rc = node_labeller.main([
            "--oneshot", "--node-name", "test-node",
            "--kube-api", fake_api.url,
            "--sysfs-root", os.path.join(root, "sys"),
            "--dev-root", os.path.join(root, "dev"),
            "--proc-root", os.path.join(root, "proc"),
            "--nvml-json", os.path.join(root, "nvml.json"),
            "--no-firmware",
        ])
        assert rc == 0
        labels = fake_api.node["metadata"]["labels"]
        assert short(labels) == {k: v for k, v in EXPECTED[
            "h100-sxm-8"].items() if k != "firmware"}

    def test_requires_node_name(self, monkeypatch):
        from tpu_k8s_device_plugin_torch.cmd import node_labeller

        monkeypatch.delenv("DS_NODE_NAME", raising=False)
        assert node_labeller.main(["--oneshot"]) == 2
