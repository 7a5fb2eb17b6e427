"""The port's allocator held against the reference's, and to stated
picks on the NVIDIA fixtures.

On inputs without NVLink, where only the NUMA node differs, the port's
``BestEffortPolicy`` and ``first_fit`` must pick what the reference's do
(the reference with ``topology=None``, its PCIe/NUMA weights) and raise
the same ``AllocationError`` cases, over 240 seeded availabilities and
sizes.  On the fixtures: a bridged pair on ``h100-pcie-4``, one NUMA node
on ``h100-sxm-8``, PCIe levels where NVML is absent.
"""

import os
import random
import time

import pytest

from tpu_k8s_device_plugin.allocator import (
    AllocationError as RefAllocationError,
    BestEffortPolicy as RefPolicy,
    first_fit as ref_first_fit,
)
from tpu_k8s_device_plugin.allocator.device import AllocDevice as RefDevice
from tpu_k8s_device_plugin_torch.allocator import (
    AllocationError,
    BestEffortPolicy,
    devices_from_discovery,
    first_fit,
)
from tpu_k8s_device_plugin_torch.allocator.device import (
    AllocDevice,
    WeightModel,
)
from tpu_k8s_device_plugin_torch.gpu import nvml
from tpu_k8s_device_plugin_torch.gpu.discovery import get_gpus
from tpu_k8s_device_plugin_torch.gpu.topology import GpuTopology

SEEDS = range(240)


def numa_only_case(seed):
    """n devices that differ only in NUMA node, an availability, a
    required subset and a size (sometimes an invalid one)."""
    rng = random.Random(seed)
    n = rng.randint(2, 8)
    ids = [f"0000:{0x10 + 8 * i:02x}:00.0" for i in range(n)]
    numa = [rng.randint(0, 2) for _ in range(n)]
    avail = [i for i in ids if rng.random() < 0.8] or ids[:1]
    rng.shuffle(avail)
    required = rng.sample(avail, min(len(avail), rng.choice([0, 0, 1, 2])))
    size = rng.randint(1, len(avail) + 1)
    if rng.random() < 0.05:
        required = required + ["0000:ff:00.0"]  # unknown id
    if rng.random() < 0.05:
        size = 0
    return ids, numa, avail, required, size


def both_policies(ids, numa, port_topology):
    ref = RefPolicy()
    ref.init([RefDevice(id=i, parent_id=i, chip_index=k, numa_node=numa[k])
              for k, i in enumerate(ids)], None)
    port = BestEffortPolicy()
    port.init([AllocDevice(id=i, parent_id=i, index=k, numa_node=numa[k])
               for k, i in enumerate(ids)], port_topology)
    return ref, port


def outcome(policy, error, avail, required, size):
    try:
        return ("ok", policy.allocate(avail, required, size))
    except error as e:
        return ("error", str(e))


@pytest.mark.parametrize("with_topology", [False, True],
                         ids=["no-topology", "numa-only-topology"])
def test_best_effort_picks_and_errors_equal_the_reference(with_topology):
    picks = errors = 0
    for seed in SEEDS:
        ids, numa, avail, required, size = numa_only_case(seed)
        topo = (GpuTopology(numa=dict(zip(ids, numa)),
                            cliques=[(i,) for i in ids])
                if with_topology else None)
        ref, port = both_policies(ids, numa, topo)
        want = outcome(ref, RefAllocationError, avail, required, size)
        got = outcome(port, AllocationError, avail, required, size)
        assert got == want, (seed, ids, numa, avail, required, size)
        picks += want[0] == "ok"
        errors += want[0] == "error"
    assert picks > 150 and errors > 10  # both kinds are exercised


def test_first_fit_equals_the_reference():
    for seed in SEEDS:
        ids, _, avail, required, size = numa_only_case(seed)
        assert first_fit(avail, required, size) == \
            ref_first_fit(avail, required, size)


def test_error_cases_equal_the_reference():
    ids = ["a", "b", "c"]
    ref, port = both_policies(ids, [0, 0, 1], None)
    for avail, required, size in (
            (ids, [], 0), (ids, ["a", "b"], 1), (["a"], ["b"], 1),
            (ids, ["bogus"], 1), (ids[:2], [], 3)):
        assert outcome(port, AllocationError, avail, required, size) == \
            outcome(ref, RefAllocationError, avail, required, size)
    for policy, error in ((RefPolicy(), RefAllocationError),
                          (BestEffortPolicy(), AllocationError)):
        with pytest.raises(error, match="not initialised"):
            policy.allocate(["a"], [], 1)
        with pytest.raises(error, match="no devices"):
            policy.init([], None)


def fixture_policy(testdata, tree, with_nvml=True):
    root = os.path.join(testdata, "nvidia", tree)
    source = (nvml.load(os.path.join(root, "nvml.json")) if with_nvml
              else None)
    gpus, topo = get_gpus(os.path.join(root, "sys"), os.path.join(root, "dev"),
                          os.path.join(root, "proc"), source)
    policy = BestEffortPolicy()
    devs = devices_from_discovery(gpus)
    policy.init(devs, topo)
    return policy, [d.id for d in devs], topo


class TestPcie4:
    @pytest.fixture(autouse=True)
    def _setup(self, testdata):
        self.policy, self.ids, self.topo = fixture_policy(testdata,
                                                          "h100-pcie-4")

    def test_pair_is_a_bridged_pair(self):
        assert self.policy.allocate(self.ids, [], 2) == self.ids[:2]

    def test_pair_with_one_taken_takes_the_other_bridge(self):
        assert self.policy.allocate(self.ids[1:], [], 2) == self.ids[2:]

    def test_required_pulls_its_bridge_partner(self):
        assert self.policy.allocate(self.ids, [self.ids[3]], 2) == \
            self.ids[2:]

    def test_no_clique_holds_three(self):
        got = self.policy.allocate(self.ids, [], 3)
        assert len(got) == 3
        # a bridged pair plus the nearest third
        assert self.ids[0] in got and self.ids[1] in got

    def test_broken_pairs_fall_back_to_numa(self):
        avail = [self.ids[0], self.ids[2], self.ids[3]]
        assert self.policy.allocate(avail, [self.ids[0]], 2) in (
            [self.ids[0], self.ids[2]], [self.ids[0], self.ids[3]])


class TestSxm8:
    @pytest.fixture(autouse=True)
    def _setup(self, testdata):
        self.policy, self.ids, self.topo = fixture_policy(testdata,
                                                          "h100-sxm-8")

    def test_four_stay_in_one_numa_node(self):
        assert self.policy.allocate(self.ids, [], 4) == self.ids[:4]

    def test_four_from_node_one_when_node_zero_is_short(self):
        avail = self.ids[1:]
        assert self.policy.allocate(avail, [], 4) == self.ids[4:]

    def test_required_anchors_the_numa_node(self):
        assert self.policy.allocate(self.ids, [self.ids[6]], 2) == \
            [self.ids[4], self.ids[6]]

    def test_full_set_returned_as_is(self):
        assert self.policy.allocate(self.ids, [], 8) == self.ids

    def test_weights_on_the_reference_scale(self):
        model = self.policy._model
        assert model.weight(self.ids[0], self.ids[1]) == 10     # NVLink
        assert model.weight(self.ids[0], self.ids[4]) == 12     # + NUMA
        assert model.weight(self.ids[0], self.ids[0]) == 0


class TestSxm8WithoutNvml:
    """No NVML: PCIe levels order the picks (switch < host bridge < NUMA
    node < across)."""

    @pytest.fixture(autouse=True)
    def _setup(self, testdata):
        self.policy, self.ids, _ = fixture_policy(testdata, "h100-sxm-8",
                                                  with_nvml=False)

    def test_pair_shares_a_switch(self):
        assert self.policy.allocate(self.ids, [], 2) == self.ids[:2]

    def test_required_takes_its_switch_partner(self):
        assert self.policy.allocate(self.ids, [self.ids[5]], 2) == \
            self.ids[4:6]

    def test_switch_partner_gone_takes_the_host_bridge(self):
        avail = [i for i in self.ids if i != self.ids[1]]
        assert self.policy.allocate(avail, [self.ids[0]], 2) == \
            [self.ids[0], self.ids[2]]

    def test_weights(self):
        model = self.policy._model
        w = model.weight
        assert w(self.ids[0], self.ids[1]) == 14   # one PCIe switch
        assert w(self.ids[0], self.ids[2]) == 17   # one host bridge
        assert w(self.ids[4], self.ids[6]) == 20   # one NUMA node
        assert w(self.ids[0], self.ids[4]) == 40   # across


def test_weight_model_without_topology_is_the_reference_fallback():
    devs = [AllocDevice(id=str(i), parent_id=str(i), index=i,
                        numa_node=i // 2) for i in range(4)]
    model = WeightModel(devs, None)
    assert model.weight("0", "1") == 20 and model.weight("0", "2") == 40
    assert model.set_weight(["0", "1", "2"]) == 20 + 40 + 40


def test_preferred_allocation_under_budget(testdata):
    """GetPreferredAllocation on 8 GPUs answers well inside the kubelet's
    patience, however fragmented the availability."""
    policy, ids, _ = fixture_policy(testdata, "h100-sxm-8", with_nvml=False)
    cases = [(ids[::2] + ids[1::4], [], 4), (ids, [], 7),
             (ids, [ids[3]], 6), (ids[3:], [ids[4]], 3)]
    for avail, req, size in cases:
        got = policy.allocate(avail, req, size)
        assert len(got) == size and set(req) <= set(got)
    t0 = time.perf_counter()
    for _ in range(20):
        for avail, req, size in cases:
            policy.allocate(avail, req, size)
    per_call_ms = (time.perf_counter() - t0) * 1000 / (20 * len(cases))
    assert per_call_ms < 25.0, f"preferred allocation {per_call_ms:.1f}ms"
