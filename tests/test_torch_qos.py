"""The port's ``workloads/qos.py`` against the JAX package's: the same
seeded sequence of charges under a fake clock gives the same quota
decisions and bucket levels; the spec grammar parses (and rejects) the
same strings; ``*`` templates clone per-tenant state the same way."""

import random

import pytest

from tpu_k8s_device_plugin.workloads import qos as jqos
from tpu_k8s_device_plugin_torch.workloads import qos as tqos

MODULES = {"jax": jqos, "torch": tqos}


class FakeTime:
    def __init__(self):
        self.t = 50.0

    def monotonic(self):
        return self.t


def _decisions(qos, seed, clock):
    rng = random.Random(seed)
    quotas = qos.parse_tenant_quotas(
        ["alpha=100:400:2", "beta=10", "*=50:100:0.5", "free=0:0:4"])
    out = []
    for _ in range(300):
        clock.t += rng.choice([0.0, 0.01, 0.1, 0.5, 2.0])
        tenant = rng.choice(["alpha", "beta", "gamma", "delta", "free",
                             ""])
        q = qos.resolve_quota(quotas, tenant)
        cost = float(rng.randint(1, 200))
        out.append((tenant, None if q is None else
                    (q.try_charge(cost), round(q.tokens, 9), q.weight)))
    out.append(sorted((k, v.rate, v.burst, v.weight)
                      for k, v in quotas.items()))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_quota_decisions_match_reference(seed, monkeypatch):
    got = {}
    for tag, mod in MODULES.items():
        clock = FakeTime()
        monkeypatch.setattr(mod, "time", clock)
        got[tag] = _decisions(mod, seed, clock)
        monkeypatch.undo()
    assert got["torch"] == got["jax"]


@pytest.mark.parametrize("spec", [
    "a=1", "a=1:2", "a=1:2:3", "*=0:0:4", "=1", "a=", "a", "a=1:2:3:4",
    "a=x", "a=1:2:0", "a=1:2:-1"])
def test_spec_grammar_matches_reference(spec):
    got = {}
    for tag, mod in MODULES.items():
        try:
            q = mod.parse_tenant_quotas([spec])
            got[tag] = sorted((k, v.rate, v.burst, v.weight, v.tokens)
                              for k, v in q.items())
        except ValueError as e:
            got[tag] = ("ValueError", str(e))
    assert got["torch"] == got["jax"]


def test_template_clones_are_independent():
    quotas = tqos.parse_tenant_quotas(["*=10:10"])
    a = tqos.resolve_quota(quotas, "a")
    b = tqos.resolve_quota(quotas, "b")
    assert a is not b and a is tqos.resolve_quota(quotas, "a")
    assert a.try_charge(10) and not a.try_charge(10)
    assert b.try_charge(10)
    assert tqos.resolve_quota({}, "a") is None
    assert tqos.__all__ == jqos.__all__
