"""The port's session KV tier (``workloads/kv_tier.py``) against the JAX
package's.

Three layers.  The reference's store-policy tests (its fake engine:
idle demotion device -> host -> disk, promotion on return, crash-safe
spill files, truncation quarantine, newest-K GC, the host cap,
single-owner export/import, the ``kv.promote`` fault degrading to a
cold miss) run again with the port's ``SessionStore``, ``faults`` and
migrate codec in place of the reference's.  A scripted sequence of
calls then drives both stores side by side: every return value, stats
snapshot, journal event and spill file (its name and its bytes) must be
equal.  Last, the store over the real paged engines: a conversation
parked, demoted, spilled and rehydrated into a fresh engine and store
gives the JAX engine's turn-2 ids on the same converted weights.
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_kv_tier as ref
from tpu_k8s_device_plugin import obs as jobs
from tpu_k8s_device_plugin.resilience import faults as jfaults
from tpu_k8s_device_plugin.workloads import kv_tier as jkv
from tpu_k8s_device_plugin.workloads import migrate as jmig
from tpu_k8s_device_plugin.workloads.inference import make_decoder
from tpu_k8s_device_plugin.workloads.serving import ServingEngine as JEngine
from tpu_k8s_device_plugin_torch import obs as tobs
from tpu_k8s_device_plugin_torch.convert import params_from_jax
from tpu_k8s_device_plugin_torch.resilience import faults as tfaults
from tpu_k8s_device_plugin_torch.workloads import inference as tinf
from tpu_k8s_device_plugin_torch.workloads import kv_tier as tkv
from tpu_k8s_device_plugin_torch.workloads import migrate as tmig
from tpu_k8s_device_plugin_torch.workloads.serving import ServingEngine

# the reference's tests that drive the store over its fake engine
POLICY_TESTS = [
    "test_idle_demotion_chain_and_stats",
    "test_prepare_hits_every_tier",
    "test_prepare_can_restore_false_gates_restores",
    "test_disk_survives_process_death",
    "test_truncated_spill_quarantined",
    "test_disk_gc_keeps_newest_k",
    "test_host_cap_drops_without_spill_dir",
    "test_promote_fault_degrades_to_cold",
    "test_export_host_and_disk_single_owner",
    "test_export_device_via_scheduler_tick",
    "test_import_payload_installs_host_entry",
    "test_import_supersedes_device_copy_on_next_tick",
    "test_note_parked_supersedes_older_tiers",
    "test_demote_for_pages_frees_closest_to_idle",
    "test_slot_pressure_tick_demotes",
    "test_stats_schema_matches_empty",
    "test_spill_filenames_newest_seq_wins",
]

_PORT_NAMES = dict(
    SessionStore=tkv.SessionStore, kv_tier=tkv, faults=tfaults,
    empty_tier_stats=tkv.empty_tier_stats, sid_hash=tkv.sid_hash,
    dump_payload=tmig.dump_payload, load_payload=tmig.load_payload,
    MigrateError=tmig.MigrateError)


def _on_port(fn):
    """*fn* (a reference test) with the port's store, faults and codec
    bound where its module binds the reference's."""
    g = dict(fn.__globals__)
    g.update(_PORT_NAMES)
    return types.FunctionType(fn.__code__, g, fn.__name__,
                              fn.__defaults__, fn.__closure__)


@pytest.mark.parametrize("name", POLICY_TESTS)
def test_reference_policy_holds_on_port(name, tmp_path):
    fn = getattr(ref, name)
    args = ["tmp_path"] if "tmp_path" in fn.__code__.co_varnames[
        :fn.__code__.co_argcount] else []
    _on_port(fn)(*[tmp_path for _ in args])


def _events(rec):
    """Journal events without durations, spill paths by file name."""
    return [(e["name"], {k: os.path.basename(v) if k == "path" else v
                         for k, v in e["attrs"].items()
                         if k not in ("duration_s", "seconds")})
            for e in rec.events()]


def _script(kv, obs, faults, mig, spill):
    """One scripted session-tier run over the fake engine."""
    reg = obs.Registry()
    rec = obs.FlightRecorder(registry=None)
    eng = ref.FakeEngine(n_slots=4)
    store = kv.SessionStore(eng, spill_dir=spill, host_cap_bytes=600,
                            disk_keep=3, device_idle_s=1.0,
                            host_idle_s=2.0, seed=5, registry=reg,
                            recorder=rec)
    out = []

    def park(sid, slot, now):
        eng.parked[slot] = ref._state(sid, n=40)
        store.note_parked(sid, slot, now)

    for i, sid in enumerate(["a", "b", "c"]):
        park(sid, i, 0.1 * i)
    out.append(store.stats())
    for now in (1.5, 2.0, 3.0, 4.5, 6.0):
        store.tick(now, slot_pressure=now == 3.0)
        out.append(store.stats())
    out.append(store.prepare("a", 6.5))
    out.append(store.prepare("b", 6.6, can_restore=False))
    out.append(store.prepare("zz", 6.7))
    park("d", 3, 7.0)
    out.append(store.demote_for_pages(7.5))
    faults.install("kv.promote:error:1", seed=0)
    try:
        out.append(store.prepare("c", 8.0))
    finally:
        faults.uninstall()
    raw = store.export_session("b")
    out.append(sorted(mig.load_payload(raw)))
    out.append(store.import_payload(raw, 9.0))
    store.spill_all(10.0)
    out.append(store.stats())
    out.append(sorted(eng.parked))
    files = sorted(os.listdir(spill))
    out.append(files)
    out.append([open(os.path.join(spill, f), "rb").read() for f in files])
    out.append(_events(rec))
    out.append([line for line in reg.render().splitlines()
                if "_seconds" not in line])
    return out


def test_scripted_transitions_match_reference(tmp_path):
    got = {}
    for tag, mods in (("jax", (jkv, jobs, jfaults, jmig)),
                      ("torch", (tkv, tobs, tfaults, tmig))):
        spill = str(tmp_path / tag)
        os.makedirs(spill)
        got[tag] = _script(*mods, spill)
    assert got["torch"] == got["jax"]
    assert tkv.sid_hash("conv-1") == jkv.sid_hash("conv-1")
    assert tkv.empty_tier_stats() == jkv.empty_tier_stats()


# -- the store over the real paged engines ---------------------------------

CFG = dict(vocab=96, d_model=64, n_heads=4, n_layers=2, d_ff=128)
MAX_LEN = 64
SID = "conv-1"
P1 = list(range(1, 13))
P2 = [33, 34, 35]


@pytest.fixture(scope="module")
def models():
    jm = make_decoder(**CFG, max_len=MAX_LEN, dtype=jnp.float32)
    tokens = jnp.zeros((1, 8), jnp.int32)
    pos = jnp.broadcast_to(jnp.arange(8, dtype=jnp.int32), (1, 8))
    params = jm.init(jax.random.PRNGKey(0), tokens, pos)["params"]
    tm = tinf.make_decoder(**CFG, max_len=MAX_LEN, dtype=torch.float32,
                           device="cpu")
    tm.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return (jm, params), tm


def _turn(eng, prompt, **kw):
    s = eng.admit(list(prompt), **kw)
    while not eng.finished(s):
        eng.step()
    return s, eng.output(s)


@pytest.mark.parametrize("kw", [{}, dict(temperature=0.8, seed=7)],
                         ids=["greedy", "sampled"])
def test_store_with_real_engines_full_cycle(models, tmp_path, kw):
    """Park -> idle-demote -> spill -> store death -> rehydrate into a
    fresh engine and store -> turn 2, on both packages: the tier
    transitions and the spill file's name agree, and turn 2 gives a
    cold re-prefill's ids on each (greedy: the JAX engine's ids too)."""
    (jm, params), tm = models
    engines = {
        "jax": lambda: JEngine(jm, params, n_slots=3, chunk=8,
                               max_new_tokens=6, auto_prefix_min=4,
                               kv_paging=True),
        "torch": lambda: ServingEngine(tm, n_slots=3, chunk=8,
                                       max_new_tokens=6,
                                       auto_prefix_min=4,
                                       kv_paging=True, device="cpu"),
    }
    stores = {"jax": jkv.SessionStore, "torch": tkv.SessionStore}
    got = {}
    for tag, mk in engines.items():
        spill = str(tmp_path / tag)
        chain = P1 + _turn(mk(), P1)[1] + P2
        _, want = _turn(mk(), chain, **kw)
        eng = mk()
        store = stores[tag](eng, spill_dir=spill, device_idle_s=1.0,
                            host_idle_s=1.0)
        s, out1 = _turn(eng, P1, session=SID)
        eng.park_session(s, SID, len(out1))
        store.note_parked(SID, s, 0.0)
        trail = [dict(store.stats())]
        store.tick(2.0)
        trail.append(dict(store.stats()))
        store.tick(5.0)
        trail.append(dict(store.stats()))
        files = sorted(os.listdir(spill))
        del store, eng
        eng2 = mk()
        store2 = stores[tag](eng2, spill_dir=spill)
        tier = store2.prepare(SID, 0.0)
        _, out2 = _turn(eng2, chain, session=SID, **kw)
        assert out2 == want, tag
        for st in trail:
            st.pop("host_bytes", None)
            st.pop("disk_bytes", None)
        got[tag] = (chain, trail, files, tier, out2 if not kw else None)
    assert got["torch"] == got["jax"]
