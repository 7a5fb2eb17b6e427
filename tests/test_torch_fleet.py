"""The port's fleet control plane, mirrored from ``tests/test_fleet.py``
and held to the reference's:

1. Pure decision core (no sockets, no clocks): seeded statz sequences
   fed to :class:`FleetPlanner` replay to DETERMINISTIC action
   sequences — hysteresis/cooldown (no flap), failure replacement
   bypassing cooldown, the degraded-slice rolling drain keyed on
   generation mismatch (never the flag alone), role choice under
   disagg, scale-to-zero, and capacity-bounded placement.
2. Capacity + router surfaces without HTTP: ``--capacity-spec``
   parsing, membership files written by the reference's slice agent
   and read through the port's own ``slice/state.py``, and the router's
   ``POST /drain`` semantics called as plain methods.
3. One live e2e (``slow``): the controller brings 2 port replica CLIs
   up on the CPU behind an in-process port router, a SIGKILL
   mid-flight is healed with a journaled, metric-counted failure
   replacement, and a drain takes a replica out of rotation without
   killing its process.
4. Parity: the port's planner gives the reference's plans over the
   recorded observation sequence; the port's membership reader gives
   the reference's record; every spawn helper of the fleet tier starts
   the port's server with the device it was given.
"""

import json
import os
import signal
import threading
import time

import pytest

from tpu_k8s_device_plugin import slice as ref_slice
from tpu_k8s_device_plugin_torch import obs
from tpu_k8s_device_plugin_torch.slice import state as slice_state
from tpu_k8s_device_plugin_torch.workloads import fleet, loadclient
from tpu_k8s_device_plugin_torch.workloads.fleet import (
    Action,
    FleetController,
    FleetMetrics,
    FleetObservation,
    FleetPlanner,
    PlannerConfig,
    ReplicaView,
    SliceCapacity,
)
from tpu_k8s_device_plugin_torch.workloads.router import RouterServer
from tools.promlint import lint

# ---------------------------------------------------------------------------
# layer 1: the pure decision core


CFG = PlannerConfig(min_replicas=1, max_replicas=4,
                    high_watermark=1.5, low_watermark=0.25,
                    up_stable_s=1.0, down_stable_s=5.0,
                    idle_to_zero_s=30.0, cooldown_s=3.0,
                    drain_timeout_s=10.0)
SLICES = (SliceCapacity("s0", 1, 4),)


def _rv(rid, state="ready", q=0, inf=0, cap=2, gen=1, alive=True,
        t0=0.0, role="mixed", dr=0.0, drr=""):
    return ReplicaView(
        rid=rid, role=role, state=state, slice_id="s0",
        generation=gen, alive=alive, healthy=True, queue_depth=q,
        in_flight=inf, capacity=cap, started_at_s=t0,
        drain_started_at_s=dr, drain_reason=drr)


def _obs(now, replicas, slices=SLICES, **kw):
    fleet_caps = sum(r.capacity for r in replicas
                     if r.state != "draining")
    kw.setdefault("capacity", fleet_caps)
    return FleetObservation(now_s=now, replicas=tuple(replicas),
                            slices=slices, **kw)


def test_empty_fleet_spawns_the_floor():
    plan = FleetPlanner(CFG).plan(_obs(0.0, ()))
    assert [(a.kind, a.reason) for a in plan.actions] \
        == [("spawn", "floor")]
    assert plan.actions[0].slice_id == "s0"
    assert plan.desired == 1


def test_hysteresis_pressure_must_sustain_before_scale_up():
    p = FleetPlanner(CFG)
    hot = _rv("fleet-1", q=6, inf=2)
    # first hot cycle: the up timer just started, nothing happens
    assert p.plan(_obs(10.0, (hot,), queue_depth=6, in_flight=2,
                       requests_served=5)).actions == ()
    # still hot 0.5s later: under up_stable_s, still held
    assert p.plan(_obs(10.5, (hot,), queue_depth=6, in_flight=2,
                       requests_served=9)).actions == ()
    # a calm cycle resets the timer entirely
    assert p.plan(_obs(11.0, (_rv("fleet-1"),),
                       requests_served=12)).actions == ()
    assert p.plan(_obs(12.4, (hot,), queue_depth=6, in_flight=2,
                       requests_served=15)).actions == ()
    # sustained past up_stable_s: scale up, reason=pressure
    plan = p.plan(_obs(13.6, (hot,), queue_depth=6, in_flight=2,
                       requests_served=20))
    assert [(a.kind, a.reason) for a in plan.actions] \
        == [("spawn", "pressure")]


def test_cooldown_blocks_back_to_back_scale_ups():
    p = FleetPlanner(CFG)
    hot1 = _rv("fleet-1", q=8, inf=2)
    p.plan(_obs(0.0, (hot1,), queue_depth=8, in_flight=2,
                requests_served=1))
    plan = p.plan(_obs(1.5, (hot1,), queue_depth=8, in_flight=2,
                       requests_served=2))
    assert [a.kind for a in plan.actions] == ["spawn"]
    # still hot immediately after: cooldown holds the loop
    hot2 = (_rv("fleet-1", q=8, inf=2), _rv("fleet-2", q=8, inf=2,
                                            t0=1.5))
    for t in (2.0, 3.0, 4.0):
        assert p.plan(_obs(t, hot2, queue_depth=16, in_flight=4,
                           requests_served=t)).actions == ()
    # cooldown over + pressure sustained: the next step is allowed
    plan = p.plan(_obs(5.0, hot2, queue_depth=16, in_flight=4,
                       requests_served=9))
    assert [a.kind for a in plan.actions] == ["spawn"]


def test_burning_slo_scales_up_with_goodput_reason():
    p = FleetPlanner(CFG)
    calm = _rv("fleet-1", q=0, inf=1)
    goodput = {"interactive": {"goodput_ratio": 0.4,
                               "burn_rate_max": 5.0,
                               "window_total": 20.0}}
    p.plan(_obs(0.0, (calm,), in_flight=1, goodput=goodput,
                requests_served=1))
    plan = p.plan(_obs(1.2, (calm,), in_flight=1, goodput=goodput,
                       requests_served=2))
    assert [(a.kind, a.reason) for a in plan.actions] \
        == [("spawn", "goodput")]
    # an empty window must NOT read as burning (ratio fields default
    # pessimistic in some exporters)
    p2 = FleetPlanner(CFG)
    empty = {"batch": {"goodput_ratio": 0.0, "burn_rate_max": 99.0,
                       "window_total": 0.0}}
    p2.plan(_obs(0.0, (calm,), in_flight=1, goodput=empty,
                 requests_served=1))
    assert p2.plan(_obs(1.2, (calm,), in_flight=1, goodput=empty,
                        requests_served=2)).actions == ()


def test_scale_in_drains_newest_after_sustained_calm():
    p = FleetPlanner(CFG)
    reps = (_rv("fleet-1", t0=0.0), _rv("fleet-2", t0=5.0))
    p.plan(_obs(100.0, reps, requests_served=50))
    assert p.plan(_obs(102.0, reps, requests_served=50)).actions == ()
    plan = p.plan(_obs(106.0, reps, requests_served=50))
    assert [(a.kind, a.reason, a.rid) for a in plan.actions] \
        == [("drain", "pressure", "fleet-2")]  # newest goes first
    # min_replicas=1 floors the shrink: with one left, no more drains
    p2 = FleetPlanner(CFG)
    one = (_rv("fleet-1"),)
    p2.plan(_obs(100.0, one, requests_served=50))
    assert p2.plan(_obs(120.0, one, requests_served=50)).actions == ()


def test_scale_to_zero_needs_min_zero_and_sustained_idle():
    cfg0 = PlannerConfig(min_replicas=0, max_replicas=2,
                         idle_to_zero_s=10.0, cooldown_s=1.0,
                         down_stable_s=60.0)
    p = FleetPlanner(cfg0)
    rep = (_rv("fleet-1"),)
    p.plan(_obs(0.0, rep, requests_served=30))
    # served counter still moving = not idle, timer keeps resetting
    assert p.plan(_obs(5.0, rep, requests_served=31)).actions == ()
    assert p.plan(_obs(11.0, rep, requests_served=32)).actions == ()
    # flat served + empty queues for idle_to_zero_s: drain to zero
    assert p.plan(_obs(15.0, rep, requests_served=32)).actions == ()
    plan = p.plan(_obs(26.0, rep, requests_served=32))
    assert [(a.kind, a.reason, a.rid) for a in plan.actions] \
        == [("drain", "idle", "fleet-1")]


def test_scale_from_zero_on_router_no_replica_pressure():
    cfg0 = PlannerConfig(min_replicas=0, max_replicas=2)
    p = FleetPlanner(cfg0)
    # zero replicas, no demand: stays at zero
    assert p.plan(_obs(0.0, (), no_replica_total=7)).actions == ()
    # the router sheds with no_replicas: the delta is the wake signal
    plan = p.plan(_obs(1.0, (), no_replica_total=9))
    assert [(a.kind, a.reason) for a in plan.actions] \
        == [("spawn", "pressure")]


def test_dead_replica_replaced_immediately_bypassing_cooldown():
    p = FleetPlanner(CFG)
    hot = _rv("fleet-1", q=8, inf=2)
    p.plan(_obs(0.0, (hot,), queue_depth=8, in_flight=2,
                requests_served=1))
    plan = p.plan(_obs(1.5, (hot,), queue_depth=8, in_flight=2,
                       requests_served=2))
    assert [a.kind for a in plan.actions] == ["spawn"]  # cooldown set
    # SIGKILL lands: stop+spawn the same cycle, cooldown irrelevant
    reps = (_rv("fleet-1", alive=False), _rv("fleet-2", t0=1.5))
    plan = p.plan(_obs(2.0, reps, requests_served=3))
    kinds = [(a.kind, a.reason) for a in plan.actions]
    assert ("stop", "failure") in kinds
    assert ("spawn", "failure") in kinds


def test_degraded_drain_keys_on_generation_not_flag():
    p = FleetPlanner(CFG)
    reps = (_rv("fleet-1", t0=0.0), _rv("fleet-2", t0=1.0))
    # the slice flips degraded WITHOUT a generation bump: replicas
    # still match advertised shape — draining here would loop forever
    # (the replacement would land on the same "degraded" generation)
    flagged = (SliceCapacity("s0", 1, 4, degraded=True),)
    assert p.plan(_obs(10.0, reps, slices=flagged,
                       requests_served=1)).actions == ()
    # the reshape lands (generation 2): rolling drain, ONE at a time,
    # oldest first
    reshaped = (SliceCapacity("s0", 2, 4, degraded=True),)
    plan = p.plan(_obs(11.0, reps, slices=reshaped,
                       requests_served=2))
    assert [(a.kind, a.reason, a.rid) for a in plan.actions] \
        == [("drain", "degraded", "fleet-1")]
    # while one drains, the second stale replica WAITS
    reps2 = (_rv("fleet-1", state="draining", dr=11.0,
                 drr="degraded", q=1),
             _rv("fleet-2", t0=1.0))
    assert p.plan(_obs(12.0, reps2, slices=reshaped,
                       requests_served=3)).actions == ()


def test_drain_completion_respawns_on_the_new_generation():
    p = FleetPlanner(CFG)
    reshaped = (SliceCapacity("s0", 2, 4),)
    reps = (_rv("fleet-1", state="draining", dr=10.0, drr="degraded",
                q=0, inf=0),
            _rv("fleet-2", t0=1.0, gen=2))
    plan = p.plan(_obs(12.0, reps, slices=reshaped,
                       requests_served=1))
    acts = [(a.kind, a.reason, a.generation) for a in plan.actions]
    assert ("stop", "degraded", 1) in acts
    assert ("spawn", "degraded", 2) in acts
    # a stuck drain is cut off at drain_timeout_s even with queue
    p2 = FleetPlanner(CFG)
    stuck = (_rv("fleet-1", state="draining", dr=0.0, drr="degraded",
                 q=5, inf=1),)
    plan = p2.plan(_obs(11.0, stuck, slices=reshaped,
                        requests_served=1))
    assert ("stop", "degraded", 1) in [
        (a.kind, a.reason, a.generation) for a in plan.actions]


def test_drain_needs_min_dwell_before_trusting_empty_queues():
    # the statz snapshot behind a drain verdict can be one scrape
    # interval stale: queue==0 at drain age < drain_min_s must NOT
    # complete the drain (stopping then tears live streams), but the
    # same observation past the dwell must
    p = FleetPlanner(CFG)
    reshaped = (SliceCapacity("s0", 2, 4),)
    fresh = (_rv("fleet-1", state="draining", dr=10.0,
                 drr="degraded", q=0, inf=0),
             _rv("fleet-2", t0=1.0, gen=2))
    plan = p.plan(_obs(10.0 + CFG.drain_min_s / 2, fresh,
                       slices=reshaped, requests_served=1))
    assert all(a.kind != "stop" for a in plan.actions)
    plan = p.plan(_obs(10.0 + CFG.drain_min_s, fresh,
                       slices=reshaped, requests_served=2))
    assert ("stop", "degraded") in [
        (a.kind, a.reason) for a in plan.actions]


def test_capacity_bounds_scale_out():
    tight = (SliceCapacity("s0", 1, 2),)  # 2 slots only
    p = FleetPlanner(CFG)
    reps = (_rv("fleet-1", q=9, inf=2), _rv("fleet-2", q=9, inf=2,
                                            t0=1.0))
    p.plan(_obs(0.0, reps, slices=tight, queue_depth=18, in_flight=4,
                requests_served=1))
    # pressure is sustained but every advertised slot is taken
    plan = p.plan(_obs(2.0, reps, slices=tight, queue_depth=18,
                       in_flight=4, requests_served=2))
    assert plan.actions == ()
    # max_replicas also caps even when slots are free
    cfg2 = PlannerConfig(min_replicas=1, max_replicas=2,
                         up_stable_s=1.0, cooldown_s=0.5)
    p2 = FleetPlanner(cfg2)
    p2.plan(_obs(0.0, reps, queue_depth=18, in_flight=4,
                 requests_served=1))
    assert p2.plan(_obs(2.0, reps, queue_depth=18, in_flight=4,
                        requests_served=2)).actions == ()


def test_disagg_role_choice_covers_phases_then_follows_pressure():
    cfg = PlannerConfig(min_replicas=1, max_replicas=4, disagg=True,
                        up_stable_s=0.5, cooldown_s=0.1)
    p = FleetPlanner(cfg)
    # empty fleet: first spawn is prefill (phase coverage first)
    plan = p.plan(_obs(0.0, ()))
    assert plan.actions[0].role == "prefill"
    # prefill exists, no decode: next is decode
    pre = _rv("fleet-1", role="prefill", q=9, inf=2)
    p.plan(_obs(1.0, (pre,), queue_depth=9, in_flight=2,
                requests_served=1))
    plan = p.plan(_obs(2.0, (pre,), queue_depth=9, in_flight=2,
                       requests_served=2))
    assert [a.role for a in plan.actions if a.kind == "spawn"] \
        == ["decode"]
    # both covered: the deeper-queued phase gets the third replica
    both = (_rv("fleet-1", role="prefill", q=1),
            _rv("fleet-2", role="decode", q=9, inf=2, t0=1.0))
    p.plan(_obs(3.0, both, queue_depth=10, in_flight=2,
                requests_served=3))
    plan = p.plan(_obs(4.0, both, queue_depth=10, in_flight=2,
                       requests_served=4))
    spawns = [a.role for a in plan.actions if a.kind == "spawn"]
    assert spawns == ["decode"]
    # scale-in never drains the last replica of a live role
    calm = (_rv("fleet-1", role="prefill", t0=0.0),
            _rv("fleet-2", role="decode", t0=1.0))
    p2 = FleetPlanner(PlannerConfig(
        min_replicas=1, max_replicas=4, disagg=True,
        down_stable_s=1.0, cooldown_s=0.1))
    p2.plan(_obs(10.0, calm, requests_served=9))
    plan = p2.plan(_obs(12.0, calm, requests_served=9))
    # fleet-2 (decode) is newest but is the last decode; fleet-1 is
    # the last prefill — neither is a safe victim, so the fleet holds
    assert all(a.kind != "drain" for a in plan.actions)


def test_planner_is_deterministic_over_a_recorded_sequence():
    hot = _rv("fleet-1", q=6, inf=2)
    seq = [
        _obs(0.0, ()),
        _obs(1.0, (hot,), queue_depth=6, in_flight=2,
             requests_served=3),
        _obs(2.2, (hot,), queue_depth=6, in_flight=2,
             requests_served=8),
        _obs(3.0, (_rv("fleet-1", alive=False),
                   _rv("fleet-2", t0=2.2)), requests_served=9),
        _obs(9.0, (_rv("fleet-2", t0=2.2), _rv("fleet-3", t0=3.0)),
             requests_served=9),
        _obs(15.0, (_rv("fleet-2", t0=2.2), _rv("fleet-3", t0=3.0)),
             requests_served=9),
    ]
    a = [FleetPlanner(CFG).plan(o) for o in [seq[0]]]
    p1, p2 = FleetPlanner(CFG), FleetPlanner(CFG)
    plans1 = [p1.plan(o) for o in seq]
    plans2 = [p2.plan(o) for o in seq]
    assert plans1 == plans2
    assert a[0] == plans1[0]
    # the sequence actually exercises transitions, not just holds
    kinds = [a.kind for pl in plans1 for a in pl.actions]
    assert "spawn" in kinds and "stop" in kinds and "drain" in kinds


def test_planner_config_validation():
    with pytest.raises(ValueError):
        PlannerConfig(min_replicas=3, max_replicas=2)
    with pytest.raises(ValueError):
        PlannerConfig(low_watermark=2.0, high_watermark=1.0)
    with pytest.raises(ValueError):
        PlannerConfig(goodput_floor=1.5)


# ---------------------------------------------------------------------------
# layer 2: capacity sources + the router drain surface (no HTTP)


def test_capacity_spec_parses_and_rejects_garbage(tmp_path):
    path = tmp_path / "cap.json"
    path.write_text(json.dumps({"slices": [
        {"slice_id": "s0", "generation": 3, "workers": 2},
        {"slice_id": "s1", "generation": 1, "workers": 4,
         "degraded": True, "max_replicas": 2},
    ]}))
    caps = fleet.load_capacity_spec(str(path))
    assert [c.slice_id for c in caps] == ["s0", "s1"]
    assert caps[0].slots == 2          # defaults to workers
    assert caps[1].slots == 2          # max_replicas overrides
    assert caps[1].degraded
    for bad in ("[]", '{"slices": "no"}',
                '{"slices": [{"generation": 1}]}'):
        path.write_text(bad)
        with pytest.raises(ValueError):
            fleet.load_capacity_spec(str(path))


def test_capacity_from_membership_reads_labeller_state(tmp_path):
    # the file is the slice agent's: the reference's writer makes it
    m = ref_slice.Membership(
        slice_id="slice-a", generation=4,
        hostnames=("h0", "h1"), coordinator_address="h0:8476",
        degraded=True)
    p = tmp_path / "membership.json"
    ref_slice.save_membership(str(p), m)
    caps = fleet.capacity_from_membership(
        [str(p), str(tmp_path / "absent.json")])
    assert len(caps) == 1
    assert caps[0] == SliceCapacity(
        slice_id="slice-a", generation=4, workers=2, degraded=True)


def test_router_drain_takes_replica_out_of_rotation():
    rt = RouterServer(statz_interval_s=60.0, replica_ttl_s=60.0)
    rt.register({"address": "127.0.0.1:9001", "replica_id": "a",
                 "capacity": 4})
    rt.register({"address": "127.0.0.1:9002", "replica_id": "b",
                 "capacity": 4})
    def pick_rid():
        rep, _hit = rt.pick(None)
        return rep.rid if rep is not None else None

    # least-loaded tie-break is deterministic: "a" wins while routable
    assert pick_rid() == "a"
    out = rt.drain({"replica_id": "a"})
    assert out["ok"] and out["draining"]
    # pick() now never lands on the draining replica...
    assert pick_rid() == "b"
    # ...and with both draining, nothing is routable at all
    rt.drain({"replica_id": "b"})
    assert pick_rid() is None
    rt.drain({"replica_id": "b", "draining": False})
    # ...but its row survives (heartbeats keep flowing), flagged
    rows = {r["replica_id"]: r for r in rt.replicas()}
    assert rows["a"]["draining"] and not rows["b"]["draining"]
    per_rep = rt.fleet_statz()["per_replica"]
    assert per_rep["a"]["draining"] is True
    # heartbeat re-registration does not resurrect it into rotation
    rt.register({"address": "127.0.0.1:9001", "replica_id": "a",
                 "capacity": 4})
    assert pick_rid() == "b"
    # undrain puts it back (and the tie-break favors it again)
    rt.drain({"replica_id": "a", "draining": False})
    assert pick_rid() == "a"
    # a ghost is a caller bug (404), a bad body a 400
    with pytest.raises(KeyError):
        rt.drain({"replica_id": "nope"})
    with pytest.raises(ValueError):
        rt.drain({"replica_id": ""})


def test_fleet_metrics_promlint_clean():
    registry = obs.Registry()
    m = FleetMetrics(registry)
    m.scale_events.labels(direction="up", reason="pressure").inc()
    m.decisions.labels(action="spawn").inc()
    m.drain_seconds.observe(1.5)
    m.replicas.set(2.0)
    m.desired.set(3.0)
    for mode in ("prom", "openmetrics"):
        problems = lint(registry.render(mode))
        assert problems == [], problems


# ---------------------------------------------------------------------------
# layer 3: live e2e — the controller drives real replica CLIs


@pytest.mark.slow
def test_controller_heals_sigkill_and_drains_live(tmp_path):
    registry = obs.Registry()
    recorder = obs.FlightRecorder(registry=registry)
    rt = RouterServer(statz_interval_s=0.3, replica_ttl_s=5.0,
                      breaker_reset_s=0.5, seed=3,
                      registry=registry)
    rt.start(host="127.0.0.1", port=0)
    cap = tmp_path / "capacity.json"
    cap.write_text(json.dumps({"slices": [
        {"slice_id": "live", "generation": 1, "workers": 2}]}))
    cache = str(tmp_path / "compile-cache")
    controller = FleetController(
        f"http://127.0.0.1:{rt.port}",
        config=PlannerConfig(min_replicas=2, max_replicas=2,
                             start_grace_s=600.0,
                             down_stable_s=600.0,
                             idle_to_zero_s=600.0),
        server=fleet.ServerSpec(config="tiny", slots=2, max_len=256,
                                max_new_tokens=32,
                                compile_cache_dir=cache, device="cpu"),
        capacity_spec=str(cap), interval_s=0.25, seed=3,
        registry=registry, recorder=recorder)
    loop = threading.Thread(target=controller.run, daemon=True)

    def healthy_count():
        return sum(1 for r in rt.replicas() if r.get("healthy"))

    def wait_for(pred, timeout_s, what):
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if pred():
                return
            time.sleep(0.2)
        raise AssertionError(f"timed out waiting for {what}")

    try:
        loop.start()
        # the floor rule brings up both replicas (port replica CLIs on
        # the CPU; the port keeps no compile cache)
        wait_for(lambda: healthy_count() >= 2, 600.0,
                 "2 healthy replicas")
        # traffic routes end to end through the router
        out = loadclient.stream_request(
            "127.0.0.1", rt.port,
            {"tokens": [1, 2, 3], "max_new_tokens": 4},
            timeout_s=120.0)
        assert out.outcome == loadclient.OUTCOME_OK

        # chaos: SIGKILL one managed replica; the reconciler must
        # stop the corpse and spawn a journaled failure replacement
        rid0, proc0 = controller.managed()[0]
        proc0.send_signal(signal.SIGKILL)
        wait_for(
            lambda: any(
                e["attrs"].get("reason") == "failure"
                for e in recorder.events(
                    name="tpu_fleet_replica_spawned")),
            120.0, "failure replacement journaled")
        wait_for(lambda: healthy_count() >= 2, 600.0,
                 "healed back to 2 healthy replicas")
        rids = {rid for rid, _ in controller.managed()}
        assert rid0 not in rids and len(rids) == 2

        # the failure scale-up is metric-backed, not just journaled
        samples = obs.parse_exposition(registry.render())
        up_failure = [
            v for name, labels, v in samples
            if name == "tpu_fleet_scale_events_total"
            and labels.get("direction") == "up"
            and labels.get("reason") == "failure"]
        assert up_failure and up_failure[0] >= 1.0
        assert any(name == "tpu_fleet_replicas" and v == 2.0
                   for name, labels, v in samples)

        # drain one replica directly: out of rotation, process alive
        rid1, proc1 = controller.managed()[0]
        controller._drain(Action(kind="drain", reason="degraded",
                                 rid=rid1))
        wait_for(
            lambda: {r["replica_id"]: r for r in rt.replicas()}
            .get(rid1, {}).get("draining") is True,
            30.0, "router marks the replica draining")
        assert proc1.poll() is None  # drained, NOT killed
        # and pick() avoids it while it drains
        for _ in range(8):
            rep, _hit = rt.pick(None)
            assert rep is not None and rep.rid != rid1
    finally:
        controller.shutdown()
        rt.stop()


class _FakeProc:
    """A replica process that records its SIGKILL."""

    def __init__(self):
        self.killed = False

    def poll(self):
        return -9 if self.killed else None

    def kill(self):
        self.killed = True


def test_kill_serving_spares_drained_starting_and_stale(tmp_path):
    """The episode's SIGKILL takes a ready replica on the advertised
    generation: never one that is draining or starting, nor one the
    degraded rolling drain will take, and no replica when none
    qualifies."""
    cap = tmp_path / "capacity.json"
    cap.write_text(json.dumps({"slices": [
        {"slice_id": "s0", "generation": 2, "workers": 4}]}))
    controller = FleetController("http://127.0.0.1:1",
                                 capacity_spec=str(cap))

    def add(rid, state, generation):
        controller._procs[rid] = fleet._Managed(
            rid=rid, proc=_FakeProc(), port=0, role="mixed",
            slice_id="s0", generation=generation, state=state,
            started_at_s=0.0)

    add("draining", "draining", 2)
    add("stale", "ready", 1)
    add("starting", "starting", 2)
    assert controller.kill_serving() is None
    add("serving", "ready", 2)
    assert controller.kill_serving() == "serving"
    assert [rid for rid, p in controller.managed() if p.killed] \
        == ["serving"]
    # a corpse is not a victim twice
    assert controller.kill_serving() is None


# ---------------------------------------------------------------------------
# layer 4: the reference's planner and membership reader, and the spawn
# helpers' command lines

import dataclasses  # noqa: E402

from tpu_k8s_device_plugin.slice import state as ref_state  # noqa: E402
from tpu_k8s_device_plugin.workloads import fleet as ref_fleet  # noqa: E402


def _recorded_sequence(mod):
    """``test_planner_is_deterministic_over_a_recorded_sequence``'s
    observations, built from *mod*'s types."""
    slices = (mod.SliceCapacity("s0", 1, 4),)

    def rv(rid, alive=True, t0=0.0, q=0, inf=0):
        return mod.ReplicaView(
            rid=rid, role="mixed", state="ready", slice_id="s0",
            generation=1, alive=alive, healthy=True, queue_depth=q,
            in_flight=inf, capacity=2, started_at_s=t0)

    def ob(now, replicas, **kw):
        kw.setdefault("capacity", sum(r.capacity for r in replicas))
        return mod.FleetObservation(now_s=now, replicas=tuple(replicas),
                                    slices=slices, **kw)

    hot = rv("fleet-1", q=6, inf=2)
    return [
        ob(0.0, ()),
        ob(1.0, (hot,), queue_depth=6, in_flight=2, requests_served=3),
        ob(2.2, (hot,), queue_depth=6, in_flight=2, requests_served=8),
        ob(3.0, (rv("fleet-1", alive=False), rv("fleet-2", t0=2.2)),
           requests_served=9),
        ob(9.0, (rv("fleet-2", t0=2.2), rv("fleet-3", t0=3.0)),
           requests_served=9),
        ob(15.0, (rv("fleet-2", t0=2.2), rv("fleet-3", t0=3.0)),
           requests_served=9),
    ]


def _planner(mod):
    return mod.FleetPlanner(mod.PlannerConfig(**dataclasses.asdict(CFG)))


def test_planner_plans_match_reference_over_recorded_sequence():
    p, r = _planner(fleet), _planner(ref_fleet)
    ours = [dataclasses.asdict(p.plan(o))
            for o in _recorded_sequence(fleet)]
    theirs = [dataclasses.asdict(r.plan(o))
              for o in _recorded_sequence(ref_fleet)]
    assert ours == theirs
    kinds = [a["kind"] for pl in ours for a in pl["actions"]]
    assert "spawn" in kinds and "stop" in kinds and "drain" in kinds


@pytest.mark.parametrize("degraded,lineage", [
    (False, ()), (True, ("slice-a-g3", "slice-a-g2"))])
def test_membership_reader_matches_reference(tmp_path, degraded,
                                             lineage):
    m = ref_state.Membership(
        slice_id="slice-a", generation=4, hostnames=("h1", "h0", "h2"),
        coordinator_address="h1:8476", reshaped_from=lineage,
        degraded=degraded)
    p = tmp_path / "membership.json"
    ref_state.save_membership(str(p), m, member_coords={"h0": (0, 1)},
                              evicted={"h9"})
    ours = slice_state.load_membership(str(p))
    theirs = ref_state.load_membership(str(p))
    assert ours.to_dict() == theirs.to_dict()
    assert (ours.num_workers, ours.rank_of("h2")) \
        == (theirs.num_workers, theirs.rank_of("h2"))
    assert fleet.capacity_from_membership([str(p)]) == tuple(
        SliceCapacity(c.slice_id, c.generation, c.workers, c.degraded)
        for c in ref_fleet.capacity_from_membership([str(p)]))
    # a corrupt, foreign-version or absent file reads as nothing in both
    for text in ("{", json.dumps(dict(m.to_dict(), version=9))):
        p.write_text(text)
        assert slice_state.load_membership(str(p)) is None
        assert ref_state.load_membership(str(p)) is None
    assert slice_state.load_membership(str(tmp_path / "none")) is None


class _Spawned:
    """What ``subprocess.Popen`` was asked to start, in place of a
    process."""

    pid = 0

    def __init__(self, cmd, **kw):
        self.cmd = list(cmd)
        self.env = kw.get("env")

    def poll(self):
        return None


@pytest.mark.parametrize("device", ["cpu", None])
def test_every_spawn_helper_starts_the_port_server(monkeypatch, device):
    """The four places of the fleet tier that spawn replicas (replay's
    fleet mode, the reconciler, ``bench_serving``'s router/disagg
    replicas and its cold-start server) start the port's server CLI and
    pass the device through; without one the replica runs on CUDA."""
    import argparse
    import subprocess

    from tpu_k8s_device_plugin_torch.workloads import bench_serving, replay

    monkeypatch.setattr(subprocess, "Popen", _Spawned)
    monkeypatch.delenv(loadclient.REPLICA_LOG_DIR_ENV, raising=False)
    args = argparse.Namespace(
        config="tiny", slots=2, max_len=64, max_new_tokens=8,
        prefix_chunk=0, slo=None, seed=0, device=device)
    controller = FleetController(
        "http://127.0.0.1:1",
        server=fleet.ServerSpec(device=device or ""))
    cmds = {
        "replay": replay._spawn_replica(0, 1, 2, args).cmd,
        "fleet": controller._spawn(Action(
            kind="spawn", reason="floor", slice_id="s0",
            generation=1)) and controller.managed()[0][1].cmd,
        "bench_replica": bench_serving._spawn_replica(
            "tiny", False, 0, 1, 2, 2, 8, 8, 64, role="decode",
            device=device).cmd,
        "bench_server": bench_serving._spawn_server(
            "tiny", False, 1, 2, 8, 64, [], device=device).cmd,
    }
    for where, cmd in cmds.items():
        assert cmd[1:3] == ["-m", loadclient.SERVER_MODULE], where
        assert loadclient.SERVER_MODULE \
            == "tpu_k8s_device_plugin_torch.workloads.server"
        if device is None:
            assert "--device" not in cmd, where
        else:
            assert cmd[cmd.index("--device") + 1] == device, where
    assert "--kv-paging" in cmds["bench_replica"]
