"""The port's replay harness, mirrored from ``tests/test_replay.py`` and
held to the reference's.

1. Pure units (no sockets, no torch): shared-loadclient frame parsing,
   SLO judging (abandonment excluded from the denominator), the
   span-bucket attribution math, report assembly, and a promlint pass
   over the ``tpu_replay_*`` families in both exposition modes.
2. Live-wire integration against an in-process tiny port engine: the
   same seeded trace replayed twice yields identical per-request
   outcome sets, and the abandonment loop closes end to end.
3. Report plumbing: ``--assert-goodput`` gate exit codes and the
   ``tools/obs_query.py --replay-report`` post-mortem rendering.
4. Parity: the reference's ``replay_trace`` against the same port
   replica gives the same per-request outcomes and the same report
   skeleton; and the fleet mode spawns two port replica CLIs on the
   CPU behind the port's router, one of them killed mid-trace.
"""

import json
import threading
import time

import pytest

from tpu_k8s_device_plugin_torch import obs
from tpu_k8s_device_plugin_torch.workloads import loadclient, replay
from tpu_k8s_device_plugin_torch.workloads.trafficgen import (
    TraceConfig,
    TraceRequest,
    generate,
    write_trace,
)
from tools.promlint import lint

# ---------------------------------------------------------------------------
# layer 1: pure units


def test_parse_frame_fast_path_counts_tokens():
    n, ev = loadclient.parse_frame(b'{"tokens":[1,2,3]}')
    assert (n, ev) == (3, None)  # fast path: no parsed event
    n, ev = loadclient.parse_frame(b'{"tokens":[7]}')
    assert (n, ev) == (1, None)
    # off the fast path (whitespace), a tokens list parses fully
    n, ev = loadclient.parse_frame(b'{"tokens": [4, 5]}')
    assert n == 2 and ev is not None


def test_parse_frame_terminal_and_error():
    # terminal frames count 0 streamed tokens — the full list rides
    # in the parsed event for done_tokens accounting
    n, ev = loadclient.parse_frame(b'{"done":true,"tokens":[1,2]}')
    assert n == 0 and ev is not None and ev.get("done") is True
    assert ev.get("tokens") == [1, 2]
    n, ev = loadclient.parse_frame(b'{"error":"boom","code":500}')
    assert n == 0 and ev is not None and ev.get("error") == "boom"
    n, ev = loadclient.parse_frame(b'{"token":42}')  # legacy frame
    assert n == 1 and ev is not None
    with pytest.raises(ValueError):
        loadclient.parse_frame(b"[1,2,3]")


def test_sse_data_extraction():
    assert loadclient.sse_data(b"data: {\"x\":1}") == b'{"x":1}'
    assert loadclient.sse_data(b"data:[DONE]") is None  # sentinel
    assert loadclient.sse_data(b": keepalive") is None
    assert loadclient.sse_data(b"") is None


def _req(slo_class="interactive", stream=True, rid="r0", t_ms=0.0,
         tenant="default"):
    return TraceRequest(
        rid=rid, t_ms=t_ms, tenant=tenant, slo_class=slo_class,
        priority=0 if stream else 1, prefix_id=0, tokens=[1, 2, 3],
        max_new_tokens=4,
        behavior=loadclient.ClientBehavior(stream=stream))


def _out(outcome=loadclient.OUTCOME_OK, ttft_s=0.01, total_s=0.05):
    return loadclient.StreamOutcome(
        status=200, outcome=outcome, total_s=total_s, ttft_s=ttft_s)


def test_judge_semantics():
    pol = obs.default_slo_policies()
    assert replay.judge(_req(), _out(), pol) is True
    # abandonment is the CLIENT's own doing: excluded, not a miss
    assert replay.judge(
        _req(), _out(outcome=loadclient.OUTCOME_ABANDONED), pol) \
        is None
    assert replay.judge(
        _req(), _out(outcome=loadclient.OUTCOME_SHED), pol) is False
    # a blown TTFT target misses even though the stream finished ok
    assert replay.judge(_req(), _out(ttft_s=10.0), pol) is False
    # unknown class falls back on request shape (stream=interactive)
    assert replay.judge(
        _req(slo_class="mystery"), _out(), pol) is True


def _ev(name, trace, parent, dur_s, **attrs):
    span = obs.new_trace()
    return {"name": name, "trace_id": trace, "span_id": span.span_id,
            "parent_id": parent, "t_wall": 0.0,
            "attrs": dict(attrs, duration_s=dur_s)}


def test_attribution_buckets_and_router_hop():
    tid = "t" * 32
    events = [
        _ev("tpu_serve_queue_wait", tid, None, 0.010),
        _ev("tpu_serve_admit", tid, None, 0.020),
        _ev("tpu_serve_window", tid, None, 0.015),
        _ev("tpu_serve_window", tid, None, 0.015),
        _ev("tpu_serve_stream_write", tid, None, 0.005),
        _ev("tpu_serve_request", tid, None, 0.070, outcome="ok"),
        _ev("tpu_router_proxy", tid, None, 0.090, outcome="ok"),
    ]
    attr = replay.attribute(events, client_total_s=0.100)
    assert attr["queue_wait_ms"] == pytest.approx(10.0)
    assert attr["prefill_ms"] == pytest.approx(20.0)
    assert attr["decode_ms"] == pytest.approx(30.0)  # windows summed
    assert attr["stream_write_ms"] == pytest.approx(5.0)
    # router hop = proxy span minus the server's own span
    assert attr["router_hop_ms"] == pytest.approx(20.0)
    # whatever the spans can't explain stays visible, never hidden
    assert attr["unattributed_ms"] == pytest.approx(
        100.0 - 10 - 20 - 30 - 5 - 20)
    assert set(attr) == set(replay.ATTRIBUTION_KEYS)


def test_attribution_without_router_span():
    tid = "u" * 32
    events = [_ev("tpu_serve_queue_wait", tid, None, 0.004)]
    attr = replay.attribute(events, client_total_s=0.010)
    assert attr["router_hop_ms"] == 0.0
    assert attr["unattributed_ms"] == pytest.approx(6.0)


def test_replay_metrics_promlint_clean_both_modes():
    reg = obs.Registry()
    m = replay.ReplayMetrics(reg, obs.default_slo_policies())
    res = replay.RequestResult(req=_req(), outcome=_out(),
                               lag_s=0.2, late=True, slo_met=True)
    m.observe(res)
    m.observe(replay.RequestResult(
        req=_req(slo_class="batch", stream=False),
        outcome=_out(outcome=loadclient.OUTCOME_ERROR, ttft_s=None),
        lag_s=0.0, late=False, slo_met=False))
    m.set_attainment({"interactive": 1.0, "batch": 0.0})
    for mode in (False, True):
        text = reg.render(openmetrics=mode)
        assert lint(text) == []
    samples = obs.parse_exposition(reg.render())
    by = {}
    for name, labels, value in samples:
        by.setdefault(name, []).append((labels, value))
    assert ("tpu_replay_requests_total" in by
            and "tpu_replay_late_dispatches_total" in by
            and "tpu_replay_slo_attainment_ratio" in by)
    got = {(l["class"], l["outcome"]): v
           for l, v in by["tpu_replay_requests_total"]}
    assert got[("interactive", "ok")] == 1.0
    assert got[("batch", "error")] == 1.0
    assert by["tpu_replay_late_dispatches_total"][0][1] == 1.0


def test_build_report_shape_and_missed_ranking():
    pol = obs.default_slo_policies()
    results = [
        replay.RequestResult(req=_req(rid="fast"), outcome=_out(),
                             lag_s=0.0, late=False, slo_met=True),
        replay.RequestResult(
            req=_req(rid="slowest"),
            outcome=_out(ttft_s=9.0, total_s=9.5),
            lag_s=0.0, late=False, slo_met=False),
        replay.RequestResult(
            req=_req(rid="slower"),
            outcome=_out(ttft_s=5.0, total_s=5.5),
            lag_s=0.0, late=False, slo_met=False),
        replay.RequestResult(
            req=_req(rid="gone"),
            outcome=_out(outcome=loadclient.OUTCOME_ABANDONED),
            lag_s=0.0, late=False, slo_met=None),
    ]
    rep = replay.build_report(
        results, pol, trace_header={"seed": 1}, target="x:1",
        time_scale=1.0, late_ms=100.0)
    assert rep["schema"] == replay.REPORT_SCHEMA
    cls = rep["classes"]["interactive"]
    assert cls["total"] == 4
    assert cls["eligible"] == 3      # abandoned excluded
    assert cls["met"] == 1
    assert cls["attainment"] == pytest.approx(1 / 3, abs=1e-3)
    missed = [r["rid"] for r in rep["slo_missed"]]
    assert missed == ["slowest", "slower"]  # worst first
    assert rep["abandoned"] == 1
    assert all(k in rep["slo_missed"][0]["attribution"]
               for k in replay.ATTRIBUTION_KEYS)


def test_report_per_tenant_attainment():
    pol = obs.default_slo_policies()
    results = [
        replay.RequestResult(req=_req(rid="p0", tenant="prio"),
                             outcome=_out(), lag_s=0.0, late=False,
                             slo_met=True),
        replay.RequestResult(req=_req(rid="p1", tenant="prio"),
                             outcome=_out(), lag_s=0.0, late=False,
                             slo_met=True),
        replay.RequestResult(
            req=_req(rid="b0", tenant="batchfarm"),
            outcome=_out(ttft_s=9.0, total_s=9.5),
            lag_s=0.0, late=False, slo_met=False),
        replay.RequestResult(
            req=_req(rid="b1", tenant="batchfarm"),
            outcome=_out(outcome=loadclient.OUTCOME_ABANDONED),
            lag_s=0.0, late=False, slo_met=None),
    ]
    rep = replay.build_report(
        results, pol, trace_header={"seed": 1}, target="x:1",
        time_scale=1.0, late_ms=100.0)
    t = rep["tenants"]
    assert set(t) == {"prio", "batchfarm"}
    assert t["prio"]["attainment"] == pytest.approx(1.0)
    assert t["prio"]["eligible"] == 2
    # abandonment excluded per-tenant exactly like per-class
    assert t["batchfarm"]["total"] == 2
    assert t["batchfarm"]["eligible"] == 1
    assert t["batchfarm"]["attainment"] == pytest.approx(0.0)
    # the gate's spec grammar reaches the tenant rows
    specs = replay._parse_goodput_specs(
        ["tenant:prio=0.7", "interactive=0.5"])
    assert specs == {"tenant:prio": 0.7, "interactive": 0.5}


def test_goodput_spec_parsing():
    assert replay._parse_goodput_specs(["interactive=0.9"]) \
        == {"interactive": 0.9}
    with pytest.raises(ValueError):
        replay._parse_goodput_specs(["nope"])
    with pytest.raises(ValueError):
        replay._parse_goodput_specs(["c=1.5"])


# ---------------------------------------------------------------------------
# layer 2: live-wire integration (the port's in-process tiny engine)

import torch  # noqa: E402

from tpu_k8s_device_plugin_torch.workloads.bench_serving import (  # noqa: E402
    random_init_)
from tpu_k8s_device_plugin_torch.workloads.inference import (  # noqa: E402
    make_decoder)
from tpu_k8s_device_plugin_torch.workloads.server import (  # noqa: E402
    EngineServer)
from tpu_k8s_device_plugin_torch.workloads.serving import (  # noqa: E402
    ServingEngine)

CFG = dict(vocab=128, d_model=64, n_heads=4, n_layers=2, d_ff=128)

# the trace the determinism proof replays: both classes, shared
# prefixes, fast virtual arrivals so the whole replay stays sub-second
TRACE_CFG = TraceConfig(
    n_requests=14, base_rate_rps=60.0, burst_rate_rps=200.0,
    p_enter_burst=0.2, p_exit_burst=0.2, prefix_chunk=8,
    n_prefixes=4, max_prefix_chunks=2, prompt_median=8.0,
    prompt_max=16, output_median=6.0, output_max=8, vocab=128,
    unary_frac=0.3, slow_reader_frac=0.0, abandon_frac=0.0)


@pytest.fixture(scope="module")
def replay_server():
    model = make_decoder(**CFG, max_len=96, dtype=torch.float32,
                         device="cpu")
    random_init_(model, seed=0)
    eng = ServingEngine(model, n_slots=4, device="cpu")
    srv = EngineServer(eng, max_new_tokens=64, window=4)
    srv.start(host="127.0.0.1", port=0)
    # warm the step variants so replayed latencies are steady-state
    loadclient.stream_request(
        "127.0.0.1", srv.port,
        {"tokens": [1, 2, 3], "max_new_tokens": 4}, timeout_s=120)
    yield srv
    srv.stop()


def _replay_once(srv, requests, policies):
    metrics = replay.ReplayMetrics(obs.Registry(), policies)
    return replay.replay_trace(
        requests, "127.0.0.1", srv.port, policies=policies,
        metrics=metrics, time_scale=1.0, late_ms=100.0,
        timeout_s=60.0)


def _outcome_map(results):
    return {r.req.rid: (r.outcome.status, r.outcome.outcome,
                        r.outcome.done_tokens) for r in results}


def test_deterministic_replay_same_trace_same_outcomes(replay_server):
    requests = generate(TRACE_CFG, 42)
    policies = obs.default_slo_policies()
    first = _outcome_map(_replay_once(replay_server, requests,
                                      policies))
    second = _outcome_map(_replay_once(replay_server, requests,
                                       policies))
    assert first == second
    assert set(first) == {r.rid for r in requests}
    assert all(st == 200 and oc == "ok"
               for st, oc, _ in first.values())
    # open loop honored: ignore_eos'd streams produce exactly the
    # trace's requested token counts, so the counts replay too
    by_rid = {r.rid: r.max_new_tokens for r in requests}
    assert all(first[rid][2] == by_rid[rid] for rid in first)


def test_abandonment_round_trip_client_and_server(replay_server):
    srv = replay_server
    stats0 = loadclient.fetch_json(srv.port, "/stats")
    journal0 = len(srv.recorder.events(
        name="tpu_serve_client_abandon"))
    # a stream long enough (64 tokens, windowed flushes) that a
    # 40 ms abandonment deadline fires mid-stream, reliably
    req = TraceRequest(
        rid="quitter", t_ms=0.0, tenant="default",
        slo_class="interactive", priority=0, prefix_id=0,
        tokens=[3, 5, 7, 9], max_new_tokens=64,
        behavior=loadclient.ClientBehavior(stream=True,
                                           abandon_after_ms=40.0))
    policies = obs.default_slo_policies()
    results = _replay_once(srv, [req], policies)
    assert results[0].outcome.outcome == loadclient.OUTCOME_ABANDONED
    assert results[0].slo_met is None  # not in the SLO denominator
    # the server's side of the story: the handler saw the disconnect,
    # journaled the abandon event, and counted it in /stats
    deadline = time.monotonic() + 20.0
    while time.monotonic() < deadline:
        stats = loadclient.fetch_json(srv.port, "/stats")
        events = srv.recorder.events(name="tpu_serve_client_abandon")
        if int(stats.get("client_abandons", 0)) \
                > int(stats0.get("client_abandons", 0)) \
                and len(events) > journal0:
            break
        time.sleep(0.1)
    assert int(stats.get("client_abandons", 0)) \
        > int(stats0.get("client_abandons", 0))
    assert len(events) > journal0
    assert "tpu_serve_client_abandons_total" in srv.registry.render()


def test_late_dispatches_counted_never_rescheduled(replay_server):
    requests = [_req(rid=f"l{i}", t_ms=float(i)) for i in range(3)]
    policies = obs.default_slo_policies()
    metrics = replay.ReplayMetrics(obs.Registry(), policies)
    results = replay.replay_trace(
        requests, "127.0.0.1", replay_server.port,
        policies=policies, metrics=metrics, time_scale=1.0,
        late_ms=0.0, timeout_s=60.0)  # every real dispatch lags >0ms
    assert all(r.late for r in results)
    assert len(results) == 3  # late ones still ran, exactly once
    samples = obs.parse_exposition(metrics.registry.render())
    late = [v for name, labels, v in samples
            if name == "tpu_replay_late_dispatches_total"]
    assert late == [3.0]


def test_replay_cli_report_gate_and_obs_query(replay_server, tmp_path,
                                              capsys):
    trace = tmp_path / "trace.jsonl"
    write_trace(str(trace), TRACE_CFG, 8, generate(TRACE_CFG, 8))
    report = tmp_path / "report.json"
    metrics_out = tmp_path / "metrics.prom"
    # an impossible TTFT target forces SLO misses so the report's
    # attribution + embedded spans paths are exercised
    rc = replay.main([
        "--trace", str(trace),
        "--target", f"127.0.0.1:{replay_server.port}",
        "--slo", "interactive=0.001", "--slo", "batch=0:0.001",
        "--report", str(report), "--metrics-out", str(metrics_out),
        "--top-missed", "2", "--timeout-s", "60",
        "--assert-goodput", "interactive=0.99"])
    assert rc == 1  # the gate trips: nothing meets a 1ms TTFT
    captured = capsys.readouterr()
    assert "GOODPUT GATE FAIL" in captured.err
    rep = json.loads(report.read_text())
    assert rep["schema"] == replay.REPORT_SCHEMA
    assert rep["classes"]["interactive"]["attainment"] == 0.0
    missed = rep["slo_missed"]
    assert missed and all("attribution" in r for r in missed)
    # the slowest rows embed raw spans for offline stitching
    assert any(r.get("events") for r in missed[:2])
    assert lint(metrics_out.read_text()) == []

    from tools import obs_query
    rc = obs_query.main(["--replay-report", str(report), "--top", "2"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "class interactive: attainment" in out
    assert "where it went:" in out
    assert "tpu_serve_request" in out  # the re-stitched span tree

    # and the gate passes (rc 0) under the generous default policies
    rc = replay.main([
        "--trace", str(trace),
        "--target", f"127.0.0.1:{replay_server.port}",
        "--report", str(report), "--timeout-s", "60",
        "--assert-goodput", "interactive=0.9",
        "--assert-goodput", "batch=0.9"])
    assert rc == 0
    assert "goodput gate ok" in capsys.readouterr().out


def test_obs_query_rejects_foreign_report(tmp_path, capsys):
    from tools import obs_query
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"schema": "something/else"}))
    assert obs_query.main(["--replay-report", str(bad)]) == 2


# ---------------------------------------------------------------------------
# layer 4: the reference's replay against the same port replica, and the
# fleet mode over port replica processes

from tpu_k8s_device_plugin import obs as ref_obs  # noqa: E402
from tpu_k8s_device_plugin.workloads import replay as ref_replay  # noqa: E402
from tpu_k8s_device_plugin.workloads import (  # noqa: E402
    trafficgen as ref_trafficgen)


def test_outcomes_match_reference_replay(replay_server):
    requests = generate(TRACE_CFG, 42)
    ref_cfg = ref_trafficgen.TraceConfig(
        **{k: v for k, v in vars(TRACE_CFG).items()})
    ref_requests = ref_trafficgen.generate(ref_cfg, 42)
    assert [r.to_record() for r in requests] \
        == [r.to_record() for r in ref_requests]
    policies = obs.default_slo_policies()
    ours = _replay_once(replay_server, requests, policies)
    ref_pol = ref_obs.default_slo_policies()
    theirs = ref_replay.replay_trace(
        ref_requests, "127.0.0.1", replay_server.port,
        policies=ref_pol,
        metrics=ref_replay.ReplayMetrics(ref_obs.Registry(), ref_pol),
        time_scale=1.0, late_ms=100.0, timeout_s=60.0)
    assert _outcome_map(ours) == _outcome_map(theirs)
    # the done frames carry the same ids (greedy, one replica)
    rep_p = replay.build_report(
        ours, policies, trace_header={"seed": 42}, target="t",
        time_scale=1.0, late_ms=1e9)
    rep_r = ref_replay.build_report(
        theirs, ref_pol, trace_header={"seed": 42}, target="t",
        time_scale=1.0, late_ms=1e9)
    assert rep_p["schema"] == rep_r["schema"] == replay.REPORT_SCHEMA
    assert set(rep_p) == set(rep_r)
    assert rep_p["outcomes"] == rep_r["outcomes"]
    for name in ("interactive", "batch"):
        for key in ("total", "eligible"):
            assert rep_p["classes"][name][key] \
                == rep_r["classes"][name][key]


def test_fleet_mode_spawns_port_replicas_and_survives_a_kill(
        tmp_path, capsys, monkeypatch):
    """``replay --replicas 2 --device cpu``: an in-process port router,
    two port replica CLIs, the last SIGKILLed mid-trace; the report
    parses with its schema, proves the eviction, and no request fails
    outside a 429 once the breaker has opened."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv(loadclient.REPLICA_LOG_DIR_ENV, str(tmp_path))
    cfg = TraceConfig(
        n_requests=24, base_rate_rps=20.0, burst_rate_rps=40.0,
        p_enter_burst=0.2, p_exit_burst=0.3, prefix_chunk=8,
        n_prefixes=4, max_prefix_chunks=2, prompt_median=8.0,
        prompt_max=16, output_median=6.0, output_max=8, vocab=128,
        unary_frac=0.3, slow_reader_frac=0.0, abandon_frac=0.0)
    trace = tmp_path / "trace.jsonl"
    write_trace(str(trace), cfg, 5, generate(cfg, 5))
    report = tmp_path / "report.json"
    rc = replay.main([
        "--trace", str(trace), "--replicas", "2", "--config", "tiny",
        "--device", "cpu", "--slots", "2", "--max-len", "64",
        "--max-new-tokens", "16", "--prefix-chunk", "8", "--seed", "5",
        "--kill-replica-at-ms", "300", "--timeout-s", "60",
        "--report", str(report)])
    capsys.readouterr()
    assert rc == 0
    rep = json.loads(report.read_text())
    assert rep["schema"] == replay.REPORT_SCHEMA
    chaos = rep["chaos"]
    assert chaos["killed_replica"] == "replay-1"
    assert chaos["recovery_probes_ok"] == chaos["recovery_probes"] == 3
    assert rep["fleet_statz"] is not None
    # the logs the spawn helper kept name the port's server on the CPU
    logs = sorted(p.name for p in tmp_path.glob("replay-*.log"))
    assert len(logs) == 2, logs
