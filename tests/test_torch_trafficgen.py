"""The port's trace generator against the reference's.

The first part mirrors ``tests/test_trafficgen.py`` on the port's copy:
byte-identical determinism, schema round-trip, the reader's rejection
of damaged traces, the shape and mix invariants and the CLI.  The last
part holds the two packages to each other: for several seeds and
configurations (tenant mixes, session revisits, shared prefixes) the
port's ``dumps_trace`` is byte-identical to the reference's, and each
package's ``load_trace`` reads the file the other wrote.
"""

import dataclasses
import json

import pytest

from tpu_k8s_device_plugin_torch.workloads.trafficgen import (
    SCHEMA,
    TraceConfig,
    TraceError,
    TraceRequest,
    _prefix_block,
    dumps_trace,
    generate,
    load_trace,
    loads_trace,
    main,
    parse_session_revisit,
    parse_tenant_mix,
    summarize,
    write_trace,
)

# small but non-trivial: both classes, slow readers, abandoners
CFG = TraceConfig(n_requests=80, base_rate_rps=20.0,
                  burst_rate_rps=120.0, p_enter_burst=0.1,
                  p_exit_burst=0.2, prefix_chunk=8, n_prefixes=4,
                  max_prefix_chunks=2, prompt_median=10.0,
                  prompt_max=24, output_median=6.0, output_max=8,
                  vocab=128, unary_frac=0.3, slow_reader_frac=0.2,
                  abandon_frac=0.2)


# -- determinism -----------------------------------------------------------


def test_same_seed_is_byte_identical(tmp_path):
    a = dumps_trace(CFG, 7, generate(CFG, 7))
    b = dumps_trace(CFG, 7, generate(CFG, 7))
    assert a == b
    pa, pb = tmp_path / "a.jsonl", tmp_path / "b.jsonl"
    write_trace(str(pa), CFG, 7, generate(CFG, 7))
    write_trace(str(pb), CFG, 7, generate(CFG, 7))
    assert pa.read_bytes() == pb.read_bytes()


def test_different_seed_differs():
    assert dumps_trace(CFG, 1, generate(CFG, 1)) \
        != dumps_trace(CFG, 2, generate(CFG, 2))


def test_timestamps_monotonic_and_virtual():
    reqs = generate(CFG, 3)
    ts = [r.t_ms for r in reqs]
    assert ts == sorted(ts)
    assert ts[0] > 0.0


# -- schema round-trip -----------------------------------------------------


def test_round_trip_preserves_every_record(tmp_path):
    reqs = generate(CFG, 11)
    path = tmp_path / "t.jsonl"
    write_trace(str(path), CFG, 11, reqs)
    header, loaded = load_trace(str(path))
    assert header["schema"] == SCHEMA
    assert header["seed"] == 11
    assert header["requests"] == len(reqs) == len(loaded)
    assert [r.to_record() for r in loaded] \
        == [r.to_record() for r in reqs]
    # behaviors survive the round trip typed, not as dicts
    assert all(type(r.behavior) is type(reqs[0].behavior)
               for r in loaded)


def test_reload_of_dumped_trace_redumps_identically():
    reqs = generate(CFG, 5)
    text = dumps_trace(CFG, 5, reqs)
    header, loaded = loads_trace(text)
    assert dumps_trace(CFG, 5, loaded) == text


# -- reader rejection ------------------------------------------------------


def _trace_lines(seed=9):
    return dumps_trace(CFG, seed, generate(CFG, seed)).splitlines()


def test_truncated_trace_rejected():
    lines = _trace_lines()
    with pytest.raises(TraceError, match="truncated or padded"):
        loads_trace("\n".join(lines[:-3]) + "\n")


def test_padded_trace_rejected():
    lines = _trace_lines()
    with pytest.raises(TraceError, match="truncated or padded"):
        loads_trace("\n".join(lines + [lines[-1]]) + "\n")


def test_unknown_schema_version_rejected():
    lines = _trace_lines()
    header = json.loads(lines[0])
    header["schema"] = "tpu-trace/v999"
    bad = "\n".join([json.dumps(header)] + lines[1:])
    with pytest.raises(TraceError, match="unsupported trace schema"):
        loads_trace(bad)


def test_malformed_record_line_rejected():
    lines = _trace_lines()
    lines[3] = lines[3][: len(lines[3]) // 2]  # chopped mid-JSON
    with pytest.raises(TraceError, match="malformed record"):
        loads_trace("\n".join(lines) + "\n")


def test_wrong_field_type_rejected():
    lines = _trace_lines()
    rec = json.loads(lines[2])
    rec["tokens"] = "not-a-list"
    lines[2] = json.dumps(rec)
    with pytest.raises(TraceError):
        loads_trace("\n".join(lines) + "\n")


def test_backwards_time_rejected():
    lines = _trace_lines()
    a, b = json.loads(lines[1]), json.loads(lines[2])
    a["t_ms"], b["t_ms"] = b["t_ms"], a["t_ms"]
    a["rid"], b["rid"] = b["rid"], a["rid"]
    lines[1], lines[2] = json.dumps(a), json.dumps(b)
    with pytest.raises(TraceError, match="goes backwards"):
        loads_trace("\n".join(lines) + "\n")


def test_empty_and_non_object_header_rejected():
    with pytest.raises(TraceError):
        loads_trace("")
    with pytest.raises(TraceError):
        loads_trace("[1,2,3]\n")


# -- shape invariants ------------------------------------------------------


def test_shared_prefixes_chunk_aligned_and_exact():
    reqs = generate(CFG, 21)
    blocks = {pid: _prefix_block(21, CFG, pid)
              for pid in range(CFG.n_prefixes)}
    for r in reqs:
        block = blocks[r.prefix_id]
        assert len(block) % CFG.prefix_chunk == 0
        # the request's prompt STARTS with its prefix block exactly —
        # what the APC cache and the router's affinity key hash over
        assert r.tokens[: len(block)] == block
        assert len(r.tokens) > len(block)  # always a unique suffix
        assert all(0 < t < CFG.vocab for t in r.tokens)
        assert CFG.output_min <= r.max_new_tokens <= CFG.output_max


def test_zipf_head_dominates():
    counts = {}
    for r in generate(CFG, 13):
        counts[r.prefix_id] = counts.get(r.prefix_id, 0) + 1
    assert counts.get(0, 0) == max(counts.values())


def test_mix_covers_both_classes_and_behaviors():
    reqs = generate(CFG, 17)
    s = summarize(reqs)
    assert set(s["classes"]) == {"interactive", "batch"}
    assert s["unary"] > 0 and s["slow_readers"] > 0 \
        and s["abandoners"] > 0
    # behavior coupling: unary requests are batch-class, never
    # slow-read or abandoned (those are streaming-client behaviors)
    for r in reqs:
        if not r.behavior.stream:
            assert r.slo_class == "batch" and r.priority == 1
            assert r.behavior.read_bytes_per_s == 0
            assert r.behavior.abandon_after_ms == 0.0
        else:
            assert r.slo_class == "interactive" and r.priority == 0


def test_weighted_tenants_skew_and_determinism():
    cfg = dataclasses.replace(CFG, tenants=("prio", "batchfarm"),
                              tenant_weights=(9.0, 1.0))
    reqs = generate(cfg, 23)
    counts = summarize(reqs)["tenants"]
    # 9:1 over 80 draws: the heavy tenant must dominate, the light one
    # must still appear (weights partition, they don't exclude)
    assert counts["prio"] > counts.get("batchfarm", 0) * 3
    assert counts.get("batchfarm", 0) > 0
    # weighted draws are part of the same determinism contract
    assert dumps_trace(cfg, 23, generate(cfg, 23)) \
        == dumps_trace(cfg, 23, reqs)


def test_unweighted_tenants_unchanged_by_weights_field():
    # tenant_weights=None must take the historical randrange arm:
    # a pre-existing trace config regenerates byte-identically
    base = dataclasses.replace(CFG, tenants=("a", "b", "c"))
    explicit = dataclasses.replace(CFG, tenants=("a", "b", "c"),
                                   tenant_weights=None)
    assert [r.tenant for r in generate(base, 7)] \
        == [r.tenant for r in generate(explicit, 7)]


def test_parse_tenant_mix():
    names, weights = parse_tenant_mix("prio:3,batchfarm:1")
    assert names == ("prio", "batchfarm")
    assert weights == (3.0, 1.0)
    # weightless mix keeps the unweighted (historical) draw arm
    names, weights = parse_tenant_mix("a,b")
    assert names == ("a", "b") and weights is None
    # partial weights: unannotated entries default to 1.0
    names, weights = parse_tenant_mix("a:2,b")
    assert weights == (2.0, 1.0)
    assert parse_tenant_mix(None) == (("default",), None)
    assert parse_tenant_mix("", ("x",)) == (("x",), None)
    with pytest.raises(ValueError):
        parse_tenant_mix("a:nope")
    with pytest.raises(ValueError):
        parse_tenant_mix(":3")


def test_session_revisit_deterministic_and_consistent():
    cfg = dataclasses.replace(CFG, session_revisit=(0.5, 1000.0))
    reqs = generate(cfg, 11)
    assert all(r.session for r in reqs)
    seen = set()
    for r in reqs:
        if r.cont:
            assert r.session in seen  # revisits target earlier sessions
        seen.add(r.session)
    s = summarize(reqs)
    assert s["revisits"] > 0
    assert s["sessions"] == len(seen)
    assert s["sessions"] + s["revisits"] == len(reqs)
    # revisit gaps advance the clock, never rewind it
    ts = [r.t_ms for r in reqs]
    assert ts == sorted(ts)
    # the session dimension is part of the determinism contract
    assert dumps_trace(cfg, 11, generate(cfg, 11)) \
        == dumps_trace(cfg, 11, reqs)


def test_unsessioned_trace_unchanged_by_revisit_field():
    # session_revisit=None must add ZERO rng draws and ZERO record
    # keys: a pre-existing trace config regenerates byte-identically
    explicit = dataclasses.replace(CFG, session_revisit=None)
    a = [json.dumps(r.to_record()) for r in generate(CFG, 7)]
    b = [json.dumps(r.to_record()) for r in generate(explicit, 7)]
    assert a == b
    assert all('"session"' not in line for line in a)


def test_session_fields_round_trip(tmp_path):
    cfg = dataclasses.replace(CFG, session_revisit=(0.4, 500.0))
    path = tmp_path / "sess.jsonl"
    write_trace(str(path), cfg, 9, generate(cfg, 9))
    _, back = load_trace(str(path))
    orig = generate(cfg, 9)
    assert [(r.session, r.cont) for r in back] \
        == [(r.session, r.cont) for r in orig]


def test_parse_session_revisit():
    assert parse_session_revisit(None) is None
    assert parse_session_revisit("") is None
    assert parse_session_revisit("0.3") == (0.3, 1000.0)
    assert parse_session_revisit("0.3:500") == (0.3, 500.0)
    assert parse_session_revisit("0:0") == (0.0, 0.0)
    with pytest.raises(ValueError):
        parse_session_revisit("1.5")
    with pytest.raises(ValueError):
        parse_session_revisit("0.3:-1")
    with pytest.raises(ValueError):
        parse_session_revisit("nope")


def test_config_validation():
    with pytest.raises(ValueError):
        TraceConfig(n_requests=0)
    with pytest.raises(ValueError):
        TraceConfig(vocab=2)
    with pytest.raises(ValueError):
        TraceConfig(unary_frac=1.5)
    with pytest.raises(ValueError):
        TraceConfig(tenants=())
    with pytest.raises(ValueError):
        TraceConfig(tenants=("a", "b"), tenant_weights=(1.0,))
    with pytest.raises(ValueError):
        TraceConfig(tenants=("a",), tenant_weights=(0.0,))
    with pytest.raises(ValueError):
        TraceConfig(session_revisit=(1.5, 0.0))
    with pytest.raises(ValueError):
        TraceConfig(session_revisit=(0.5, -1.0))


def test_cli_writes_loadable_trace(tmp_path, capsys):
    out = tmp_path / "cli.jsonl"
    rc = main(["--out", str(out), "--seed", "4", "--requests", "30",
               "--prefix-chunk", "8", "--n-prefixes", "4",
               "--prompt-max", "32", "--output-max", "8",
               "--vocab", "128", "--tenant", "acme",
               "--tenant", "globex"])
    assert rc == 0
    header, reqs = load_trace(str(out))
    assert len(reqs) == 30
    assert {r.tenant for r in reqs} <= {"acme", "globex"}
    printed = json.loads(capsys.readouterr().out)
    assert printed["summary"]["requests"] == 30


# -- parity with the reference ---------------------------------------------

from tpu_k8s_device_plugin.workloads import trafficgen as ref  # noqa: E402
from tpu_k8s_device_plugin_torch.workloads import (  # noqa: E402
    trafficgen as port)

PARITY_CFGS = {
    "mixed": {},
    "tenants": dict(tenants=("prio", "batchfarm", "free"),
                    tenant_weights=(6.0, 3.0, 1.0)),
    "sessions": dict(session_revisit=(0.4, 750.0)),
    "prefixes": dict(prefix_chunk=16, n_prefixes=8, max_prefix_chunks=3,
                     prompt_median=40.0, prompt_max=96),
    "unweighted": dict(tenants=("a", "b", "c"), unary_frac=0.0,
                       slow_reader_frac=0.0, abandon_frac=0.0),
}


def _cfgs(name):
    kw = dict(dataclasses.asdict(CFG), **PARITY_CFGS[name])
    for key in ("tenants", "tenant_weights", "session_revisit"):
        if isinstance(kw.get(key), list):
            kw[key] = tuple(kw[key])
    return port.TraceConfig(**kw), ref.TraceConfig(**kw)


@pytest.mark.parametrize("seed", [0, 7, 1234])
@pytest.mark.parametrize("name", sorted(PARITY_CFGS))
def test_dumps_trace_byte_identical_to_reference(name, seed):
    pcfg, rcfg = _cfgs(name)
    ours = port.dumps_trace(pcfg, seed, port.generate(pcfg, seed))
    theirs = ref.dumps_trace(rcfg, seed, ref.generate(rcfg, seed))
    assert ours == theirs
    assert port.summarize(port.generate(pcfg, seed)) \
        == ref.summarize(ref.generate(rcfg, seed))


@pytest.mark.parametrize("name", ["tenants", "sessions"])
def test_each_package_reads_the_others_trace(tmp_path, name):
    pcfg, rcfg = _cfgs(name)
    mine, theirs = tmp_path / "port.jsonl", tmp_path / "ref.jsonl"
    port.write_trace(str(mine), pcfg, 5, port.generate(pcfg, 5))
    ref.write_trace(str(theirs), rcfg, 5, ref.generate(rcfg, 5))
    assert mine.read_bytes() == theirs.read_bytes()
    h_port, by_port = port.load_trace(str(theirs))
    h_ref, by_ref = ref.load_trace(str(mine))
    assert h_port == h_ref
    assert [r.to_record() for r in by_port] \
        == [r.to_record() for r in by_ref]
    assert port.dumps_trace(pcfg, 5, by_port) \
        == ref.dumps_trace(rcfg, 5, by_ref)


def test_cli_writes_the_reference_cli_bytes(tmp_path, capsys):
    argv = ["--seed", "7", "--requests", "32", "--base-rate", "10",
            "--burst-rate", "50", "--prefix-chunk", "16",
            "--n-prefixes", "4", "--prompt-median", "16",
            "--prompt-max", "32", "--output-median", "12",
            "--output-max", "24", "--vocab", "256"]
    a, b = tmp_path / "a.jsonl", tmp_path / "b.jsonl"
    assert port.main(["--out", str(a), *argv]) == 0
    assert ref.main(["--out", str(b), *argv]) == 0
    capsys.readouterr()
    assert a.read_bytes() == b.read_bytes()
