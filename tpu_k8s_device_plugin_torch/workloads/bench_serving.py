"""Serving benchmark: tokens/sec of the decode loop, and the prefill time.

The uniform mode of the JAX package's ``bench_serving``: one batch of
prompts of one length, greedy, prefill once, then the decode loop timed
best-of-rounds.  Weights are random, built on the device from a seed:

    python -m tpu_k8s_device_plugin_torch.workloads.bench_serving \\
        --config llama3-8b --batch 4 --prompt-len 1024 --steps 32 \\
        --max-len 2048

prints one JSON line.  ``--engine`` times the same decode through the
continuous-batching ``ServingEngine`` instead: one request a slot,
``run_scan`` windows of ``--steps`` steps.  ``--http CLIENTS`` is the
front-door load test: that many concurrent streaming clients against a
live ``EngineServer`` in this process (``--batch`` slots), reporting
req/s, p50/p99 TTFT/TPOT as the wire sees them, goodput and the
server's own span breakdown next to the direct-engine tokens/sec; it
prints one ``key: value`` line per figure, as the JAX benchmark does.
``--prefill-heavy`` (long distinct prompts, packing and overlap off
against on) and ``--decode-heavy`` (seeded-sampled long outputs, the
fused decode loop off against on) are its in-process A/Bs, and
``--no-interleave`` its serial arm.  The speculative and quantized
modes, and the ``--router``, ``--disagg`` and ``--cold-start`` modes
that spawn replicas, are not yet ported: they exit naming their
ROADMAP item.
"""

from __future__ import annotations

import argparse
import json
import math
import time

import torch

from . import llama
from .inference import decode_throughput
from .transformer import _fill_, _unported, resolve_device

CONFIGS = {
    "llama3-8b": llama.LLAMA3_8B,
    "llama3-1b": llama.LLAMA32_1B,
    "llama2-7b": llama.LLAMA2_7B,
    "tiny": llama.TINY_LLAMA,
    "tiny-draft": llama.TINY_DRAFT,
}

@torch.no_grad()
def random_init_(model: torch.nn.Module, seed: int = 0) -> None:
    """Random weights at flax's initializer scales, made on the model's
    device from *seed*: Dense weights lecun-normal (truncated normal,
    sd 1/sqrt(fan_in)), the embedding the flax Embed default (normal,
    sd 1/sqrt(d_model)), norm scales 1.  Each leaf is written in the
    model dtype directly; no f32 copy of the model is made."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    for name, p in model.named_parameters():
        if name.endswith("_norm.scale"):
            p.fill_(1.0)
        elif name == "embed.weight":
            _fill_(p, gen, 1.0 / math.sqrt(p.shape[1]), truncated=False)
        else:  # Dense weight [out, in]
            _fill_(p, gen, 1.0 / math.sqrt(p.shape[1]), truncated=True)


def build_model_and_params(config: str, max_len: int, device=None,
                           seed: int = 0):
    """``(cfg, model)`` for a named config with random bf16 weights
    built directly on *device* (CUDA unless given).  The model holds its
    weights, so there is no separate params tree."""
    cfg = CONFIGS[config]
    model = llama.decoder(cfg, max_len=max_len, device=device)
    random_init_(model, seed)
    return cfg, model


# windows the engine benchmark runs: one warm-up, then the timed rounds
# (run()'s headroom guard counts them)
_ENGINE_WARMUP = 1
_ENGINE_ROUNDS = 3


def _engine_throughput(model, prompt, steps: int,
                       rounds: int = _ENGINE_ROUNDS):
    """Tokens/sec through the continuous-batching engine: one request a
    slot, decode as ``run_scan`` windows of *steps* (on CUDA, replays
    of the captured step), best of *rounds* after one warm-up window
    (which captures the step).  Admission is outside the timed
    region."""
    from .serving import ServingEngine

    batch = prompt.shape[0]
    eng = ServingEngine(model, n_slots=batch, device=model.device)
    prompt_host = prompt.cpu().numpy()
    for b in range(batch):
        eng.admit(prompt_host[b].tolist())
    eng.run_scan(steps)
    best = None
    for _ in range(rounds):
        t0 = time.perf_counter()
        eng.run_scan(steps)  # its harvest waits for the device
        dt = time.perf_counter() - t0
        best = dt if best is None or dt < best else best
    return {
        "tokens_per_sec": batch * steps / best,
        "tokens_per_sec_per_seq": steps / best,
        "batch": float(batch),
        "steps": float(steps),
        "engine": True,
    }


def _percentile(xs, q):
    xs = sorted(xs)
    if not xs:
        return float("nan")
    i = min(len(xs) - 1, int(round(q * (len(xs) - 1))))
    return xs[i]


def _http_burst(port, n_burst: int, tokens, lock):
    """Backpressure burst phase: *n_burst* simultaneous one-shot
    requests (half stall before reading — the slow-client posture)
    against the server's FIXED pool; overflow must come back as fast
    429 + Retry-After, not new threads.  Returns the status list
    (-1 = connection error/reset)."""
    import http.client
    import threading

    statuses = []

    def one(i):
        status = -1
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port,
                                              timeout=60)
            conn.request("POST", "/generate", json.dumps(
                {"tokens": tokens, "max_new_tokens": 4,
                 "stream": False}),
                {"Content-Type": "application/json"})
            if i % 2:
                time.sleep(0.2)
            resp = conn.getresponse()
            resp.read()
            status = resp.status
            conn.close()
        except OSError:
            pass
        with lock:
            statuses.append(status)

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(n_burst)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    return statuses


def _trace_events(port, tid):
    """The flight-recorder events of trace *tid*, from ``/debug/traces``
    (None when the server cannot be reached)."""
    import http.client

    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request("GET", f"/debug/traces?trace_id={tid}")
        body = json.loads(conn.getresponse().read())
        conn.close()
    except OSError:
        return None
    return body.get("events", [])


def _trace_breakdown(port, traced):
    """Admit→first-token breakdown aggregated over every traced
    request, straight from ``/debug/traces``: mean milliseconds spent
    in the queue, in admission (prefill + splice, possibly overlapped
    with an open decode window), and to the first token.  The
    per-request spans are the same ones `_print_slowest_traces` shows
    for the tail."""
    sums = {"tpu_serve_queue_wait": [], "tpu_serve_admit": [],
            "tpu_serve_ttft": []}
    for _latency, tid in traced:
        events = _trace_events(port, tid)
        if events is None:
            continue
        per = {}
        for ev in events:
            d = ev.get("attrs", {}).get("duration_s")
            if isinstance(d, (int, float)) and ev["name"] in sums:
                per[ev["name"]] = per.get(ev["name"], 0.0) + d
        for name, v in per.items():
            sums[name].append(v)
    out = {}
    for name, key in (("tpu_serve_queue_wait", "queue_wait_ms_mean"),
                      ("tpu_serve_admit", "admit_ms_mean"),
                      ("tpu_serve_ttft", "ttft_ms_mean")):
        if sums[name]:
            out[key] = 1e3 * sum(sums[name]) / len(sums[name])
    return out


def _print_slowest_traces(port, traced, k=3):
    """The bench explains its own tail: pull the *k* slowest benched
    requests' server-side timelines from ``/debug/traces`` and print
    each one's span breakdown — queue wait vs TTFT vs decode windows vs
    stream writes — so a bad p99 comes with its own diagnosis."""
    for latency, tid in sorted(traced, reverse=True)[:k]:
        events = _trace_events(port, tid)
        if events is None:
            print(f"slow-trace {tid}: /debug/traces failed", flush=True)
            continue
        sums: dict = {}
        counts: dict = {}
        for ev in events:
            d = ev.get("attrs", {}).get("duration_s")
            if isinstance(d, (int, float)):
                sums[ev["name"]] = sums.get(ev["name"], 0.0) + d
                counts[ev["name"]] = counts.get(ev["name"], 0) + 1
        parts = [f"total={latency * 1e3:.1f}ms"]
        for name, label in (
                ("tpu_serve_queue_wait", "queue_wait"),
                ("tpu_serve_admit", "admit"),
                ("tpu_serve_ttft", "ttft"),
                ("tpu_serve_window", "windows"),
                ("tpu_serve_stream_write", "stream_writes")):
            if name in sums:
                parts.append(
                    f"{label}={sums[name] * 1e3:.1f}ms"
                    + (f"/{counts[name]}x" if counts[name] > 1 else ""))
        print(f"slow-trace {tid}: " + " ".join(parts), flush=True)


def _scrape_metrics_body(port, accept=None):
    """One /metrics scrape as text (plain, or OpenMetrics via
    *accept*)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    headers = {"Accept": accept} if accept else {}
    conn.request("GET", "/metrics", headers=headers)
    body = conn.getresponse().read().decode()
    conn.close()
    return body


def _slo_counts(samples):
    """tpu_slo_requests_total samples -> ({class: total},
    {class: met})."""
    tot, met = {}, {}
    for name, lab, v in samples:
        if name != "tpu_slo_requests_total":
            continue
        c = lab.get("class", "")
        tot[c] = tot.get(c, 0.0) + v
        if lab.get("met") == "true":
            met[c] = met.get(c, 0.0) + v
    return tot, met


def _delta(after: dict, before: dict, key: str) -> float:
    return float(after.get(key, 0) - before.get(key, 0))


def _http_throughput(model, prompt, steps, clients, n_requests, slots,
                     cancel_every: int = 0, burst: int = 0,
                     interleave: bool = True, kv_paging: bool = False,
                     tenants: int = 0, packed_prefill: bool = True,
                     overlap_dispatch: bool = True, metrics_out=None,
                     fused_decode: bool = False, sampled: bool = False,
                     logprobs_k: int = 0):
    """Front-door load test: *clients* concurrent streaming HTTP
    clients drive *n_requests* total requests (mixed priorities; every
    *cancel_every*-th request disconnects after its first token,
    exercising the release path under load) against a live
    ``EngineServer`` over *model*.  Reports req/s and p50/p99 TTFT/TPOT
    as the wire sees them — queueing, scheduler windows and HTTP
    framing included — next to the direct-engine tokens/sec for the
    same model, so the front-door overhead is a number, not a guess.
    *prompt* is a [rows, T] tensor; request i sends row i mod rows."""
    import http.client
    import threading

    import numpy as np

    from .. import obs
    from . import loadclient
    from .qos import parse_tenant_quotas
    from .server import EngineServer
    from .serving import ServingEngine

    prompt_host = np.asarray(prompt.cpu())
    eng = ServingEngine(model, n_slots=slots, kv_paging=kv_paging,
                        fused_decode=fused_decode, logprobs_k=logprobs_k,
                        device=model.device)
    # a deliberately SMALL pool/queue: the load phase fits inside it,
    # and the burst phase overflows it — so the measured path is the
    # production admission-control path, not an unbounded one
    tenant_quotas = None
    if tenants:
        # mixed-priority tenants: tenant-0 is the heavy "batch" lane
        # (weight 1), the rest are interactive lanes at weight 4 — no
        # rate caps, so the phase measures WFQ scheduling, not sheds
        tenant_quotas = parse_tenant_quotas(
            ["tenant-0=0:0:1"]
            + [f"tenant-{i}=0:0:4" for i in range(1, tenants)])
    srv = EngineServer(eng, max_new_tokens=steps, window=16,
                       max_connections=clients + 2,
                       max_queue=max(clients, slots, 4, n_requests
                                     if tenants else 0),
                       interleave=interleave,
                       packed_prefill=packed_prefill,
                       overlap_dispatch=overlap_dispatch,
                       tenant_quotas=tenant_quotas)
    # capture the adaptive-window step variants and the packed shapes
    # before traffic: each would otherwise be captured mid-traffic the
    # first time the batch synchronizes
    srv.warm_scheduler()
    srv.start(host="127.0.0.1", port=0)
    lock = threading.Lock()
    ttfts, tpots, done_tokens, errors = [], [], [], []
    traced = []  # (request latency, trace_id) for the tail breakdown
    cancelled = [0]
    seq = iter(range(n_requests))

    def body_of(i, **extra):
        body = {"tokens": prompt_host[i % len(prompt_host)].tolist(),
                "max_new_tokens": steps, **extra}
        if sampled:
            # SEEDED sampling: deterministic per request, yet the
            # windows are sampled
            body["temperature"] = 0.8
            body["seed"] = i + 1
        if logprobs_k:
            body["logprobs"] = logprobs_k
        return body

    def client_loop(cid):
        while True:
            with lock:
                i = next(seq, None)
            if i is None:
                return
            # mixed priorities: odd requests jump the queue, and ride
            # the interactive SLO class (the rest the batch class)
            req_body = body_of(
                i, priority=i % 2,
                slo_class="interactive" if i % 2 else "batch")
            if tenants:
                req_body["tenant"] = f"tenant-{i % tenants}"
            # the shared load client stamps a fresh traceparent per
            # request and executes the abandoner behavior: every
            # cancel_every-th request disconnects after its first frame
            beh = loadclient.ClientBehavior(
                abandon_after_tokens=1 if cancel_every
                and i % cancel_every == cancel_every - 1 else 0)
            res = loadclient.stream_request(
                "127.0.0.1", srv.port, req_body, behavior=beh,
                timeout_s=600)
            with lock:
                if res.outcome == loadclient.OUTCOME_ABANDONED:
                    cancelled[0] += 1
                elif res.outcome == loadclient.OUTCOME_OK:
                    if res.ttft_s is not None:
                        ttfts.append(res.ttft_s)
                    if res.tpot_s is not None:
                        tpots.append(res.tpot_s)
                    done_tokens.append(res.done_tokens)
                    traced.append((res.total_s, res.trace_id))
                else:
                    # errored requests must not vanish from the stats
                    errors.append(res.error or res.outcome)

    try:
        def _warm_one(i):
            warm = http.client.HTTPConnection("127.0.0.1", srv.port,
                                              timeout=600)
            warm.request("POST", "/generate",
                         json.dumps(body_of(i, stream=False)),
                         {"Content-Type": "application/json"})
            warm.getresponse().read()
            warm.close()

        # warm outside the timed region: twice with the same prompt
        # (the second admit hits the automatic prefix cache), then once
        # concurrently at full width (the grown windows and packs)
        for _ in range(2):
            _warm_one(0)
        warm_threads = [threading.Thread(target=_warm_one, args=(i,))
                        for i in range(slots)]
        for t in warm_threads:
            t.start()
        for t in warm_threads:
            t.join()
        # post-warmup snapshot: the timed phase's figures are deltas
        # against it (warmup requests are not workload)
        stats_warm = srv.stats()
        slo_base_tot, slo_base_met = _slo_counts(
            obs.parse_exposition(_scrape_metrics_body(srv.port)))

        t_start = time.perf_counter()
        threads = [threading.Thread(target=client_loop, args=(c,))
                   for c in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t_start
        # timed-phase snapshot BEFORE the burst phase
        stats_load = srv.stats()
        slo_load_tot, slo_load_met = _slo_counts(
            obs.parse_exposition(_scrape_metrics_body(srv.port)))
        burst_statuses = []
        if burst:
            burst_statuses = _http_burst(
                srv.port, burst, prompt_host[0].tolist(), lock)
        server_stats = srv.stats()
        metrics_body = _scrape_metrics_body(srv.port)
        if metrics_out:
            # both exposition modes, for promlint
            with open(metrics_out, "w") as f:
                f.write(metrics_body)
            with open(metrics_out + ".om", "w") as f:
                f.write(_scrape_metrics_body(
                    srv.port, accept=obs.OPENMETRICS_CONTENT_TYPE))
        _print_slowest_traces(srv.port, traced)
        breakdown = _trace_breakdown(srv.port, traced)
    finally:
        # a failure mid-bench must not leak the live server
        srv.stop()
    if errors and not done_tokens:
        raise RuntimeError(f"every request errored; first: {errors[0]}")
    del srv, eng

    # the direct-engine ceiling for the same shapes: batch = slot count
    eng_stats = _engine_throughput(
        model, prompt[:1].expand(slots, prompt.shape[1]), steps)
    http_tps = sum(done_tokens) / wall
    out = {
        "http": True,
        "clients": float(clients),
        "slots": float(slots),
        "requests_completed": float(len(done_tokens)),
        "requests_cancelled": float(cancelled[0]),
        "requests_abandoned": float(cancelled[0]),
        "server_client_abandons": float(
            server_stats.get("client_abandons", 0)),
        "requests_errored": float(len(errors)),
        "req_per_sec": len(done_tokens) / wall,
        "ttft_ms_p50": _percentile(ttfts, 0.5) * 1e3,
        "ttft_ms_p99": _percentile(ttfts, 0.99) * 1e3,
        "tpot_ms_p50": _percentile(tpots, 0.5) * 1e3,
        "tpot_ms_p99": _percentile(tpots, 0.99) * 1e3,
        "tokens_per_sec_http": http_tps,
        "tokens_per_sec_engine": eng_stats["tokens_per_sec"],
        # goodput: requests/sec meeting their class SLO over the timed
        # phase, from the server's tpu_slo_requests_total deltas
        "goodput_req_per_sec": sum(
            slo_load_met.get(c, 0.0) - slo_base_met.get(c, 0.0)
            for c in slo_load_tot) / wall,
        "front_door_overhead_pct":
            100.0 * (1.0 - http_tps / eng_stats["tokens_per_sec"]),
        "http_over_engine_ratio":
            http_tps / eng_stats["tokens_per_sec"],
        "decode_tokens_per_sec": http_tps,
        "prefill_tokens_per_sec":
            _delta(stats_load, stats_warm, "prefill_tokens") / wall,
        "packed_prefill": float(packed_prefill),
        "overlap_dispatch": float(overlap_dispatch),
        "fused_decode": float(fused_decode),
    }
    for key in ("prefix_cache_hits", "prefix_reused_tokens",
                "packed_prefill_requests", "packed_prefill_extends",
                "packed_prefill_pad_tokens", "fused_windows",
                "fused_truncated_tokens"):
        out[key] = _delta(stats_load, stats_warm, key)
    # per-class goodput: met/sec and the met fraction for every class
    # the timed phase touched
    for c in sorted(slo_load_tot):
        t = slo_load_tot[c] - slo_base_tot.get(c, 0.0)
        if t <= 0:
            continue
        m = slo_load_met.get(c, 0.0) - slo_base_met.get(c, 0.0)
        out[f"goodput_{c}_req_per_sec"] = m / wall
        out[f"goodput_{c}_ratio"] = m / t
    if kv_paging:
        total = max(1, server_stats.get("kv_pages", 0))
        used = total - server_stats.get("kv_pages_free", 0)
        out.update({
            "kv_paging": True,
            "kv_pages_total": float(server_stats.get("kv_pages", 0)),
            "kv_pool_occupancy": used / total,
            "kv_shared_page_ratio":
                server_stats.get("kv_pages_shared", 0) / max(1, used),
            "kv_cow_copies": float(server_stats.get("kv_cow_copies", 0)),
            "kv_preemptions": float(server_stats.get("kv_preemptions", 0)),
            "prefix_evictions": float(server_stats.get(
                "prefix_evictions", 0)),
        })
    if tenants:
        out["tenants"] = float(tenants)
    out.update(breakdown)
    # server-side percentiles, estimated from the scraped histogram
    # buckets (what PromQL histogram_quantile would show a dashboard)
    hist_samples = obs.parse_exposition(metrics_body)
    for key, hname in (("hist_ttft", "tpu_serve_ttft_seconds"),
                       ("hist_tpot", "tpu_serve_token_seconds"),
                       ("hist_request", "tpu_serve_request_seconds"),
                       ("hist_admit_to_first_step",
                        "tpu_serve_admit_to_first_step_seconds")):
        for q, tag in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
            v = obs.histogram_quantile(hist_samples, hname, q)
            if v == v:  # NaN = series absent (no samples)
                out[f"{key}_ms_{tag}"] = v * 1e3
    # mean host-side harvest cost per scheduler window
    ph_sum = sum(v for n, lbl, v in hist_samples
                 if n == "tpu_serve_window_phase_seconds_sum"
                 and lbl.get("phase") == "harvest")
    ph_cnt = sum(v for n, lbl, v in hist_samples
                 if n == "tpu_serve_window_phase_seconds_count"
                 and lbl.get("phase") == "harvest")
    if ph_cnt > 0:
        out["harvest_ms_per_window"] = ph_sum / ph_cnt * 1e3
    if burst:
        out.update({
            "burst_requests": float(burst),
            "burst_ok": float(sum(s == 200 for s in burst_statuses)),
            "burst_429": float(sum(s == 429 for s in burst_statuses)),
            "burst_errors": float(
                sum(s not in (200, 429) for s in burst_statuses)),
            "connections_rejected": float(
                server_stats.get("connections_rejected", 0)),
            "requests_throttled": float(
                server_stats.get("requests_throttled", 0)),
            "http_workers": float(server_stats.get("http_workers", 0)),
        })
    return out


def _check_budget(prompt_len: int, steps: int, max_len: int) -> None:
    budget = steps * (_ENGINE_WARMUP + _ENGINE_ROUNDS)
    if prompt_len + budget > max_len:
        raise ValueError(
            f"prompt_len {prompt_len} + decode budget {budget} exceed "
            f"max_len {max_len}")


def _random_prompts(vocab: int, rows: int, prompt_len: int, seed: int,
                    device):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, vocab, (rows, prompt_len),
                         generator=gen).to(device)


def run_prefill_heavy(config, quantized, clients, n_requests, slots,
                      steps, prompt_len, max_len, seed: int = 0,
                      device=None):
    """Prefill-dominated A/B: long DISTINCT prompts (no APC dedupe)
    with short outputs, once with ragged packing + dispatch overlap ON
    and once OFF over the same model and load, so the delta is the
    packed-prefill/overlap win.  Reports both arms' prefill tok/s,
    HTTP/engine ratio and the admit→first-token breakdown, plus the
    ON/OFF speedup."""
    _unported(quantized=quantized)
    _check_budget(prompt_len, steps, max_len)
    device = resolve_device(device)
    cfg, model = build_model_and_params(config, max_len, device, seed)
    # one DISTINCT prompt per request: prefill every time, pack when
    # concurrent — the workload the packed path exists for
    prompt = _random_prompts(cfg.vocab, max(n_requests, clients),
                             prompt_len, seed + 7, device)
    out = {"prefill_heavy": True, "config": config,
           "quantized": quantized, "prompt_len": float(prompt_len),
           "steps": float(steps)}
    for tag, on in (("off", False), ("on", True)):
        arm = _http_throughput(
            model, prompt, steps, clients, n_requests,
            slots=slots, packed_prefill=on, overlap_dispatch=on)
        for key in ("prefill_tokens_per_sec", "tokens_per_sec_http",
                    "http_over_engine_ratio", "ttft_ms_p50",
                    "ttft_ms_p99", "req_per_sec", "admit_ms_mean",
                    "queue_wait_ms_mean", "ttft_ms_mean",
                    "packed_prefill_requests",
                    "packed_prefill_extends",
                    "packed_prefill_pad_tokens"):
            if key in arm:
                out[f"{key}_{tag}"] = arm[key]
    base = out.get("prefill_tokens_per_sec_off", 0.0)
    if base > 0:
        out["prefill_speedup_x"] = (
            out.get("prefill_tokens_per_sec_on", 0.0) / base)
    if out.get("req_per_sec_off", 0.0) > 0:
        out["req_per_sec_speedup_x"] = (
            out.get("req_per_sec_on", 0.0) / out["req_per_sec_off"])
    return out


def run_decode_heavy(config, quantized, clients, n_requests, slots,
                     steps, prompt_len, max_len, seed: int = 0,
                     device=None):
    """Decode-dominated A/B: SHORT distinct prompts with LONG
    seeded-sampled outputs (logprobs on every request), once with the
    fused decode loop ON and once OFF over the same model and load,
    best of two passes an arm.  Reports both arms' TPOT percentiles,
    harvest-ms per window (from the server's
    tpu_serve_window_phase_seconds{phase="harvest"} histogram) and the
    ON/OFF tokens/sec speedup."""
    _unported(quantized=quantized)
    _check_budget(prompt_len, steps, max_len)
    device = resolve_device(device)
    cfg, model = build_model_and_params(config, max_len, device, seed)
    prompt = _random_prompts(cfg.vocab, max(n_requests, clients),
                             prompt_len, seed + 11, device)
    out = {"decode_heavy": True, "config": config,
           "quantized": quantized, "prompt_len": float(prompt_len),
           "steps": float(steps)}
    for tag, on in (("off", False), ("on", True)):
        arm = max((_http_throughput(
            model, prompt, steps, clients, n_requests,
            slots=slots, sampled=True, fused_decode=on,
            logprobs_k=4)
            for _ in range(2)),
            key=lambda a: a["tokens_per_sec_http"])
        for key in ("tokens_per_sec_http", "http_over_engine_ratio",
                    "tpot_ms_p50", "tpot_ms_p99", "ttft_ms_p50",
                    "req_per_sec", "harvest_ms_per_window",
                    "fused_windows", "fused_truncated_tokens"):
            if key in arm:
                out[f"{key}_{tag}"] = arm[key]
    base = out.get("tokens_per_sec_http_off", 0.0)
    if base > 0:
        out["fused_speedup_x"] = (
            out.get("tokens_per_sec_http_on", 0.0) / base)
    hbase = out.get("harvest_ms_per_window_on", 0.0)
    if hbase > 0 and "harvest_ms_per_window_off" in out:
        out["harvest_speedup_x"] = (
            out["harvest_ms_per_window_off"] / hbase)
    return out


# the JAX benchmark's modes that spawn replicas behind its router
_REPLICA_MODES = "ROADMAP.md, queue 1, item 5.2"


def run(config: str, quantized, batch: int, steps: int, prompt_len: int,
        max_len: int, engine: bool = False, spec: int = 0,
        http_clients: int = 0, http_requests: int = 0,
        cancel_every: int = 0, burst: int = 0,
        interleave: bool = True, kv_paging: bool = False,
        tenants: int = 0, packed_prefill: bool = True,
        overlap_dispatch: bool = True, metrics_out=None,
        fused_decode: bool = False, seed: int = 0, device=None):
    """Uniform-batch decode benchmark; returns the stats dict of
    ``decode_throughput`` (or, with *engine*, of the engine's windows;
    with *http_clients*, of the front-door load test) with the config
    and device added.  The JAX package's arguments in its order, then
    the port's seed and device; the modes not yet ported raise
    ``NotImplementedError``."""
    for flag, on in (("--spec", spec), ("--quantized", quantized)):
        if on:
            raise NotImplementedError(
                f"{flag} is not yet ported (ROADMAP.md, queue 1, item 1b)")
    if http_clients:
        # the post-load direct-engine comparison is the deep consumer
        budget = steps * (_ENGINE_WARMUP + _ENGINE_ROUNDS)
    else:
        budget = steps * ((_ENGINE_WARMUP + _ENGINE_ROUNDS) if engine
                          else 1)
    if prompt_len + budget > max_len:
        raise ValueError(
            f"prompt_len {prompt_len} + decode budget {budget} exceed "
            f"max_len {max_len}")
    device = resolve_device(device)
    cfg, model = build_model_and_params(config, max_len, device, seed)
    prompt = _random_prompts(cfg.vocab, batch, prompt_len, seed + 1,
                             device)
    if http_clients:
        stats = _http_throughput(
            model, prompt, steps, http_clients,
            http_requests or 4 * http_clients, slots=batch,
            cancel_every=cancel_every, burst=burst,
            interleave=interleave, kv_paging=kv_paging,
            tenants=tenants, packed_prefill=packed_prefill,
            overlap_dispatch=overlap_dispatch,
            metrics_out=metrics_out, fused_decode=fused_decode)
    elif engine:
        stats = _engine_throughput(model, prompt, steps)
    else:
        stats = decode_throughput(model, prompt, steps)
    stats["config"] = config
    stats["prompt_len"] = float(prompt_len)
    stats["device"] = (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu")
    return stats


def _report_ratio(stats, key, floor) -> int:
    ratio = stats.get(key, 0.0)
    if ratio < floor:
        print(f"FAIL: {key} {ratio:.3f} below the {floor:.2f} floor",
              flush=True)
        return 1
    print(f"OK: {key} {ratio:.3f} >= {floor:.2f}", flush=True)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="torch-serving-bench")
    p.add_argument("--config", choices=sorted(CONFIGS), default="tiny")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--steps", type=int, default=64)
    p.add_argument("--prompt-len", type=int, default=128)
    p.add_argument("--max-len", type=int, default=512)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda, required)")
    p.add_argument("--engine", action="store_true",
                   help="time the decode through ServingEngine windows")
    p.add_argument("--http", type=int, default=0, metavar="CLIENTS",
                   help="front-door load test: N concurrent streaming "
                        "HTTP clients (mixed priorities) against a "
                        "live EngineServer; --batch sets the slot "
                        "count; reports req/s + p50/p99 TTFT/TPOT vs "
                        "the direct-engine tokens/sec")
    p.add_argument("--requests", type=int, default=0,
                   help="total requests for --http (default 4x clients)")
    p.add_argument("--cancel-every", type=int, default=0, metavar="K",
                   help="with --http: every K-th request disconnects "
                        "after its first token (release-path stress)")
    p.add_argument("--burst", type=int, default=0, metavar="N",
                   help="with --http: after the timed load, N "
                        "simultaneous requests (half slow-reading) "
                        "against the fixed pool — reports the 200/429 "
                        "shed mix")
    p.add_argument("--no-interleave", action="store_true",
                   help="with --http: disable iteration-level "
                        "prefill/decode interleaving (the serial arm; "
                        "outputs identical either way)")
    p.add_argument("--packed-prefill", default=True,
                   action=argparse.BooleanOptionalAction,
                   help="with --http: ragged packed prefill (default on)")
    p.add_argument("--overlap-dispatch", default=True,
                   action=argparse.BooleanOptionalAction,
                   help="with --http: dispatch-ahead overlap (default on)")
    p.add_argument("--fused-decode", default=False,
                   action=argparse.BooleanOptionalAction,
                   help="with --http: the engine's fused decode loop "
                        "(default off)")
    p.add_argument("--prefill-heavy", action="store_true",
                   help="with --http: long distinct prompts, short "
                        "outputs, packing+overlap OFF vs ON")
    p.add_argument("--decode-heavy", action="store_true",
                   help="with --http: short distinct prompts, long "
                        "seeded-sampled outputs, fused decode OFF vs ON")
    p.add_argument("--assert-fused-speedup", type=float, default=0.0,
                   metavar="FLOOR",
                   help="with --decode-heavy: exit nonzero unless "
                        "harvest_speedup_x >= FLOOR")
    p.add_argument("--assert-ratio", type=float, default=0.0,
                   metavar="FLOOR",
                   help="with --http: exit nonzero unless "
                        "http_over_engine_ratio >= FLOOR")
    p.add_argument("--assert-goodput", action="store_true",
                   help="with --http: exit nonzero unless the timed "
                        "phase's goodput is nonzero")
    p.add_argument("--metrics-out", default=None, metavar="PATH",
                   help="with --http: write the post-run /metrics "
                        "scrape to PATH (plain) and PATH.om")
    p.add_argument("--kv-paging", action="store_true",
                   help="with --http: serve from the paged KV pool")
    p.add_argument("--tenants", type=int, default=0, metavar="N",
                   help="with --http: N round-robin tenants under "
                        "weighted fair queueing")
    p.add_argument("--quantized", action="store_true",
                   help="not yet ported")
    p.add_argument("--spec", type=int, default=0, help="not yet ported")
    p.add_argument("--router", type=int, default=0, metavar="N",
                   help="not yet ported")
    p.add_argument("--disagg", action="store_true", help="not yet ported")
    p.add_argument("--cold-start", action="store_true",
                   help="not yet ported")
    args = p.parse_args(argv)
    for flag, on in (("--router", args.router), ("--disagg", args.disagg),
                     ("--cold-start", args.cold_start)):
        if on:
            p.error(f"{flag} is not yet ported ({_REPLICA_MODES})")
    modes = [f for f, on in (("--engine", args.engine),
                             ("--spec", args.spec),
                             ("--http", args.http)) if on]
    if len(modes) > 1:
        p.error(f"{' and '.join(modes)} are mutually exclusive")
    if (args.requests or args.cancel_every or args.burst
            or args.assert_ratio or args.no_interleave
            or args.kv_paging or args.tenants or args.prefill_heavy
            or args.assert_goodput or args.metrics_out
            or args.decode_heavy or args.fused_decode) and not args.http:
        p.error("--requests/--cancel-every/--burst/--assert-ratio/"
                "--no-interleave/--kv-paging/--tenants/--prefill-heavy/"
                "--decode-heavy/--fused-decode/--assert-goodput/"
                "--metrics-out only apply with --http")
    if args.assert_fused_speedup and not args.decode_heavy:
        p.error("--assert-fused-speedup needs --decode-heavy")
    if args.decode_heavy and args.prefill_heavy:
        p.error("--decode-heavy and --prefill-heavy are mutually "
                "exclusive")
    if args.tenants < 0:
        p.error("--tenants must be >= 0")
    heavy = {"prefill": run_prefill_heavy, "decode": run_decode_heavy}
    for kind, fn in heavy.items():
        if not getattr(args, f"{kind}_heavy"):
            continue
        try:
            stats = fn(args.config, args.quantized, clients=args.http,
                       n_requests=args.requests or 4 * args.http,
                       slots=args.batch, steps=args.steps,
                       prompt_len=args.prompt_len, max_len=args.max_len,
                       seed=args.seed, device=args.device)
        except (ValueError, RuntimeError, NotImplementedError) as e:
            p.error(str(e))
        for k, v in stats.items():
            print(f"{k}: {v}", flush=True)
        rc = 0
        if args.assert_fused_speedup:
            rc |= _report_ratio(stats, "harvest_speedup_x",
                                args.assert_fused_speedup)
        if args.assert_ratio:
            rc |= _report_ratio(stats, "http_over_engine_ratio_on",
                                args.assert_ratio)
        return rc
    try:
        stats = run(args.config, args.quantized, args.batch, args.steps,
                    args.prompt_len, args.max_len, engine=args.engine,
                    spec=args.spec, http_clients=args.http,
                    http_requests=args.requests,
                    cancel_every=args.cancel_every, burst=args.burst,
                    interleave=not args.no_interleave,
                    kv_paging=args.kv_paging, tenants=args.tenants,
                    packed_prefill=args.packed_prefill,
                    overlap_dispatch=args.overlap_dispatch,
                    metrics_out=args.metrics_out,
                    fused_decode=args.fused_decode, seed=args.seed,
                    device=args.device)
    except (ValueError, NotImplementedError) as e:
        p.error(str(e))
    if not args.http:
        print(json.dumps(stats), flush=True)
        return 0
    for k, v in stats.items():
        print(f"{k}: {v}", flush=True)
    rc = 0
    if args.assert_ratio:
        rc |= _report_ratio(stats, "http_over_engine_ratio",
                            args.assert_ratio)
    if args.assert_goodput:
        goodput = stats.get("goodput_req_per_sec", 0.0)
        if goodput <= 0:
            print("FAIL: goodput_req_per_sec is zero — the SLO "
                  "accounting saw no met request", flush=True)
            rc = 1
        else:
            print(f"OK: goodput_req_per_sec {goodput:.2f} > 0",
                  flush=True)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
