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
``--no-interleave`` its serial arm.  ``--router N`` (with
``--router-kill`` and ``--assert-scaling``), ``--disagg`` (with
``--assert-disagg``) and ``--cold-start`` spawn replicas of the port's
server CLI, on ``--device`` (default CUDA), behind the port's router or
alone.  ``--quantized`` (weight-only int8) and ``--int4`` build the
model directly in that layout (``llama.random_quantized_params``), in
every mode that builds one.  ``--spec GAMMA`` measures speculative
rounds through the engine with the paired draft (``DRAFT_FOR``): the
round and plain-step times, the break-even accept rate and the implied
tokens/s over accept rates.
"""

from __future__ import annotations

import argparse
import json
import math
import time

import torch

from . import llama
from .inference import decode_throughput
from .transformer import _fill_, resolve_device

CONFIGS = {
    "llama3-8b": llama.LLAMA3_8B,
    "llama3-1b": llama.LLAMA32_1B,
    "llama2-7b": llama.LLAMA2_7B,
    "tiny": llama.TINY_LLAMA,
    "tiny-draft": llama.TINY_DRAFT,
}

# the draft each config is paired with for --spec (same vocabulary)
DRAFT_FOR = {
    "llama3-8b": "llama3-1b",
    "tiny": "tiny-draft",
}

@torch.no_grad()
def random_init_(model: torch.nn.Module, seed: int = 0) -> None:
    """Random weights at flax's initializer scales, made on the model's
    device from *seed*: Dense weights lecun-normal (truncated normal,
    sd 1/sqrt(fan_in)), the embedding the flax Embed default (normal,
    sd 1/sqrt(d_model)), norm scales 1; the MoE router and expert stacks
    lecun-normal over their input dim, LoRA A normal with sd 0.01 and B
    zeros (the JAX initialisers).  Each leaf is written in the model
    dtype directly; no f32 copy of the model is made.  Quantized models
    take ``llama.random_quantized_params`` instead."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    for name, p in _init_order(model):
        _init_leaf_(name, p, gen)


def _init_order(model: torch.nn.Module):
    """*model*'s ``(name, parameter)`` pairs in the order
    :func:`random_init_` draws them: the adapter stacks last, so a
    model's base weights are those of the same model without adapters
    from the same seed."""
    return sorted(model.named_parameters(), key=lambda kv: "_lora_" in kv[0])


def _init_leaf_(name: str, p: torch.Tensor, gen: torch.Generator) -> None:
    """Fill the whole leaf *name* in place as :func:`random_init_` does."""
    leaf = name.rpartition(".")[2]
    if p.dtype == torch.int8 or leaf.endswith("_scale") or (
            leaf == "scale" and not name.endswith("_norm.scale")):
        raise ValueError(f"{name}: quantized models take "
                         "llama.random_quantized_params")
    if name.endswith("_norm.scale"):
        p.fill_(1.0)
    elif name == "embed.weight":
        _fill_(p, gen, 1.0 / math.sqrt(p.shape[1]), truncated=False)
    elif leaf.endswith("_lora_A"):
        _fill_(p, gen, 0.01, truncated=False)
    elif leaf.endswith("_lora_B"):
        p.zero_()
    elif leaf in ("router", "experts_up", "experts_down"):
        # [D, E], [E, D, F], [E, F, D]: fan-in is the dim before last
        _fill_(p, gen, 1.0 / math.sqrt(p.shape[-2]), truncated=True)
    else:  # Dense weight [out, in]
        _fill_(p, gen, 1.0 / math.sqrt(p.shape[1]), truncated=True)


def build_model_and_params(config: str, max_len: int, device=None,
                           seed: int = 0, quantized=False, mesh=None,
                           dtype=None):
    """``(cfg, model)`` for a named config (or a ``llama.LlamaConfig``)
    with random weights built directly on *device* (CUDA unless given):
    bf16 (or *dtype*), or with
    *quantized* (True for int8, ``"int4"``) the quantized layout from
    ``llama.random_quantized_params``, so no bf16 copy is made.  The
    model holds its weights, so there is no separate params tree
    (``load_checkpoint_params`` gives the same pair from a checkpoint).

    With *mesh* the model is this rank's split over its ``model`` axis
    (``inference.tp_twin``), built one leaf at a time: each leaf is
    drawn whole, in the order and from the generator the whole model's
    are, and only this rank's piece of it is kept, so the pieces equal
    the slices of the whole model from the same seed and the peak is
    one whole leaf."""
    cfg = CONFIGS[config] if isinstance(config, str) else config
    kw = {} if dtype is None else {"dtype": dtype}
    if mesh is not None:
        return cfg, _build_split(cfg, max_len, device, seed, quantized,
                                 mesh, kw)
    model = llama.decoder(cfg, max_len=max_len, quantized=quantized,
                          device=device, **kw)
    if quantized:
        params = llama.random_quantized_params(
            cfg, seed=seed, bits=4 if quantized == "int4" else 8,
            device=model.device)
        model.load_state_dict(params)
        del params
    else:
        random_init_(model, seed)
    return cfg, model


@torch.no_grad()
def _fill_split(whole_model, model, leaves) -> None:
    """Copy this rank's piece of each ``(name, whole leaf)`` of *leaves*
    into the split *model* (``inference.tp_twin`` of *whole_model*),
    one leaf at a time; every parameter must be named once."""
    from .inference import tp_piece

    params = dict(model.named_parameters())
    m, r = model.tp_size, model.tp_rank
    for name, whole in leaves:
        params.pop(name).copy_(tp_piece(whole_model, name, whole, m, r))
    if params:
        raise ValueError(f"leaves missing from the tree: "
                         f"{sorted(params)[:5]}")


@torch.no_grad()
def _build_split(cfg, max_len: int, device, seed: int, quantized, mesh,
                 kw) -> torch.nn.Module:
    """:func:`build_model_and_params`'s split model (see there)."""
    from .inference import tp_twin

    device = resolve_device(device)
    whole = llama.decoder(cfg, max_len=max_len, quantized=quantized,
                          device="meta", **kw)
    model = tp_twin(whole, mesh, device="meta")
    model.to_empty(device=device)
    if quantized:
        leaves = llama.random_quantized_leaves(
            cfg, seed=seed, bits=4 if quantized == "int4" else 8,
            device=device)
    else:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)

        def drawn():
            for name, p in _init_order(whole):
                leaf = torch.empty(p.shape, dtype=p.dtype, device=device)
                _init_leaf_(name, leaf, gen)
                yield name, leaf

        leaves = drawn()
    _fill_split(whole, model, leaves)
    return model


def _train_init(cfg, device="meta"):
    """The train-layout template: ``llama.train_model(cfg)``'s state
    dict (f32), the tree a training run saves under ``"params"``.  On
    the ``meta`` device by default, so that it holds shapes and dtypes
    and nothing is materialised twice."""
    return llama.train_model(cfg, device=device).state_dict()


def load_checkpoint_params(config: str, max_len: int, quantized,
                           checkpoint_dir: str, step=None, device=None,
                           mesh=None):
    """``(cfg, model)`` as :func:`build_model_and_params` gives them, with
    REAL weights restored from a checkpoint (``workloads.checkpoint``
    layout, state ``{"params": ...}`` in the f32 train layout — what a
    training run saves).  The single-chip recipe: the train tree
    restores into host memory, is quantized there for *quantized*
    (True: int8, ``"int4"``), and loads strictly into
    ``llama.decoder(cfg, ...)`` on *device* (CUDA unless given), so only
    the serving tree reaches the card and every key is consumed.  The
    train model's keys are the decoder's (``train_model`` and
    ``decoder`` build the same layers), so no mapping is needed; the
    load casts each f32 leaf to its parameter's dtype once.

    With *mesh* the model is this rank's split over its ``model`` axis,
    as :func:`build_model_and_params` gives it: each restored leaf is
    quantized on the host (for *quantized*: quantize first, slice
    after) and only this rank's piece of it goes to *device*."""
    from .checkpoint import restore_checkpoint
    from .inference import quantize_lm_params, quantize_lm_params_int4

    cfg = CONFIGS[config]
    device = resolve_device(device)
    restored = restore_checkpoint(
        checkpoint_dir, step=step, template={"params": _train_init(cfg)})
    params = restored.pop("params")
    quant = None
    if quantized == "int4":
        quant = quantize_lm_params_int4
    elif quantized:
        quant = quantize_lm_params
    if mesh is not None:
        from .inference import tp_twin

        whole = llama.decoder(cfg, max_len=max_len, quantized=quantized,
                              device="meta")
        model = tp_twin(whole, mesh, device="meta")
        model.to_empty(device=device)

        def leaves():
            while params:
                key, leaf = params.popitem()
                yield from (quant({key: leaf}) if quant
                            else {key: leaf}).items()

        _fill_split(whole, model, leaves())
        return cfg, model
    if quant is not None:
        params = quant(params)
    model = llama.decoder(cfg, max_len=max_len, quantized=quantized,
                          device=device)
    model.load_state_dict(params, strict=True)
    return cfg, model


def _quant_args(quantized) -> list:
    """The server CLI's flag for *quantized*."""
    if quantized == "int4":
        return ["--int4"]
    return ["--quantized"] if quantized else []


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


def _spec_throughput(model, draft_model, prompt, gamma: int, steps: int,
                     rounds: int = _ENGINE_ROUNDS):
    """Speculative-round economics through the engine.  Random weights
    make the measured accept rate meaningless, but a round's time does
    not depend on the data, so this reports a plain step's time (one
    timed window of *steps*, after a warm-up window) and a round's (best
    of *rounds*, after a warm-up round) and the throughput they imply
    over accept rates, with the break-even accept probability:

        E[commit | p] = 1 + sum_{k=1..gamma} p^k
        tokens/sec(p) = batch * E[commit | p] / t_round
        break-even:     E[commit | p*] = t_round / t_step

    The plain step is a window of *steps* replays of the captured step
    on CUDA; the spec round runs op by op."""
    from .serving import ServingEngine

    batch = prompt.shape[0]
    eng = ServingEngine(model, n_slots=batch, draft=draft_model,
                        gamma=gamma, device=model.device)
    prompt_host = prompt.cpu().numpy()
    for b in range(batch):
        eng.admit(prompt_host[b].tolist())
    eng.run_scan(steps)  # the captures
    t0 = time.perf_counter()
    eng.run_scan(steps)  # its harvest waits for the device
    t_step = (time.perf_counter() - t0) / steps
    eng.spec_round()     # warm propose and verify
    best = None
    for _ in range(rounds):
        t0 = time.perf_counter()
        eng.spec_round()  # reads the verify's argmaxes
        dt = time.perf_counter() - t0
        best = dt if best is None or dt < best else best

    def commit(p):
        return 1.0 + sum(p ** k for k in range(1, gamma + 1))

    # the break-even accept rate: bisect E[commit | p] = t_round / t_step
    ratio = best / t_step
    if ratio <= 1.0:
        breakeven = 0.0
    elif ratio >= commit(1.0):
        breakeven = 1.0
    else:
        lo, hi = 0.0, 1.0
        for _ in range(40):
            mid = (lo + hi) / 2
            lo, hi = (mid, hi) if commit(mid) < ratio else (lo, mid)
        breakeven = (lo + hi) / 2
    out = {
        "spec_round_ms": best * 1e3,
        "plain_step_ms": t_step * 1e3,
        "gamma": float(gamma),
        "batch": float(batch),
        "breakeven_accept": breakeven,
        "measured_accept": eng.accept_rate,
    }
    for p in (0.5, 0.8, 1.0):
        out[f"tokens_per_sec_at_accept_{p}"] = batch * commit(p) / best
    return out


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


def _free_port() -> int:
    # the reference's name; the implementation lives with the shared
    # load client
    from .loadclient import free_port

    return free_port()


def _wait_http_ok(port, path, timeout_s, predicate=None, procs=()):
    """Poll GET path until 200 (and *predicate*(json) when given); as
    soon as one of *procs* (the replicas waited for) has exited, raise
    with its exit code instead of waiting out the deadline."""
    from .loadclient import wait_http_ok

    return wait_http_ok(port, path, timeout_s, predicate, procs=procs)


def _spawn_replica(config, quantized, idx, port, router_port, slots,
                   steps, prompt_len, max_len, role=None,
                   kv_paging=False, device=None, extra_args=()):
    """One serving replica subprocess through the REAL CLI (the same
    path a pod runs), self-registering with the router.  *role* +
    *kv_paging* spawn a disaggregated-class replica (prefill/decode
    roles require the paged pool — migration is preempt/resume).  The
    port's server, on *device* (none: CUDA); *extra_args* go last on
    its command line."""
    from .loadclient import server_cmd, spawn_replica

    cmd = server_cmd(
        device,
        "--config", config,
        *_quant_args(quantized),
        "--n-slots", str(slots),
        "--max-len", str(max_len),
        "--max-new-tokens", str(steps),
        "--window", "16",
        "--host", "127.0.0.1", "--port", str(port),
        "--register-with", f"http://127.0.0.1:{router_port}",
        "--replica-id", f"replica-{idx}",
        "--register-interval", "0.5",
    )
    if kv_paging or role not in (None, "mixed"):
        cmd.append("--kv-paging")
    if role is not None:
        cmd += ["--replica-role", role]
    cmd += list(extra_args)
    return spawn_replica(cmd, f"replica-{idx}", env=_spawn_env())


def _spawn_env():
    """The replicas' environment: this one, with the repository root
    first on PYTHONPATH so ``-m`` finds the port from any directory."""
    import os

    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _stop_procs(procs) -> None:
    import subprocess

    for proc in procs:
        proc.kill()
    for proc in procs:
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            pass


def _router_load(router_port, prompts, steps, clients, n_requests,
                 lock):
    """Drive *n_requests* streaming requests (round-robin over
    *prompts* — repeats are the affinity workload) through the router
    with *clients* concurrent clients.  Returns (wall, done_tokens,
    statuses, errors)."""
    import threading

    from . import loadclient

    done_tokens, statuses, errors = [], [], []
    seq = iter(range(n_requests))

    def client_loop():
        while True:
            with lock:
                i = next(seq, None)
            if i is None:
                return
            res = loadclient.stream_request(
                "127.0.0.1", router_port,
                {"tokens": prompts[i % len(prompts)],
                 "max_new_tokens": steps},
                timeout_s=600)
            with lock:
                if res.outcome == loadclient.OUTCOME_OK:
                    done_tokens.append(res.done_tokens)
                elif res.error is not None:
                    # in-band error frames, sheds, and transport
                    # failures all land here — the phases gate on it
                    errors.append(res.error)
                statuses.append(res.status)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client_loop)
               for _ in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    return time.perf_counter() - t0, done_tokens, statuses, errors


def run_router(config, quantized, n_replicas, clients, n_requests,
               slots, steps, prompt_len, max_len, kill=False,
               seed=0, device=None, extra_args=(), before_kill=None):
    """Multi-replica mode: N replica subprocesses (the real
    ``workloads.server`` CLI, self-registering) behind an in-process
    ``workloads.router`` tier.  Phase 1 measures aggregate tokens/sec
    through the router with ONE replica, phase 2 with all N — the
    ratio is the scaling number the router-smoke CI job gates.  Also
    reports per-replica request share and the affinity hit rate from
    the router's own /metrics, and (with *kill*) SIGKILLs a replica
    and proves the survivors absorb the follow-on traffic with zero
    non-429 errors.

    The port's additions: *device* and *extra_args* go to every
    replica's command line; *before_kill*, when given, is called with
    the router's port after the timed phases, while every replica
    still serves; ``replica_boot_s_1`` / ``replica_boot_s_n`` time the
    spawn to the first replica's ``/healthz`` and to the whole fleet
    routable.  Replicas that share one card share its SMs, so there
    ``scaling_x`` measures that sharing, not scaling."""
    import http.client
    import json as _json
    import random
    import threading

    from .. import obs
    from .router import RouterServer, affinity_key

    if n_requests < 2 * n_replicas:
        raise ValueError(
            f"--requests {n_requests} too small for --router "
            f"{n_replicas} (need >= {2 * n_replicas})")

    cfg = CONFIGS[config]
    rng = random.Random(seed)
    # a handful of DISTINCT prompts, each repeated many times: the
    # affinity workload (repeat traffic must pin to the replica whose
    # KV pool is already warm).  The set is BALANCED over the ring —
    # every replica id gets the same number of affine prompts (the
    # ring depends only on the ids, so a throwaway router computes the
    # mapping before any replica exists) — so the scaling measurement
    # reflects the router, not one seed's hash luck
    n_prompts = max(2, 2 * n_replicas)
    probe = RouterServer()
    for i in range(n_replicas):
        probe.register({"address": f"127.0.0.1:{9000 + i}",
                        "replica_id": f"replica-{i}"})
    want = {f"replica-{i}": n_prompts // n_replicas
            for i in range(n_replicas)}
    prompts = []
    while sum(want.values()):
        cand = [rng.randrange(1, cfg.vocab)
                for _ in range(prompt_len)]
        target = probe.affinity_target(
            affinity_key({"tokens": cand}, probe.prefix_chunk))
        if want.get(target, 0):
            want[target] -= 1
            prompts.append(cand)
    lock = threading.Lock()
    rt = RouterServer(statz_interval_s=0.25, replica_ttl_s=5.0,
                      breaker_reset_s=1.0, seed=seed)
    rt.start(host="127.0.0.1", port=0)
    procs = []
    out = {"router": True, "replicas": float(n_replicas)}

    def scrape_router():
        conn = http.client.HTTPConnection("127.0.0.1", rt.port,
                                          timeout=10)
        conn.request("GET", "/metrics")
        body = conn.getresponse().read().decode()
        conn.close()
        return obs.parse_exposition(body)

    def spawn(idx, port):
        procs.append(_spawn_replica(
            config, quantized, idx, port, rt.port, slots, steps,
            prompt_len, max_len, device=device, extra_args=extra_args))

    try:
        # -- phase 1: one replica through the router ------------------
        port0 = _free_port()
        t_spawn = time.perf_counter()
        spawn(0, port0)
        _wait_http_ok(port0, "/healthz", 600, procs=procs)
        out["replica_boot_s_1"] = time.perf_counter() - t_spawn
        _wait_http_ok(
            rt.port, "/replicas", 30,
            lambda b: sum(r["healthy"] for r in b["replicas"]) >= 1,
            procs=procs)
        # warm every prompt through the router (compile + APC donor)
        _router_load(rt.port, prompts, steps, min(clients, 4),
                     len(prompts), lock)
        wall, toks, statuses, errors = _router_load(
            rt.port, prompts, steps, clients, n_requests, lock)
        if errors:
            raise RuntimeError(
                f"single-replica phase errored: {errors[0]}")
        tps_1 = sum(toks) / wall
        out["tokens_per_sec_router_1"] = tps_1
        out["requests_completed_1"] = float(len(toks))
        if n_replicas > 1:
            # -- phase 2: the full fleet ------------------------------
            t_spawn = time.perf_counter()
            for idx in range(1, n_replicas):
                spawn(idx, _free_port())
            _wait_http_ok(
                rt.port, "/replicas", 600,
                lambda b: sum(r["healthy"] for r in b["replicas"])
                >= n_replicas, procs=procs)
            out["replica_boot_s_n"] = time.perf_counter() - t_spawn
            # re-warm: prompts re-mapped onto the grown ring, and each
            # replica's first window sizes still need compiling
            _router_load(rt.port, prompts, steps, min(clients, 4),
                         2 * len(prompts), lock)
            base = scrape_router()
            base_req = {
                lab.get("replica"): v for n, lab, v in base
                if n == "tpu_router_requests_total"
                and lab.get("outcome") == "ok"}
            base_aff = sum(
                v for n, lab, v in base
                if n == "tpu_router_affinity_hits_total")
            wall, toks, statuses, errors = _router_load(
                rt.port, prompts, steps, clients, n_requests, lock)
            if errors:
                raise RuntimeError(
                    f"router phase errored: {errors[0]}")
            tps_n = sum(toks) / wall
            out["tokens_per_sec_router_n"] = tps_n
            out["requests_completed_n"] = float(len(toks))
            out["scaling_x"] = tps_n / tps_1
            out["scaling_efficiency"] = tps_n / tps_1 / n_replicas
            samples = scrape_router()
            served = {
                lab.get("replica"): v - base_req.get(
                    lab.get("replica"), 0.0)
                for n, lab, v in samples
                if n == "tpu_router_requests_total"
                and lab.get("outcome") == "ok"}
            total_ok = sum(served.values()) or 1.0
            for rid in sorted(served):
                out[f"share_{rid}"] = served[rid] / total_ok
            aff = sum(v for n, lab, v in samples
                      if n == "tpu_router_affinity_hits_total")
            out["affinity_hit_rate"] = (aff - base_aff) / total_ok
            # the fleet snapshot must aggregate EVERY replica: the
            # router-smoke CI job gates on this (a replica missing
            # from /fleet/statz is invisible to the autoscaler)
            conn = http.client.HTTPConnection(
                "127.0.0.1", rt.port, timeout=10)
            conn.request("GET", "/fleet/statz")
            fleet = _json.loads(conn.getresponse().read())
            conn.close()
            out["fleet_statz_replicas"] = float(fleet["replicas"])
            out["fleet_statz_healthy"] = float(fleet["healthy"])
            out["fleet_capacity"] = float(
                fleet["fleet"]["capacity"])
            goodput = fleet["fleet"].get("goodput", {})
            out["fleet_goodput_rps"] = float(sum(
                row.get("goodput_rps", 0.0)
                for row in goodput.values()))
            if fleet["replicas"] != n_replicas or \
                    len(fleet["per_replica"]) != n_replicas:
                raise RuntimeError(
                    f"/fleet/statz aggregates "
                    f"{fleet['replicas']} replica(s), expected "
                    f"{n_replicas}")
            if fleet["fleet"]["capacity"] != n_replicas * slots:
                raise RuntimeError(
                    "/fleet/statz capacity "
                    f"{fleet['fleet']['capacity']} != "
                    f"{n_replicas} x {slots} slots")
        if before_kill is not None:
            before_kill(rt.port)
        if kill:
            # -- kill phase: SIGKILL one replica, survivors absorb ----
            victim = procs[-1]
            victim.kill()
            victim.wait(timeout=30)
            t0 = time.perf_counter()
            _w, ktoks, kstatuses, kerrors = _router_load(
                rt.port, prompts, steps, min(clients, 4),
                4 * max(1, n_replicas - 1), lock)
            out["kill_requests"] = float(len(kstatuses))
            out["kill_ok"] = float(
                sum(s == 200 for s in kstatuses))
            out["kill_429"] = float(
                sum(s == 429 for s in kstatuses))
            out["kill_errors"] = float(
                sum(s not in (200, 429) for s in kstatuses)
                + len(kerrors))
            out["kill_recovery_s"] = time.perf_counter() - t0
            samples = scrape_router()
            out["failovers_total"] = sum(
                v for n, lab, v in samples
                if n == "tpu_router_failovers_total")
    finally:
        rt.stop()
        _stop_procs(procs)
    out["config"] = config
    out["quantized"] = quantized
    return out


def _disagg_load(router_port, long_prompts, short_prompts, steps,
                 clients, n_requests, lock):
    """Mixed-phase load through the router: even request ids are
    long-prefill UNARY completions (the interference source), odd ids
    short-prompt STREAMING decodes (the interference victim).
    Returns (wall, unary_lat_s, ttft_s, tpot_s, statuses, errors) —
    TTFT is request-start to the first streamed line, TPOT the
    per-token gap over the rest of the stream."""
    import threading

    from . import loadclient

    unary_lat, ttfts, tpots = [], [], []
    statuses, errors = [], []
    seq = iter(range(n_requests))

    def client_loop():
        while True:
            with lock:
                i = next(seq, None)
            if i is None:
                return
            if i % 2 == 0:
                res = loadclient.unary_request(
                    "127.0.0.1", router_port,
                    {"tokens": long_prompts[
                        (i // 2) % len(long_prompts)],
                     "max_new_tokens": max(4, steps // 4),
                     "stream": False},
                    timeout_s=600)
                with lock:
                    if res.outcome == loadclient.OUTCOME_TRANSPORT:
                        errors.append(res.error)
                        continue
                    statuses.append(res.status)
                    if res.outcome == loadclient.OUTCOME_OK:
                        unary_lat.append(res.total_s)
                    elif res.error is not None and res.status == 200:
                        errors.append(res.error)
            else:
                res = loadclient.stream_request(
                    "127.0.0.1", router_port,
                    {"tokens": short_prompts[
                        (i // 2) % len(short_prompts)],
                     "max_new_tokens": steps,
                     "ignore_eos": True},
                    timeout_s=600)
                with lock:
                    if res.outcome == loadclient.OUTCOME_TRANSPORT:
                        errors.append(res.error)
                        continue
                    statuses.append(res.status)
                    if res.outcome != loadclient.OUTCOME_OK \
                            and res.error is not None:
                        errors.append(res.error)
                    elif res.ttft_s is not None:
                        ttfts.append(res.ttft_s)
                        if res.tpot_s is not None:
                            tpots.append(res.tpot_s)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client_loop)
               for _ in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    return (time.perf_counter() - t0, unary_lat, ttfts, tpots,
            statuses, errors)


def run_disagg(config, quantized, clients, n_requests, slots, steps,
               prompt_len, max_len, seed=0, device=None,
               extra_args=(), on_arm=None):
    """Disaggregated prefill/decode A/B (the ROADMAP router-v2 gate):
    the SAME mixed traffic — long-prefill unary completions
    interleaved with short-prompt streaming decodes — once against 2
    homogeneous mixed replicas and once against a prefill+decode pair
    with phase-aware routing + KV migration.  Reports decode TTFT p99
    and decode TPOT p99 per arm: on the homogeneous arm long prefills
    contend with decode windows on whichever replica the ring picks;
    on the disagg arm decode streams run on a replica that never
    prefills a long prompt.

    The port's additions: *device* and *extra_args* go to every
    replica's command line; *on_arm*, when given, is called with the
    arm's name and its router's port after the arm's timed load, while
    both replicas still serve; ``replicas_boot_s_<arm>`` times the
    spawn to both replicas routable.  Two replicas on one card share
    its SMs, so there the arms do not separate prefill from decode as
    separate chips would."""
    import http.client
    import random
    import threading

    from .. import obs
    from .router import RouterServer

    cfg = CONFIGS[config]
    long_len = min(max_len - steps - 8, max(64, prompt_len * 4))
    if long_len < 32:
        raise ValueError(
            f"--max-len {max_len} leaves no room for a long-prefill "
            "phase (need >= 32 prompt tokens + the decode budget)")
    short_len = max(4, prompt_len // 4)
    rng = random.Random(seed)
    # DISTINCT long prompts: every one pays a full prefill (no APC
    # dedupe) — that cost is exactly what the phase split relocates
    long_prompts = [
        [rng.randrange(1, cfg.vocab) for _ in range(long_len)]
        for _ in range(max(2, (n_requests + 1) // 2))]
    short_prompts = [
        [rng.randrange(1, cfg.vocab) for _ in range(short_len)]
        for _ in range(4)]
    lock = threading.Lock()
    out = {"disagg": True, "long_prompt_len": float(long_len),
           "short_prompt_len": float(short_len),
           "config": config, "quantized": quantized}

    def run_arm(arm):
        rt = RouterServer(statz_interval_s=0.25, replica_ttl_s=5.0,
                          breaker_reset_s=1.0, seed=seed,
                          prefill_threshold=long_len)
        rt.start(host="127.0.0.1", port=0)
        roles = (("prefill", "decode") if arm == "disagg"
                 else ("mixed", "mixed"))
        procs = []
        t_spawn = time.perf_counter()
        try:
            for i, role in enumerate(roles):
                procs.append(_spawn_replica(
                    config, quantized, i, _free_port(), rt.port,
                    slots, steps, prompt_len, max_len, role=role,
                    kv_paging=True, device=device,
                    extra_args=extra_args))
            _wait_http_ok(
                rt.port, "/replicas", 600,
                lambda b: sum(r["healthy"]
                              for r in b["replicas"]) >= 2,
                procs=procs)
            boot_s = time.perf_counter() - t_spawn
            # warm both request classes (window compiles, packed
            # shapes, the migration path itself)
            _disagg_load(rt.port, long_prompts[:2], short_prompts,
                         steps, min(clients, 4), 8, lock)
            wall, unary, ttfts, tpots, statuses, errors = \
                _disagg_load(rt.port, long_prompts, short_prompts,
                             steps, clients, n_requests, lock)
            if errors:
                raise RuntimeError(f"{arm} arm errored: {errors[0]}")
            if not ttfts or not tpots or not unary:
                raise RuntimeError(
                    f"{arm} arm produced no complete samples "
                    f"(statuses: {statuses[:8]})")
            res = {
                f"requests_ok_{arm}": float(
                    sum(s == 200 for s in statuses)),
                f"wall_s_{arm}": wall,
                f"long_unary_p99_ms_{arm}":
                    _percentile(unary, 0.99) * 1000.0,
                f"decode_ttft_p99_ms_{arm}":
                    _percentile(ttfts, 0.99) * 1000.0,
                f"decode_tpot_p99_ms_{arm}":
                    _percentile(tpots, 0.99) * 1000.0,
                f"replicas_boot_s_{arm}": boot_s,
            }
            if arm == "disagg":
                conn = http.client.HTTPConnection(
                    "127.0.0.1", rt.port, timeout=10)
                conn.request("GET", "/metrics")
                samples = obs.parse_exposition(
                    conn.getresponse().read().decode())
                conn.close()
                res["migrations_ok"] = sum(
                    v for n, lab, v in samples
                    if n == "tpu_router_migrations_total"
                    and lab.get("outcome") == "ok")
                ships = [v for n, lab, v in samples
                         if n == "tpu_router_migrate_seconds_sum"]
                counts = [v for n, lab, v in samples
                          if n == "tpu_router_migrate_seconds_count"]
                if counts and counts[0]:
                    res["migrate_mean_ms"] = (
                        ships[0] / counts[0] * 1000.0)
            if on_arm is not None:
                on_arm(arm, rt.port)
            return res
        finally:
            rt.stop()
            _stop_procs(procs)

    out.update(run_arm("homog"))
    out.update(run_arm("disagg"))
    if out.get("migrations_ok", 0) < 1:
        raise RuntimeError(
            "disagg arm routed no migration — the phase split never "
            "engaged (check roles/threshold)")
    out["ttft_p99_ratio"] = (out["decode_ttft_p99_ms_disagg"]
                             / out["decode_ttft_p99_ms_homog"])
    out["tpot_p99_ratio"] = (out["decode_tpot_p99_ms_disagg"]
                             / out["decode_tpot_p99_ms_homog"])
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
    _check_budget(prompt_len, steps, max_len)
    device = resolve_device(device)
    cfg, model = build_model_and_params(config, max_len, device, seed,
                                        quantized)
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
    _check_budget(prompt_len, steps, max_len)
    device = resolve_device(device)
    cfg, model = build_model_and_params(config, max_len, device, seed,
                                        quantized)
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


def _spawn_server(config, quantized, port, slots, steps, max_len,
                  extra, device=None):
    """One serving subprocess through the REAL CLI (the path a pod
    runs), no router — the cold-start phase's replica.  The port's
    server, on *device* (none: CUDA)."""
    from .loadclient import server_cmd, spawn_replica

    cmd = server_cmd(
        device,
        "--config", config,
        *_quant_args(quantized),
        "--n-slots", str(slots),
        "--max-len", str(max_len),
        "--max-new-tokens", str(steps),
        "--window", "16",
        "--host", "127.0.0.1", "--port", str(port),
        *extra)
    return spawn_replica(cmd, "cold-start", env=_spawn_env())


def run_cold_start(config, quantized, slots, steps, prompt_len,
                   max_len, cache_dir=None, device=None, extra_args=()):
    """Replica cold-start economics: boot the real server CLI twice
    against ONE ``--compile-cache-dir`` — the first boot compiles and
    fills the cache (cold), the second loads executables from it
    (warm) — timing spawn → first successful completion each time.
    The warm boot MUST be measurably faster (asserted by the CLI exit
    code): that delta is what makes router-driven autoscaling real,
    because a scale-up replica that pays the per-shape warmup storm
    is not capacity for minutes.

    The port keeps no compile cache (``server.enable_compile_cache``
    returns False: each process captures its CUDA graphs itself), so
    both boots do the same work — import, weights on the device,
    ``warm_scheduler``'s captures — and the gate decides on their
    noise, as the reference's does on a jax without the cache knobs.
    *device* and *extra_args* go to both command lines."""
    import http.client
    import json as _json
    import shutil
    import tempfile

    cache = cache_dir or tempfile.mkdtemp(prefix="tpu-compile-cache-")
    own_cache = cache_dir is None
    prompt = list(range(1, prompt_len + 1))
    out = {"cold_start": True, "config": config,
           "quantized": quantized, "compile_cache_dir": cache}
    try:
        for phase in ("cold", "warm"):
            port = _free_port()
            t0 = time.perf_counter()
            proc = _spawn_server(
                config, quantized, port, slots, steps, max_len,
                ["--compile-cache-dir", cache, *extra_args],
                device=device)
            try:
                _wait_http_ok(port, "/healthz", 900, procs=(proc,))
                out[f"{phase}_ready_s"] = time.perf_counter() - t0
                conn = http.client.HTTPConnection("127.0.0.1", port,
                                                  timeout=600)
                conn.request(
                    "POST", "/generate",
                    _json.dumps({"tokens": prompt,
                                 "max_new_tokens": steps,
                                 "stream": False}),
                    {"Content-Type": "application/json"})
                resp = conn.getresponse()
                body = resp.read()
                conn.close()
                if resp.status != 200:
                    raise RuntimeError(
                        f"{phase} start first request answered "
                        f"{resp.status}: {body[:120]!r}")
                out[f"{phase}_first_completion_s"] = (
                    time.perf_counter() - t0)
            finally:
                _stop_procs((proc,))
        out["warm_speedup_x"] = (out["cold_first_completion_s"]
                                 / out["warm_first_completion_s"])
        out["warm_faster"] = float(out["warm_first_completion_s"]
                                   < out["cold_first_completion_s"])
    finally:
        if own_cache:
            shutil.rmtree(cache, ignore_errors=True)
    return out


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
    with *http_clients*, of the front-door load test; with *spec*, of
    ``_spec_throughput`` at gamma *spec*) with the config, ``quantized``
    and the device added.  The JAX package's arguments in its order,
    then the port's seed and device."""
    if spec:
        # two plain windows, then the warm and the timed spec rounds,
        # each committing at most gamma + 1
        budget = 2 * steps + (1 + _ENGINE_ROUNDS) * (spec + 1)
    elif http_clients:
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
    cfg, model = build_model_and_params(config, max_len, device, seed,
                                        quantized)
    prompt = _random_prompts(cfg.vocab, batch, prompt_len, seed + 1,
                             device)
    if spec:
        draft_name = DRAFT_FOR.get(config)
        if draft_name is None:
            raise ValueError(f"no draft pairing for {config} (DRAFT_FOR)")
        _, dmodel = build_model_and_params(draft_name, max_len, device,
                                           seed + 2, quantized)
        stats = _spec_throughput(model, dmodel, prompt, spec, steps)
        stats["draft"] = draft_name
    elif http_clients:
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
    stats["quantized"] = quantized
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
                   help="weight-only int8")
    p.add_argument("--int4", action="store_true",
                   help="weight-only int4 (packed; dense configs only)")
    p.add_argument("--spec", type=int, default=0, metavar="GAMMA",
                   help="speculative-round economics at this gamma "
                        "(paired draft per DRAFT_FOR; reports round "
                        "latency + implied tok/s over accept rate)")
    p.add_argument("--cold-start", action="store_true",
                   help="replica cold-start phase: boot the real "
                        "server CLI twice against one "
                        "--compile-cache-dir and time spawn -> first "
                        "completion; exits nonzero unless the warm "
                        "boot is faster (the port keeps no compile "
                        "cache, so both boots do the same work)")
    p.add_argument("--compile-cache-dir", default=None, metavar="DIR",
                   help="with --cold-start: reuse DIR as the "
                        "compile-cache directory instead of a "
                        "throwaway tempdir")
    p.add_argument("--router", type=int, default=0, metavar="N",
                   help="with --http: multi-replica mode — spawn N "
                        "serving-replica subprocesses (the real CLI, "
                        "self-registering) behind the in-process "
                        "router tier; reports aggregate tokens/sec, "
                        "per-replica share, affinity hit rate, and "
                        "scaling vs 1 replica through the same hop")
    p.add_argument("--disagg", action="store_true",
                   help="disaggregated prefill/decode A/B: mixed "
                        "long-prefill-unary + short-streaming-decode "
                        "traffic against 2 homogeneous replicas vs a "
                        "prefill+decode pair with phase routing + KV "
                        "migration; reports decode TTFT/TPOT p99 per "
                        "arm (clients from --http, counts from "
                        "--requests)")
    p.add_argument("--assert-disagg", action="store_true",
                   help="with --disagg: exit nonzero unless the "
                        "disagg arm beats the homogeneous arm on "
                        "decode TTFT p99 or decode TPOT p99")
    p.add_argument("--assert-scaling", type=float, default=0.0,
                   metavar="FLOOR",
                   help="with --router: exit nonzero unless the "
                        "N-replica aggregate is >= FLOOR x the "
                        "1-replica aggregate")
    p.add_argument("--router-kill", action="store_true",
                   help="with --router: SIGKILL one replica after the "
                        "timed phases and prove the survivors absorb "
                        "the follow-on traffic (zero non-429 errors, "
                        "failovers counted)")
    args = p.parse_args(argv)
    if args.int4 and args.quantized:
        p.error("--quantized and --int4 are mutually exclusive")
    quantized = "int4" if args.int4 else args.quantized
    modes = [f for f, on in (("--engine", args.engine),
                             ("--spec", args.spec),
                             ("--http", args.http),
                             ("--cold-start", args.cold_start)) if on]
    if len(modes) > 1:
        p.error(f"{' and '.join(modes)} are mutually exclusive")
    if (args.requests or args.cancel_every or args.burst
            or args.assert_ratio or args.no_interleave
            or args.kv_paging or args.tenants or args.router
            or args.prefill_heavy or args.assert_goodput
            or args.metrics_out or args.disagg or args.decode_heavy
            or args.fused_decode) and not args.http:
        p.error("--requests/--cancel-every/--burst/--assert-ratio/"
                "--no-interleave/--kv-paging/--tenants/--router/"
                "--prefill-heavy/--decode-heavy/--fused-decode/"
                "--assert-goodput/--metrics-out/"
                "--disagg only apply with --http")
    if args.assert_fused_speedup and not args.decode_heavy:
        p.error("--assert-fused-speedup needs --decode-heavy")
    if args.decode_heavy and args.prefill_heavy:
        p.error("--decode-heavy and --prefill-heavy are mutually "
                "exclusive")
    if args.compile_cache_dir and not args.cold_start:
        p.error("--compile-cache-dir only applies with --cold-start")
    if args.cold_start:
        try:
            stats = run_cold_start(
                args.config, quantized, slots=args.batch or 4,
                steps=args.steps, prompt_len=args.prompt_len,
                max_len=args.max_len,
                cache_dir=args.compile_cache_dir, device=args.device)
        except (ValueError, RuntimeError, NotImplementedError) as e:
            p.error(str(e))
        for k, v in stats.items():
            print(f"{k}: {v}", flush=True)
        if not stats.get("warm_faster"):
            print("FAIL: warm start "
                  f"({stats['warm_first_completion_s']:.1f}s) not "
                  "faster than cold start "
                  f"({stats['cold_first_completion_s']:.1f}s)",
                  flush=True)
            return 1
        print(f"OK: warm start {stats['warm_speedup_x']:.2f}x faster "
              "than cold", flush=True)
        return 0
    heavy = {"prefill": run_prefill_heavy, "decode": run_decode_heavy}
    for kind, fn in heavy.items():
        if not getattr(args, f"{kind}_heavy"):
            continue
        try:
            stats = fn(args.config, quantized, clients=args.http,
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
    if args.tenants < 0:
        p.error("--tenants must be >= 0")
    if args.router < 0:
        p.error("--router must be >= 0")
    if (args.assert_scaling or args.router_kill) and not args.router:
        p.error("--assert-scaling/--router-kill need --router")
    if args.router and (args.cancel_every or args.burst
                        or args.assert_ratio or args.kv_paging
                        or args.tenants or args.no_interleave):
        p.error("--router is its own mode: the single-replica phase "
                "flags do not apply")
    if args.assert_disagg and not args.disagg:
        p.error("--assert-disagg needs --disagg")
    if args.disagg and (args.router or args.cancel_every
                        or args.burst or args.assert_ratio
                        or args.kv_paging or args.tenants
                        or args.no_interleave):
        p.error("--disagg is its own mode: the single-replica and "
                "--router phase flags do not apply")
    if args.disagg:
        try:
            stats = run_disagg(
                args.config, quantized, clients=args.http,
                n_requests=args.requests or 8 * args.http,
                slots=args.batch, steps=args.steps,
                prompt_len=args.prompt_len, max_len=args.max_len,
                seed=args.seed, device=args.device)
        except (ValueError, RuntimeError, NotImplementedError) as e:
            p.error(str(e))
        for k, v in stats.items():
            print(f"{k}: {v}", flush=True)
        if args.assert_disagg:
            ttft_r = stats["ttft_p99_ratio"]
            tpot_r = stats["tpot_p99_ratio"]
            if min(ttft_r, tpot_r) >= 1.0:
                print(f"FAIL: disagg beat the homogeneous arm on "
                      f"neither decode TTFT p99 (x{ttft_r:.3f}) nor "
                      f"decode TPOT p99 (x{tpot_r:.3f})", flush=True)
                return 1
            print(f"OK: disagg decode TTFT p99 x{ttft_r:.3f} / "
                  f"TPOT p99 x{tpot_r:.3f} vs homogeneous "
                  "(< 1.0 = better)", flush=True)
        return 0
    if args.router:
        try:
            stats = run_router(
                args.config, quantized, args.router,
                clients=args.http,
                n_requests=args.requests or 8 * args.http,
                slots=args.batch, steps=args.steps,
                prompt_len=args.prompt_len, max_len=args.max_len,
                kill=args.router_kill, seed=args.seed,
                device=args.device)
        except (ValueError, RuntimeError, NotImplementedError) as e:
            p.error(str(e))
        for k, v in stats.items():
            print(f"{k}: {v}", flush=True)
        rc = 0
        if args.assert_scaling:
            scaling = stats.get("scaling_x", 0.0)
            if scaling < args.assert_scaling:
                print(f"FAIL: scaling_x {scaling:.3f} below the "
                      f"{args.assert_scaling:.2f} floor", flush=True)
                rc = 1
            else:
                print(f"OK: scaling_x {scaling:.3f} >= "
                      f"{args.assert_scaling:.2f}", flush=True)
        if args.router_kill and stats.get("kill_errors", 0):
            print(f"FAIL: {stats['kill_errors']:.0f} non-429 errors "
                  "after the replica kill", flush=True)
            rc = 1
        return rc
    try:
        stats = run(args.config, quantized, args.batch, args.steps,
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
