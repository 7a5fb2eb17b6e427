#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card, end to end.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. require CUDA; print the card's name and power limit;
2. build every kernel from ``tpu_k8s_device_plugin_torch/csrc`` (one
   nvcc per source, in parallel) and print the build time;
3. hold each kernel against its plain PyTorch version on the card, at
   the main path's shapes and a few edge shapes, and time the kernel,
   the plain version and one PyTorch library call for the same function
   (a yardstick only; the port never calls it);
4. the main path: Llama-3-8B at full width and depth, bf16, random
   weights from a seed, through ``greedy_generate`` (batch 4, prompt
   1024, 32 new tokens): the launch counts are zeroed just before and
   read just after, and every kernel of the path must have run; then
   prefill ms and decode tokens/s, and a 4-layer model at the same width
   with the flash prefill against the einsum prefill; a profile of one
   prefill and of a few decode steps by kernel;
5. print the ``kernels`` JSON line, then the result line.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

# published H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor-core
# FLOP/s, f32 FLOP/s outside the tensor cores, HBM bytes/s
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12

TOL = {"bfloat16": (3e-2, 3e-2), "float32": (2e-5, 2e-5)}

# the main path's prefill: Llama-3-8B, batch 4, prompt 1024
BATCH, PROMPT, NEW_TOKENS, MAX_LEN = 4, 1024, 32, 2048


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean ms per call over *iters* calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound_ms(q, k, causal: bool):
    """Least time for the attention on these inputs: the visible
    (query, key) pairs at 4*D FLOPs each against the peak for the
    dtype, or q, k, v read and o written once against HBM."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    pairs = Tq * (Tq + 1) // 2 if causal else Tq * Tk
    flops = 4 * D * pairs * B * H
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    peak = PEAK_BF16 if q.element_size() == 2 else PEAK_F32
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def check_flash(torch, fa):
    """Phase 3: the flash kernel against its plain version."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(0)
    # (name, q shape, Tk, KV heads, dtype, causal); "main" is the
    # Llama-3-8B prefill's call (grouped K/V, 8 KV heads for 32)
    cases = [
        ("main", (BATCH, PROMPT, 32, 128), PROMPT, 8, torch.bfloat16, True),
        ("ragged", (2, 600, 32, 128), 600, 8, torch.bfloat16, True),
        ("cross", (2, 100, 8, 64), 300, 2, torch.bfloat16, False),
        ("f32", (2, 256, 8, 64), 256, 2, torch.float32, True),
        ("f32-ragged", (1, 200, 4, 128), 200, 4, torch.float32, False),
    ]
    result = None
    for name, qs, tk, hkv, dtype, causal in cases:
        B, _, _, D = qs
        q = torch.randn(qs, generator=gen, device="cuda", dtype=dtype)
        k = torch.randn((B, tk, hkv, D), generator=gen, device="cuda",
                        dtype=dtype)
        v = torch.randn((B, tk, hkv, D), generator=gen, device="cuda",
                        dtype=dtype)
        got = fa.flash_attention_cuda(q, k, v, causal)
        want = fa.flash_attention_plain(q, k, v, causal)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        atol, rtol = TOL[str(dtype).split(".")[-1]]
        bad = int((err > atol + rtol * want.float().abs()).sum())
        max_err = float(err.max())
        print(f"flash {name}: q {list(qs)} kv {[B, tk, hkv, D]} "
              f"{str(dtype)[6:]} causal={causal} max_abs_err={max_err:.3e} "
              f"(atol {atol}, rtol {rtol}) mismatches={bad}", flush=True)
        if bad or not torch.isfinite(got).all():
            fail(f"flash kernel disagrees with its plain version ({name})")
        if name != "main":
            continue
        kernel_ms = time_ms(
            torch, lambda: fa.flash_attention_cuda(q, k, v, causal), 20)
        plain_ms = time_ms(
            torch, lambda: fa.flash_attention_plain(q, k, v, causal), 5)
        # the library yardstick: the same grouped inputs, as [B, H, T, D]
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = time_ms(
            torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True), 20)
        bound_ms, bound_by = attention_bound_ms(q, k, causal)
        print(f"flash main: kernel {kernel_ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, library (sdpa) {library_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by})", flush=True)
        result = dict(max_abs_err=max_err, ms=kernel_ms, kernel_ms=kernel_ms,
                      plain_ms=plain_ms, bound_ms=bound_ms,
                      bound_by=bound_by, library_ms=library_ms)
    return result


def profile_split(torch, inference, model, prompt, steps: int = 8):
    """Where the time goes: device time by kernel over one prefill and
    over *steps* decode steps (``torch.profiler``), against the wall
    time of the same region; the difference is device idle time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    B, T = prompt.shape
    pos = torch.arange(T, dtype=torch.int32, device="cuda").expand(B, T)
    logits, cache = inference._prefill(model, prompt, pos)
    pos0 = torch.full((B,), T, dtype=torch.int32, device="cuda")

    def prefill():
        inference._prefill(model, prompt, pos)

    def decode():
        inference._decode_loop(model, cache, logits[:, -1], steps + 1, pos0,
                               None, inference._greedy_pick, 1.0, None)

    for name, fn in (("prefill", prefill), (f"decode x{steps}", decode)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # device-side events only: a CPU op's device time repeats the
        # time of the kernels it launched
        kernels = [(e.key, e.self_device_time_total / 1e3)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not e.is_user_annotation
                   and e.self_device_time_total > 0]
        busy = sum(ms for _, ms in kernels)
        print(f"profile {name}: wall {wall_ms:.3f} ms, device busy "
              f"{busy:.3f} ms, idle share "
              f"{max(0.0, 1 - busy / wall_ms):.3f}", flush=True)
        for key, ms in sorted(kernels, key=lambda kv: -kv[1])[:8]:
            print(f"  {ms:9.3f} ms {100 * ms / max(busy, 1e-9):5.1f}%  "
                  f"{key[:90]}", flush=True)


def main_path(torch, fa, inference, llama, bench_serving):
    """Phase 4: Llama-3-8B greedy generation through the port."""
    t0 = time.perf_counter()
    cfg, model = bench_serving.build_model_and_params(
        "llama3-8b", MAX_LEN, device="cuda", seed=0)
    torch.cuda.synchronize()
    print(f"llama3-8b: {cfg.n_layers} layers, {cfg.n_params() / 1e9:.2f}B "
          f"params bf16, random weights built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    prompt = torch.randint(0, cfg.vocab, (BATCH, PROMPT),
                           generator=torch.Generator().manual_seed(1))
    prompt = prompt.to("cuda")

    fa.flash_attention_cuda.launches = 0
    t0 = time.perf_counter()
    toks, logits = inference.greedy_generate(model, prompt, NEW_TOKENS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fa.flash_attention_cuda.launches
    print(f"greedy_generate: batch {BATCH}, prompt {PROMPT}, {NEW_TOKENS} "
          f"tokens in {wall:.3f} s; flash launches {launches}", flush=True)
    if launches != cfg.n_layers:
        fail(f"flash kernel launched {launches} times in the prefill, "
             f"expected {cfg.n_layers} (one per layer)")
    if tuple(toks.shape) != (BATCH, NEW_TOKENS) or \
            tuple(logits.shape) != (BATCH, PROMPT, cfg.vocab):
        fail(f"unexpected shapes {tuple(toks.shape)}, "
             f"{tuple(logits.shape)}")
    if not torch.isfinite(logits).all():
        fail("non-finite prefill logits")
    if not ((toks >= 0) & (toks < cfg.vocab)).all():
        fail("token id out of range")
    if not torch.equal(toks[:, 0], logits[:, -1].argmax(-1)):
        fail("first token is not the argmax of the last prefill logits")
    del toks, logits

    stats = inference.decode_throughput(model, prompt, NEW_TOKENS, rounds=3)
    print(f"llama3-8b: prefill {stats['prefill_ms']:.3f} ms "
          f"({BATCH}x{PROMPT} tokens), decode "
          f"{stats['tokens_per_sec']:.1f} tokens/s at batch {BATCH}; peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB",
          flush=True)
    profile_split(torch, inference, model, prompt)
    del model
    torch.cuda.empty_cache()

    # the same width at 4 layers: flash prefill against einsum prefill
    cfg4 = dataclasses.replace(cfg, n_layers=4)
    model4 = llama.decoder(cfg4, max_len=MAX_LEN, device="cuda")
    bench_serving.random_init_(model4, seed=0)
    pos = torch.arange(PROMPT, dtype=torch.int32,
                       device="cuda").expand(BATCH, PROMPT)
    flash_logits = inference._prefill(model4, prompt, pos)[0][:, -1]
    threshold = inference._FLASH_PREFILL_MIN_T
    inference._FLASH_PREFILL_MIN_T = PROMPT + 1
    try:
        plain_logits = inference._prefill(model4, prompt, pos)[0][:, -1]
    finally:
        inference._FLASH_PREFILL_MIN_T = threshold
    err = (flash_logits - plain_logits).abs()
    # bf16 end to end: attention outputs differ by about one bf16 ulp
    # between the two paths, and four layers carry that to the logits
    atol, rtol = 0.1, 0.05
    bad = int((err > atol + rtol * plain_logits.abs()).sum())
    print(f"llama3-8b width, 4 layers: last-position logits flash vs "
          f"einsum prefill max_abs_err={float(err.max()):.4f} (max |logit| "
          f"{float(plain_logits.abs().max()):.3f}; atol {atol}, rtol {rtol})"
          f" mismatches={bad}", flush=True)
    if bad:
        fail("flash prefill disagrees with the einsum prefill")
    return launches, stats


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tpu_k8s_device_plugin_torch import build
    from tpu_k8s_device_plugin_torch.workloads import (
        bench_serving, inference, llama)
    from tpu_k8s_device_plugin_torch.workloads import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)", flush=True)

    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"build: {len(logs)} source(s) in {time.perf_counter() - t0:.1f} "
          "s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    flash = check_flash(torch, fa)
    launches, _ = main_path(torch, fa, inference, llama, bench_serving)

    kernels = [dict(
        name="flash_attn_fwd", route="cuda",
        source="tpu_k8s_device_plugin_torch/csrc/flash_attn_fwd.cu",
        replaces="tpu_k8s_device_plugin/workloads/flash_attention.py:101",
        launches=launches, **flash)]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
