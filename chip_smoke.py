#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card, end to end.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. require CUDA; print the card's name and power limit;
2. build every kernel from ``tpu_k8s_device_plugin_torch/csrc`` (one
   nvcc per source, in parallel) and print the build time; the bf16
   kernels of K3, K4, K5 and K6 must spill nothing and run on ``wgmma``
   (``HGMMA`` in the built library's SASS), and K1 and K2 must spill
   nothing and copy their bands with ``cp.async.bulk`` (``UBLKCP``);
3. hold each kernel against its plain PyTorch version on the card, at
   the main paths' shapes and a few edge shapes (attention by blocks of
   64 rows, each with bars scaled to its own values), and time the kernel,
   the plain version and one PyTorch library call for the same function
   (a yardstick only; the port never calls it): K4 (flash attention) at
   the Llama-3-8B prefill and at edge shapes (D 96 and 64, T 1024 with
   GQA 4:1 and with group 1, fewer than 64 keys, Tq and Tk ragged, views
   of one fused projection, no key at all), each bf16 block within 1.5x
   of rounding alone and a second launch giving the same bits; K4 with
   its lse residual, K5 (dQ) and K6
   (dK, dV) on a head slice of the LM training call (q [1, 8192, 8, 128],
   K/V [1, 8192, 2, 128], where the plain version's [T, T] f32 scores
   fit) and edge shapes (among them T 1024 with GQA 4:1, and D 96, which
   the bf16 kernels pad to 128), timed at the full call (q [1, 8192, 32,
   128], K/V [1, 8192, 8, 128]) against ``scaled_dot_product_attention``'s
   forward and backward; K1/K2 (max-pool forward/backward, bit-exact,
   each stage in the bulk-copy mode, its bands and grid printed) and K3
   (fused conv+pool) at AlexNet's three stage shapes, batch 1024, bf16,
   K3 also at 128 features and at an odd size with 8 channels;
4. the generation path: Llama-3-8B at full width and depth, bf16, random
   weights from a seed, through ``greedy_generate`` (batch 4, prompt
   1024, 32 new tokens): the launch counts are zeroed just before and
   read just after, and K4 must have run once per layer; the decode
   step must have been captured and replayed once a step, and give the
   ids of the same loop run op by op from the same prefilled cache; then
   prefill ms, decode tokens/s and the capture ms, a profile of one
   prefill and of a few replayed decode steps by kernel; then the
   serving engine on the same model: ``ServingEngine(n_slots=8)``,
   ``max_len`` 2048, eight requests (prompts of 96 to 1000 tokens; four
   greedy, two sampled with seeds, one with stop ids, one with logprobs)
   admitted alike into two engines, one ``run_scan`` window of 32 steps
   replayed on the first against 32 ``step`` calls run op by op on the
   second (identical ids, logprobs and finish reasons; 32 replays), the
   admission ms, a profile of one window, ``_decode_attention``'s share
   of a replayed step and ``bench_serving --engine``'s tokens/s; then
   the paged engine on the same model and requests
   (``kv_paging=True``, pages of 32 rows): a full pool's window gives
   the contiguous engine's ids, finish reasons and logprobs; a pool of
   half the pages the requests hold at their end finishes all eight
   with the full pool's ids through a policy that preempts the newest
   slot and resumes it (preemptions counted, ms per preempt and
   resume); an int8 pool runs the window (agreeing leading ids, the
   first step's largest logit difference); a request under a regex
   grammar over a synthetic 128,256-token vocabulary full-matches it
   after a jump round that forces tokens, its neighbours keeping their
   ids; the paged decode rate, window idle share and device ms a step
   beside the contiguous engine's, the pool gather's ms and share of a
   replayed step, and the host ms a window spends allocating pages;
   then the iteration scheduler on the same model: the captured chunk
   extend of admission (projections over 4 rows, attention over the K
   real ones; one graph a K) against its run op by op at K = 1 to 4,
   bit for bit, its ms beside its bound, and extends of their own shape
   at B = 1..4 (their ms, and their rows' logits against the same rows
   at B = 1); sixteen requests
   (the engine phase's eight at iteration 0, eight more at iterations
   2-9, two of them APC hits, one seeded sampled, at most 32 new tokens
   each) through ``IterationScheduler`` (windows of 8, 4 prefill
   dispatches a window, packs of 4) in four arms, serial, interleave,
   interleave + packed, interleave + packed + overlap, and a paged
   engine in the last: every arm gives the serial arm's ids and finish
   reasons, and prints its wall seconds, tokens/s, admit-to- and
   arrival-to-first-token p50 and p99, a running request's longest
   stall, duty cycle, overlap windows and packed extends; then the HTTP
   front door on the same model: ``EngineServer`` (windows of 8, at most
   32 new tokens, interleave, packed prefill and overlap on) over a paged
   ``ServingEngine(n_slots=8)``, warmed; the scheduler phase's sixteen
   requests to ``/generate`` from 8 concurrent streaming clients of the
   port's ``loadclient``, each giving the scheduler phase's ids and
   finish reason; one ``/v1/completions`` request, unary and SSE, with a
   byte tokenizer, whose text agrees with the ids; ``/metrics`` with the
   scheduler's and the server's families, ``/statz`` with the
   reference's keys, each request's trace in ``/debug/traces``;
   ``/debug/profile?seconds=1`` under a decoding request, whose chrome
   trace must hold CUDA kernel events; the longest greedy request
   answered ``prefill_only`` and resumed through ``/migrate`` on a
   second server (``replica_role="decode"``, its own engine) with the
   scheduler phase's ids; ``bench_serving``'s ``--http`` load test (8
   clients, 32 requests, prompts of 128); it prints HTTP tokens/s, its
   ratio to the scheduler phase's overlap arm, client time to first
   token p50 and p99, server admit-to-first-token p50 and p99, the 429s
   and the phase's wall time; and a 4-layer model at the same width with
   the flash prefill against the einsum prefill;
5. the training path: AlexNet at full width (224 px, 1000 classes, s2d,
   bf16 compute, f32 parameters from a seed), batch 1024, one
   ``train_step`` under each ``pool`` with the launch counts zeroed just
   before and read just after (``pallas``: K1 and K2 three times each;
   ``fused``: K3 and K2 three times each; every K1 and K2 launch in the
   bulk-copy mode), the first-step losses held
   against ``xla``'s; images/sec and MFU of ``bench_main.run_single``
   (3 warmup, 10 steps) per ``pool``; a profile of one ``pallas`` and
   one ``fused`` step by kernel;
6. the LM training path: Llama-3-8B at full width and 4 of its 32
   layers, bf16 compute, f32 parameters from seed 0, the flash kernels
   as attention, ``torch.optim.Adam(3e-4)``, one sequence of 8192
   tokens from ``synthetic_lm_batch``: the same model with the einsum
   attention at 1024 tokens (first-step loss within 1e-2, every
   gradient within 5e-2 in relative norm); one ``lm_train_step`` with
   the launch counts zeroed just before and read just after (K4, K5 and
   K6 four times each); the loss finite and lower after 5 steps on the
   same batch; tokens/s and MFU over 5 steps after 2 warmup, the peak
   memory, and a profile of one step by kernel;
7. the fleet tier, after the LM training path has released its model:
   replicas of the port's server CLI on the card (Llama-3-8B at full
   width and depth, bf16, random weights from seed 0, 8 slots,
   ``max_len`` 2048, windows of 8), spawned by the port's own helpers
   behind the port's router, each writing its output to a file under a
   temporary directory whose tails are printed when the phase fails;
   the free device memory printed before the first spawn;
   ``bench_serving.run_router`` with two replicas and the kill (tokens/s
   with one and with two, ``scaling_x``, shares, affinity hit rate, no
   non-429 error after the kill), the scheduler phase's sixteen
   requests through the router before the kill giving its ids and
   finish reasons; ``run_disagg``'s homogeneous and prefill+decode arms
   (decode TTFT and TPOT p99 and their ratios, the migrations), the
   scheduler phase's longest greedy prompt migrated across processes
   giving its ids; a seeded ``trafficgen`` trace of 32 requests replayed
   open loop through ``replay.run_fleet`` (two replicas), its report
   parsing with its schema and no request failing outside a 429;
   one ``fleet.run_episode`` (floor 1, ceiling 2, a cut ramp) whose
   ``--assert-fleet`` checks pass; ``run_cold_start`` (cold and warm
   boot times, printed, not gated); the replicas' capture times and the
   phase's wall time;
8. print the ``kernels`` JSON line, then the result line.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
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

# the engine: Llama-3-8B (the main path's model), 8 slots, prompts of 96
# to 1000 tokens, windows of 32 steps; logprobs of the top 5 for the slot
# that asks; the engine benchmark's prompts of 128 tokens
ENGINE_SLOTS, ENGINE_STEPS, ENGINE_PROMPTS = 8, 32, (96, 1000)
ENGINE_LOGPROBS, ENGINE_BENCH_PROMPT = 5, 128

# the paged engine: pages of 32 rows (the admission chunk); the grammar
# of its constrained request, whose keys and punctuation are forced
# tokens over the synthetic vocabulary (see grammar_vocab)
PAGE = 32
GRAMMAR = r'\{"n":[0-9][0-9]?[0-9]?\}'

# the scheduler phase: windows of 8 steps, 4 prefill dispatches an open
# window, packs of up to 4 admissions, at most 32 new tokens a request;
# the engine phase's eight requests at iteration 0, eight more at
# iterations 2-9; the arms (interleave, packed prefill, overlap)
SCHED_WINDOW, SCHED_BUDGET, SCHED_PACK, SCHED_NEW = 8, 4, 4, 32
SCHED_ARMS = (("serial", False, False, False),
              ("interleave", True, False, False),
              ("interleave+packed", True, True, False),
              ("interleave+packed+overlap", True, True, True))

# the HTTP phase: 8 concurrent streaming clients; bench_serving's --http
# load test at 32 requests of prompts of 128 tokens (8 distinct prompts,
# one a slot, as its --batch 8 gives)
HTTP_CLIENTS, HTTP_BENCH_REQUESTS, HTTP_BENCH_PROMPT = 8, 32, 128

# the training path: AlexNet, batch 1024 (224 px, s2d), and its three
# conv->pool stages: (pool input = conv output, conv input, window)
ALEX_BATCH, ALEX_WARMUP, ALEX_STEPS = 1024, 3, 10
STAGES = [((56, 56, 64), (56, 56, 48), 3),
          ((27, 27, 192), (27, 27, 64), 5),
          ((13, 13, 256), (13, 13, 256), 3)]


# the LM training path: Llama-3-8B at full width, 4 layers, one sequence
# of 8192 tokens (the model's context); Adam at the Llama papers' peak
# rate for this size; the flash-vs-einsum check at 1024 tokens
LM_LAYERS, LM_SEQ, LM_LR, LM_WARMUP, LM_STEPS = 4, 8192, 3e-4, 2, 5
LM_CHECK_SEQ = 1024
# its attention call (q shape, KV heads), and the head slice of it at
# which the plain version's f32 [T, T] scores fit
ATTN_FULL = ((1, LM_SEQ, 32, 128), 8)
ATTN_SLICE = ((1, LM_SEQ, 8, 128), 2)
GRAD_TOL = {"bfloat16": 5e-2, "float32": 5e-4}
# attention outputs and gradients are held by blocks of BLOCK_ROWS rows
# of one (batch, head): their values fall as 1/sqrt(row) along a causal
# sequence, so each entry's bar is TOL or GRAD_TOL times its block's rms
# (plus |want|), and each block's ||got - want|| / ||want|| is within
# BLOCK_REL; rounding the plain f32 result to bf16 alone gives about 2e-3
# (printed beside each reading), and a block that is 10% off or missing
# gives 0.1 or 1
BLOCK_ROWS = 64
BLOCK_REL = {"bfloat16": 1e-2, "float32": 1e-5}
ROUNDING_X = 1.5


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


def attention_bound_ms(q, k, causal: bool, per_pair: int, *moved):
    """Least time for an attention pass on these inputs: the visible
    (query, key) pairs at *per_pair* x D FLOPs each (4 forward, 6 for
    dQ, 8 for dK and dV) against the peak for the dtype, or each tensor
    in *moved* (every input read, every output written) once against
    HBM."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    pairs = Tq * (Tq + 1) // 2 if causal else Tq * Tk
    flops = per_pair * D * pairs * B * H
    peak = PEAK_BF16 if q.element_size() == 2 else PEAK_F32
    t_ops, t_bytes = flops / peak, nbytes(*moved) / PEAK_BYTES
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


# what each library's kernels must contain, by library (csrc/<library>.cu),
# kernel names in the built library and SASS instruction: the bf16 flash
# and conv+pool kernels run their products on the tensor cores through
# `wgmma` (HGMMA); the max-pool kernels copy their bands with
# `cp.async.bulk` (UBLKCP)
BUILD_CHECKS = (
    ("flash_attn_fwd", ("flash_fwd_bf16_kernel",), "HGMMA"),
    ("flash_attn_bwd", ("flash_dq_bf16_kernel", "flash_dkv_bf16_kernel"),
     "HGMMA"),
    ("conv_pool_fwd", ("conv_pool_bf16_kernel",), "HGMMA"),
    ("maxpool", ("maxpool_fwd_kernel", "maxpool_bwd_kernel"), "UBLKCP"),
)


def _cuobjdump(build, *args) -> str:
    """The output of the toolkit's ``cuobjdump`` (beside nvcc)."""
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    return subprocess.run([tool, *args], capture_output=True, text=True,
                          timeout=300, check=True).stdout


def check_build(build, library: str, kernels, instruction: str) -> None:
    """Phase 2: every instantiation of each of *kernels* in the built
    *library* spills nothing (no stack and no local memory in
    ``cuobjdump -res-usage``) and issues *instruction* (in ``cuobjdump
    -sass``); its registers and static shared memory are printed beside
    them (registers at launch: the flash kernels then move them from the
    producer warpgroup to the consumers with ``setmaxnreg``; the max-pool
    kernels' band ring is dynamic shared memory, printed by phase 3)."""
    lib = str(build.lib_path(library))
    usage, name = {}, None
    for line in _cuobjdump(build, "-res-usage", lib).splitlines():
        head = re.match(r"\s*Function (\S+?):?\s*$", line)
        if head:
            name = head.group(1)
        elif name and "REG:" in line:
            usage[name] = {k: int(v) for k, v in
                           re.findall(r"(\w+):(\d+)", line)}
            name = None
    hits, name = {}, None
    for line in _cuobjdump(build, "-sass", lib).splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            name = head.group(1)
            hits[name] = 0
        elif name and instruction in line:
            hits[name] += 1
    for kernel in kernels:
        found = sorted(n for n in hits if kernel in n)
        if not found:
            fail(f"{kernel} not in the SASS of {lib}")
        for n in found:
            u = usage.get(n)
            if u is None:
                fail(f"no resource usage for {n}")
            # the template arguments: the element type (t: bf16 bits,
            # f: f32), if any, then the integers
            kind = re.search(r"I([a-z])Li", n)
            label = ",".join(([kind.group(1)] if kind else [])
                             + re.findall(r"Li(\d+)E", n)) or "?"
            print(f"  {kernel}<{label}>: "
                  f"{u.get('REG')} registers at launch, stack "
                  f"{u.get('STACK')} B, local {u.get('LOCAL')} B, shared "
                  f"{u.get('SHARED', 0)} B static, {hits[n]} {instruction} "
                  f"instructions", flush=True)
            if u.get("STACK", 0) or u.get("LOCAL", 0):
                fail(f"{kernel} spills to local memory")
            if not hits[n]:
                fail(f"{kernel} issues no {instruction}")


def _held_forward(torch, fa, got, want, q, k, v, causal):
    """Hold a forward output against the plain version's (:func:`_held`).
    In bf16 also against the unrounded function, which is the plain
    version on f32 copies of the inputs (P and the output stay f32):
    ``exact_rel`` is the largest block ||got - exact|| / ||exact||, and
    ``rounding_rel`` what the plain version's own roundings (P and the
    output, to bf16) read against it.  The kernel rounds P against its
    running maximum and the plain version against the row's, so the two
    are compared through the function both of them round."""
    key = str(got.dtype).split(".")[-1]
    held = _held(torch, got, want, TOL[key][0], BLOCK_REL[key])
    if got.dtype == torch.bfloat16:
        exact = fa.flash_attention_fwd_plain(q.float(), k.float(), v.float(),
                                             causal)[0]
        held["exact_rel"] = float(_block_stats(torch, got, exact)[3]
                                  .nan_to_num(float("inf")).max())
        held["rounding_rel"] = float(_block_stats(torch, want, exact)[3]
                                     .max())
    return held


def _forward_line(r: dict) -> str:
    line = (f"o max_abs_err={r['max_abs_err']:.3e} block_rel="
            f"{r['block_rel']:.3e} mismatches={r['mismatches']}")
    if "exact_rel" in r:
        line += (f", against the unrounded function {r['exact_rel']:.3e} "
                 f"(the plain version's rounding alone "
                 f"{r['rounding_rel']:.3e})")
    return line


def _forward_failed(r: dict) -> bool:
    return bool(r["mismatches"]) or (
        "exact_rel" in r
        and r["exact_rel"] > ROUNDING_X * r["rounding_rel"])


def check_flash(torch, fa):
    """Phase 3: the flash kernel against its plain version: every entry
    and every block of 64 rows within the bars, every bf16 block within
    ROUNDING_X of rounding alone, and a second launch giving the same
    bits."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    # (name, q shape, Tk, KV heads, dtype, causal); "main" is the
    # Llama-3-8B prefill's call (grouped K/V, 8 KV heads for 32); "fused"
    # passes q/k/v as views of one fused projection
    cases = [
        ("main", (BATCH, PROMPT, 32, 128), PROMPT, 8, bf16, True),
        ("ragged", (2, 600, 32, 128), 600, 8, bf16, True),
        ("cross", (2, 100, 8, 64), 300, 2, bf16, False),
        ("d96", (1, 200, 4, 96), 200, 2, bf16, True),
        ("d64", (2, 320, 8, 64), 320, 2, bf16, True),
        ("t1024-gqa", (1, 1024, 8, 128), 1024, 2, bf16, True),
        ("t1024-mha", (1, 1024, 2, 128), 1024, 2, bf16, True),
        ("short", (2, 130, 4, 64), 40, 2, bf16, False),
        ("fused", (2, 96, 4, 64), 96, 2, bf16, True),
        ("no-keys", (2, 70, 4, 64), 0, 2, bf16, False),
        ("f32", (2, 256, 8, 64), 256, 2, f32, True),
        ("f32-ragged", (1, 200, 4, 128), 200, 4, f32, False),
    ]
    result = None
    for name, qs, tk, hkv, dtype, causal in cases:
        q, k, v, _ = _attention_inputs(torch, gen, qs, tk, hkv, dtype,
                                       fused=name == "fused")
        got = fa.flash_attention_cuda(q, k, v, causal)
        again = fa.flash_attention_cuda(q, k, v, causal)
        want = fa.flash_attention_plain(q, k, v, causal)
        torch.cuda.synchronize()
        key = str(dtype).split(".")[-1]
        held = _held_forward(torch, fa, got, want, q, k, v, causal)
        print(f"flash {name}: q {list(qs)} kv {[qs[0], tk, hkv, qs[3]]} "
              f"{key} causal={causal} " + _forward_line(held)
              + f" (tol {TOL[key][0]} x (block rms + |want|), block bar "
              f"{BLOCK_REL[key]}, {ROUNDING_X}x rounding)", flush=True)
        if _forward_failed(held) or not torch.isfinite(got).all():
            fail(f"flash kernel disagrees with its plain version ({name})")
        if not torch.equal(got, again):
            fail(f"two launches of the flash kernel differ ({name})")
        if tk == 0 and bool(got.any()):
            fail("flash kernel with no keys must give zeros")
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
        bound_ms, bound_by = attention_bound_ms(
            q, k, causal, 4, q, k, v, got)
        print(f"flash main: kernel {kernel_ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, library (sdpa) {library_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by})", flush=True)
        result = dict(max_abs_err=held["max_abs_err"],
                      max_block_rel_err=held["block_rel"], ms=kernel_ms,
                      kernel_ms=kernel_ms,
                      plain_ms=plain_ms, bound_ms=bound_ms,
                      bound_by=bound_by, library_ms=library_ms)
    return result


def _attention_inputs(torch, gen, q_shape, tk, hkv, dtype, fused=False):
    """q, k, v and an upstream gradient dO; with *fused*, q/k/v are views
    of one fused projection, as the model passes them."""
    B, Tq, H, D = q_shape
    if fused:
        qkv = torch.randn(B, Tq, (H + 2 * hkv) * D, generator=gen,
                          device="cuda", dtype=dtype)
        q = qkv[..., :H * D].view(B, Tq, H, D)
        k = qkv[..., H * D:(H + hkv) * D].view(B, Tq, hkv, D)
        v = qkv[..., (H + hkv) * D:].view(B, Tq, hkv, D)
    else:
        q = torch.randn(q_shape, generator=gen, device="cuda", dtype=dtype)
        k, v = (torch.randn((B, tk, hkv, D), generator=gen, device="cuda",
                            dtype=dtype) for _ in range(2))
    do = torch.randn(q_shape, generator=gen, device="cuda", dtype=dtype)
    return q, k, v, do


def _mismatches(torch, got, want, atol, rtol):
    err = (got.float() - want.float()).abs()
    bad = ~(err <= atol + rtol * want.float().abs())  # NaN counts as bad
    return float(err.nan_to_num(float("inf")).max()), int(bad.sum())


def _block_stats(torch, got, want, rows: int = BLOCK_ROWS):
    """*got* against *want* ([B, T, H, D]) by blocks of *rows* rows of one
    (batch, head): the f32 difference, *want*, each block's root mean
    square of *want* (over its rows within T) and its ||got - want|| /
    ||want||, all-zero blocks at 0 where *got* is 0 there too."""
    import torch.nn.functional as F

    B, T, H, D = want.shape
    pad = (0, 0, 0, 0, 0, (-T) % rows)
    w = F.pad(want.float(), pad).view(B, -1, rows, H, D)
    diff = F.pad(got.float(), pad).view(B, -1, rows, H, D) - w
    n = torch.full((w.shape[1], 1), float(rows * D), device=w.device)
    n[-1] = (T - rows * (w.shape[1] - 1)) * D
    sq, err_sq = w.square().sum((2, 4)), diff.square().sum((2, 4))
    rel = torch.where(sq > 0, (err_sq / sq).sqrt(),
                      torch.where(err_sq > 0, float("inf"), 0.0))
    return diff, w, (sq / n).sqrt(), rel


def _held(torch, got, want, tol: float, rel_bar: float):
    """Hold *got* against *want* with bars scaled to each block's own
    values, so that late rows, whose values are small, cannot hide under a
    bar set by the early ones: every entry within tol x (the block's rms +
    |want|), and every block's ||got - want|| / ||want|| within
    *rel_bar*.  Returns the readings and the mismatches (NaN counts as
    one): max abs error, largest block error, the same for *want* rounded
    to *got*'s dtype (the rounding alone), the smallest and largest block
    rms."""
    diff, w, rms, rel = _block_stats(torch, got, want)
    err = diff.abs()
    bad = ~(err <= tol * (rms[:, :, None, :, None] + w.abs()))
    bad_blocks = ~(rel <= rel_bar)
    rounding = _block_stats(torch, want.to(got.dtype), want)[3]
    return dict(max_abs_err=float(err.nan_to_num(float("inf")).max()),
                block_rel=float(rel.nan_to_num(float("inf")).max()),
                rounding_rel=float(rounding.max()),
                rms=(float(rms.min()), float(rms.max())),
                mismatches=int(bad.sum()) + int(bad_blocks.sum()))


def _held_line(name: str, r: dict) -> str:
    return (f"{name} max_abs_err={r['max_abs_err']:.3e} block_rel="
            f"{r['block_rel']:.3e} (rounding alone {r['rounding_rel']:.3e})"
            f" ref rms {r['rms'][0]:.3e}..{r['rms'][1]:.3e} "
            f"mismatches={r['mismatches']}")


def check_flash_training(torch, fa):
    """Phase 3: K4 with its lse, K5 and K6 against their plain versions on
    the LM training call's head slice and on edge shapes (the plain
    forward's lse and delta feed both backward versions, so each kernel is
    held alone); then the kernels' times at the full call against their
    bounds and ``scaled_dot_product_attention``, and the plain versions'
    at the slice."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(4)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # name, q shape, Tk, KV heads, dtype, causal
        ("slice", ATTN_SLICE[0], LM_SEQ, ATTN_SLICE[1], bf16, True),
        ("ragged", (1, 200, 4, 128), 200, 1, bf16, True),
        ("ragged-long", (2, 700, 8, 128), 700, 2, bf16, True),
        ("t1024", (1, 1024, 8, 128), 1024, 2, bf16, True),
        ("d96", (1, 200, 4, 96), 200, 2, bf16, True),
        ("short", (2, 40, 2, 64), 40, 2, bf16, True),
        ("cross", (1, 100, 4, 48), 150, 4, bf16, False),
        ("fused", (2, 96, 4, 64), 96, 2, bf16, True),
        ("f32", (1, 256, 8, 64), 256, 2, f32, True),
        ("f32-ragged", (1, 130, 6, 16), 130, 3, f32, True),
    ]
    err = {}
    for name, qs, tk, hkv, dtype, causal in cases:
        q, k, v, do = _attention_inputs(torch, gen, qs, tk, hkv, dtype,
                                        fused=name == "fused")
        o, lse = fa.flash_attention_cuda(q, k, v, causal, return_lse=True)
        po, plse = fa.flash_attention_fwd_plain(q, k, v, causal)
        delta = fa.attention_delta(do, po)
        dq = fa.flash_attention_dq_cuda(q, k, v, do, plse, delta, causal)
        dk, dv = fa.flash_attention_dkv_cuda(q, k, v, do, plse, delta,
                                             causal)
        torch.cuda.synchronize()
        want = fa.flash_attention_bwd_plain(q, k, v, do, plse, delta, causal)
        key = str(dtype).split(".")[-1]
        tol, gtol, bar = TOL[key][0], GRAD_TOL[key], BLOCK_REL[key]
        held = {"o": _held_forward(torch, fa, o, po, q, k, v, causal),
                "dq": _held(torch, dq, want[0], gtol, bar),
                "dk": _held(torch, dk, want[1], gtol, bar),
                "dv": _held(torch, dv, want[2], gtol, bar)}
        # lse is f32 in both, of order log(T): only the order of the f32
        # sums differs
        lse_err, lse_bad = _mismatches(torch, lse, plse, 1e-4, 1e-5)
        print(f"flash training {name}: q {list(qs)} kv "
              f"{[qs[0], tk, hkv, qs[3]]} {key} causal={causal} "
              f"lse max_abs_err={lse_err:.3e} mismatches={lse_bad}, "
              + ", ".join(_forward_line(r) if n == "o" else _held_line(n, r)
                          for n, r in held.items())
              + f" (lse atol 1e-4 rtol 1e-5; o {tol}, gradients {gtol} x "
              f"(block rms + |want|); block bar {bar})", flush=True)
        if lse_bad or _forward_failed(held["o"]) or any(
                r["mismatches"] for r in held.values()):
            fail(f"K4 (lse), K5 or K6 disagrees with its plain version "
                 f"({name})")
        # in bf16 the gradients are the f32 ones rounded: a block reads at
        # most 1.5x what rounding the reference to bf16 alone reads
        if dtype == bf16 and any(held[n]["block_rel"]
                                 > ROUNDING_X * held[n]["rounding_rel"]
                                 for n in ("dq", "dk", "dv")):
            fail(f"K5 or K6 is further from its plain version than "
                 f"{ROUNDING_X}x rounding to bf16 ({name})")
        if name == "slice":
            err = {"lse": (max(held["o"]["max_abs_err"], lse_err),
                           held["o"]["block_rel"]),
                   "dq": (held["dq"]["max_abs_err"], held["dq"]["block_rel"]),
                   "dkv": (max(held["dk"]["max_abs_err"],
                               held["dv"]["max_abs_err"]),
                           max(held["dk"]["block_rel"],
                               held["dv"]["block_rel"]))}
            plain_fwd_ms = time_ms(
                torch, lambda: fa.flash_attention_fwd_plain(q, k, v, True), 2,
                warmup=1)
            plain_bwd_ms = time_ms(
                torch, lambda: fa.flash_attention_bwd_plain(
                    q, k, v, do, plse, delta, True), 2, warmup=1)
        del q, k, v, do, o, lse, po, plse, delta, dq, dk, dv, want
        torch.cuda.empty_cache()

    # times at the full call of the training path
    q, k, v, do = _attention_inputs(torch, gen, ATTN_FULL[0], LM_SEQ,
                                    ATTN_FULL[1], bf16)
    o, lse = fa.flash_attention_cuda(q, k, v, True, return_lse=True)
    delta = fa.attention_delta(do, o)
    dq = fa.flash_attention_dq_cuda(q, k, v, do, lse, delta, True)
    dk, dv = fa.flash_attention_dkv_cuda(q, k, v, do, lse, delta, True)
    fwd_ms = time_ms(torch, lambda: fa.flash_attention_cuda(
        q, k, v, True, return_lse=True), 10)
    dq_ms = time_ms(torch, lambda: fa.flash_attention_dq_cuda(
        q, k, v, do, lse, delta, True), 10)
    dkv_ms = time_ms(torch, lambda: fa.flash_attention_dkv_cuda(
        q, k, v, do, lse, delta, True), 10)
    # the library yardstick: SDPA on [B, H, T, D] transposes; its forward
    # runs before the timer and only its backward (dQ, dK and dV in one
    # call) is timed
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    lib_fwd_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), 10)
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                         enable_gqa=True)
    dot = do.transpose(1, 2)
    lib_bwd_ms = time_ms(torch, lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True), 10)
    bounds = {
        "lse": attention_bound_ms(q, k, True, 4, q, k, v, o, lse),
        "dq": attention_bound_ms(q, k, True, 6, q, k, v, do, lse, delta, dq),
        "dkv": attention_bound_ms(q, k, True, 8, q, k, v, do, lse, delta,
                                  dk, dv),
    }
    times = {"lse": (fwd_ms, plain_fwd_ms, lib_fwd_ms),
             "dq": (dq_ms, plain_bwd_ms, lib_bwd_ms),
             "dkv": (dkv_ms, plain_bwd_ms, lib_bwd_ms)}
    for key, label in (("lse", "K4 with lse"), ("dq", "K5 dQ"),
                       ("dkv", "K6 dK/dV")):
        t, (b, by) = times[key], bounds[key]
        print(f"{label}: kernel {t[0]:.4f} ms at q {list(ATTN_FULL[0])} kv "
              f"{list(k.shape)} bf16 causal, bound "
              f"{b:.4f} ms ({by}); plain {t[1]:.4f} ms at the slice q "
              f"{list(ATTN_SLICE[0])}; library (sdpa "
              f"{'forward' if key == 'lse' else 'backward'}) {t[2]:.4f} ms",
              flush=True)
    print(f"K5 + K6 {dq_ms + dkv_ms:.4f} ms against the sdpa backward "
          f"{lib_bwd_ms:.4f} ms", flush=True)
    return {key: dict(max_abs_err=err[key][0], max_block_rel_err=err[key][1],
                      ms=times[key][0],
                      plain_ms=times[key][1], bound_ms=bounds[key][0],
                      bound_by=bounds[key][1], library_ms=times[key][2])
            for key in times}


def profile_region(torch, name: str, fn) -> None:
    """Where the time goes: device time by kernel over one call of *fn*
    (``torch.profiler``), against the wall time of the same region; the
    difference is device idle time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    return wall_ms, busy


def profile_split(torch, inference, model, prompt, steps: int = 8):
    """Device time by kernel over one prefill and over *steps* decode
    steps, the steps replayed from the captured graph (captured before
    the profiled region)."""
    B, T = prompt.shape
    pos = torch.arange(T, dtype=torch.int32, device="cuda").expand(B, T)
    logits, cache = inference._prefill(model, prompt, pos)
    pos0 = torch.full((B,), T, dtype=torch.int32, device="cuda")

    def prefill():
        inference._prefill(model, prompt, pos)

    # the prefill first: a capture empties the allocator's cache, and the
    # prefill's allocations would then reach cudaMalloc
    profile_region(torch, "prefill", prefill)
    decode_steps = inference._DecodeSteps(
        model, cache, inference._greedy_pick, None, 1.0, 0, steps + 1,
        graph=True)

    def decode():
        decode_steps.run(logits[:, -1], pos0, steps + 1)

    before = inference._decode_loop.graph_replays
    _, busy = profile_region(torch, f"decode x{steps} (replays)", decode)
    if inference._decode_loop.graph_replays - before != steps:
        fail("the profiled decode did not replay its graph once a step")
    if busy <= 0:
        fail("the profiler saw no device time in the replayed decode")


def clone_cache(cache):
    return {name: {key: t.clone() for key, t in layer.items()}
            for name, layer in cache.items()}


def graph_vs_eager_decode(torch, inference, model, prompt, toks):
    """The decode loop captured and replayed against the same loop run
    op by op, from copies of one prefilled cache: identical ids, one
    replay a step."""
    B, T = prompt.shape
    pos = torch.arange(T, dtype=torch.int32, device="cuda").expand(B, T)
    logits, cache = inference._prefill(model, prompt, pos)
    pos0 = torch.full((B,), T, dtype=torch.int32, device="cuda")
    last = logits[:, -1]
    eager_cache = clone_cache(cache)
    want = inference._decode_loop(model, eager_cache, last, NEW_TOKENS,
                                  pos0, None, inference._greedy_pick, 1.0,
                                  None, eager=True)
    before = inference._decode_loop.graph_replays
    got = inference._decode_loop(model, cache, last, NEW_TOKENS, pos0,
                                 None, inference._greedy_pick, 1.0, None)
    replays = inference._decode_loop.graph_replays - before
    same = int((got == want).sum())
    print(f"decode graph vs eager on one prefilled cache: "
          f"{same}/{got.numel()} ids equal, "
          f"{replays} replays for {NEW_TOKENS - 1} steps; "
          f"greedy_generate's ids equal: {torch.equal(got, toks)}",
          flush=True)
    if replays != NEW_TOKENS - 1:
        fail(f"{replays} replays for {NEW_TOKENS - 1} decode steps")
    if not torch.equal(got, want):
        fail("the replayed decode's ids differ from the eager loop's")
    if not torch.equal(got, toks):
        fail("greedy_generate's ids differ from the decode loop's")


def main_path(torch, counts, inference, llama, bench_serving, serving,
              grammar, obs, scheduler, card):
    """Phase 4: Llama-3-8B greedy generation through the port, then the
    serving engine, the paged engine and the iteration scheduler."""
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

    counts.zero()
    replays = inference._decode_loop.graph_replays
    t0 = time.perf_counter()
    toks, logits = inference.greedy_generate(model, prompt, NEW_TOKENS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = counts.read()
    launches = got["flash_attn_fwd"]
    replays = inference._decode_loop.graph_replays - replays
    print(f"greedy_generate: batch {BATCH}, prompt {PROMPT}, {NEW_TOKENS} "
          f"tokens in {wall:.3f} s (capture included); launches {got}; "
          f"{replays} decode graph replays", flush=True)
    if launches != cfg.n_layers:
        fail(f"flash kernel launched {launches} times in the prefill, "
             f"expected {cfg.n_layers} (one per layer)")
    if replays != NEW_TOKENS - 1:
        fail(f"the decode replayed its graph {replays} times, expected "
             f"{NEW_TOKENS - 1}")
    if tuple(toks.shape) != (BATCH, NEW_TOKENS) or \
            tuple(logits.shape) != (BATCH, PROMPT, cfg.vocab):
        fail(f"unexpected shapes {tuple(toks.shape)}, "
             f"{tuple(logits.shape)}")
    if not torch.isfinite(logits).all():
        fail("non-finite prefill logits")
    if not ((toks >= 0) & (toks < cfg.vocab)).all():
        fail("token id out of range")
    if not torch.equal(toks[:, 0].long(), logits[:, -1].argmax(-1)):
        fail("first token is not the argmax of the last prefill logits")
    del logits
    graph_vs_eager_decode(torch, inference, model, prompt, toks)
    del toks

    replays = inference._decode_loop.graph_replays
    stats = inference.decode_throughput(model, prompt, NEW_TOKENS, rounds=3)
    replays = inference._decode_loop.graph_replays - replays
    print(f"llama3-8b: prefill {stats['prefill_ms']:.3f} ms "
          f"({BATCH}x{PROMPT} tokens), decode "
          f"{stats['tokens_per_sec']:.1f} tokens/s at batch {BATCH} "
          f"(graph captured in {stats['capture_ms']:.1f} ms, {replays} "
          f"replays over 4 rounds); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; {card}",
          flush=True)
    if replays != 4 * (NEW_TOKENS - 1):
        fail(f"decode_throughput replayed {replays} times, expected "
             f"{4 * (NEW_TOKENS - 1)}")
    profile_split(torch, inference, model, prompt)
    engine = engine_path(torch, inference, serving, bench_serving, model,
                         card)
    torch.cuda.empty_cache()
    engine["paged"] = paged_path(torch, inference, serving, grammar, model,
                                 engine, card)
    torch.cuda.empty_cache()
    counts.zero()
    engine["scheduler"] = scheduler_path(torch, obs, inference, serving,
                                         scheduler, model, card)
    got = counts.read()
    print(f"scheduler: kernel launches over the phase {got} (its extends "
          f"attend through the einsum, as the JAX engine's do)", flush=True)
    torch.cuda.empty_cache()
    counts.zero()
    engine["http"] = http_path(torch, obs, serving, model,
                               engine["scheduler"], card)
    got = counts.read()
    print(f"http: kernel launches over the phase {got}", flush=True)
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
    return launches, stats, engine


def engine_requests(np, vocab: int):
    """The engine phase's eight requests: prompts of ENGINE_PROMPTS
    tokens from a seeded numpy generator; four greedy, two sampled with
    their own seeds (temperature 0.8, top-p 0.95), one with stop ids,
    one asking for logprobs."""
    rng = np.random.default_rng(2)
    lengths = rng.integers(ENGINE_PROMPTS[0], ENGINE_PROMPTS[1] + 1,
                           size=ENGINE_SLOTS)
    prompts = [rng.integers(0, vocab, size=int(n)).tolist()
               for n in lengths]
    sampled = dict(temperature=0.8, top_p=0.95)
    knobs = [{}, {}, {}, {}, dict(sampled, seed=101),
             dict(sampled, seed=202),
             dict(stop=rng.integers(0, vocab, size=4).tolist()),
             dict(logprobs=ENGINE_LOGPROBS)]
    return list(zip(prompts, knobs))


def graph_ms(torch, fn, iters: int = 10) -> float:
    """Device ms of one call of *fn*, captured as a CUDA graph and timed
    over replays (no host launch time in it)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(torch, graph.replay, iters)


def engine_path(torch, inference, serving, bench_serving, model, card):
    """Phase 4, the engine: the same eight admissions on two
    ``ServingEngine(n_slots=8)``; one run_scan window of ENGINE_STEPS
    steps replayed from the captured step on the first, as many
    ``step`` calls run op by op on the second; identical ids (sampled
    slots too), logprobs and finish reasons, and one replay a step.
    Then the engine benchmark's tokens/s, a profile of one window and
    the share of ``_decode_attention`` in a replayed step."""
    import numpy as np

    reqs = engine_requests(np, model.vocab)
    engines, admit_ms = [], {}
    for graphs in (True, False):
        eng = serving.ServingEngine(model, n_slots=ENGINE_SLOTS,
                                    logprobs_k=ENGINE_LOGPROBS, rng=0,
                                    device="cuda")
        eng._use_graphs = graphs
        # the captured admission extend is captured here, not in the
        # timed admissions
        eng.warm_packed([1])
        admit_ms[graphs] = _admit_all(torch, eng, reqs)
        engines.append(eng)
    graph, eager = engines
    lengths = [len(p) for p, _ in reqs]
    print(f"engine: {ENGINE_SLOTS} slots, max_len {MAX_LEN}, chunk "
          f"{graph.chunk}; prompts {lengths}; admission "
          f"{admit_ms[True]:.1f} ms a request through the captured chunk "
          f"extend ({graph.extend_replays} replays, captured in "
          f"{graph.extend_capture_ms:.1f} ms), {admit_ms[False]:.1f} ms "
          f"run op by op (means of {len(reqs)}, chunked prefill "
          f"included); {card}", flush=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    graph.run_scan(ENGINE_STEPS)
    window_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    for _ in range(ENGINE_STEPS):
        eager.step()
    eager_ms = (time.perf_counter() - t0) * 1e3
    print(f"engine: one window of {ENGINE_STEPS} steps in {window_ms:.1f} "
          f"ms (capture {graph.capture_ms:.1f} ms of it, "
          f"{graph.graph_replays} replays); {ENGINE_STEPS} eager steps in "
          f"{eager_ms:.1f} ms; {card}", flush=True)
    if graph.graph_replays != ENGINE_STEPS:
        fail(f"a window of {ENGINE_STEPS} steps replayed "
             f"{graph.graph_replays} times")
    for s in range(ENGINE_SLOTS):
        got, want = graph.output(s), eager.output(s)
        if got != want:
            fail(f"slot {s} ({reqs[s][1]}): graph ids {got} differ from "
                 f"eager {want}")
        if graph.token_logprobs(s) != eager.token_logprobs(s):
            fail(f"slot {s}: graph logprobs differ from eager")
        if graph.finish_reason(s) != eager.finish_reason(s):
            fail(f"slot {s}: finish reasons differ")
        if not all(0 <= t < model.vocab for t in got):
            fail(f"slot {s}: token id out of range")
        if graph.finish_reason(s) is None and len(got) != ENGINE_STEPS + 1:
            fail(f"slot {s}: {len(got)} tokens, expected "
                 f"{ENGINE_STEPS + 1}")
    lp = graph.token_logprobs(7)
    if len(lp) != len(graph.output(7)) or not all(
            math.isfinite(c) and c <= 0 for c, _ in lp):
        fail("logprobs missing or not finite")
    print(f"engine: graph and eager ids identical in all {ENGINE_SLOTS} "
          f"slots (sampled slots 4, 5: {graph.output(4)[:6]}..., "
          f"{graph.output(5)[:6]}...); finish reasons "
          f"{[graph.finish_reason(s) for s in range(ENGINE_SLOTS)]}",
          flush=True)
    # what the paged engine's first window is held to
    window = [(graph.output(s), graph.finish_reason(s),
               graph.token_logprobs(s)) for s in range(ENGINE_SLOTS)]

    steps = 8
    before = graph.graph_replays
    wall, busy = profile_region(
        torch, f"engine window x{steps} (replays)",
        lambda: graph.run_scan(steps))
    if graph.graph_replays - before != steps or busy <= 0:
        fail("the profiled window did not replay its step on the device")
    # _decode_attention of every layer at the engine's shapes, its own
    # graph, against the replayed step's device time
    cfg_heads, head_dim = model.n_heads, model.d_model // model.n_heads
    layer = graph.cache["block_0"]
    q = torch.randn(ENGINE_SLOTS, 1, cfg_heads, head_dim,
                    dtype=model.dtype, device="cuda")

    def attention():
        for _ in range(model.n_layers):
            inference._decode_attention(q, layer["cached_k"],
                                        layer["cached_v"],
                                        layer["cache_lens"])

    attn_ms = graph_ms(torch, attention)
    step_ms = busy / steps
    print(f"engine: _decode_attention x{model.n_layers} layers "
          f"{attn_ms:.3f} ms of a replayed step's {step_ms:.3f} ms device "
          f"time: share {attn_ms / step_ms:.3f}; {card}", flush=True)
    del engines, graph, eager
    torch.cuda.empty_cache()

    prompt = torch.randint(0, model.vocab, (ENGINE_SLOTS, ENGINE_BENCH_PROMPT),
                           generator=torch.Generator().manual_seed(3))
    stats = bench_serving._engine_throughput(model, prompt.cuda(),
                                             ENGINE_STEPS)
    print(f"engine: bench_serving --engine {stats['tokens_per_sec']:.1f} "
          f"tokens/s at {ENGINE_SLOTS} slots (windows of {ENGINE_STEPS}, "
          f"prompts of {ENGINE_BENCH_PROMPT}, best of 3); {card}",
          flush=True)
    return dict(stats, window_ms=window_ms, eager_ms=eager_ms,
                admit_ms=admit_ms[True], admit_eager_ms=admit_ms[False],
                attention_share=attn_ms / step_ms, window=window)


def _admit_all(torch, eng, reqs):
    """Admit every request of *reqs* in turn; mean ms an admission."""
    ms = []
    for prompt, kw in reqs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.admit(prompt, **kw)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return sum(ms) / len(ms)


def next_logits(torch, eng):
    """The logits of the engine's next decode step, all slots, from a
    copy of its pool (the engine is not advanced)."""
    cache = clone_cache(eng.cache)
    tok = torch.as_tensor(eng.last_token, dtype=torch.int64,
                          device="cuda")[:, None]
    pos = torch.as_tensor(eng.lens, dtype=torch.int32, device="cuda")
    logits = eng._pmodel(tok, pos[:, None], cache, decode=True,
                         block_tables=eng._bt())[:, -1]
    del cache
    return logits


def grammar_vocab(np, vocab: int, seed: int):
    """A synthetic token vocabulary: ids below 128 are their ASCII byte
    (0 is eos, no bytes), the rest two-letter strings drawn from
    *seed*."""
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz"
                            b"ABCDEFGHIJKLMNOPQRSTUVWXYZ", np.uint8)
    pairs = np.random.default_rng(seed).choice(letters, (vocab - 128, 2))
    return ([b""] + [bytes([i]) for i in range(1, 128)]
            + [bytes(p) for p in pairs.tolist()])


def window_rate(torch, serving, model, prompt, steps: int, **kw):
    """An engine's decode rate at ENGINE_SLOTS requests of
    ENGINE_BENCH_PROMPT tokens: windows of *steps* replays, best of 3
    after one warm window; then a profile of one window (its idle share
    and device ms a step), and the host ms a window spends in
    ``_ensure_append_pages``."""
    eng = serving.ServingEngine(model, n_slots=ENGINE_SLOTS, rng=0,
                                device="cuda", **kw)
    for row in prompt.tolist():
        eng.admit(row)
    host = [0.0]
    ensure = eng._ensure_append_pages

    def timed_ensure(n):
        t0 = time.perf_counter()
        ensure(n)
        host[0] += (time.perf_counter() - t0) * 1e3

    eng._ensure_append_pages = timed_ensure
    eng.run_scan(steps)
    best = None
    host[0] = 0.0
    for _ in range(3):
        t0 = time.perf_counter()
        eng.run_scan(steps)
        dt = time.perf_counter() - t0
        best = dt if best is None or dt < best else best
    ensure_ms = host[0] / 3
    profiled = 8
    wall, busy = profile_region(
        torch, f"{'paged' if kw else 'contiguous'} engine window "
               f"x{profiled}", lambda: eng.run_scan(profiled))
    return eng, dict(tokens_per_sec=ENGINE_SLOTS * steps / best,
                     idle=max(0.0, 1 - busy / wall),
                     step_ms=busy / profiled, ensure_ms=ensure_ms)


def paged_path(torch, inference, serving, grammar, model, engine, card):
    """Phase 4, the paged engine: ``ServingEngine(kv_paging=True)`` on
    the engine phase's model and eight requests, page 32.  (1) a full
    pool: ids, finish reasons and logprobs of one window of 32 replays
    equal the contiguous engine's; (2) a pool of about half the pages
    the requests hold at their end, with a policy that preempts the
    newest active slot and resumes it when pages free: every request
    finishes with the full pool's ids; (3) int8 pages run to the end;
    (4) one greedy request under a regex grammar among the others,
    over a synthetic 128,256-token vocabulary: its output full-matches
    the grammar, the neighbours keep their ids, and a jump round
    forces tokens; (5) the decode rate, idle share and device ms a
    step of paged windows beside contiguous ones, the pool gather's
    share of a replayed step, and the host ms a window spends
    allocating pages.  Every check is fatal."""
    import numpy as np

    reqs = engine_requests(np, model.vocab)
    want = engine["window"]
    base = dict(n_slots=ENGINE_SLOTS, logprobs_k=ENGINE_LOGPROBS, rng=0,
                kv_paging=True, kv_page_size=PAGE, device="cuda")

    # (1) a full pool against the contiguous engine's window
    full = serving.ServingEngine(model, **base)
    admit_ms = _admit_all(torch, full, reqs)
    first = next_logits(torch, full)
    full.run_scan(ENGINE_STEPS)
    flags = list(full._graphs)
    if full.graph_replays != ENGINE_STEPS or not all(f[-1] for f in flags):
        fail(f"paged window: {full.graph_replays} replays of {flags}")
    for s in range(ENGINE_SLOTS):
        got = (full.output(s), full.finish_reason(s),
               full.token_logprobs(s))
        if got != want[s]:
            fail(f"paged slot {s} ({reqs[s][1]}): ids, finish reason or "
                 f"logprobs differ from the contiguous engine's: "
                 f"{got[0][:8]}... against {want[s][0][:8]}...")
    st = full.stats()
    held = st["kv_pages"] - st["kv_pages_free"]
    full_ids = [full.output(s) for s in range(ENGINE_SLOTS)]
    print(f"paged: full pool of {st['kv_pages']} pages of {PAGE} rows; "
          f"admission {admit_ms:.1f} ms a request; one window of "
          f"{ENGINE_STEPS} replays gives the contiguous engine's ids, "
          f"finish reasons and logprobs in all {ENGINE_SLOTS} slots; "
          f"{held} pages held at its end; {card}", flush=True)
    del full
    torch.cuda.empty_cache()

    # (2) an oversubscribed pool with a preemption policy
    pages = held // 2
    eng = serving.ServingEngine(model, max_new_tokens=ENGINE_STEPS + 1,
                                kv_pages=pages, **base)
    order, parked, owner, done = [], [], {}, {}
    ms = {"preempt": [], "resume": []}

    def timed(kind, fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        ms[kind].append((time.perf_counter() - t0) * 1e3)
        return out

    def preempt_newest(exclude):
        live = [s for s in order if eng.active[s] and s != exclude]
        if not live:
            return False
        s = live[-1]
        parked.append((owner.pop(s), timed("preempt", eng.preempt, s)))
        order.remove(s)
        return True

    eng.set_preempt_cb(preempt_newest)
    queue = list(range(ENGINE_SLOTS))
    windows = 0
    while len(done) < ENGINE_SLOTS:
        while parked and eng.free_slots():
            try:
                s = timed("resume", eng.resume, parked[0][1])
            except serving.PagePoolExhausted:
                ms["resume"].pop()
                break
            owner[s] = parked.pop(0)[0]
            order.append(s)
        while queue and eng.free_slots() and not parked:
            prompt, kw = reqs[queue[0]]
            try:
                s = eng.admit(prompt, **kw)
            except serving.PagePoolExhausted:
                break
            owner[s] = queue.pop(0)
            order.append(s)
        if not any(eng.active):
            fail("oversubscribed pool: nothing could run")
        eng.run_scan(ENGINE_STEPS)
        windows += 1
        if windows > 4 * ENGINE_SLOTS:
            fail(f"oversubscribed pool: {len(done)} of {ENGINE_SLOTS} "
                 f"requests finished after {windows} windows")
        for s in list(owner):
            if eng.finished(s):
                done[owner.pop(s)] = eng.output(s)
                order.remove(s)
                eng.release(s)
    for i in range(ENGINE_SLOTS):
        if done[i] != full_ids[i]:
            fail(f"oversubscribed pool: request {i} gave {done[i][:8]}... "
                 f"against the full pool's {full_ids[i][:8]}...")
    n_pre, n_res = len(ms["preempt"]), len(ms["resume"])
    if not n_pre or n_res != n_pre:
        fail(f"oversubscribed pool: {n_pre} preemptions, {n_res} "
             "resumptions")
    eng._pool.check()
    print(f"paged: pool of {pages} pages (half the {held} the full pool "
          f"held), {windows} windows: all {ENGINE_SLOTS} requests finish "
          f"with the full pool's ids after {n_pre} preemptions and "
          f"{n_res} resumptions; preempt {sum(ms['preempt']) / n_pre:.1f} "
          f"ms, resume {sum(ms['resume']) / n_res:.1f} ms (means); {card}",
          flush=True)
    del eng
    torch.cuda.empty_cache()

    # (3) int8 pages
    q8 = serving.ServingEngine(model, kv_dtype="int8", **base)
    _admit_all(torch, q8, reqs)
    diff = float((next_logits(torch, q8) - first).abs().max())
    q8.run_scan(ENGINE_STEPS)
    agree = []
    for s in (0, 1, 2, 3):
        got, ref = q8.output(s), full_ids[s]
        n = next((i for i, (a, b) in enumerate(zip(got, ref)) if a != b),
                 min(len(got), len(ref)))
        agree.append(n)
    if any(len(q8.output(s)) != len(full_ids[s])
           for s in range(ENGINE_SLOTS)):
        fail("int8 pool: a slot did not run to the end of the window")
    print(f"paged: int8 pool runs the window; leading greedy ids that "
          f"agree with the bf16 pool (slots 0-3, of "
          f"{ENGINE_STEPS + 1}): {agree}; largest logit difference at the "
          f"first step {diff:.4f} (max |logit| "
          f"{float(first.abs().max()):.3f}); {card}", flush=True)
    del q8, first
    torch.cuda.empty_cache()

    # (4) a grammar over a synthetic vocabulary
    t0 = time.perf_counter()
    dfa = grammar.token_dfa(grammar.regex_to_dfa(GRAMMAR),
                            grammar_vocab(np, model.vocab, 0), eos_id=0)
    build_s = time.perf_counter() - t0
    g = serving.ServingEngine(model, grammar=dfa, **base)
    prompt0 = reqs[0][0]
    gs = g.admit(prompt0, grammar=True, stop=[0])
    forced = g.forced_pending()
    jumped = g.jump_round()
    st = g.stats()
    if not forced or jumped is None or st["jump_forced_tokens"] < 1:
        fail(f"grammar: no forced token jumped ({st['jump_rounds']} "
             f"rounds, {st['jump_forced_tokens']} forced)")
    for prompt, kw in reqs[1:]:
        g.admit(prompt, **kw)
    g.run_scan(ENGINE_STEPS)
    out = g.output(gs)
    text = bytes(t for t in out if t).decode("latin-1")
    if g.finish_reason(gs) != "stop" or not re.fullmatch(GRAMMAR, text):
        fail(f"grammar: output {text!r} ({g.finish_reason(gs)}) does not "
             f"full-match {GRAMMAR}")
    for s in range(1, ENGINE_SLOTS):
        if g.output(s) != full_ids[s]:
            fail(f"grammar: neighbour slot {s} gave {g.output(s)[:8]}... "
                 f"against {full_ids[s][:8]}...")
    if not any(f[7] for f in g._graphs):
        fail("grammar: no grammared step was captured")
    print(f"paged: grammar {GRAMMAR} over {model.vocab} tokens (table "
          f"built in {build_s:.2f} s, {dfa.table.shape[0]} states): "
          f"{text!r}, a jump round forced {st['jump_forced_tokens']} "
          f"tokens; the {ENGINE_SLOTS - 1} neighbours keep their ids; "
          f"{card}", flush=True)
    del g
    torch.cuda.empty_cache()

    # (5) rates and shares, paged beside contiguous
    prompt = torch.randint(0, model.vocab, (ENGINE_SLOTS, ENGINE_BENCH_PROMPT),
                           generator=torch.Generator().manual_seed(3))
    rates = {}
    for name, kw in (("contiguous", {}),
                     ("paged", dict(kv_paging=True, kv_page_size=PAGE))):
        eng, rates[name] = window_rate(torch, serving, model, prompt,
                                       ENGINE_STEPS, **kw)
        if name == "paged":
            # the gather with this run's tables (short prompts: most
            # entries are the scratch page, read from the L2 cache), and
            # with every entry a distinct page, as in a full pool
            pool = eng._pool
            tables = {"run": eng._bt().clone(),
                      "full": torch.randperm(pool.n_pages, device="cuda")[
                          :ENGINE_SLOTS * pool.n_tables].view(
                              ENGINE_SLOTS, pool.n_tables)}
            gather_ms = {}
            for key, bt in tables.items():
                def gather(bt=bt):
                    for layer in eng.cache.values():
                        inference._gather_pool_view(layer["cached_k"], bt,
                                                    model.dtype)
                        inference._gather_pool_view(layer["cached_v"], bt,
                                                    model.dtype)
                gather_ms[key] = graph_ms(torch, gather)
            layer = eng.cache["block_0"]
            view = layer["cached_k"][tables["full"]]
            # every view row read once from a page and written once, K
            # and V, every layer
            gather_bound = bytes_bound_ms(view, view, view, view) \
                * model.n_layers
            mapped = (int((tables["run"] != pool.scratch).sum()),
                      tables["run"].numel())
            del view
        del eng
        torch.cuda.empty_cache()
    c, p = rates["contiguous"], rates["paged"]
    share = gather_ms["run"] / p["step_ms"]
    print(f"paged: decode {p['tokens_per_sec']:.1f} tokens/s at "
          f"{ENGINE_SLOTS} slots against contiguous "
          f"{c['tokens_per_sec']:.1f}; window idle share {p['idle']:.3f} "
          f"against {c['idle']:.3f}; device {p['step_ms']:.3f} ms a step "
          f"against {c['step_ms']:.3f}; _ensure_append_pages "
          f"{p['ensure_ms']:.3f} host ms a window of {ENGINE_STEPS}; {card}",
          flush=True)
    print(f"paged: the pool gather (K and V, {model.n_layers} layers) "
          f"{gather_ms['run']:.3f} ms with this run's tables ({mapped[0]} of "
          f"{mapped[1]} entries mapped), share "
          f"{share:.3f} of a replayed step; {gather_ms['full']:.3f} ms with "
          f"every entry a distinct page (bound {gather_bound:.3f} ms by "
          f"the bytes); {card}", flush=True)
    return dict(rates=rates, gather_ms=gather_ms, gather_share=share,
                gather_bound=gather_bound, preemptions=n_pre,
                int8_agree=agree, int8_diff=diff)


def scheduler_trace(np, vocab: int, engine_reqs):
    """The scheduler phase's sixteen requests as (arrival iteration,
    prompt, knobs): the engine phase's eight at iteration 0, then eight
    at iterations 2-9, prompts of ENGINE_PROMPTS tokens from a seeded
    generator: one repeats the first 256 tokens of the engine phase's
    first prompt and one the first 160 of its third (chunk-aligned
    prefixes: APC hits), one is sampled with its own seed, the rest
    greedy."""
    rng = np.random.default_rng(3)
    lengths = rng.integers(ENGINE_PROMPTS[0], ENGINE_PROMPTS[1] + 1, size=8)
    trace = [(0, p, kw) for p, kw in engine_reqs]
    for j, n in enumerate(lengths):
        prompt = rng.integers(0, vocab, size=int(n)).tolist()
        kw = {}
        if j == 1:
            prompt = engine_reqs[0][0][:256] + prompt
        elif j == 4:
            prompt = engine_reqs[2][0][:160] + prompt
        elif j == 5:
            kw = dict(temperature=0.8, top_p=0.95, seed=303)
        trace.append((2 + j, prompt[:ENGINE_PROMPTS[1]], kw))
    return trace


def _metric(obs, body: str, name: str) -> float:
    return sum(v for n, _, v in obs.parse_exposition(body) if n == name)


def run_scheduled(torch, np, obs, scheduler, eng, trace, interleave,
                  packed, overlap):
    """Drive *trace* through an ``IterationScheduler`` over *eng*, the
    arrivals keyed to iteration indices; the owner's bookkeeping between
    iterations is its ``stream`` phase.  Arrival-to-first-token runs from
    the iteration a request arrives at to its first token (queueing for a
    slot included); admit-to-first-token from its ``Ticket``'s begin.  A
    running request's stall is the host time between two iterations that
    bring it decoded tokens.  Returns {request: (ids, finish reason)} and
    the arm's figures."""
    reg = obs.Registry()
    intake, keys, live, out, tickets = [], {}, {}, {}, []
    arrived, first_at, last, stall = {}, {}, {}, {}

    def pull():
        if not intake:
            return None
        i, prompt, kw = intake.pop(0)
        t = sched.begin(prompt, **kw)
        keys[t] = i
        tickets.append(t)
        return t

    sched = scheduler.IterationScheduler(
        eng, window=SCHED_WINDOW, interleave=interleave,
        prefill_budget=SCHED_BUDGET, pull=pull, sync_dwell_s=0.0,
        packed_prefill=packed, max_pack=SCHED_PACK, overlap=overlap,
        registry=reg)
    captures = eng.capture_ms + eng.extend_capture_ms
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for it in range(100000):
        now = time.perf_counter()
        for i, (at, p, kw) in enumerate(trace):
            if at == it:
                intake.append((i, p, kw))
                arrived[i] = now
        res = sched.iterate()
        t1 = time.perf_counter()
        for s, toks in res.decoded.items():
            if s in live and toks:
                i = live[s]
                if i in last:
                    stall[i] = max(stall.get(i, 0.0), t1 - last[i])
                last[i] = t1
        for t in res.admitted:
            live[t.slot] = keys.pop(t)
            first_at[live[t.slot]] = t.t_done
        for s in list(live):
            if eng.finished(s):
                out[live.pop(s)] = (eng.output(s), eng.finish_reason(s))
        sched.note_phase("stream", time.perf_counter() - t1)
        if len(out) == len(trace) and not sched.busy():
            break
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if len(out) != len(trace):
        fail(f"scheduler: {len(out)} of {len(trace)} requests finished")
    captured_s = (eng.capture_ms + eng.extend_capture_ms - captures) / 1e3
    body = reg.render()
    first = np.asarray([(t.t_done - t.t_begin) * 1e3 for t in tickets])
    ttft = np.asarray([(first_at[i] - arrived[i]) * 1e3 for i in first_at])
    stalls = np.asarray(list(stall.values())) * 1e3
    st = eng.stats()
    tokens = sum(len(ids) for ids, _ in out.values())
    figures = dict(
        wall_s=wall, capture_s=captured_s, tokens=tokens,
        tokens_per_sec=tokens / (wall - captured_s),
        first_p50_ms=float(np.percentile(first, 50)),
        first_p99_ms=float(np.percentile(first, 99)),
        ttft_p50_ms=float(np.percentile(ttft, 50)),
        ttft_p99_ms=float(np.percentile(ttft, 99)),
        stall_p50_ms=float(np.percentile(stalls, 50)),
        stall_max_ms=float(stalls.max()),
        duty=_metric(obs, body, "tpu_serve_device_duty_cycle"),
        overlap_windows=int(_metric(obs, body,
                                    "tpu_serve_overlap_windows_total")),
        iterations=it + 1,
        **{k: st[k] for k in ("packed_prefill_extends", "packed_prefill_rows",
                              "packed_prefill_pad_tokens",
                              "prefix_cache_hits", "prefill_tokens")})
    return out, figures


def _fresh(torch):
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def extend_bound_ms(model, rows: int):
    """Least time for one chunk extend of *rows* rows of 32 tokens: the
    weights read once and the f32 logits written once at the HBM rate,
    or 2 FLOPs per weight per token at the bf16 peak."""
    params = sum(p.numel() for p in model.parameters())
    logits = rows * 32 * model.vocab * 4
    t_bytes = (params * 2 + logits) / PEAK_BYTES
    t_ops = 2 * (params - model.vocab * model.d_model) * rows * 32 / PEAK_BF16
    return max(t_bytes, t_ops) * 1e3


def admission_extends(torch, inference, serving, model, reqs, card):
    """The captured chunk extend against its eager run at K = 1..4
    admissions on one set of minis (bit for bit), its ms beside the
    bound, what copying the minis in and out costs, and the per-K shapes
    it replaces: a B=K extend's last-row logits against the same rows
    run at B=1, and each shape's ms."""
    prompts = [p for p, _ in reqs[:SCHED_PACK]]
    kw = dict(n_slots=ENGINE_SLOTS, auto_prefix=False, device=model.device)
    graph = serving.ServingEngine(model, **kw)
    eager = serving.ServingEngine(model, **kw)
    eager._use_graphs = False
    graph.warm_packed(range(1, SCHED_PACK + 1))
    for k in range(1, SCHED_PACK + 1):
        got = []
        for eng in (graph, eager):
            sts = [eng.begin_admit(p) for p in prompts[:k]]
            if k == 1:
                eng.admit_step(sts[0])
            else:
                eng.admit_step_packed(sts)
            got.append([st.result[0] for st in sts]
                       + [eng._batch.logits[k][:k].clone()])
            for st in sts:
                eng.abort_admit(st)
        (*gm, gl), (*em, el) = got
        same = torch.equal(gl, el) and all(
            torch.equal(a[n][key], b[n][key]) for a, b in zip(gm, em)
            for n in a for key in a[n])
        if not same:
            fail(f"captured chunk extend at K={k} differs from its eager "
                 "run")
        del got, gm, em, gl, el
    batch = graph._batch
    width = batch.inputs.shape[1]
    captured = {}
    for k in range(1, SCHED_PACK + 1):
        captured[k] = dict(ms=time_ms(torch, batch.graphs[k].replay, 10),
                           bound=extend_bound_ms(model, k))
    # what a run of chunks pays to use the static cache: K minis copied
    # in and back out (each byte read and written once each way)
    sts = [graph.begin_admit(p) for p in prompts]
    minis = [st.gen.mini for st in sts]
    for k in (1, SCHED_PACK):
        def copies(k=k):
            serving._pack_minis(minis[:k], batch.cache)
            serving._unpack_minis(batch.cache, minis[:k])
        leaves = [t for m in minis[:k] for layer in m.values()
                  for t in layer.values()]
        captured[k].update(copy_ms=time_ms(torch, copies, 10),
                           copy_bound=4 * bytes_bound_ms(*leaves))
    for st in sts:
        graph.abort_admit(st)
    del minis, sts
    print(f"admission extend: the captured chunk extend ({width} rows of "
          f"32 tokens, K of them attending) equals its eager run bit for "
          f"bit at K = 1..{SCHED_PACK}; ms a replay at K = 1..{SCHED_PACK}: "
          + ", ".join(f"{c['ms']:.3f} (bound {c['bound']:.3f})"
                      for c in captured.values())
          + f"; {SCHED_PACK} captures in {graph.extend_capture_ms:.1f} ms; "
          f"copying the minis into the static cache and back, once a run "
          f"of chunks: {captured[1]['copy_ms']:.3f} ms at K = 1 (bound "
          f"{captured[1]['copy_bound']:.3f}), "
          f"{captured[SCHED_PACK]['copy_ms']:.3f} ms at K = {SCHED_PACK} "
          f"(bound {captured[SCHED_PACK]['copy_bound']:.3f}); {card}",
          flush=True)
    del graph, eager
    _fresh(torch)

    # the per-K shapes: each K its own extend, as one graph a pack size
    # would be; rows of a B=K extend against the same rows at B=1
    tok = torch.as_tensor([p[:32] for p in prompts], device=model.device,
                          dtype=torch.int32)
    pos = torch.arange(32, dtype=torch.int32, device=model.device).expand(
        SCHED_PACK, 32).contiguous()
    with torch.no_grad():
        alone = [model(tok[i:i + 1], pos[i:i + 1],
                       inference.init_cache(model, 1), decode=True)[0, -1]
                 for i in range(SCHED_PACK)]
    shapes = {}
    for k in range(1, SCHED_PACK + 1):
        cache = inference.init_cache(model, k)
        with torch.no_grad():
            rows = model(tok[:k], pos[:k], inference.init_cache(model, k),
                         decode=True)[:, -1]

        def extend(k=k, cache=cache):
            with torch.no_grad():
                model(tok[:k], pos[:k], cache, decode=True)

        diff = max(float((rows[i] - alone[i]).abs().max())
                   for i in range(k))
        agree = sum(int(rows[i].argmax() == alone[i].argmax())
                    for i in range(k))
        shapes[k] = dict(ms=graph_ms(torch, extend), diff=diff,
                         bound=extend_bound_ms(model, k))
        print(f"admission extend: a B={k} extend of its own shape "
              f"{shapes[k]['ms']:.3f} ms (bound {shapes[k]['bound']:.3f} "
              f"ms); its last-row logits against the same rows at B=1: "
              f"largest difference {diff:.4f}, {agree} of {k} argmax ids "
              f"agree; {card}", flush=True)
        del cache, rows
    del alone
    _fresh(torch)
    return dict(captured=captured, width=width, shapes=shapes)


class ByteTok:
    """One byte a token: ids 0-255 of the model's vocabulary; a larger
    id decodes as its low byte.  Lossless on the prompts it encodes,
    so the text surfaces can be held against the ids."""

    def encode(self, s):
        return list(s.encode("latin-1"))

    def decode(self, ids, **kw):
        return bytes(int(t) % 256 for t in ids).decode("latin-1")


# the reference's /statz keys
STATZ_KEYS = {"scheduler_alive", "queue_depth", "in_flight", "capacity",
              "kv_pages", "kv_pages_free", "requests_served", "role",
              "migrations", "shed", "kv_tiers", "goodput", "alerts"}
# /metrics families the phase needs: the scheduler's and the server's
HTTP_FAMILIES = ("tpu_serve_window_phase_seconds_count",
                 "tpu_serve_admit_to_first_step_seconds_count",
                 "tpu_serve_device_duty_cycle",
                 "tpu_serve_ttft_seconds_count",
                 "tpu_serve_request_seconds_count",
                 "tpu_serve_admit_seconds_count",
                 "tpu_slo_requests_total",
                 "tpu_serving_requests_served_total")


def _http(port, method, path, body=None, headers=None, timeout=600):
    """(status, headers, body bytes) of one request to the local server."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        data = body if isinstance(body, (bytes, type(None))) else \
            json.dumps(body)
        conn.request(method, path, data,
                     headers or {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, dict(resp.headers), resp.read()
    finally:
        conn.close()


def serve_trace(loadclient, port, trace, clients: int):
    """The scheduler phase's requests to ``/generate`` as token ids, in
    index order, from *clients* concurrent streaming clients of the
    port's ``loadclient``.  Returns {request: (ids, finish reason)},
    {request: StreamOutcome} and the wall seconds."""
    import threading

    lock = threading.Lock()
    order = iter(range(len(trace)))
    out, res = {}, {}

    def client():
        while True:
            with lock:
                i = next(order, None)
            if i is None:
                return
            _, prompt, kw = trace[i]
            lines = []
            r = loadclient.stream_request(
                "127.0.0.1", port,
                {"tokens": prompt, "max_new_tokens": SCHED_NEW, **kw},
                on_line=lines.append)
            done = json.loads(lines[-1]) if lines else {}
            with lock:
                res[i] = r
                out[i] = (done.get("tokens"), done.get("finish_reason"))

    threads = [threading.Thread(target=client) for _ in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out, res, time.perf_counter() - t0


def _kernel_events(path: str):
    """The CUDA kernel events of a chrome trace, and its event count by
    category."""
    with open(path) as f:
        trace = json.load(f)
    events = trace.get("traceEvents", trace) if isinstance(trace, dict) \
        else trace
    cats = {}
    for e in events:
        if isinstance(e, dict):
            cats[e.get("cat")] = cats.get(e.get("cat"), 0) + 1
    return cats.get("kernel", 0), cats


def http_path(torch, obs, serving, model, sched, card):
    """Phase 4, the HTTP front door on the engine phase's model: an
    ``EngineServer`` (windows of 8, at most 32 new tokens, interleave,
    packed prefill and overlap on: the server's defaults) over a paged
    ``ServingEngine(n_slots=8)``, warmed, then: the scheduler phase's
    sixteen requests from 8 concurrent streaming clients, each giving
    the scheduler phase's ids and finish reason; one ``/v1/completions``
    request, unary and SSE, whose text agrees with the ids of the same
    prompt on ``/generate``; ``/metrics``, ``/statz`` and
    ``/debug/traces``; ``/debug/profile?seconds=1`` with a request
    decoding, whose trace must hold CUDA kernel events; a request
    answered ``prefill_only`` and resumed through ``/migrate`` on a
    second server (``replica_role="decode"``, its own engine) with the
    ids of the scheduler phase; then ``bench_serving``'s ``--http`` load
    test (8 clients, 32 requests, prompts of 128).  Every check is
    fatal."""
    import shutil
    import tempfile

    import numpy as np

    from tpu_k8s_device_plugin_torch.workloads import (
        bench_serving, loadclient, migrate)
    from tpu_k8s_device_plugin_torch.workloads import server as srv_mod

    t_phase = time.perf_counter()
    trace, streams = sched["trace"], sched["streams"]
    overlap_arm = sched["arms"]["interleave+packed+overlap"]
    kw = dict(n_slots=ENGINE_SLOTS, logprobs_k=ENGINE_LOGPROBS, rng=0,
              kv_paging=True, kv_page_size=PAGE, device=model.device)
    prof_dir = tempfile.mkdtemp(prefix="chip_smoke_profile_")
    eng = serving.ServingEngine(model, **kw)
    srv = srv_mod.EngineServer(eng, window=SCHED_WINDOW,
                               max_new_tokens=SCHED_NEW, tokenizer=ByteTok(),
                               profile_dir=prof_dir)
    t0 = time.perf_counter()
    srv.warm_scheduler()
    warm_s = time.perf_counter() - t0
    srv.start(host="127.0.0.1", port=0)
    decode = None
    try:
        # (2) the sixteen requests over the wire
        captures = eng.capture_ms + eng.extend_capture_ms
        out, res, wall = serve_trace(loadclient, srv.port, trace,
                                     HTTP_CLIENTS)
        captured_s = (eng.capture_ms + eng.extend_capture_ms
                      - captures) / 1e3
        for i in range(len(trace)):
            if res[i].outcome != "ok" or out[i] != streams[i]:
                fail(f"http: request {i} gave {out[i][0]} "
                     f"({out[i][1]}, {res[i].outcome}: {res[i].error}) "
                     f"against the scheduler phase's {streams[i][0]} "
                     f"({streams[i][1]})")
        tokens = sum(len(ids) for ids, _ in out.values())
        tps = tokens / (wall - captured_s)
        ttft = np.asarray([r.ttft_s * 1e3 for r in res.values()])
        admit = []
        for r in res.values():
            _, _, body = _http(srv.port, "GET",
                               f"/debug/traces?trace_id={r.trace_id}")
            events = json.loads(body)["events"]
            names = {e["name"] for e in events}
            if not {"tpu_serve_admit", "tpu_serve_request"} <= names:
                fail(f"http: trace {r.trace_id} holds only {sorted(names)}")
            admit += [e["attrs"]["duration_s"] * 1e3 for e in events
                      if e["name"] == "tpu_serve_admit"]
        admit = np.asarray(admit)
        # (3) the OpenAI surface against the ids
        text = "The front door of the port, "
        _, _, body = _http(srv.port, "POST", "/generate", {
            "prompt": text, "max_new_tokens": 16, "stream": False})
        native = json.loads(body)
        _, _, body = _http(srv.port, "POST", "/v1/completions", {
            "prompt": text, "max_tokens": 16, "temperature": 0})
        unary = json.loads(body)
        _, _, body = _http(srv.port, "POST", "/v1/completions", {
            "prompt": text, "max_tokens": 16, "temperature": 0,
            "stream": True})
        sse = "".join(
            json.loads(line[6:])["choices"][0]["text"]
            for line in body.decode("latin-1").splitlines()
            if line.startswith("data: ") and line != "data: [DONE]")
        want = ByteTok().decode(native["tokens"])
        got = (native["text"], unary["choices"][0]["text"], sse)
        if len(native["tokens"]) != 16 or any(t != want for t in got) or \
                unary["usage"]["completion_tokens"] != 16:
            fail(f"http: text surfaces {got!r} disagree with the ids "
                 f"{native['tokens']} ({want!r})")
        # (4) the scrape surfaces
        _, _, body = _http(srv.port, "GET", "/metrics")
        names = {n for n, _, _ in obs.parse_exposition(body.decode())}
        missing = [n for n in HTTP_FAMILIES if n not in names]
        _, _, body = _http(srv.port, "GET", "/statz")
        statz = json.loads(body)
        if missing or set(statz) != STATZ_KEYS:
            fail(f"http: /metrics lacks {missing} or /statz keys "
                 f"{sorted(statz)} are not the reference's")
        # (5) /debug/profile with a request decoding under it
        import threading

        busy = threading.Thread(target=_http, args=(
            srv.port, "POST", "/generate",
            {"tokens": trace[0][1], "max_new_tokens": SCHED_NEW,
             "stream": False}))
        busy.start()
        time.sleep(0.2)
        status, _, body = _http(srv.port, "GET", "/debug/profile?seconds=1")
        busy.join()
        prof = json.loads(body)
        kernels, cats = (_kernel_events(prof["trace"]) if status == 200
                         else (0, {}))
        if not kernels:
            fail(f"http: /debug/profile answered {status} {body[:200]!r} "
                 f"with no kernel event (events by category {cats})")
        # (6) prefill on this server, decode on a second one
        i = max((j for j, (_, _, k) in enumerate(trace) if not k),
                key=lambda j: len(trace[j][1]))
        eng_b = serving.ServingEngine(model, **kw)
        decode = srv_mod.EngineServer(eng_b, window=SCHED_WINDOW,
                                      max_new_tokens=SCHED_NEW,
                                      replica_role="decode")
        decode.warm_scheduler()
        decode.start(host="127.0.0.1", port=0)
        t0 = time.perf_counter()
        status, hdrs, payload = _http(srv.port, "POST", "/generate", {
            "tokens": trace[i][1], "max_new_tokens": SCHED_NEW,
            "prefill_only": True, "stream": False})
        prefill_ms = (time.perf_counter() - t0) * 1e3
        if status != 200 or hdrs.get("Content-Type") != \
                migrate.MIGRATE_CONTENT_TYPE:
            fail(f"http: prefill_only answered {status} {payload[:200]!r}")
        t0 = time.perf_counter()
        status, _, body = _http(
            decode.port, "POST", "/migrate", payload,
            {"Content-Type": migrate.MIGRATE_CONTENT_TYPE})
        migrate_ms = (time.perf_counter() - t0) * 1e3
        done = json.loads(body)
        mig = (srv.statz()["migrations"], decode.statz()["migrations"])
        if status != 200 or (done.get("tokens"), done.get(
                "finish_reason")) != streams[i] or \
                mig != ({"out": 1, "in": 0}, {"out": 0, "in": 1}):
            fail(f"http: /migrate of request {i} answered {status} "
                 f"{done} against {streams[i]}; migrations {mig}")
        shed = srv.statz()["shed"]
    finally:
        if decode is not None:
            decode.stop()
        srv.stop()
        shutil.rmtree(prof_dir, ignore_errors=True)
    del eng
    _fresh(torch)
    # (7) the load test of bench_serving --http
    prompt = bench_serving._random_prompts(
        model.vocab, ENGINE_SLOTS, HTTP_BENCH_PROMPT, 1, model.device)
    bench = bench_serving._http_throughput(
        model, prompt, SCHED_NEW, HTTP_CLIENTS, HTTP_BENCH_REQUESTS,
        slots=ENGINE_SLOTS)
    if bench["requests_completed"] != HTTP_BENCH_REQUESTS or \
            bench["requests_errored"]:
        fail(f"http: bench_serving --http completed "
             f"{bench['requests_completed']} of {HTTP_BENCH_REQUESTS}")
    wall_phase = time.perf_counter() - t_phase
    figures = dict(
        tokens_per_sec=tps, ratio=tps / overlap_arm["tokens_per_sec"],
        ttft_p50_ms=float(np.percentile(ttft, 50)),
        ttft_p99_ms=float(np.percentile(ttft, 99)),
        admit_p50_ms=float(np.percentile(admit, 50)),
        admit_p99_ms=float(np.percentile(admit, 99)),
        shed=shed, wall_s=wall_phase, bench=bench)
    print(f"http: {len(trace)} requests from {HTTP_CLIENTS} streaming "
          f"clients in {wall:.3f} s ({captured_s:.3f} s of it captures), "
          f"{tokens} tokens: {tps:.1f} tokens/s net of captures, "
          f"{figures['ratio']:.3f} of the scheduler phase's overlap arm "
          f"({overlap_arm['tokens_per_sec']:.1f}); client time to first "
          f"token p50 {figures['ttft_p50_ms']:.1f} ms, p99 "
          f"{figures['ttft_p99_ms']:.1f} ms; server admit-to-first-token "
          f"p50 {figures['admit_p50_ms']:.1f} ms, p99 "
          f"{figures['admit_p99_ms']:.1f} ms; 429s {shed}; warm-up "
          f"{warm_s:.2f} s; every request gave the scheduler phase's ids "
          f"and finish reason; {card}", flush=True)
    print(f"http: /v1/completions unary and SSE text agree with the ids; "
          f"/debug/profile held {kernels} CUDA kernel events; request {i} "
          f"prefilled on the mixed server in {prefill_ms:.1f} ms and "
          f"resumed through /migrate on the decode server in "
          f"{migrate_ms:.1f} ms with the scheduler phase's ids", flush=True)
    print(f"http: bench_serving --http ({HTTP_CLIENTS} clients, "
          f"{HTTP_BENCH_REQUESTS} requests, prompt {HTTP_BENCH_PROMPT}, "
          f"{SCHED_NEW} tokens): {bench['tokens_per_sec_http']:.1f} tokens/s "
          f"over HTTP against {bench['tokens_per_sec_engine']:.1f} in the "
          f"engine (ratio {bench['http_over_engine_ratio']:.3f}), time to "
          f"first token p50 {bench['ttft_ms_p50']:.1f} ms, p99 "
          f"{bench['ttft_ms_p99']:.1f} ms, {bench['req_per_sec']:.2f} req/s; "
          f"{card}", flush=True)
    print(f"http: phase wall {wall_phase:.1f} s; {card}", flush=True)
    return figures


def scheduler_path(torch, obs, inference, serving, scheduler, model, card):
    """Phase 4, the iteration scheduler on the engine phase's model: the
    captured admission extend (``admission_extends``); then sixteen
    requests (``scheduler_trace``) through ``IterationScheduler`` over a
    fresh ``ServingEngine(n_slots=8)`` in each of SCHED_ARMS, and over a
    paged engine (pages of 32) in the last arm.  Every arm gives the
    serial arm's ids and finish reasons; each arm's figures
    (``run_scheduled``) are printed.  Every check is fatal."""
    import numpy as np

    reqs = engine_requests(np, model.vocab)
    extends = admission_extends(torch, inference, serving, model, reqs,
                                card)
    trace = scheduler_trace(np, model.vocab, reqs)
    kw = dict(n_slots=ENGINE_SLOTS, logprobs_k=ENGINE_LOGPROBS, rng=0,
              max_new_tokens=SCHED_NEW, device=model.device)
    arms, base = {}, None
    for name, interleave, packed, overlap in SCHED_ARMS + (
            ("paged interleave+packed+overlap", True, True, True),):
        extra = (dict(kv_paging=True, kv_page_size=PAGE)
                 if name.startswith("paged") else {})
        eng = serving.ServingEngine(model, **kw, **extra)
        eng.warm_packed([SCHED_PACK])
        out, fig = run_scheduled(torch, np, obs, scheduler, eng, trace,
                                 interleave, packed, overlap)
        arms[name] = fig
        print(f"scheduler {name}: {len(trace)} requests in "
              f"{fig['wall_s']:.3f} s ({fig['capture_s']:.3f} s of it "
              f"decode-step captures), {fig['tokens']} tokens: "
              f"{fig['tokens_per_sec']:.1f} tokens/s net of captures; "
              f"admit-to-first-token p50 {fig['first_p50_ms']:.1f} ms, p99 "
              f"{fig['first_p99_ms']:.1f} ms; arrival-to-first-token p50 "
              f"{fig['ttft_p50_ms']:.1f} ms, p99 {fig['ttft_p99_ms']:.1f} ms; "
              f"a running request's longest "
              f"stall p50 {fig['stall_p50_ms']:.1f} ms, max "
              f"{fig['stall_max_ms']:.1f} ms; duty cycle {fig['duty']:.3f}; "
              f"{fig['overlap_windows']} overlap windows; packed extends "
              f"{fig['packed_prefill_extends']}, rows "
              f"{fig['packed_prefill_rows']}, pad tokens "
              f"{fig['packed_prefill_pad_tokens']}; APC hits "
              f"{fig['prefix_cache_hits']}, prefill tokens "
              f"{fig['prefill_tokens']}; {fig['iterations']} iterations; "
              f"{card}", flush=True)
        if base is None:
            base = out
        else:
            for i in range(len(trace)):
                if out[i] != base[i]:
                    fail(f"scheduler {name}: request {i} gave "
                         f"{out[i][0][:8]}... ({out[i][1]}) against the "
                         f"serial arm's {base[i][0][:8]}... "
                         f"({base[i][1]})")
        if packed and not fig["packed_prefill_extends"]:
            fail(f"scheduler {name}: no packed extend ran")
        if overlap and not fig["overlap_windows"]:
            fail(f"scheduler {name}: no window was dispatched ahead")
        for ids, reason in out.values():
            if not ids or not all(0 <= t < model.vocab for t in ids) or \
                    (reason == "length" and len(ids) != SCHED_NEW):
                fail(f"scheduler {name}: bad stream {ids[:8]}... "
                     f"({reason})")
        del eng
        _fresh(torch)
    print(f"scheduler: all {len(SCHED_ARMS) + 1} arms give the serial arm's "
          f"ids and finish reasons for all {len(trace)} requests", flush=True)
    return dict(arms=arms, extends=extends, trace=trace, streams=base)


class Counts:
    """Every kernel wrapper's launch count, by kernel name."""

    def __init__(self, **wrappers):
        self.wrappers = wrappers

    def zero(self) -> None:
        for w in self.wrappers.values():
            w.launches = 0
            for mode in getattr(w, "modes", {}):
                w.modes[mode] = 0

    def read(self) -> dict:
        return {n: w.launches for n, w in self.wrappers.items()}

    def modes(self) -> dict:
        """Launches by load mode, for the wrappers that count them."""
        return {n: dict(w.modes) for n, w in self.wrappers.items()
                if hasattr(w, "modes")}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bytes_bound_ms(*tensors) -> float:
    """Least time to read or write each tensor once at the HBM rate."""
    return nbytes(*tensors) / PEAK_BYTES * 1e3


def _timed_stage(torch, kernel, plain, library, iters=20):
    return (time_ms(torch, kernel, iters), time_ms(torch, plain, 3),
            time_ms(torch, library, iters))


def check_pool(torch, mp):
    """Phase 3: K1 and K2 bit-exact against their plain versions at the
    training path's three pool shapes (batch 1024, bf16) and at small f32
    and edge cases; kernel, plain and library (``F.max_pool2d`` and its
    backward) times summed over the three stages."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(2)
    cases = [(f"stage{i + 1}", (ALEX_BATCH, *pool_in), torch.bfloat16)
             for i, (pool_in, _, _) in enumerate(STAGES)]
    cases += [(f"f32-stage{i + 1}", (3, *pool_in), torch.float32)
              for i, (pool_in, _, _) in enumerate(STAGES)]
    totals = {"fwd": [0.0] * 4, "bwd": [0.0] * 4}
    max_err = {"fwd": 0.0, "bwd": 0.0}
    for name, shape, dtype in cases:
        x = torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
        modes = (dict(mp.max_pool_fwd_cuda.modes),
                 dict(mp.max_pool_bwd_cuda.modes))
        y, idx = mp.max_pool_fwd_cuda(x)
        dp = torch.randn(y.shape, generator=gen, device="cuda", dtype=dtype)
        dy = mp.max_pool_bwd_cuda(idx, dp, x.shape)
        torch.cuda.synchronize()
        py, pidx = mp.max_pool_fwd_plain(x)
        pdy = mp.max_pool_bwd_plain(pidx, dp, x.shape)
        same = (torch.equal(y, py), torch.equal(idx, pidx),
                torch.equal(dy, pdy))
        # the load mode of each launch: the stage shapes take the bulk
        # copies
        took = [next(m for m, n in w.modes.items() if n > before[m])
                for w, before in zip((mp.max_pool_fwd_cuda,
                                      mp.max_pool_bwd_cuda), modes)]
        plans = "; ".join(
            f"K{i + 1} {took[i]}, {w.plan['rows']} pooled rows a band, "
            f"{w.plan['channels']} channels a slice, "
            f"{w.plan['smem']} B shared, {w.plan['blocks']} blocks"
            for i, w in enumerate((mp.max_pool_fwd_cuda,
                                   mp.max_pool_bwd_cuda)))
        print(f"pool {name}: x {list(shape)} {str(dtype)[6:]} y/idx/dy "
              f"equal to the plain version: {same}; {plans}", flush=True)
        if not all(same):
            fail(f"pool kernels disagree with their plain versions "
                 f"({name})")
        if took != ["bulk", "bulk"]:
            fail(f"pool kernels at {name} took {took}, not the bulk "
                 f"copies")
        if dtype != torch.bfloat16:
            continue
        for key, got, want in (("fwd", y, py), ("bwd", dy, pdy)):
            err = float((got.float() - want.float()).abs().max())
            max_err[key] = max(max_err[key], err)
        xc = x.permute(0, 3, 1, 2)
        ly, lind = F.max_pool2d(xc, 3, 2, return_indices=True)
        dpc = dp.permute(0, 3, 1, 2)
        fwd = _timed_stage(
            torch, lambda: mp.max_pool_fwd_cuda(x),
            lambda: mp.max_pool_fwd_plain(x),
            lambda: F.max_pool2d(xc, 3, 2, return_indices=True))
        bwd = _timed_stage(
            torch, lambda: mp.max_pool_bwd_cuda(idx, dp, x.shape),
            lambda: mp.max_pool_bwd_plain(idx, dp, x.shape),
            lambda: torch.ops.aten.max_pool2d_with_indices_backward(
                dpc, xc, [3, 3], [2, 2], [0, 0], [1, 1], False, lind))
        for k, (key, t, bound) in enumerate((
                ("fwd", fwd, bytes_bound_ms(x, y, idx)),
                ("bwd", bwd, bytes_bound_ms(idx, dp, dy)))):
            totals[key] = [a + b for a, b in zip(totals[key], (*t, bound))]
            print(f"  K{k + 1} {name} ({took[k]}): "
                  f"kernel {t[0]:.4f} ms, plain {t[1]:.4f} ms, library "
                  f"{t[2]:.4f} ms, bound {bound:.4f} ms (bytes), "
                  f"{bound / t[0]:.2f} of the bound", flush=True)
        del ly, lind
    return {key: dict(max_abs_err=max_err[key], ms=v[0], kernel_ms=v[0],
                      plain_ms=v[1], library_ms=v[2], bound_ms=v[3],
                      bound_by="bytes")
            for key, v in totals.items()}


def _pool_decided(torch, conv, rel):
    """Where a pool window's best candidate beats the second by more than
    *rel* of its magnitude: there no accumulation order can change which
    offset wins."""
    win = conv.float().unfold(1, 3, 2).unfold(2, 3, 2).flatten(-2)
    top = win.topk(2, dim=-1).values
    return top[..., 0] - top[..., 1] > rel * top.abs().amax(-1)


def check_conv_pool(torch, cp):
    """Phase 3: K3 against its plain version at the training path's three
    stage shapes (batch 1024, bf16: values at 2e-2, the index where the
    plain version's best and second-best differ by more than two bf16
    units in the last place) and at small f32 shapes (1e-5; the index
    where they differ by more than 1e-4), and on small integer inputs,
    where every sum is exact, bit for bit; at batch 1024 a second launch
    gives the same bits; kernel, plain and library (``F.conv2d`` +
    ``F.max_pool2d``) times summed over the stages."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(3)
    cases = [(f"stage{i + 1}", (ALEX_BATCH, *conv_in), win, pool_in[2],
              torch.bfloat16) for i, (pool_in, conv_in, win)
             in enumerate(STAGES)]
    cases += [(f"{tag}-stage{i + 1}", (3, *conv_in), win, pool_in[2],
               dtype) for i, (pool_in, conv_in, win) in enumerate(STAGES)
              for tag, dtype in (("small", torch.bfloat16),
                                 ("f32", torch.float32))]
    # 128 features (one block of 128), and an odd size with few channels:
    # a 64-wide slice of the im2col matrix spans eight taps, and the
    # last slice is ragged (K = 200)
    cases += [(f"{tag}-f128", (3, 27, 27, 64), 3, 128, dtype)
              for tag, dtype in (("small", torch.bfloat16),
                                 ("f32", torch.float32))]
    cases += [(f"{tag}-odd", (3, 15, 15, 8), 5, 64, dtype)
              for tag, dtype in (("small", torch.bfloat16),
                                 ("f32", torch.float32))]
    totals, max_err = [0.0] * 4, 0.0
    bound_flops = bound_bytes = 0.0
    for name, shape, win, feat, dtype in cases:
        # integer inputs at the small batch only: there cuDNN's f32 conv,
        # which the plain version uses, sums them exactly (at batch 1024
        # it may pick a transform-based algorithm that rounds)
        for integer in (False, True) if shape[0] == 3 else (False,):
            if integer:
                x = torch.randint(-1, 2, shape, generator=gen,
                                  device="cuda").to(dtype)
                k = torch.randint(-1, 2, (win, win, shape[-1], feat),
                                  generator=gen, device="cuda").to(dtype)
            else:
                x = torch.randn(shape, generator=gen, device="cuda",
                                dtype=dtype)
                k = (torch.randn((win, win, shape[-1], feat), generator=gen,
                                 device="cuda")
                     * (win * win * shape[-1]) ** -0.5).to(dtype)
            y, idx = cp.conv_pool_cuda(x, k)
            torch.cuda.synchronize()
            py, pidx = cp.conv_pool_plain(x, k)
            if integer:
                if not (torch.equal(y, py) and torch.equal(idx, pidx)):
                    fail(f"conv+pool kernel not exact on integers ({name})")
                print(f"conv_pool {name}: exact on integer inputs",
                      flush=True)
                continue
            conv = cp._conv(x.float(), k.float()).to(dtype)
            bf16 = dtype == torch.bfloat16
            decided = _pool_decided(torch, conv, 2 ** -6 if bf16 else 1e-4)
            del conv
            err = (y.float() - py.float()).abs()
            tol = 2e-2 if bf16 else 1e-5
            bad = int((err > tol + tol * py.float().abs()).sum())
            idx_bad = int((idx[decided] != pidx[decided]).sum())
            print(f"conv_pool {name}: x {list(shape)} k {list(k.shape)} "
                  f"{str(dtype)[6:]} max_abs_err={float(err.max()):.3e} "
                  f"(atol {tol}, rtol {tol}) mismatches={bad}; index "
                  f"checked at {float(decided.float().mean()):.4f} of "
                  f"outputs, mismatches={idx_bad}", flush=True)
            if bad or idx_bad or decided.float().mean() < 0.8 or \
                    not torch.isfinite(y).all():
                fail(f"conv+pool kernel disagrees with its plain version "
                     f"({name})")
            if shape[0] != ALEX_BATCH:
                continue
            again = cp.conv_pool_cuda(x, k)
            if not (torch.equal(y, again[0]) and torch.equal(idx, again[1])):
                fail(f"two launches of the conv+pool kernel differ ({name})")
            del again
            max_err = max(max_err, float(err.max()))
            xc = x.permute(0, 3, 1, 2)
            wc = k.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            t = _timed_stage(
                torch, lambda: cp.conv_pool_cuda(x, k),
                lambda: cp.conv_pool_plain(x, k),
                lambda: F.max_pool2d(F.conv2d(xc, wc, padding=win // 2),
                                     3, 2, return_indices=True))
            # the conv values the pool reads: rows and columns up to
            # 2 * OH and 2 * OW
            oh, ow = y.shape[1], y.shape[2]
            flops = 2 * shape[0] * (2 * oh + 1) * (2 * ow + 1) * feat \
                * win * win * shape[-1]
            moved = nbytes(x, k, y, idx)
            bound = max(flops / PEAK_BF16, moved / PEAK_BYTES) * 1e3
            bound_flops += flops
            bound_bytes += moved
            totals = [a + b for a, b in zip(totals, (*t, bound))]
            print(f"  K3 {name}: kernel {t[0]:.4f} ms, plain {t[1]:.4f} ms,"
                  f" library {t[2]:.4f} ms, bound {bound:.4f} ms "
                  f"({flops:.3e} FLOPs, {moved:.3e} bytes)", flush=True)
    bound_by = "operations" if bound_flops / PEAK_BF16 >= \
        bound_bytes / PEAK_BYTES else "bytes"
    return dict(max_abs_err=max_err, ms=totals[0], kernel_ms=totals[0],
                plain_ms=totals[1], library_ms=totals[2],
                bound_ms=totals[3], bound_by=bound_by)


# the launches one training step must make under each pool
ALEX_LAUNCHES = {
    "xla": {},
    "pallas": {"maxpool_fwd": 3, "maxpool_bwd": 3},
    "fused": {"conv_pool_fwd": 3, "maxpool_bwd": 3},
}


def training_path(torch, counts, alexnet, bench_main):
    """Phase 5: AlexNet training at full width through the port, under
    each pool; returns the launches of each pool's counted step, by
    kernel, and the pool kernels' launches by load mode."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    images, labels = alexnet.synthetic_batch(gen, ALEX_BATCH, s2d=True)
    launches, load_modes, losses = {}, {}, {}
    for pool, expected in ALEX_LAUNCHES.items():
        model, opt = alexnet.create_train_state(seed=0, s2d=True, pool=pool,
                                                device="cuda")
        counts.zero()
        loss = alexnet.train_step(model, opt, images, labels)
        torch.cuda.synchronize()
        got = counts.read()
        modes = counts.modes()
        print(f"alexnet {pool}: first step loss {float(loss):.6f}; "
              f"launches {got}; pool launches by load mode {modes}",
              flush=True)
        if got != {n: expected.get(n, 0) for n in got}:
            fail(f"pool={pool}: launches {got}, expected {expected}")
        if any(m["cooperative"] for m in modes.values()):
            fail(f"pool={pool}: a pool kernel took the cooperative loads")
        if not torch.isfinite(loss):
            fail(f"pool={pool}: non-finite loss")
        losses[pool] = float(loss)
        launches[pool] = got
        load_modes[pool] = modes
        if pool != "xla":
            profile_region(torch, f"alexnet {pool} step", lambda: (
                alexnet.train_step(model, opt, images, labels)))
        del model, opt
    # pallas differs from xla only in the pool op, whose forward is exact;
    # fused adds the bias after the pool and rounds its own conv to bf16
    for pool, rel in (("pallas", 1e-3), ("fused", 2e-2)):
        diff = abs(losses[pool] - losses["xla"]) / abs(losses["xla"])
        print(f"alexnet {pool} vs xla first-step loss: relative "
              f"difference {diff:.3e} (limit {rel})", flush=True)
        if diff > rel:
            fail(f"pool={pool} first-step loss disagrees with xla")
    peak = bench_main.peak_flops(torch.device("cuda"))
    for pool in ALEX_LAUNCHES:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ips, flops = bench_main.run_single(
            ALEX_BATCH, ALEX_STEPS, ALEX_WARMUP, want_flops=True, pool=pool,
            device="cuda")
        mfu = ips * flops / ALEX_BATCH / peak if peak else None
        print(f"alexnet {pool}: batch {ALEX_BATCH}, {ALEX_STEPS} steps: "
              f"{ips:.1f} images/s, {flops / ALEX_BATCH:.4e} FLOPs per "
              f"image, MFU {mfu}; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB",
              flush=True)
    return launches, load_modes


def lm_flops_per_step(cfg, seq: int) -> float:
    """Analytic FLOPs of one training step on one sequence: 6 per matmul
    parameter per token (the embedding is a gather and counts nothing),
    and 12 * D per visible (query, key) pair per head per layer for the
    attention (forward 4 * D, backward 8 * D; the backward's recomputed
    S is not counted)."""
    d, f, kv = cfg.d_model, cfg.d_ff, cfg.n_kv_heads * cfg.head_dim
    per_layer = d * (d + 2 * kv) + d * d + 3 * d * f
    matmul = cfg.n_layers * per_layer + d * cfg.vocab
    pairs = seq * (seq + 1) // 2
    return (6 * matmul * seq
            + 12 * cfg.head_dim * pairs * cfg.n_heads * cfg.n_layers)


def _loss_and_grads(transformer, model, batch):
    model.zero_grad(set_to_none=True)
    loss = transformer.lm_loss(model, *batch)
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.item(), grads


def lm_training_path(torch, counts, fa, llama, transformer, bench_serving):
    """Phase 6: Llama-3-8B LM training at full width, 4 layers, through the
    port; returns the launches of the counted step, by kernel."""
    cfg = dataclasses.replace(llama.LLAMA3_8B, n_layers=LM_LAYERS)
    t0 = time.perf_counter()
    model = llama.train_model(cfg, attn_fn=fa.flash_causal_attention,
                              device="cuda")
    bench_serving.random_init_(model, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"llama3-8b training: {cfg.n_layers} of 32 layers at full width, "
          f"{n_params / 1e9:.3f}B f32 parameters, bf16 compute, random "
          f"weights built in {time.perf_counter() - t0:.1f} s", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(5)

    # flash against einsum attention on the initial weights, at a length
    # where the einsum's [T, T] scores fit
    check = transformer.synthetic_lm_batch(gen, 1, LM_CHECK_SEQ, cfg.vocab)
    blocks = [getattr(model, f"block_{i}") for i in range(cfg.n_layers)]
    flash_loss, flash_grads = _loss_and_grads(transformer, model, check)
    for b in blocks:
        b.attn_fn = transformer.local_causal_attention
    ein_loss, ein_grads = _loss_and_grads(transformer, model, check)
    for b in blocks:
        b.attn_fn = fa.flash_causal_attention
    loss_rel = abs(flash_loss - ein_loss) / abs(ein_loss)
    grad_rel = {n: float((flash_grads[n] - g).norm() / g.norm().clamp(
        min=1e-30)) for n, g in ein_grads.items()}
    worst = max(grad_rel, key=grad_rel.get)
    print(f"llama3-8b training, {LM_CHECK_SEQ} tokens: first-step loss "
          f"flash {flash_loss:.6f}, einsum {ein_loss:.6f} (relative "
          f"difference {loss_rel:.3e}, limit 1e-2); gradients: largest "
          f"|g_flash - g_einsum| / |g_einsum| {grad_rel[worst]:.3e} at "
          f"{worst} (limit 5e-2), median "
          f"{sorted(grad_rel.values())[len(grad_rel) // 2]:.3e}",
          flush=True)
    if not (loss_rel <= 1e-2 and all(r <= 5e-2 for r in grad_rel.values())
            and math.isfinite(flash_loss)):  # a NaN fails every comparison
        fail("flash LM disagrees with the einsum LM")
    del flash_grads, ein_grads, check
    torch.cuda.empty_cache()

    tokens, labels, positions = transformer.synthetic_lm_batch(
        gen, 1, LM_SEQ, cfg.vocab)
    opt = torch.optim.Adam(model.parameters(), lr=LM_LR, betas=(0.9, 0.999),
                           eps=1e-8)

    def step():
        return transformer.lm_train_step(model, opt, tokens, labels,
                                         positions)

    torch.cuda.reset_peak_memory_stats()
    counts.zero()
    loss = step()
    torch.cuda.synchronize()
    got = counts.read()
    expect = {"flash_attn_fwd": cfg.n_layers, "flash_attn_dq": cfg.n_layers,
              "flash_attn_dkv": cfg.n_layers}
    print(f"lm_train_step: 1 x {LM_SEQ} tokens, loss {float(loss):.6f}; "
          f"launches {got}", flush=True)
    if got != {n: expect.get(n, 0) for n in got}:
        fail(f"LM training step launches {got}, expected {expect}")
    losses = [float(loss)] + [float(step()) for _ in range(5)]
    print(f"losses over 6 steps on one batch: "
          f"{[round(x, 6) for x in losses]}", flush=True)
    if not losses[-1] < losses[0]:
        fail("LM training loss did not fall over 5 steps")

    later = [step() for _ in range(LM_WARMUP)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    later += [step() for _ in range(LM_STEPS)]
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / LM_STEPS
    flops = lm_flops_per_step(cfg, LM_SEQ)
    print(f"llama3-8b training ({cfg.n_layers} layers, 1 x {LM_SEQ} "
          f"tokens): {LM_SEQ / step_s:.1f} tokens/s, {step_s * 1e3:.3f} ms "
          f"per step over {LM_STEPS} steps after {LM_WARMUP} warmup, "
          f"{flops:.4e} FLOPs per step, MFU {flops / step_s / PEAK_BF16:.4f}"
          f"; peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} "
          f"GiB", flush=True)
    profile_region(torch, "llama train step", lambda: later.append(step()))
    losses += torch.stack(later).tolist()
    if not all(map(math.isfinite, losses)):
        fail(f"non-finite LM training loss in {losses}")
    del model, opt
    torch.cuda.empty_cache()
    return got


# the fleet phase: replicas of the port's server CLI on the card at the HTTP
# phase's settings (Llama-3-8B at full width and depth, bf16, random weights
# from seed 0, 8 slots, max_len 2048, windows of 8) behind the port's router
FLEET_CONFIG = "llama3-8b"
FLEET_ARGS = ("--window", str(SCHED_WINDOW))
# run_router: 8 clients, 16 requests over 4 distinct 128-token prompts;
# run_disagg: 4 clients, 8 requests (512-token unary prefills and
# 32-token streams); the replay: a trafficgen trace of 32 requests
ROUTER_CLIENTS, ROUTER_REQUESTS, ROUTER_PROMPT = 8, 16, 128
DISAGG_CLIENTS, DISAGG_REQUESTS = 4, 8
REPLAY_REQUESTS = 32
# the fleet episode: the reference's ramp cut from 16 calm, 72 peak and
# 20 tail requests to 4, 12 and 40 (a peak that still fills the floor
# replica's 8 slots and queues, a demand scale-up; a tail of light
# requests to 25.7 s), and its two chaos hooks, each of which waits for two
# routable replicas, placed so that they never wait together: the degraded
# reshape at the peak's first request (it fires when the scaled-out
# replica is ready, about 17 s in) and the SIGKILL at 23 s of trace time
# (it waits through the rolling drain that the reshape starts, and lands
# on two fresh replicas after the trace is served: no stream to tear);
# scale-in after 60 s of calm (the reference's 2 s would drain a ready
# replica while others boot); the settle bound (the loop leaves as soon
# as the fleet is back at its floor)
EPISODE_RAMP = dict(calm_requests=4, peak_requests=12, tail_requests=40,
                    calm_rate=2.0, peak_rate=10.0)
EPISODE_KILL_AT_MS, EPISODE_DOWN_STABLE_S = 23000.0, 60.0
EPISODE_SETTLE_S = 240.0


def _replica_logs(log_dir: str):
    """{log file name: its text}, for the replicas spawned so far."""
    out = {}
    for name in sorted(os.listdir(log_dir)):
        with open(os.path.join(log_dir, name), errors="replace") as f:
            out[name] = f.read()
    return out


def _migrate_seconds(obs, port):
    """(sum, count) of the router's ``tpu_router_migrate_seconds``."""
    _, _, body = _http(port, "GET", "/metrics")
    body = body.decode()
    return (_metric(obs, body, "tpu_router_migrate_seconds_sum"),
            _metric(obs, body, "tpu_router_migrate_seconds_count"))


def fleet_router(bench_serving, loadclient, sched, card):
    """``run_router`` with two replicas and the kill; before the kill,
    the scheduler phase's sixteen requests through the router's
    ``/generate``, each giving the scheduler phase's ids and finish
    reason."""
    trace, streams = sched["trace"], sched["streams"]
    served = {}

    def before_kill(port):
        out, res, wall = serve_trace(loadclient, port, trace, HTTP_CLIENTS)
        for i in range(len(trace)):
            if res[i].outcome != "ok" or out[i] != streams[i]:
                fail(f"fleet router: request {i} gave {out[i][0]} "
                     f"({out[i][1]}, {res[i].outcome}: {res[i].error}) "
                     f"against the scheduler phase's {streams[i][0]} "
                     f"({streams[i][1]})")
        served.update(wall=wall, tokens=sum(
            len(ids) for ids, _ in out.values()))

    st = bench_serving.run_router(
        FLEET_CONFIG, False, 2, clients=ROUTER_CLIENTS,
        n_requests=ROUTER_REQUESTS, slots=ENGINE_SLOTS, steps=SCHED_NEW,
        prompt_len=ROUTER_PROMPT, max_len=MAX_LEN, kill=True, seed=0,
        extra_args=FLEET_ARGS, before_kill=before_kill)
    if not served:
        fail("fleet router: the scheduler phase's requests never ran")
    if st["kill_errors"] or st["kill_ok"] + st["kill_429"] != \
            st["kill_requests"]:
        fail(f"fleet router: {st['kill_errors']:.0f} non-429 errors of "
             f"{st['kill_requests']:.0f} requests after the kill")
    shares = ", ".join(f"{k[6:]} {v:.3f}" for k, v in st.items()
                       if k.startswith("share_"))
    print(f"fleet router: 1 replica {st['tokens_per_sec_router_1']:.1f} "
          f"tokens/s, 2 replicas {st['tokens_per_sec_router_n']:.1f} "
          f"tokens/s ({ROUTER_CLIENTS} clients, {ROUTER_REQUESTS} requests "
          f"of {ROUTER_PROMPT}-token prompts, {SCHED_NEW} tokens); "
          f"scaling_x {st['scaling_x']:.3f} (both replicas share this one "
          f"card); shares {shares}; affinity hit rate "
          f"{st['affinity_hit_rate']:.3f}; /fleet/statz capacity "
          f"{st['fleet_capacity']:.0f}; after the kill "
          f"{st['kill_requests']:.0f} requests, kill_errors "
          f"{st['kill_errors']:.0f}, 429s {st['kill_429']:.0f}, failovers "
          f"{st['failovers_total']:.0f}, recovered in "
          f"{st['kill_recovery_s']:.3f} s; replica boot (spawn to ready) "
          f"{st['replica_boot_s_1']:.1f} s alone, "
          f"{st['replica_boot_s_n']:.1f} s beside a serving one; {card}",
          flush=True)
    print(f"fleet router: the scheduler phase's {len(trace)} requests "
          f"through the router in {served['wall']:.3f} s "
          f"({served['tokens']} tokens) gave its ids and finish reasons",
          flush=True)


def fleet_disagg(bench_serving, obs, cfg, sched, card):
    """``run_disagg``'s homogeneous and prefill+decode arms; in the
    second, the scheduler phase's longest greedy prompt through the
    pair, migrated across processes, gives the scheduler phase's ids."""
    trace, streams = sched["trace"], sched["streams"]
    i = max((j for j, (_, _, k) in enumerate(trace) if not k),
            key=lambda j: len(trace[j][1]))
    moved = {}

    def on_arm(arm, port):
        if arm != "disagg":
            return
        before = _migrate_seconds(obs, port)
        t0 = time.perf_counter()
        status, hdrs, body = _http(port, "POST", "/generate", {
            "tokens": trace[i][1], "max_new_tokens": SCHED_NEW,
            "stream": False})
        wall_ms = (time.perf_counter() - t0) * 1e3
        after = _migrate_seconds(obs, port)
        done = json.loads(body) if status == 200 else {}
        if status != 200 or (done.get("tokens"), done.get(
                "finish_reason")) != streams[i] or \
                after[1] != before[1] + 1 or \
                hdrs.get("X-Replica") != "replica-1":
            fail(f"fleet disagg: request {i} answered {status} by "
                 f"{hdrs.get('X-Replica')} with {done.get('tokens')} against "
                 f"{streams[i]}; migrations {before[1]:.0f} -> "
                 f"{after[1]:.0f}")
        moved.update(wall_ms=wall_ms,
                     ship_ms=(after[0] - before[0]) * 1e3)

    st = bench_serving.run_disagg(
        FLEET_CONFIG, False, clients=DISAGG_CLIENTS,
        n_requests=DISAGG_REQUESTS, slots=ENGINE_SLOTS, steps=SCHED_NEW,
        prompt_len=ROUTER_PROMPT, max_len=MAX_LEN, seed=0,
        extra_args=FLEET_ARGS, on_arm=on_arm)
    if not moved:
        fail("fleet disagg: the longest prompt never went through the pair")
    kv_mb = (len(trace[i][1]) * cfg.n_layers * 2 * cfg.n_kv_heads
             * cfg.head_dim * 2) / 1e6
    print(f"fleet disagg: decode TTFT p99 homogeneous "
          f"{st['decode_ttft_p99_ms_homog']:.1f} ms, prefill+decode "
          f"{st['decode_ttft_p99_ms_disagg']:.1f} ms (ratio "
          f"{st['ttft_p99_ratio']:.3f}); decode TPOT p99 "
          f"{st['decode_tpot_p99_ms_homog']:.2f} / "
          f"{st['decode_tpot_p99_ms_disagg']:.2f} ms (ratio "
          f"{st['tpot_p99_ratio']:.3f}); long unary p99 "
          f"{st['long_unary_p99_ms_homog']:.1f} / "
          f"{st['long_unary_p99_ms_disagg']:.1f} ms; migrations "
          f"{st['migrations_ok']:.0f} (mean ship "
          f"{st.get('migrate_mean_ms', float('nan')):.1f} ms); both arms' "
          f"prefill and decode share this one card's SMs; pair boot "
          f"{st['replicas_boot_s_homog']:.1f} / "
          f"{st['replicas_boot_s_disagg']:.1f} s; {card}", flush=True)
    print(f"fleet disagg: the longest greedy prompt (request {i}, "
          f"{len(trace[i][1])} tokens, {kv_mb:.1f} MB of bf16 KV) prefilled "
          f"on the prefill replica and migrated to the decode replica gave "
          f"the scheduler phase's ids: {moved['wall_ms']:.1f} ms end to end, "
          f"{moved['ship_ms']:.1f} ms from the payload read to /migrate's "
          f"answer", flush=True)


def fleet_replay(obs, replay, trafficgen, vocab: int, card):
    """A seeded trafficgen trace replayed open loop through
    ``replay.run_fleet`` (an in-process router, two replicas); the report
    parses with its schema and no request fails outside a 429."""
    import argparse

    tcfg = trafficgen.TraceConfig(
        n_requests=REPLAY_REQUESTS, base_rate_rps=4.0, burst_rate_rps=12.0,
        p_enter_burst=0.2, p_exit_burst=0.3, prefix_chunk=32,
        n_prefixes=4, max_prefix_chunks=4, prompt_median=128.0,
        prompt_max=512, output_median=16.0, output_max=SCHED_NEW,
        vocab=vocab, unary_frac=0.25, slow_reader_frac=0.0,
        abandon_frac=0.0)
    header, requests = trafficgen.loads_trace(trafficgen.dumps_trace(
        tcfg, 0, trafficgen.generate(tcfg, 0)))
    policies = obs.default_slo_policies()
    metrics = replay.ReplayMetrics(obs.Registry(), policies)
    args = argparse.Namespace(
        replicas=2, config=FLEET_CONFIG, device=None, slots=ENGINE_SLOTS,
        max_len=MAX_LEN, max_new_tokens=SCHED_NEW, prefix_chunk=32,
        seed=0, session_tier=False, kill_replica_at_ms=None, slo=None,
        time_scale=1.0, late_ms=100.0, timeout_s=300.0, top_missed=3,
        tenant_quota=None, server_extra_args=FLEET_ARGS)
    t0 = time.perf_counter()
    report = json.loads(json.dumps(replay.run_fleet(
        args, requests, policies, metrics, header)))
    wall = time.perf_counter() - t0
    failed = {k: v for k, v in report.get("outcomes", {}).items()
              if k not in ("ok", "shed") and v}
    if report.get("schema") != replay.REPORT_SCHEMA or failed or \
            sum(report["outcomes"].values()) != len(requests):
        bad = [(r["rid"], r["status"], r["error"])
               for r in report.get("requests", [])
               if r["outcome"] not in ("ok", "shed")]
        fail(f"fleet replay: report schema {report.get('schema')}, "
             f"outcomes {report.get('outcomes')}; failed {bad[:4]}")
    goodput = (report.get("fleet_statz") or {}).get("fleet", {}).get(
        "goodput", {})
    rows = []
    for name, c in sorted(report["classes"].items()):
        ttft = c["ttft_ms"]
        rows.append(
            f"{name}: attainment {c['attainment']} ({c['met']} of "
            f"{c['eligible']}), goodput "
            f"{goodput.get(name, {}).get('goodput_rps', float('nan')):.3f} "
            f"req/s, " + (f"TTFT p50 {ttft['p50']} ms, p99 {ttft['p99']} ms"
                          if ttft["p50"] is not None else "unary (no TTFT)"))
    print(f"fleet replay: {len(requests)} trafficgen requests (seed 0) open "
          f"loop through a router and 2 replicas in {wall:.1f} s (boots "
          f"included), outcomes {report['outcomes']}, late dispatches "
          f"{report['open_loop']['late_dispatches']}; "
          + "; ".join(rows) + f"; {card}", flush=True)


def fleet_episode(fleet, work: str, card):
    """One ``fleet.run_episode`` (floor 1, ceiling 2) on the cut ramp,
    with ``--assert-fleet``'s structural checks (not the goodput
    floors): scaled out past the floor on demand, scaled back to it,
    the killed replica replaced, the degraded slice drained and
    re-registered, zero malformed frames."""
    import argparse
    import contextlib
    import io

    _, ramp = fleet.build_ramp_trace(0, **EPISODE_RAMP, prefix_chunk=16)
    degrade_at_ms = ramp[EPISODE_RAMP["calm_requests"]].t_ms
    if not degrade_at_ms < EPISODE_KILL_AT_MS < ramp[-1].t_ms:
        fail(f"fleet episode: the kill at {EPISODE_KILL_AT_MS} ms is not "
             f"inside the ramp ({degrade_at_ms}-{ramp[-1].t_ms} ms)")
    args = argparse.Namespace(
        mode="episode", seed=0, max_replicas=2, **EPISODE_RAMP,
        high_watermark=1.0, low_watermark=0.25, up_stable_s=0.5,
        down_stable_s=EPISODE_DOWN_STABLE_S, cooldown_s=2.0,
        drain_timeout_s=30.0, kill_at_ms=EPISODE_KILL_AT_MS,
        degrade_at_ms=degrade_at_ms, no_kill=False,
        no_degrade=False, capacity_spec="", workdir=work, time_scale=1.0,
        late_ms=100.0, timeout_s=300.0, settle_s=EPISODE_SETTLE_S,
        top_missed=3, report=None, metrics_out=None, assert_goodput=None,
        assert_fleet=True, fault_spec=None, incident_dir=None,
        config=FLEET_CONFIG, slots=ENGINE_SLOTS, max_len=MAX_LEN,
        max_new_tokens=128, prefix_chunk=16, slo=None,
        compile_cache_dir="", device=None, server_extra_args=FLEET_ARGS)
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        report, rc = fleet.run_episode(args)
    wall = time.perf_counter() - t0
    gate = [line for line in buf.getvalue().splitlines()
            if line.startswith("fleet gate ok")]
    f, c = report["fleet"], report["chaos"]
    attain = {n: v["attainment"] for n, v in report["classes"].items()}
    n = sum(EPISODE_RAMP[k] for k in ("calm_requests", "peak_requests",
                                      "tail_requests"))
    print(f"fleet episode: {n} requests in {wall:.1f} s: max replicas "
          f"{f['max_replicas_observed']}, spawned {f['replicas_spawned']}, "
          f"stopped {f['replicas_stopped']}, scale-ups "
          f"{f['scale_up_events']:.0f} ({f['demand_scale_up_events']} on "
          f"demand), scale-downs {f['scale_down_events']:.0f}, final "
          f"{f['final_replicas']}; killed {c['killed_replica']}, replaced "
          f"{f['replaced_after_kill']}; degraded drained "
          f"{f['degraded_drained']}, respawned on generation 2 "
          f"{f['respawned_on_new_generation']}; frame errors "
          f"{c['frame_errors']}, error responses {c['error_responses']}; "
          f"outcomes {report['outcomes']}; attainment {attain} (a "
          f"measurement on one shared card, not gated); "
          f"{f['reconcile_cycles']} reconcile cycles; {card}", flush=True)
    for line in gate:
        print(f"  {line}", flush=True)
    if rc:
        for e in f["journal"]:
            print(f"  journal: {e['name']} {e['attrs']}", flush=True)
        fail("fleet episode: --assert-fleet failed (see the FLEET GATE FAIL "
             "lines above)")


def fleet_cold_start(bench_serving, card):
    """``run_cold_start`` once: two boots of one replica, each timed to
    its first completion; printed, not gated (the port keeps no compile
    cache, so both boots do the same work)."""
    st = bench_serving.run_cold_start(
        FLEET_CONFIG, False, slots=ENGINE_SLOTS, steps=SCHED_NEW,
        prompt_len=ROUTER_PROMPT, max_len=MAX_LEN, extra_args=FLEET_ARGS)
    print(f"fleet cold start: cold ready {st['cold_ready_s']:.2f} s, first "
          f"completion {st['cold_first_completion_s']:.2f} s; warm ready "
          f"{st['warm_ready_s']:.2f} s, first completion "
          f"{st['warm_first_completion_s']:.2f} s; warm_speedup_x "
          f"{st['warm_speedup_x']:.3f} (warm_faster "
          f"{st['warm_faster']:.0f}; no compile cache: both boots import, "
          f"build the weights and capture their graphs); {card}",
          flush=True)


def fleet_path(torch, cfg, sched, card):
    """Phase 7, the fleet tier on the card: replicas of the port's server
    CLI (``FLEET_CONFIG`` at full width and depth, seed 0, 8 slots,
    ``max_len`` 2048, windows of 8), spawned by the port's own helpers
    behind the port's router: ``run_router`` with two replicas and the
    kill (the scheduler phase's requests through the router before the
    kill), ``run_disagg`` (the longest greedy prompt migrated across
    processes), a trafficgen trace through ``replay.run_fleet``, one
    ``fleet.run_episode`` under ``--assert-fleet``, and
    ``run_cold_start``.  Each replica's output goes to a file under a
    temporary directory; when the phase fails, their tails are printed.
    Every check is fatal."""
    import shutil
    import tempfile

    from tpu_k8s_device_plugin_torch import obs
    from tpu_k8s_device_plugin_torch.workloads import (
        bench_serving, fleet, loadclient, replay, trafficgen)

    t_phase = time.perf_counter()
    log_dir = tempfile.mkdtemp(prefix="chip_smoke_replicas_")
    work = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    os.environ[loadclient.REPLICA_LOG_DIR_ENV] = log_dir
    free, total = torch.cuda.mem_get_info()
    print(f"fleet: device memory free {free / 2**30:.1f} of "
          f"{total / 2**30:.1f} GiB before the first replica (this "
          f"process holds {torch.cuda.memory_reserved() / 2**30:.2f} GiB)",
          flush=True)
    try:
        fleet_router(bench_serving, loadclient, sched, card)
        fleet_disagg(bench_serving, obs, cfg, sched, card)
        fleet_replay(obs, replay, trafficgen, cfg.vocab, card)
        fleet_episode(fleet, work, card)
        fleet_cold_start(bench_serving, card)
    except BaseException:
        for name, text in _replica_logs(log_dir).items():
            tail = "\n    ".join(text.splitlines()[-15:])
            print(f"fleet: replica log {name}:\n    {tail}", flush=True)
        raise
    finally:
        del os.environ[loadclient.REPLICA_LOG_DIR_ENV]
        logs = _replica_logs(log_dir)
        shutil.rmtree(log_dir, ignore_errors=True)
        shutil.rmtree(work, ignore_errors=True)
    warm = []
    for name, text in logs.items():
        m = re.search(r"warmup ([0-9.]+)s", text)
        warm.append(f"{name.rsplit('-', 1)[0]} "
                    f"{m.group(1) + ' s' if m else 'none (not ready)'}")
    print(f"fleet: {len(logs)} replicas spawned; warm_scheduler's captures "
          f"by replica: {', '.join(warm)}", flush=True)
    print(f"fleet: phase wall {time.perf_counter() - t_phase:.1f} s; {card}",
          flush=True)


def main() -> int:
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tpu_k8s_device_plugin_torch import build, obs
    from tpu_k8s_device_plugin_torch.workloads import (
        alexnet, bench_main, bench_serving, grammar, inference, llama,
        scheduler, serving, transformer)
    from tpu_k8s_device_plugin_torch.workloads import convpool as cp
    from tpu_k8s_device_plugin_torch.workloads import flash_attention as fa
    from tpu_k8s_device_plugin_torch.workloads import pool as mp
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
            if any(w in line for w in ("registers", "spill", "wgmma")):
                print(f"  {name}: {line.strip()}", flush=True)
    for library, names, instruction in BUILD_CHECKS:
        check_build(build, library, names, instruction)

    counts = Counts(flash_attn_fwd=fa.flash_attention_cuda,
                    flash_attn_dq=fa.flash_attention_dq_cuda,
                    flash_attn_dkv=fa.flash_attention_dkv_cuda,
                    maxpool_fwd=mp.max_pool_fwd_cuda,
                    maxpool_bwd=mp.max_pool_bwd_cuda,
                    conv_pool_fwd=cp.conv_pool_cuda)
    flash = check_flash(torch, fa)
    flash_train = check_flash_training(torch, fa)
    pool = check_pool(torch, mp)
    conv_pool = check_conv_pool(torch, cp)
    launches, _, engine = main_path(torch, counts, inference, llama,
                                    bench_serving, serving, grammar, obs,
                                    scheduler, card)
    torch.cuda.empty_cache()
    train, train_modes = training_path(torch, counts, alexnet, bench_main)
    torch.cuda.empty_cache()
    lm = lm_training_path(torch, counts, fa, llama, transformer,
                          bench_serving)
    torch.cuda.empty_cache()
    fleet_path(torch, llama.LLAMA3_8B, engine["scheduler"], card)

    csrc = "tpu_k8s_device_plugin_torch/csrc/"
    ref = "tpu_k8s_device_plugin/workloads/"
    kernels = [
        dict(name="flash_attn_fwd", route="cuda",
             source=csrc + "flash_attn_fwd.cu",
             replaces=ref + "flash_attention.py:101",
             launches=launches, **flash,
             note="launches and times: greedy_generate's prefill, without "
                  "the lse write; under lse_mode, the same for one "
                  "lm_train_step, whose forward writes the lse",
             lse_mode=dict(launches=lm["flash_attn_fwd"],
                           **flash_train["lse"])),
        dict(name="flash_attn_dq", route="cuda",
             source=csrc + "flash_attn_bwd.cu",
             replaces=ref + "flash_attention.py:208",
             launches=lm["flash_attn_dq"], **flash_train["dq"],
             note="plain_ms is the plain backward (dQ, dK and dV) at the "
                  "head slice; library_ms is sdpa's whole backward, the "
                  "yardstick for K5 and K6 together"),
        dict(name="flash_attn_dkv", route="cuda",
             source=csrc + "flash_attn_bwd.cu",
             replaces=ref + "flash_attention.py:254",
             launches=lm["flash_attn_dkv"], **flash_train["dkv"],
             note="plain_ms is the plain backward (dQ, dK and dV) at the "
                  "head slice; library_ms is sdpa's whole backward, the "
                  "yardstick for K5 and K6 together"),
        dict(name="maxpool_fwd", route="cuda", source=csrc + "maxpool.cu",
             replaces=ref + "pool.py:150",
             launches=train["pallas"]["maxpool_fwd"], **pool["fwd"],
             load_modes=train_modes["pallas"]["maxpool_fwd"]),
        dict(name="maxpool_bwd", route="cuda", source=csrc + "maxpool.cu",
             replaces=ref + "pool.py:169",
             launches=train["pallas"]["maxpool_bwd"], **pool["bwd"],
             note="launches: the pool=pallas step; the pool=fused step's "
                  "are under launches_fused",
             launches_fused=train["fused"]["maxpool_bwd"],
             load_modes=train_modes["pallas"]["maxpool_bwd"],
             load_modes_fused=train_modes["fused"]["maxpool_bwd"]),
        dict(name="conv_pool_fwd", route="cuda",
             source=csrc + "conv_pool_fwd.cu",
             replaces=ref + "convpool.py:83",
             launches=train["fused"]["conv_pool_fwd"], **conv_pool),
    ]
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
