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
3. the device plugin, before any kernel is checked or any model is on
   the card, in a process of its own (``--worker device-plugin``), as
   the agents run on a node, so that none of its servers, threads or
   sockets outlives it (the threads of this process before and after
   it, and the child's before the agents and after their teardown, which
   must leave none): what the machine exposes of its GPUs (the
   nvidia-bound PCI functions in sysfs, ``/proc/driver/nvidia/gpus``, the ``/dev/nvidia*``
   nodes, whether NVML loads, ``nvidia-smi``'s view); the port's
   discovery on the real roots, matched to torch's device 0 by PCI bus
   id (or as the only GPU where this machine hides the bus id), its UUID
   torch's where it is exposed, its memory within 1% of torch's, its
   name and its spec-table SM count torch's; the gpuprobe shim, built
   with the host compiler, finding ``/dev/nvidia<minor>`` a char device
   of major 195; the ``PluginManager`` behind a stub kubelet made from
   the port's proto (registration, ListAndWatch's first frame Healthy
   with the NUMA node, GetPreferredAllocation, Allocate's nodes and
   ``NVIDIA_VISIBLE_DEVICES``); Allocate p50/p99 us, measured as
   ``bench.py`` measures it, for 1 GPU on this host and 4 of 8 on the
   ``h100-sxm-8`` fixture; the health server reporting the card Healthy,
   a ListAndWatch frame Unhealthy within two pulses of arming
   ``probe:hang:1`` and Healthy within two of disarming it; every label,
   product-name, memory, device-id and driver-version held to torch,
   NVML and sysfs where they expose them; a child process given the
   Allocate env and ``CUDA_VISIBLE_DEVICES`` as the container runtime
   sets it: one device, torch's UUID, K4 on a small prefill within 3e-2
   of its plain version; the phase's wall time;
4. hold each kernel against its plain PyTorch version on the card, at
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
   fit), on the same slice of the checkpointing phase's LM resume call
   (q [1, 4096, 8, 64], K/V [1, 4096, 2, 64]) and edge shapes (among
   them T 1024 with GQA 4:1, and D 96, which
   the bf16 kernels pad to 128), timed at the full call (q [1, 8192, 32,
   128], K/V [1, 8192, 8, 128]) against ``scaled_dot_product_attention``'s
   forward and backward; K5 and K6 in their f32 output mode (ring
   attention's partials) against their plain versions at that head slice
   and an edge shape, the bf16 mode's result equal to the f32 mode's
   rounded, bit for bit, and both modes timed at the full call; the
   block forms (``flash_block_forward``, ``flash_block_grads``) at the
   ring's zig-zag tile (q [1, 2048, 32, 128], K/V [1, 1024, 32, 128]);
   K1/K2 (max-pool forward/backward, bit-exact,
   each stage in the bulk-copy mode, its bands and grid printed) and K3
   (fused conv+pool) at AlexNet's three stage shapes, batch 1024, bf16,
   K3 also at 128 features and at an odd size with 8 channels;
4b. multi-device, in children (``--worker md-rank``): four ranks on one
   gloo group on this card (NCCL refuses two ranks on one GPU), the
   kernels built by this process first: ring attention at Llama-3-8B's
   attention on the LM call's sequence (q [1, 8192, 32, 128], K/V 8
   heads, repeated to 32 for the flash impl, causal, 2048 tokens a
   rank), every impl and layout, its gathered output and gradients held
   by blocks of 64 rows against the single-device flash attention (K4;
   K4 with its lse, K5, K6) at the reference tests' bf16 bars, each
   rank's launches counted (contiguous flash: r + 1 blocks on rank r;
   zig-zag: 6); the data x model AlexNet on a (2, 2) mesh at the
   training path's size (global batch 1024, ``pool="pallas"``), 3 steps
   whose losses and every gathered parameter are held against the
   single-device step's, K1 and K2 three times a step on each rank; the
   LM mesh (``make_lm_train_step``, one step from seed 0): Llama-3-8B's
   widths, 1 layer, on (data 1, expert 1, seq 2, model 2) with the
   zig-zag ring at batch 1 x 4096, and Mixtral-8x7B's widths, 1 layer, on
   (data 1, expert 2, seq 1, model 2) at batch 2 x 4096 (each rank's
   expert stacks [4, 4096, 7168]), each in bf16 compute (the loss within
   2e-2 of the single-device ``lm_train_step``'s, run alone on the card
   first) and in f32 compute (the loss, and the gathered updates and
   gradients of qkv, out_proj, the down projection and lm_head within
   5e-2 in relative norm); GPipe (``make_pipeline``): 8 Llama-3-8B
   blocks with flash attention over 4 pipe stages, 4 microbatches of
   [1, 2048, 4096] bf16, forward and backward against the blocks run one
   after another on rank 0 (forward within 1e-5, bit-equality printed;
   gradients within 1e-4), K4, K5 and K6 counted on each stage; and
   beside them two NCCL ranks at world size 1 under torchrun's env,
   ``bench_main --sharded`` and ``make_lm_train_step`` on a (1, 1, 1, 1)
   mesh at the reference tests' tiny config (its loss sums real NCCL
   calls, the loss falling over 3 steps);
5. the generation path: Llama-3-8B at full width and depth, bf16, random
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
6. the training path: AlexNet at full width (224 px, 1000 classes, s2d,
   bf16 compute, f32 parameters from a seed), batch 1024, one
   ``train_step`` under each ``pool`` with the launch counts zeroed just
   before and read just after (``pallas``: K1 and K2 three times each;
   ``fused``: K3 and K2 three times each; every K1 and K2 launch in the
   bulk-copy mode), the first-step losses held
   against ``xla``'s; images/sec and MFU of ``bench_main.run_single``
   (3 warmup, 10 steps) per ``pool``; a profile of one ``pallas`` and
   one ``fused`` step by kernel;
7. the LM training path: Llama-3-8B at full width and 4 of its 32
   layers, bf16 compute, f32 parameters from seed 0, the flash kernels
   as attention, ``torch.optim.Adam(3e-4)``, one sequence of 8192
   tokens from ``synthetic_lm_batch``: the same model with the einsum
   attention at 1024 tokens (first-step loss within 1e-2, every
   gradient within 5e-2 in relative norm); one ``lm_train_step`` with
   the launch counts zeroed just before and read just after (K4, K5 and
   K6 four times each); the loss finite and lower after 5 steps on the
   same batch; tokens/s and MFU over 5 steps after 2 warmup, the peak
   memory, and a profile of one step by kernel;
8. the rest of the model, with no other model resident: Llama-3-8B's
   widths at 8 of its 32 layers with int8 and with int4 projections
   (``random_quantized_params``, seed 0; the int4 unpack on the card
   against the CPU's for every byte):
   ``greedy_generate`` at the main path's shapes with K4 once a layer,
   the captured decode against the op-by-op loop, prefill ms, decode
   tokens/s and the bytes a step must read beside the bf16 figures, and
   ``bench_serving --engine``'s tokens/s; speculative decoding, the
   Llama-3-8B target with Llama-3.2-1B as its draft (gamma 4):
   ``speculative_generate`` on the main path's first prompt with that
   draft and with the target as its own, against ``greedy_generate``,
   the scheduler phase's sixteen requests through ``IterationScheduler``
   over a draft engine and an n-gram engine against that phase's ids,
   and ``bench_serving --spec``'s figures; in bf16 a divergence passes
   only at a near tie of the plain path (its two logits within 4 bf16
   ulps: a verify of gamma + 1 rows rounds otherwise than a step), then
   both models in f32 at 4 layers each, where ``speculative_generate``'s
   ids must equal
   ``greedy_generate``'s and the target as its own draft must accept
   every proposal; LoRA (4 adapters of rank 8, B stacks from a seed):
   the engine phase's requests with no adapter give its ids, finish
   reasons and logprobs, and with the adapters and the base mixed over 8
   slots one captured window gives each request its run alone in the
   same engine shape; MoE at Mixtral-8x7B's widths (GELU experts, up and
   down): 2-layer training (one 8192-token sequence, capacity 2560:
   K4 with its lse, K5 and K6 twice each in one ``lm_train_step``, the
   loss falling over 5 steps, tokens/s, MFU against
   ``moe_flops_per_step``, peak memory and the f32 combine's share of
   the step) and 4-layer bf16 serving (``greedy_generate`` at batch 4 in
   the gather branch with K4 once a layer and its captured decode
   against the op-by-op loop; an 8-slot engine in the dense branch whose
   captured window gives the op-by-op steps' ids);
9. the fleet tier, after the LM training path has released its model:
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
   giving its ids; a seeded ``trafficgen`` trace of 16 requests replayed
   open loop through ``replay.run_fleet`` (two replicas), its report
   parsing with its schema and no request failing outside a 429;
   one ``fleet.run_episode`` (floor 1, ceiling 2, a cut ramp) whose
   ``--assert-fleet`` checks pass; ``run_cold_start`` (cold and warm
   boot times, printed, not gated); the replicas' capture times and the
   phase's wall time;
10. checkpointing, with no other model resident, under a temporary
   directory whose free bytes are printed first (each checkpoint deleted
   once checked; too little room fails): a save and a restore of
   AlexNet's stepped state timed (GB/s); the elastic AlexNet loop at the
   training phase's size (pool ``pallas``, 6 steps, a save every 2)
   through ``bench_main``'s CLI in subprocesses: run 1 SIGKILLed once
   step_4 is committed, run 2 with the membership file moved to
   generation 2 resumes from 4, exits 77 after step 5 and leaves
   step_5, run 3 under generation 2 resumes from 5 and leaves [4, 5, 6],
   whose step_6 equals an uninterrupted run's (in this process, K1 and
   K2 counted) bit for bit, under deterministic cuDNN algorithms; the
   elastic loop's images/s against ``run_single``'s; the LM resume
   (Llama-3.2-1B at full width, 2 of 16 layers, one 4096-token
   sequence, Adam): a worker takes 2 steps, saves and SIGKILLs itself, a
   fresh one restores and takes 3 more, whose losses equal this
   process's uninterrupted 5 (K4 with its lse, K5, K6 counted) bit for
   bit, save and restore GB/s printed; Llama-3.2-1B at full width and
   depth saved in f32 and served by the server CLI with ``--checkpoint``
   (bf16, ``--quantized``, ``--int4``, the three booting side by side),
   each answering the scheduler phase's greedy requests with the ids of
   an in-process engine over the same weights loaded without a
   checkpoint, each boot's restore seconds printed;
11. chaos, in a child (``--worker chaos``): the chaos soak's episodes
   5 (a ``serve.step`` crash), 6 (a ``serve.schedule`` hang past the
   schedule watchdog), 9 (a tenant burst under KV page pressure) and 11
   (a kill in a packed prefill) on an ``EngineServer`` over Llama-3-8B
   at full width, bf16, 4 of 32 layers, captured steps; 5 and 6 restart
   three times on one server, and after each restart a greedy control
   request gives the baseline's ids bit for bit, replays a captured
   step, ``torch.cuda.synchronize()`` raises nothing and
   ``memory_allocated`` does not grow from the previous restart;
   episode 17 (a spilled session through a SIGKILL) on server CLI
   replicas of Llama-3.2-1B at full width and depth, whose respawned
   replica's next turn equals the control replica's; one line an
   episode (restart ms, ids, replays, memory delta);
12. print the ``kernels`` JSON line, then the result line.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
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
    kernels' band ring is dynamic shared memory, printed by phase 4)."""
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
                             + re.findall(r"L[ib](\d+)E", n)) or "?"
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
    """Phase 4: the flash kernel against its plain version: every entry
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
    """Phase 4: K4 with its lse, K5 and K6 against their plain versions on
    the LM training call's head slice, the checkpointing phase's LM resume
    head slice (head dim 64, 4096 tokens) and edge shapes (the plain
    forward's lse and delta feed both backward versions, so each kernel is
    held alone); then the kernels' times at the full call against their
    bounds and ``scaled_dot_product_attention``, and the plain versions'
    at the slice."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(4)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # name, q shape, Tk, KV heads, dtype, causal
        ("slice", ATTN_SLICE[0], LM_SEQ, ATTN_SLICE[1], bf16, True),
        ("ckpt-lm", ATTN_CKPT_SLICE[0], CKPT_LM_SEQ, ATTN_CKPT_SLICE[1],
         bf16, True),
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


# the ring phase's zig-zag tile: a rank's whole query (2 chunks of the
# LM call's 8192 tokens over 4 ranks) against its early K/V chunk, with
# the flash impl's equal head counts
ZZ_TILE = ((1, 2048, 32, 128), 1024, 32)


def check_flash_f32_modes(torch, fa, library_bwd_ms):
    """Phase 4: the f32 output mode of the bf16 K5 and K6 (ring
    attention's partials) against the plain versions on the training
    call's head slice and an edge shape (Tq != Tk, D 48), the bf16 mode's
    result equal to the f32 mode's rounded to bf16 bit for bit; the block
    forms at the ring's zig-zag tile (Tq = 2 Tk, not causal); both
    modes timed at the full call."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    bf16, f32 = torch.bfloat16, torch.float32
    err = {}
    for name, qs, tk, hkv, causal in (
            ("slice", ATTN_SLICE[0], LM_SEQ, ATTN_SLICE[1], True),
            ("cross", (1, 100, 4, 48), 150, 4, False)):
        q, k, v, do = _attention_inputs(torch, gen, qs, tk, hkv, bf16)
        po, plse = fa.flash_attention_fwd_plain(q, k, v, causal)
        delta = fa.attention_delta(do, po)
        got = (fa.flash_attention_dq_cuda(q, k, v, do, plse, delta, causal,
                                          out_dtype=f32),
               *fa.flash_attention_dkv_cuda(q, k, v, do, plse, delta, causal,
                                            out_dtype=f32))
        rounded = (fa.flash_attention_dq_cuda(q, k, v, do, plse, delta,
                                              causal),
                   *fa.flash_attention_dkv_cuda(q, k, v, do, plse, delta,
                                                causal))
        torch.cuda.synchronize()
        want = fa.flash_attention_bwd_plain(q, k, v, do, plse, delta, causal)
        held = {n: _held(torch, g, w, GRAD_TOL["bfloat16"],
                         BLOCK_REL["bfloat16"])
                for n, g, w in zip(("dq", "dk", "dv"), got, want)}
        same = [torch.equal(r, g.to(bf16)) for r, g in zip(rounded, got)]
        print(f"flash f32 mode {name}: q {list(qs)} kv "
              f"{[qs[0], tk, hkv, qs[3]]} bf16 in, f32 out, causal={causal} "
              + ", ".join(_held_line(n, r) for n, r in held.items())
              + f"; the bf16 mode equals the f32 mode rounded, bit for bit: "
              f"{same} (gradients {GRAD_TOL['bfloat16']} x (block rms + "
              f"|want|); block bar {BLOCK_REL['bfloat16']})", flush=True)
        if any(g.dtype != f32 for g in got) or not all(same) or any(
                r["mismatches"] for r in held.values()):
            fail(f"K5 or K6 in f32 mode disagrees ({name})")
        if name == "slice":
            err = {"dq": (held["dq"]["max_abs_err"], held["dq"]["block_rel"]),
                   "dkv": (max(held["dk"]["max_abs_err"],
                               held["dv"]["max_abs_err"]),
                           max(held["dk"]["block_rel"],
                               held["dv"]["block_rel"]))}
            plain_ms = time_ms(torch, lambda: fa.flash_attention_bwd_plain(
                q, k, v, do, plse, delta, True), 2, warmup=1)
        del q, k, v, do, po, plse, delta, got, rounded, want
        torch.cuda.empty_cache()

    # the block forms at the zig-zag tile: K4 with its lse as [B, T, H],
    # K5/K6 writing f32 from the global lse and delta
    qs, tk, hkv = ZZ_TILE
    q, k, v, do = _attention_inputs(torch, gen, qs, tk, hkv, bf16)
    o, lse = fa.flash_block_forward(q, k, v, causal=False)
    po, plse = fa.flash_attention_fwd_plain(q, k, v, False)
    delta = fa.attention_delta(do, po)
    grads = fa.flash_block_grads(q, k, v, do, plse.transpose(1, 2),
                                 delta.transpose(1, 2), causal=False)
    torch.cuda.synchronize()
    want = fa.flash_attention_bwd_plain(q, k, v, do, plse, delta, False)
    lse_err, lse_bad = _mismatches(torch, lse, plse.transpose(1, 2), 1e-4,
                                   1e-5)
    held = {"o": _held_forward(torch, fa, o, po, q, k, v, False),
            **{n: _held(torch, g, w, GRAD_TOL["bfloat16"],
                        BLOCK_REL["bfloat16"])
               for n, g, w in zip(("dq", "dk", "dv"), grads, want)}}
    print(f"flash block forms at the zig-zag tile: q {list(qs)} kv "
          f"{[qs[0], tk, hkv, qs[3]]} bf16, not causal: lse [B, T, H] "
          f"max_abs_err={lse_err:.3e} mismatches={lse_bad}, "
          + ", ".join(_forward_line(r) if n == "o" else _held_line(n, r)
                      for n, r in held.items())
          + f"; gradients {[str(g.dtype) for g in grads]}", flush=True)
    if lse_bad or _forward_failed(held["o"]) or any(
            g.dtype != f32 for g in grads) or any(
            r["mismatches"] for n, r in held.items() if n != "o"):
        fail("the flash block forms disagree with their plain versions")
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    tile_ms = (time_ms(torch, lambda: fa.flash_block_forward(q, k, v), 20),
               time_ms(torch, lambda: fa.flash_attention_fwd_plain(
                   q, k, v, False), 3),
               time_ms(torch, lambda: F.scaled_dot_product_attention(
                   qt, kt, vt), 20))
    bound, by = attention_bound_ms(q, k, False, 4, q, k, v, o, lse)
    print(f"flash_block_forward at the zig-zag tile: kernel {tile_ms[0]:.4f}"
          f" ms, plain {tile_ms[1]:.4f} ms, library (sdpa forward) "
          f"{tile_ms[2]:.4f} ms, bound {bound:.4f} ms ({by})", flush=True)
    del q, k, v, do, o, lse, po, plse, delta, grads, want, qt, kt, vt
    torch.cuda.empty_cache()

    # both modes at the full call of the training path
    q, k, v, do = _attention_inputs(torch, gen, ATTN_FULL[0], LM_SEQ,
                                    ATTN_FULL[1], bf16)
    o, lse = fa.flash_attention_cuda(q, k, v, True, return_lse=True)
    delta = fa.attention_delta(do, o)
    out = {}
    for key, fn, per_pair in (
            ("dq", lambda dt: fa.flash_attention_dq_cuda(
                q, k, v, do, lse, delta, True, out_dtype=dt), 6),
            ("dkv", lambda dt: fa.flash_attention_dkv_cuda(
                q, k, v, do, lse, delta, True, out_dtype=dt), 8)):
        ms = {str(dt).split(".")[-1]: time_ms(torch, lambda: fn(dt), 10)
              for dt in (bf16, f32, bf16, f32)}
        res = fn(f32)
        res = res if isinstance(res, tuple) else (res,)
        bound, by = attention_bound_ms(q, k, True, per_pair, q, k, v, do,
                                       lse, delta, *res)
        print(f"{'K5 dQ' if key == 'dq' else 'K6 dK/dV'} at q "
              f"{list(ATTN_FULL[0])}: bf16 out {ms['bfloat16']:.4f} ms, f32 "
              f"out {ms['float32']:.4f} ms (bound of the f32 mode "
              f"{bound:.4f} ms, {by}; the second of two turns each)",
              flush=True)
        out[key] = dict(max_abs_err=err[key][0],
                        max_block_rel_err=err[key][1], ms=ms["float32"],
                        bf16_mode_ms=ms["bfloat16"], plain_ms=plain_ms,
                        bound_ms=bound, bound_by=by,
                        library_ms=library_bwd_ms)
    return out


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
    """Phase 5: Llama-3-8B greedy generation through the port, then the
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
    # the servers' engines can sit in reference cycles: collect them now,
    # not whenever the collector next reaches its oldest generation
    _fresh(torch)

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
    """Phase 5, the engine: the same eight admissions on two
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
    """Phase 5, the paged engine: ``ServingEngine(kv_paging=True)`` on
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
        with sched.in_phase("stream"):
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
                    out[live.pop(s)] = (eng.output(s),
                                        eng.finish_reason(s))
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
    """Phase 5, the HTTP front door on the engine phase's model: an
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
    """Phase 5, the iteration scheduler on the engine phase's model: the
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
    """Phase 4: K1 and K2 bit-exact against their plain versions at the
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
    """Phase 4: K3 against its plain version at the training path's three
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
    """Phase 6: AlexNet training at full width through the port, under
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
        modes = {n: m for n, m in counts.modes().items()
                 if n.startswith("maxpool")}
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
    """Phase 7: Llama-3-8B LM training at full width, 4 layers, through the
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
# 32-token streams); the replay: a trafficgen trace of 16 requests
ROUTER_CLIENTS, ROUTER_REQUESTS, ROUTER_PROMPT = 8, 16, 128
DISAGG_CLIENTS, DISAGG_REQUESTS = 4, 8
REPLAY_REQUESTS = 16
# the fleet episode: the reference's ramp cut from 16 calm, 72 peak and
# 20 tail requests to 4, 12 and 40 (a peak that still fills the floor
# replica's 8 slots and queues, a demand scale-up; a tail of light
# requests to 25.7 s), and its two chaos hooks, each of which waits for two
# routable replicas, placed so that they never wait together: the degraded
# reshape at the peak's first request (it fires when the scaled-out
# replica is ready, about 17 s in) and the SIGKILL at 23 s of trace time
# (it waits through the rolling drain that the reshape starts, which
# keeps the second stale replica in rotation until the first one's
# replacement serves, and lands on a replica of the new generation after
# the trace is served: no stream to tear); scale-in after 30 s of calm
# (the reference's 2 s would drain a ready replica while others boot; a
# replica boots in 11-15 s; cut from 60 s, then 45, to pay for the
# multi-device and chaos phases); the settle bound (the loop leaves as soon as the
# fleet is back at its floor and no chaos hook is still waiting)
EPISODE_RAMP = dict(calm_requests=4, peak_requests=12, tail_requests=40,
                    calm_rate=2.0, peak_rate=10.0)
EPISODE_KILL_AT_MS, EPISODE_DOWN_STABLE_S = 23000.0, 30.0
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
    buf, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
        report, rc = fleet.run_episode(args)
    wall = time.perf_counter() - t0
    sys.stderr.write(err.getvalue())
    failed = [line for line in err.getvalue().splitlines()
              if line.startswith("FLEET GATE FAIL")]
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
        fail(f"fleet episode: --assert-fleet failed: {'; '.join(failed)}; "
             f"killed {c['killed_replica']}, journal "
             + ", ".join(f"{e['attrs'].get('action') or e['name'][10:]} "
                         f"{e['attrs'].get('replica') or ''}"
                         f"({e['attrs'].get('reason', '')})"
                         for e in f["journal"]))


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
    """Phase 9, the fleet tier on the card: replicas of the port's server
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


# the rest of the model (int8/int4 weights, speculative decoding, LoRA
# adapters, expert FFNs): the quantized Llama-3-8B at the main path's
# shapes; gamma 4 with Llama-3.2-1B as the draft; 4 adapters of rank 8
# whose B stacks are normal with sd 0.05 from a seed; Mixtral-8x7B's
# widths (mistralai/Mixtral-8x7B-v0.1: d_model 4096, 32 / 8 heads, d_ff
# 14336, 8 experts, top-2, vocab 32000, rope theta 1e6) with the
# reference's GELU expert FFN (up and down: two of Mixtral's three
# expert matrices), cut to 2 layers for training (f32 parameters and
# Adam take 16 bytes a parameter) and 4 for serving, capacity factor
# 1.25; a divergence between two paths of other shapes passes only at a
# near tie: the plain path's logits of the two tokens within
# NEAR_TIE_ULPS bf16 ulps of the larger
QUANT_KINDS = (("int8", True), ("int4", "int4"))
# depth cuts, to pay for phase 4b's LM mesh and pipeline (PR 17: 32 to
# 8) and its tensor-parallel serving (PR 18: 8 to 4): the int8 and int4
# models at 4 of Llama-3-8B's 32 layers (full width), and the f32
# speculative exactness check's target and draft at 4 layers each
QUANT_LAYERS, SPEC_F32_LAYERS = 4, 4
SPEC_GAMMA, SPEC_DRAFT = 4, "llama3-1b"
LORA_ADAPTERS, LORA_RANK, LORA_B_SD = 4, 8, 0.05
LORA_SLOT_ADAPTERS = (0, 1, 2, 3, None, 0, 1, 2)
MIXTRAL = dict(vocab=32000, d_model=4096, n_heads=32, n_kv_heads=8,
               d_ff=14336, n_experts=8, moe_k=2, moe_capacity_factor=1.25,
               ffn="gelu", rope_theta=1e6)
MOE_TRAIN_LAYERS, MOE_SERVE_LAYERS, MOE_WARMUP, MOE_STEPS = 2, 2, 1, 3
MOE_ENGINE_STEPS = 16
NEAR_TIE_ULPS = 4


def weight_bytes(model) -> int:
    """Bytes of every parameter but the embedding (a decode step reads
    B of its rows): what one decode step must read of the weights."""
    return sum(p.numel() * p.element_size()
               for n, p in model.named_parameters() if n != "embed.weight")


def kv_bytes(cfg, batch: int, depth: int) -> int:
    """Bytes of a bf16 KV cache of *depth* rows a sequence."""
    return 2 * cfg.n_layers * batch * depth * cfg.n_kv_heads * \
        cfg.head_dim * 2


def first_divergence(torch, inference, model, prompt, want, got, what):
    """Equal ids, or a first divergence at a near tie of the plain path:
    the logits of the two tokens after ``prompt + want[:p]`` (the flash
    prefill) within NEAR_TIE_ULPS bf16 ulps of the larger.  Prints and
    returns the divergence index (None when equal); anything else
    fails."""
    if list(got) == list(want):
        return None
    n = min(len(got), len(want))
    p = next((i for i in range(n) if got[i] != want[i]), n)
    if p == n:
        fail(f"{what}: {len(got)} ids against {len(want)}")
    ids = torch.tensor([list(prompt) + list(want[:p])], device="cuda")
    pos = torch.arange(ids.shape[1], dtype=torch.int32,
                       device="cuda")[None, :]
    row = inference._prefill(model, ids, pos)[0][0, -1]
    a, b = float(row[want[p]]), float(row[got[p]])
    top = max(abs(a), abs(b), 1e-30)
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
    gap = abs(a - b)
    print(f"{what}: ids equal up to token {p}, then {want[p]} against "
          f"{got[p]}: the plain path's logits {a:.5f} and {b:.5f}, gap "
          f"{gap:.5f} = {gap / ulp:.2f} bf16 ulps (near-tie bar "
          f"{NEAR_TIE_ULPS})", flush=True)
    if gap > NEAR_TIE_ULPS * ulp:
        fail(f"{what}: diverged at token {p} where the plain path's "
             f"choice is no near tie")
    return p


def quant_path(torch, counts, inference, bench_serving, bf16, card):
    """Phase 8a: Llama-3-8B's widths with int8 and with int4 projections,
    QUANT_LAYERS of its 32 layers, weights from
    ``random_quantized_params`` (seed 0), as ``build_model_and_params``
    builds them: ``greedy_generate`` at the main path's shapes (K4 once a
    layer in the prefill; the captured decode gives the op-by-op loop's
    ids), prefill ms, decode tokens/s and the bytes a step must read
    beside the bf16 figures (32 layers), and ``bench_serving
    --engine``'s tokens/s at 8 prompts of 128."""
    out = {}
    llama = bench_serving.llama
    full = bench_serving.CONFIGS["llama3-8b"]
    cfg = dataclasses.replace(full, n_layers=QUANT_LAYERS)
    prompt = torch.randint(0, cfg.vocab, (BATCH, PROMPT),
                           generator=torch.Generator().manual_seed(1))
    prompt = prompt.to("cuda")
    depth = PROMPT + NEW_TOKENS // 2
    kv = kv_bytes(cfg, BATCH, depth)
    bf16_bytes = (full.n_params() - full.vocab * full.d_model) * 2 + \
        kv_bytes(full, BATCH, depth)
    # the int4 unpack shifts int8 on the card as on the CPU: every byte
    every = torch.arange(-128, 128, dtype=torch.int8).reshape(16, 16)
    if not torch.equal(inference.unpack_int4(every.cuda()).cpu(),
                       inference.unpack_int4(every)):
        fail("unpack_int4 on the card differs from the CPU's")
    for kind, flag in QUANT_KINDS:
        t0 = time.perf_counter()
        model = llama.decoder(cfg, max_len=MAX_LEN, quantized=flag,
                              device="cuda")
        model.load_state_dict(llama.random_quantized_params(
            cfg, seed=0, bits=4 if flag == "int4" else 8,
            device=model.device))
        torch.cuda.synchronize()
        wbytes = weight_bytes(model)
        print(f"llama3-8b {kind}, {cfg.n_layers} of {full.n_layers} layers: "
              f"weights built in "
              f"{time.perf_counter() - t0:.1f} s, {wbytes / 1e9:.3f} GB of "
              f"projections and scales, "
              f"{model.embed.weight.numel() * 2 / 1e9:.3f} GB of bf16 "
              f"embedding; device memory "
              f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB", flush=True)
        counts.zero()
        toks, logits = inference.greedy_generate(model, prompt, NEW_TOKENS)
        torch.cuda.synchronize()
        got = counts.read()
        print(f"{kind} greedy_generate: launches {got}", flush=True)
        if got != {n: (cfg.n_layers if n == "flash_attn_fwd" else 0)
                   for n in got}:
            fail(f"{kind} prefill launches {got}, expected K4 "
                 f"{cfg.n_layers} times")
        if not torch.isfinite(logits).all() or \
                not torch.equal(toks[:, 0].long(), logits[:, -1].argmax(-1)):
            fail(f"{kind}: non-finite logits or a first token that is not "
                 "their argmax")
        del logits
        graph_vs_eager_decode(torch, inference, model, prompt, toks)
        stats = inference.decode_throughput(model, prompt, NEW_TOKENS,
                                            rounds=3)
        step_ms = 1e3 * BATCH / stats["tokens_per_sec"]
        need = wbytes + kv
        print(f"llama3-8b {kind}, {cfg.n_layers} layers: prefill "
              f"{stats['prefill_ms']:.3f} ms (bf16 at {full.n_layers} "
              f"layers {bf16['prefill_ms']:.3f}); decode "
              f"{stats['tokens_per_sec']:.1f} tokens/s at batch {BATCH} "
              f"(bf16 {bf16['tokens_per_sec']:.1f}), {step_ms:.3f} ms a "
              f"step; a step must read {need / 1e9:.3f} GB (bf16 "
              f"{bf16_bytes / 1e9:.3f} GB): {need / step_ms / 1e6:.1f} GB/s"
              f", {need / PEAK_BYTES * 1e3:.3f} ms at the HBM rate; {card}",
              flush=True)
        eng_prompt = torch.randint(
            0, cfg.vocab, (ENGINE_SLOTS, ENGINE_BENCH_PROMPT),
            generator=torch.Generator().manual_seed(3))
        est = bench_serving._engine_throughput(model, eng_prompt.cuda(),
                                               ENGINE_STEPS)
        print(f"{kind}: bench_serving --engine --"
              f"{'int4' if flag == 'int4' else 'quantized'} "
              f"{est['tokens_per_sec']:.1f} tokens/s at {ENGINE_SLOTS} "
              f"slots (prompts of {ENGINE_BENCH_PROMPT}, windows of "
              f"{ENGINE_STEPS}, best of 3); {card}", flush=True)
        out[kind] = dict(launches=got["flash_attn_fwd"],
                         prefill_ms=stats["prefill_ms"],
                         tokens_per_sec=stats["tokens_per_sec"],
                         step_ms=step_ms, step_bytes=need,
                         engine_tokens_per_sec=est["tokens_per_sec"])
        del model, toks
        _fresh(torch)
    return out


def spec_path(torch, np, obs, inference, llama, bench_serving, serving,
              scheduler, speculative, engine, card):
    """Phase 8b: Llama-3-8B bf16 (the main path's weights) with
    Llama-3.2-1B bf16 as its draft: ``speculative_generate`` on the main
    path's first prompt, with that draft and with the target as its own,
    against ``greedy_generate`` (equal ids, or a first divergence at a
    near tie); the scheduler phase's sixteen requests through
    ``IterationScheduler`` over ``ServingEngine(n_slots=8, draft=...)``
    and with ``draft="ngram"`` (the scheduler phase's ids, or a near
    tie); ``bench_serving --spec``'s figures.  Then both models in f32,
    where a GEMM's shape moves no argmax: ``speculative_generate`` gives
    ``greedy_generate``'s ids exactly with either draft, and the target
    as its own draft accepts every proposal."""
    cfg, target = bench_serving.build_model_and_params(
        "llama3-8b", MAX_LEN, device="cuda", seed=0)
    dcfg, draft = bench_serving.build_model_and_params(
        SPEC_DRAFT, MAX_LEN, device="cuda", seed=1)
    print(f"speculative: target llama3-8b, draft {SPEC_DRAFT} "
          f"({dcfg.n_params() / 1e9:.2f}B parameters, "
          f"{weight_bytes(draft) / 1e9:.2f} GB bf16), gamma {SPEC_GAMMA}",
          flush=True)
    prompt = torch.randint(0, cfg.vocab, (BATCH, PROMPT),
                           generator=torch.Generator().manual_seed(1))[0]
    prompt = prompt.tolist()
    want = inference.greedy_generate(target, [prompt], NEW_TOKENS)[0]
    want = want[0].tolist()
    out = {}
    for name, d in ((SPEC_DRAFT, draft), ("self", target)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids, rate = speculative.speculative_generate(
            target, d, prompt, NEW_TOKENS, gamma=SPEC_GAMMA)
        wall = time.perf_counter() - t0
        ids = ids.tolist()
        print(f"speculative_generate (bf16, {name} draft): prompt "
              f"{PROMPT}, {NEW_TOKENS} tokens in {wall:.3f} s, accept rate "
              f"{rate:.4f}; {card}", flush=True)
        first_divergence(torch, inference, target, prompt, want, ids,
                         f"speculative_generate (bf16, {name} draft)")
        out[f"generate_{name}_s"] = wall
        out[f"accept_{name}"] = rate

    trace = engine["scheduler"]["trace"]
    base = engine["scheduler"]["streams"]
    kw = dict(n_slots=ENGINE_SLOTS, logprobs_k=ENGINE_LOGPROBS, rng=0,
              max_new_tokens=SCHED_NEW, device="cuda", gamma=SPEC_GAMMA)
    for name, d in ((SPEC_DRAFT, draft), ("ngram", "ngram")):
        eng = serving.ServingEngine(target, draft=d, **kw)
        eng.warm_packed([SCHED_PACK])
        streams, fig = run_scheduled(torch, np, obs, scheduler, eng, trace,
                                     True, True, True)
        st = eng.stats()
        print(f"scheduler + spec ({name}): {len(trace)} requests in "
              f"{fig['wall_s']:.3f} s, {fig['tokens']} tokens, "
              f"{fig['tokens_per_sec']:.1f} tokens/s net of captures "
              f"(the scheduler phase's overlap arm: "
              f"{engine['scheduler']['arms']['interleave+packed+overlap']['tokens_per_sec']:.1f}); "
              f"{st['spec_rounds']} spec rounds, accept rate "
              f"{eng.accept_rate:.4f}; {card}", flush=True)
        if not st["spec_rounds"]:
            fail(f"scheduler + spec ({name}): no spec round ran")
        diverged = 0
        for i, (_, p, knobs) in enumerate(trace):
            if streams[i][0] == base[i][0]:
                if streams[i][1] != base[i][1]:
                    fail(f"spec ({name}) request {i}: finish reason "
                         f"{streams[i][1]} against {base[i][1]}")
                continue
            if "temperature" in knobs or "logprobs" in knobs:
                # never in a spec round: their steps are the phase's
                fail(f"spec ({name}) request {i} ({knobs}) gave other ids "
                     "than the scheduler phase's")
            first_divergence(torch, inference, target, p, base[i][0],
                             streams[i][0], f"spec ({name}) request {i}")
            diverged += 1
        print(f"scheduler + spec ({name}): {len(trace) - diverged} of "
              f"{len(trace)} requests give the scheduler phase's ids "
              f"exactly", flush=True)
        out[f"sched_{name}_tokens_per_sec"] = fig["tokens_per_sec"]
        out[f"sched_{name}_accept"] = eng.accept_rate
        del eng
        _fresh(torch)

    bench_prompt = torch.randint(0, cfg.vocab,
                                 (ENGINE_SLOTS, ENGINE_BENCH_PROMPT),
                                 generator=torch.Generator().manual_seed(3))
    stats = bench_serving._spec_throughput(target, draft, bench_prompt.cuda(),
                                           SPEC_GAMMA, ENGINE_STEPS)
    stats.update(config="llama3-8b", draft=SPEC_DRAFT, quantized=False)
    print(f"bench_serving --spec {SPEC_GAMMA} (its _spec_throughput at "
          f"{ENGINE_SLOTS} prompts of {ENGINE_BENCH_PROMPT}); {card}",
          flush=True)
    print(json.dumps(stats), flush=True)
    out["bench"] = stats
    del target, draft
    _fresh(torch)

    # in f32 the logits carry no bf16 ties and the GEMMs of other shapes
    # agree far below any gap: the ids must be equal, and the target as
    # its own draft must accept every proposal
    dt = torch.float32
    target = llama.decoder(
        dataclasses.replace(cfg, n_layers=SPEC_F32_LAYERS), max_len=MAX_LEN,
        dtype=dt, device="cuda")
    bench_serving.random_init_(target, seed=0)
    draft = llama.decoder(
        dataclasses.replace(dcfg, n_layers=SPEC_F32_LAYERS),
        max_len=MAX_LEN, dtype=dt, device="cuda")
    bench_serving.random_init_(draft, seed=1)
    want = inference.greedy_generate(target, [prompt], NEW_TOKENS)[0]
    want = want[0].tolist()
    for name, d in ((SPEC_DRAFT, draft), ("self", target)):
        ids, rate = speculative.speculative_generate(
            target, d, prompt, NEW_TOKENS, gamma=SPEC_GAMMA)
        print(f"speculative_generate (f32, {SPEC_F32_LAYERS} layers each, "
              f"{name} draft): accept rate "
              f"{rate:.4f}, ids equal to greedy_generate's: "
              f"{ids.tolist() == want}; {card}", flush=True)
        if ids.tolist() != want:
            fail(f"f32 speculative_generate ({name} draft) gave other ids "
                 "than greedy_generate")
        out[f"accept_{name}_f32"] = rate
    if out["accept_self_f32"] != 1.0:
        fail(f"in f32 the target as its own draft accepted "
             f"{out['accept_self_f32']:.4f} of its proposals, not all")
    del target, draft
    _fresh(torch)
    return out


def lora_path(torch, np, inference, bench_serving, serving, engine, card):
    """Phase 8c: Llama-3-8B bf16 (the main path's base weights) with 4
    adapters of rank 8: the engine phase's eight requests over 8 slots
    with adapters 0-3 and the base mixed, one captured window, each
    request's ids those of its run alone in the same engine shape; with
    no adapter, the engine phase's ids, finish reasons and logprobs."""
    cfg = bench_serving.CONFIGS["llama3-8b"]
    model = inference.make_decoder(
        vocab=cfg.vocab, d_model=cfg.d_model, n_heads=cfg.n_heads,
        n_layers=cfg.n_layers, d_ff=cfg.d_ff, max_len=MAX_LEN,
        n_kv_heads=cfg.n_kv_heads, ffn="swiglu", rope_theta=cfg.rope_theta,
        n_adapters=LORA_ADAPTERS, lora_rank=LORA_RANK, device="cuda")
    bench_serving.random_init_(model, seed=0)
    gen = torch.Generator(device="cuda").manual_seed(7)
    for name, p in model.named_parameters():
        if name.endswith("_lora_B"):
            p.normal_(0.0, LORA_B_SD, generator=gen)
    reqs = engine_requests(np, model.vocab)
    kw = dict(n_slots=ENGINE_SLOTS, logprobs_k=ENGINE_LOGPROBS, rng=0,
              device="cuda")

    base = serving.ServingEngine(model, **kw)
    for p, knobs in reqs:
        base.admit(p, **knobs)
    base.run_scan(ENGINE_STEPS)
    for s in range(ENGINE_SLOTS):
        got = (base.output(s), base.finish_reason(s), base.token_logprobs(s))
        if got != engine["window"][s]:
            fail(f"lora, no adapter: slot {s} gave {got[0][:8]}... against "
                 f"the engine phase's {engine['window'][s][0][:8]}...")
    print(f"lora: with no adapter all {ENGINE_SLOTS} slots give the engine "
          f"phase's ids, finish reasons and logprobs", flush=True)
    del base
    _fresh(torch)

    mixed = serving.ServingEngine(model, **kw)
    for (p, knobs), a in zip(reqs, LORA_SLOT_ADAPTERS):
        mixed.admit(p, adapter=a, **knobs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mixed.run_scan(ENGINE_STEPS)
    window_ms = (time.perf_counter() - t0) * 1e3
    if mixed.graph_replays != ENGINE_STEPS:
        fail(f"lora: the mixed window replayed {mixed.graph_replays} times")
    solo = serving.ServingEngine(model, **kw)
    changed = 0
    for s, ((p, knobs), a) in enumerate(zip(reqs, LORA_SLOT_ADAPTERS)):
        slot = solo.admit(p, adapter=a, **knobs)
        solo.run_scan(ENGINE_STEPS)
        got = (solo.output(slot), solo.finish_reason(slot),
               solo.token_logprobs(slot))
        solo.release(slot)
        want = (mixed.output(s), mixed.finish_reason(s),
                mixed.token_logprobs(s))
        if got != want:
            fail(f"lora: slot {s} (adapter {a}) gave {want[0][:8]}... "
                 f"mixed against {got[0][:8]}... alone")
        changed += want[0] != engine["window"][s][0]
    print(f"lora: {LORA_ADAPTERS} adapters and the base over "
          f"{ENGINE_SLOTS} slots: one captured window of {ENGINE_STEPS} "
          f"steps in {window_ms:.1f} ms (capture {mixed.capture_ms:.1f} ms "
          f"of it); every request's ids, finish reason and logprobs equal "
          f"its run alone; {changed} of the {ENGINE_SLOTS - 1} adapted "
          f"requests decode other ids than the base; {card}", flush=True)
    prompt = torch.randint(0, cfg.vocab, (ENGINE_SLOTS, ENGINE_BENCH_PROMPT),
                           generator=torch.Generator().manual_seed(3))
    est = bench_serving._engine_throughput(model, prompt.cuda(),
                                           ENGINE_STEPS)
    print(f"lora: bench_serving --engine {est['tokens_per_sec']:.1f} "
          f"tokens/s at {ENGINE_SLOTS} slots with adapters loaded (none "
          f"asked: the base rows gated off); {card}", flush=True)
    del model, mixed, solo
    _fresh(torch)
    return dict(window_ms=window_ms, changed=changed,
                engine_tokens_per_sec=est["tokens_per_sec"])


def moe_flops_per_step(layers: int, seq: int) -> float:
    """Analytic FLOPs of one MoE training step on one sequence at
    MIXTRAL's widths: 6 per weight per token for the attention
    projections, the router and the LM head; the expert matmuls over the
    E x C capacity slots (6 per weight per slot); the dispatch
    contraction 4 FLOPs per (token, expert, slot, feature) (forward and
    the input's gradient: the one-hot plan takes none) and the f32
    combine 6 (forward and both gradients); attention 12 * Dh per
    visible (query, key) pair per head."""
    m = MIXTRAL
    d, f, E = m["d_model"], m["d_ff"], m["n_experts"]
    hd = d // m["n_heads"]
    kv = m["n_kv_heads"] * hd
    cap = math.ceil(m["moe_k"] * seq / E * m["moe_capacity_factor"])
    proj = d * (d + 2 * kv) + d * d + d * E
    experts = 6 * E * cap * 2 * d * f
    routing = (4 + 6) * seq * E * cap * d
    attn = 12 * hd * seq * (seq + 1) // 2 * m["n_heads"]
    return layers * (6 * proj * seq + experts + routing + attn) + \
        6 * d * m["vocab"] * seq


def moe_path(torch, counts, fa, inference, transformer, serving,
             bench_serving, card):
    """Phase 8d: MoE at Mixtral-8x7B's widths.  Training at 2 layers (one
    8192-token sequence, capacity factor 1.25, so 2560 slots an expert;
    attention K4 with its lse, then K5 and K6): the launches of one
    ``lm_train_step``, the loss over a few steps, tokens/s, MFU against
    ``moe_flops_per_step``, peak memory and the f32 combine's share of
    the step.  Serving at 4 layers, bf16: ``greedy_generate`` at batch 4
    (the gather branch: B*k = 8 <= E), its captured decode against the
    op-by-op loop, and an 8-slot engine (the dense branch) whose
    captured window gives the op-by-op steps' ids."""
    import numpy as np

    m = MIXTRAL
    model = transformer.TransformerLM(
        vocab=m["vocab"], d_model=m["d_model"], n_heads=m["n_heads"],
        n_layers=MOE_TRAIN_LAYERS, d_ff=m["d_ff"],
        attn_fn=fa.flash_causal_attention, n_kv_heads=m["n_kv_heads"],
        ffn=m["ffn"], rope_theta=m["rope_theta"],
        n_experts=m["n_experts"], device="cuda", moe_k=m["moe_k"],
        moe_capacity_factor=m["moe_capacity_factor"])
    bench_serving.random_init_(model, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    cap = math.ceil(m["moe_k"] * LM_SEQ / m["n_experts"]
                    * m["moe_capacity_factor"])
    print(f"moe training: Mixtral-8x7B widths, {MOE_TRAIN_LAYERS} layers, "
          f"{n_params / 1e9:.3f}B f32 parameters, {m['n_experts']} experts "
          f"top-{m['moe_k']}, capacity {cap} an expert for {LM_SEQ} tokens",
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(5)
    tokens, labels, positions = transformer.synthetic_lm_batch(
        gen, 1, LM_SEQ, m["vocab"])
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
    expect = {"flash_attn_fwd": MOE_TRAIN_LAYERS,
              "flash_attn_dq": MOE_TRAIN_LAYERS,
              "flash_attn_dkv": MOE_TRAIN_LAYERS}
    print(f"moe lm_train_step: loss {float(loss):.6f} (aux "
          f"{float(model.aux_loss().detach()):.6f}); launches {got}",
          flush=True)
    if got != {n: expect.get(n, 0) for n in got}:
        fail(f"MoE training step launches {got}, expected {expect}")
    losses = [float(loss)] + [float(step()) for _ in range(4)]
    print(f"moe losses over 5 steps on one batch: "
          f"{[round(x, 6) for x in losses]}", flush=True)
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        fail("MoE training loss not finite or not falling")
    for _ in range(MOE_WARMUP):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(MOE_STEPS):
        step()
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / MOE_STEPS
    flops = moe_flops_per_step(MOE_TRAIN_LAYERS, LM_SEQ)
    peak = torch.cuda.max_memory_allocated() / 2**30
    del model, opt, tokens, labels, positions
    _fresh(torch)
    # the f32 combine of one layer, forward and backward, at the step's
    # shapes
    g = torch.Generator(device="cuda").manual_seed(6)
    comb = torch.rand(1, LM_SEQ, m["n_experts"], cap, device="cuda",
                      generator=g).requires_grad_()
    out = torch.randn(1, m["n_experts"], cap, m["d_model"], device="cuda",
                      generator=g).requires_grad_()
    dy = torch.randn(1, LM_SEQ, m["d_model"], device="cuda", generator=g)

    def combine():
        comb.grad = out.grad = None
        y = torch.einsum("btec,becd->btd", comb, out)
        y.backward(dy)

    combine_ms = time_ms(torch, combine, 3)
    share = combine_ms * MOE_TRAIN_LAYERS / (step_s * 1e3)
    combine_flops = 6 * LM_SEQ * m["n_experts"] * cap * m["d_model"]
    del comb, out, dy
    _fresh(torch)
    print(f"moe training ({MOE_TRAIN_LAYERS} layers, 1 x {LM_SEQ} tokens): "
          f"{LM_SEQ / step_s:.1f} tokens/s, {step_s * 1e3:.3f} ms a step "
          f"over {MOE_STEPS} steps after {MOE_WARMUP} warmup, {flops:.4e} "
          f"FLOPs a step, MFU {flops / step_s / PEAK_BF16:.4f} (bf16 peak); "
          f"the f32 combine, forward and backward, {combine_ms:.3f} ms a "
          f"layer ({combine_flops / combine_ms / 1e9:.1f} TFLOP/s of "
          f"{PEAK_F32 / 1e12:.0f} outside the tensor cores): share "
          f"{share:.3f} of the step; peak memory {peak:.1f} GiB; {card}",
          flush=True)
    result = dict(train_launches=got, tokens_per_sec=LM_SEQ / step_s,
                  step_ms=step_s * 1e3, mfu=flops / step_s / PEAK_BF16,
                  combine_share=share, peak_gib=peak)

    serve = inference.make_decoder(
        vocab=m["vocab"], d_model=m["d_model"], n_heads=m["n_heads"],
        n_layers=MOE_SERVE_LAYERS, d_ff=m["d_ff"], max_len=MAX_LEN,
        n_experts=m["n_experts"], moe_k=m["moe_k"],
        moe_capacity_factor=m["moe_capacity_factor"],
        n_kv_heads=m["n_kv_heads"], ffn=m["ffn"],
        rope_theta=m["rope_theta"], device="cuda")
    bench_serving.random_init_(serve, seed=0)
    prompt = torch.randint(0, m["vocab"], (BATCH, PROMPT),
                           generator=torch.Generator().manual_seed(1))
    prompt = prompt.to("cuda")
    counts.zero()
    toks, logits = inference.greedy_generate(serve, prompt, NEW_TOKENS)
    torch.cuda.synchronize()
    got = counts.read()
    if got["flash_attn_fwd"] != MOE_SERVE_LAYERS or \
            not torch.isfinite(logits).all():
        fail(f"moe greedy_generate: launches {got}, or non-finite logits")
    del logits
    graph_vs_eager_decode(torch, inference, serve, prompt, toks)
    stats = inference.decode_throughput(serve, prompt, NEW_TOKENS, rounds=3)
    print(f"moe serving ({MOE_SERVE_LAYERS} layers, bf16): greedy_generate "
          f"at batch {BATCH} (the gather branch, B*k = "
          f"{BATCH * m['moe_k']} <= E = {m['n_experts']}): launches {got}; "
          f"prefill {stats['prefill_ms']:.3f} ms, decode "
          f"{stats['tokens_per_sec']:.1f} tokens/s; {card}", flush=True)
    reqs = engine_requests(np, m["vocab"])
    engines = []
    for graphs in (True, False):
        eng = serving.ServingEngine(serve, n_slots=ENGINE_SLOTS,
                                    logprobs_k=ENGINE_LOGPROBS, rng=0,
                                    device="cuda")
        eng._use_graphs = graphs
        eng.warm_packed([1])
        _admit_all(torch, eng, reqs)
        engines.append(eng)
    graph, eager = engines
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    graph.run_scan(MOE_ENGINE_STEPS)
    window_ms = (time.perf_counter() - t0) * 1e3
    for _ in range(MOE_ENGINE_STEPS):
        eager.step()
    if graph.graph_replays != MOE_ENGINE_STEPS:
        fail(f"moe engine: {graph.graph_replays} replays")
    for s in range(ENGINE_SLOTS):
        if (graph.output(s), graph.token_logprobs(s),
                graph.finish_reason(s)) != (eager.output(s),
                                            eager.token_logprobs(s),
                                            eager.finish_reason(s)):
            fail(f"moe engine: slot {s}: the captured window's ids "
                 f"{graph.output(s)[:8]}... differ from the op-by-op "
                 f"steps' {eager.output(s)[:8]}...")
    print(f"moe engine: {ENGINE_SLOTS} slots (the dense branch, B*k = "
          f"{ENGINE_SLOTS * m['moe_k']} > E), one captured window of "
          f"{MOE_ENGINE_STEPS} steps in {window_ms:.1f} ms (capture "
          f"{graph.capture_ms:.1f} ms of it) gives the op-by-op steps' "
          f"ids, logprobs and finish reasons in every slot; {card}",
          flush=True)
    result.update(serve_launches=got, serve_tokens_per_sec=
                  stats["tokens_per_sec"], engine_window_ms=window_ms)
    del serve, engines, graph, eager
    _fresh(torch)
    return result


def rest_of_model_path(torch, counts, fa, inference, llama, transformer,
                       bench_serving, serving, scheduler, speculative, obs,
                       bf16, engine, card):
    """Phase 8: the rest of the model, with no other model resident."""
    import numpy as np

    t0 = time.perf_counter()
    out, walls = {}, []
    for name, run in (
            ("quant", lambda: quant_path(torch, counts, inference,
                                         bench_serving, bf16, card)),
            ("spec", lambda: spec_path(torch, np, obs, inference, llama,
                                       bench_serving, serving, scheduler,
                                       speculative, engine, card)),
            ("lora", lambda: lora_path(torch, np, inference, bench_serving,
                                       serving, engine, card)),
            ("moe", lambda: moe_path(torch, counts, fa, inference,
                                     transformer, serving, bench_serving,
                                     card))):
        t = time.perf_counter()
        out[name] = run()
        walls.append(f"{name} {time.perf_counter() - t:.1f} s")
    print(f"rest of the model: phase wall {time.perf_counter() - t0:.1f} s "
          f"({', '.join(walls)})", flush=True)
    return out


# the checkpointing phase, with no other model resident: the elastic
# AlexNet loop at the training phase's size (224 px, 1000 classes, s2d,
# bf16 compute, f32 parameters, batch 1024, pool pallas), 6 steps with a
# save every 2 (run 1 SIGKILLed once step_4 is committed, run 2 resumed
# under a moved membership generation, run 3 under the new one); the LM
# resume on Llama-3.2-1B at full width with 2 of its 16 layers (f32
# parameters and Adam's moments: 12 bytes a parameter saved), one
# 4096-token sequence, 2 steps, a save, a SIGKILL and 3 more steps in a
# fresh process; and Llama-3.2-1B at full width and depth (f32, seed 0)
# served from a checkpoint by the server CLI, bf16, int8 and int4, the
# three boots side by side
CKPT_STEPS, CKPT_EVERY = 6, 2
CKPT_LM_LAYERS, CKPT_LM_SEQ, CKPT_LM_STEPS, CKPT_LM_SAVE_AT = 2, 4096, 5, 2
# the head slice of the LM resume's attention call (Llama-3.2-1B: 32 / 8
# heads of 64), which phase 4 holds against the plain versions
ATTN_CKPT_SLICE = ((1, CKPT_LM_SEQ, 8, 64), 2)
CKPT_SERVE_CONFIG = "llama3-1b"
CKPT_KINDS = (("bf16", False), ("int8", True), ("int4", "int4"))
# subprocess bounds: a run of the elastic loop, an LM worker, a boot
CKPT_RUN_S, CKPT_BOOT_S = 600, 900


def _ckpt_numerics(torch) -> dict:
    """Set the phase's numerics (no TF32; cuDNN's deterministic
    algorithms, chosen without benchmarking) and return the settings it
    replaced: cuDNN's conv gradients may otherwise take algorithms whose
    sums are not reproducible, and every comparison of the phase is bit
    for bit."""
    flags = (torch.backends.cuda.matmul, "allow_tf32"), \
        (torch.backends.cudnn, "allow_tf32"), \
        (torch.backends.cudnn, "deterministic"), \
        (torch.backends.cudnn, "benchmark")
    before = {(mod, name): getattr(mod, name) for mod, name in flags}
    for (mod, name), value in zip(flags, (False, False, True, False)):
        setattr(mod, name, value)
    return before


def _lm_resume_setup(torch, fa, llama, transformer, bench_serving):
    """The LM resume model (Llama-3.2-1B at full width, 2 layers, flash
    attention, random f32 weights from seed 0), its Adam and its one
    4096-token batch from seed 7: the same in every process."""
    cfg = dataclasses.replace(llama.LLAMA32_1B, n_layers=CKPT_LM_LAYERS)
    model = llama.train_model(cfg, attn_fn=fa.flash_causal_attention,
                              device="cuda")
    bench_serving.random_init_(model, seed=0)
    opt = torch.optim.Adam(model.parameters(), lr=LM_LR, betas=(0.9, 0.999),
                           eps=1e-8)
    gen = torch.Generator(device="cuda").manual_seed(7)
    batch = transformer.synthetic_lm_batch(gen, 1, CKPT_LM_SEQ, cfg.vocab)
    return cfg, model, opt, batch


def worker(argv) -> int:
    """``chip_smoke.py --worker KIND ARGS``: the device-plugin phase
    (``device-plugin``, :func:`device_plugin_child`) and its container
    child (``container``, :func:`container_child`), and the
    checkpointing phase's subprocesses, under that phase's numerics
    (``_ckpt_numerics``):

    ``elastic ARGS``: ``bench_main``'s CLI with ARGS;
    ``lm-crash DIR``: the LM resume model takes 2 steps, saves step_2
    under DIR, prints the save's seconds and SIGKILLs itself;
    ``lm-resume DIR OUT``: restores the newest step under DIR in this
    fresh process, takes the rest of the 5 steps and writes the step,
    the restore's seconds and the losses to OUT."""
    import signal

    if argv[:1] == ["container"]:
        return container_child()
    if argv[:1] == ["device-plugin"]:
        return device_plugin_child()
    if argv[:1] == ["rank"]:
        return rank_child()
    if argv[:1] == ["md-rank"]:
        return md_rank_child(argv[1:])
    if argv[:1] == ["md-nccl-lm"]:
        return md_nccl_lm_child()
    if argv[:1] == ["chaos"]:
        return chaos_child(argv[1:])
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    _ckpt_numerics(torch)
    kind, args = argv[0], argv[1:]
    if kind == "elastic":
        from tpu_k8s_device_plugin_torch.workloads import bench_main

        return bench_main.main(args)
    from tpu_k8s_device_plugin_torch.workloads import (
        bench_serving, checkpoint, llama, transformer)
    from tpu_k8s_device_plugin_torch.workloads import flash_attention as fa

    _, model, opt, batch = _lm_resume_setup(torch, fa, llama, transformer,
                                            bench_serving)
    if kind == "lm-crash":
        for _ in range(CKPT_LM_SAVE_AT):
            transformer.lm_train_step(model, opt, *batch)
        t0 = time.perf_counter()
        checkpoint.save_checkpoint(args[0], CKPT_LM_SAVE_AT, {
            "params": model.state_dict(), "opt_state": opt.state_dict()})
        print(f"saved {time.perf_counter() - t0:.6f}", flush=True)
        os.kill(os.getpid(), signal.SIGKILL)
    if kind != "lm-resume":
        raise SystemExit(f"unknown worker {kind!r}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step, restored = checkpoint.restore_latest(args[0], template={
        "params": model.state_dict(),
        "opt_state": checkpoint.optimizer_template(opt)})
    model.load_state_dict(restored["params"])
    opt.load_state_dict(restored["opt_state"])
    del restored
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    losses = [float(transformer.lm_train_step(model, opt, *batch))
              for _ in range(CKPT_LM_STEPS - step)]
    with open(args[1], "w") as f:
        json.dump({"step": step, "restore_s": restore_s, "losses": losses},
                  f)
    return 0


def _room(path: str, need: int, what: str) -> None:
    import shutil

    free = shutil.disk_usage(path).free
    print(f"checkpointing, {what}: {free} bytes free under {path}, "
          f"{need} needed", flush=True)
    if free < need:
        fail(f"checkpointing, {what}: {need} bytes needed under {path}, "
             f"{free} free")


def _payload_bytes(checkpoint, base: str, step: int) -> int:
    with open(os.path.join(base, f"step_{step}",
                           checkpoint._METADATA)) as f:
        return sum(json.load(f)["payloads"].values())


def _rate(nbytes: int, seconds: float) -> str:
    return (f"{seconds * 1e3:.1f} ms for {nbytes} bytes, "
            f"{nbytes / seconds / 1e9:.3f} GB/s")


def _trees_equal(torch, checkpoint, a, b) -> int:
    """Fail unless trees *a* and *b* have the same keys and every leaf
    the same bits; returns the number of tensor leaves."""
    la, lb = list(checkpoint._leaves(a)), list(checkpoint._leaves(b))
    if [k for k, _ in la] != [k for k, _ in lb]:
        fail("checkpointing: the trees' keys differ")
    n = 0
    for (key, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            n += 1
            if x.dtype != y.dtype or not torch.equal(x.cpu(), y.cpu()):
                fail(f"checkpointing: {key} differs")
        elif x != y:
            fail(f"checkpointing: {key} is {x!r} against {y!r}")
    return n


def _write_membership(path: str, generation: int, workers: int,
                      degraded: bool = False) -> None:
    """A membership file as the slice agent writes it (atomically)."""
    from tpu_k8s_device_plugin_torch.slice.state import Membership

    hosts = tuple(f"host-{i}" for i in range(workers))
    m = Membership(slice_id=f"slice-{generation}", generation=generation,
                   hostnames=hosts, coordinator_address=f"{hosts[0]}:8476",
                   degraded=degraded)
    with open(path + ".tmp", "w") as f:
        json.dump(m.to_dict(), f)
    os.replace(path + ".tmp", path)


def _elastic_run(args, generation: int, log: str, kill_at: str = ""):
    """One run of the elastic loop through ``bench_main``'s CLI in a
    subprocess with ``TPU_SLICE_GENERATION`` = *generation*; with
    *kill_at* (a step dir), SIGKILLed as soon as that dir is committed.
    Returns (exit code, output, wall seconds)."""
    import signal

    from tpu_k8s_device_plugin_torch.types import constants

    env = dict(os.environ)
    env[constants.ENV_TPU_SLICE_GENERATION] = str(generation)
    cmd = [sys.executable, os.path.abspath(__file__), "--worker", "elastic",
           *args]
    t0 = time.perf_counter()
    with open(log, "w") as out:
        proc = subprocess.Popen(cmd, env=env, stdout=out,
                                stderr=subprocess.STDOUT)
        try:
            if kill_at:
                while not os.path.isdir(kill_at):
                    if proc.poll() is not None:
                        break
                    if time.perf_counter() - t0 > CKPT_RUN_S:
                        fail(f"checkpointing: {kill_at} never appeared")
                    time.sleep(0.002)
                else:
                    proc.send_signal(signal.SIGKILL)
            rc = proc.wait(timeout=CKPT_RUN_S)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    with open(log) as f:
        text = f.read()
    return rc, text, time.perf_counter() - t0


def ckpt_elastic(torch, counts, alexnet, bench_main, checkpoint, work,
                 card):
    """The elastic AlexNet loop at full size: a save and a restore of one
    stepped state timed; run 1 SIGKILLed once step_4 is committed; run 2,
    with the membership file moved to generation 2, resumes from 4,
    exits 77 after step 5 and leaves step_5; run 3 under generation 2
    resumes from 5 and leaves [4, 5, 6], whose step_6 must equal an
    uninterrupted run's bit for bit; the elastic loop's images/s against
    ``run_single``'s.  Returns the uninterrupted run's launches."""
    import shutil

    model, opt = alexnet.create_train_state(seed=0, s2d=True, pool="pallas",
                                            device="cuda")
    step_bytes = 8 * sum(p.numel() for p in model.parameters())
    # the runs keep 3 step dirs and write a fourth, twice over, and the
    # timed save one more
    _room(work, 9 * step_bytes, "elastic AlexNet")
    gen = torch.Generator(device="cuda").manual_seed(0)
    images, labels = alexnet.synthetic_batch(gen, ALEX_BATCH, s2d=True)
    alexnet.train_step(model, opt, images, labels)
    state = {"params": model.state_dict(), "opt_state": opt.state_dict()}
    timed = os.path.join(work, "timed")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpoint.save_checkpoint(timed, 1, state)
    save_s = time.perf_counter() - t0
    nbytes = _payload_bytes(checkpoint, timed, 1)
    fresh, fresh_opt = alexnet.create_train_state(
        seed=1, s2d=True, pool="pallas", device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored = checkpoint.restore_checkpoint(timed, template={
        "params": fresh.state_dict(),
        "opt_state": checkpoint.optimizer_template(fresh_opt)})
    fresh.load_state_dict(restored["params"])
    fresh_opt.load_state_dict(restored["opt_state"])
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    n = _trees_equal(torch, checkpoint, {
        "params": fresh.state_dict(), "opt_state": fresh_opt.state_dict()},
        state)
    print(f"checkpointing, AlexNet (224 px, 1000 classes, f32 parameters "
          f"and momentum, {n} tensors): save {_rate(nbytes, save_s)}; "
          f"restore into a fresh model and optimizer "
          f"{_rate(nbytes, restore_s)}; the restored state equals the "
          f"saved one bit for bit; {card}", flush=True)
    del model, opt, fresh, fresh_opt, restored, state, images, labels
    shutil.rmtree(timed)
    _fresh(torch)

    ckpt = os.path.join(work, "elastic")
    members = os.path.join(work, "membership.json")
    args = ["--batch", str(ALEX_BATCH), "--steps", str(CKPT_STEPS),
            "--pool", "pallas", "--checkpoint-dir", ckpt,
            "--checkpoint-every", str(CKPT_EVERY), "--slice-state", members]
    _write_membership(members, 1, 2)
    rc, out, wall1 = _elastic_run(args, 1, os.path.join(work, "run1.log"),
                                  kill_at=os.path.join(ckpt, "step_4"))
    steps = checkpoint.list_steps(ckpt)
    print(f"checkpointing, elastic run 1 (generation 1): SIGKILLed once "
          f"step_4 was committed, exit {rc} after {wall1:.2f} s; step dirs "
          f"{steps}", flush=True)
    if rc != -9 or steps != [2, 4]:
        fail(f"elastic run 1: exit {rc}, steps {steps} (want -9, [2, 4]); "
             f"output:\n{out}")
    _write_membership(members, 2, 1, degraded=True)
    rc, out, wall2 = _elastic_run(args, 1, os.path.join(work, "run2.log"))
    steps = checkpoint.list_steps(ckpt)
    lines = out.splitlines()
    print(f"checkpointing, elastic run 2 (membership at generation 2, the "
          f"identity at 1): exit {rc} after {wall2:.2f} s; step dirs "
          f"{steps}; {[l for l in lines if 'checkpoint' in l]}", flush=True)
    reshaped = ("slice reshaped to gen 2 (1 worker(s), degraded); "
                "checkpointed step 5; exiting 77 for restart under the new "
                "identity")
    if rc != checkpoint.RESHAPE_EXIT_CODE or steps != [2, 4, 5] or \
            "resumed from checkpoint step 4" not in lines or \
            reshaped not in lines:
        fail(f"elastic run 2: exit {rc}, steps {steps}; output:\n{out}")
    rc, out, wall3 = _elastic_run(args, 2, os.path.join(work, "run3.log"))
    steps = checkpoint.list_steps(ckpt)
    lines = out.splitlines()
    print(f"checkpointing, elastic run 3 (generation 2): exit {rc} after "
          f"{wall3:.2f} s; step dirs {steps}; "
          f"{[l for l in lines if 'checkpoint' in l or 'loss' in l]}",
          flush=True)
    if rc != 0 or steps != [4, 5, 6] or \
            "resumed from checkpoint step 5" not in lines or not any(
                l.startswith(f"final loss after {CKPT_STEPS} steps: ")
                for l in lines):
        fail(f"elastic run 3: exit {rc}, steps {steps}; output:\n{out}")

    solo = os.path.join(work, "uninterrupted")
    signal = checkpoint.ReshapeSignal(os.path.join(work, "none.json"),
                                      generation=1)
    counts.zero()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = bench_main.run_elastic(ALEX_BATCH, CKPT_STEPS, solo, CKPT_EVERY,
                                "", pool="pallas", signal=signal,
                                device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts.read()
    want = {"maxpool_fwd": 3 * CKPT_STEPS, "maxpool_bwd": 3 * CKPT_STEPS}
    print(f"checkpointing, elastic loop uninterrupted in this process: exit "
          f"{rc}, {CKPT_STEPS} steps in {wall:.3f} s (the model's build and "
          f"{CKPT_STEPS // CKPT_EVERY} saves included): "
          f"{ALEX_BATCH * CKPT_STEPS / wall:.1f} images/s; launches "
          f"{launches}", flush=True)
    if rc != 0 or launches != {k: want.get(k, 0) for k in launches}:
        fail(f"elastic loop: exit {rc}, launches {launches}, expected "
             f"{want}")
    n = _trees_equal(torch, checkpoint,
                     checkpoint.restore_checkpoint(ckpt, step=CKPT_STEPS),
                     checkpoint.restore_checkpoint(solo, step=CKPT_STEPS))
    print(f"checkpointing, elastic: step_{CKPT_STEPS} after a SIGKILL, a "
          f"reshape exit and two resumes equals the uninterrupted run's bit "
          f"for bit ({n} tensors: parameters and momentum)", flush=True)
    shutil.rmtree(ckpt)
    shutil.rmtree(solo)
    _fresh(torch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ips = bench_main.run_single(ALEX_BATCH, CKPT_STEPS, 0, pool="pallas",
                                device="cuda")
    single_wall = time.perf_counter() - t0
    print(f"checkpointing, elastic loop {ALEX_BATCH * CKPT_STEPS / wall:.1f} "
          f"images/s against run_single's {ips:.1f} images/s over its timed "
          f"steps and {ALEX_BATCH * CKPT_STEPS / single_wall:.1f} over its "
          f"whole call (batch {ALEX_BATCH}, {CKPT_STEPS} steps, no warmup, "
          f"pool pallas, deterministic cuDNN); the three runs' walls "
          f"{wall1:.2f}, {wall2:.2f}, {wall3:.2f} s; {card}", flush=True)
    return launches


def _lm_workers(work, running, result):
    """The LM resume's two worker processes, one after the other: the
    first takes 2 steps, saves and SIGKILLs itself; the second restores
    and takes 3 more.  Each one's (completed process, wall seconds) goes
    into *result* under "crash" and "resume"; the running one's Popen
    into *running*, so a failed phase can kill it."""
    base = os.path.join(work, "lm")
    me = [sys.executable, os.path.abspath(__file__), "--worker"]
    for key, args in (("crash", ["lm-crash", base]),
                      ("resume", ["lm-resume", base,
                                  os.path.join(work, "lm_resumed.json")])):
        t0 = time.perf_counter()
        proc = subprocess.Popen(me + args, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        running["proc"] = proc
        try:
            out, err = proc.communicate(timeout=CKPT_RUN_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        result[key] = (subprocess.CompletedProcess(
            proc.args, proc.returncode, out, err),
            time.perf_counter() - t0)
        if key == "crash" and (proc.returncode != -9 or not any(
                l.startswith("saved ") for l in out.splitlines())):
            return


def ckpt_lm_start(torch, counts, fa, llama, transformer, bench_serving,
                  work):
    """The LM resume's first half: its two workers start in a thread
    (:func:`_lm_workers`), and meanwhile this process takes the
    uninterrupted 5 steps (K4 with its lse, K5 and K6 counted; the
    workers' launches are their own processes').  The workers then run
    beside the elastic AlexNet loop, whose runs are processes too.
    Returns what :func:`ckpt_lm_finish` checks."""
    import threading

    cfg, model, opt, batch = _lm_resume_setup(torch, fa, llama, transformer,
                                              bench_serving)
    n_params = sum(p.numel() for p in model.parameters())
    _room(work, 12 * n_params + 2**30, "LM resume")
    lm = dict(running={}, result={})
    lm["thread"] = threading.Thread(
        target=_lm_workers, args=(work, lm["running"], lm["result"]),
        name="lm-workers", daemon=True)
    lm["thread"].start()
    counts.zero()
    losses = [float(transformer.lm_train_step(model, opt, *batch))
              for _ in range(CKPT_LM_STEPS)]
    launches = counts.read()
    want = {k: CKPT_LM_LAYERS * CKPT_LM_STEPS
            for k in ("flash_attn_fwd", "flash_attn_dq", "flash_attn_dkv")}
    print(f"checkpointing, LM resume: llama3-1b at full width, "
          f"{cfg.n_layers} of 16 layers, {n_params / 1e9:.3f}B f32 "
          f"parameters, 1 x {CKPT_LM_SEQ} tokens: {CKPT_LM_STEPS} "
          f"uninterrupted losses {losses}; launches {launches}", flush=True)
    if launches != {k: want.get(k, 0) for k in launches}:
        fail(f"LM resume launches {launches}, expected {want}")
    del model, opt, batch
    _fresh(torch)
    lm.update(losses=losses, launches=launches)
    return lm


def ckpt_lm_stop(lm) -> None:
    """Kill the LM resume's running worker, if any, and wait for its
    thread: a failed phase leaves no process behind."""
    proc = lm["running"].get("proc")
    if proc is not None and proc.poll() is None:
        proc.kill()
    lm["thread"].join(timeout=60)


def ckpt_lm_finish(checkpoint, work, lm, card):
    """The LM resume's second half: wait for the workers; the resumed
    worker's 3 losses must be this process's last 3, bit for bit.
    Returns the launches of the uninterrupted 5 steps."""
    import shutil

    lm["thread"].join(timeout=2 * CKPT_RUN_S + 60)
    losses, result = lm["losses"], lm["result"]
    if "crash" not in result:
        fail("LM crash worker: no result within its time limit")
    crash, crash_wall = result["crash"]
    saved = [l for l in crash.stdout.splitlines() if l.startswith("saved ")]
    if crash.returncode != -9 or not saved:
        fail(f"LM crash worker: exit {crash.returncode}, output "
             f"{crash.stdout[-2000:]} {crash.stderr[-4000:]}")
    base = os.path.join(work, "lm")
    nbytes = _payload_bytes(checkpoint, base, CKPT_LM_SAVE_AT)
    save_s = float(saved[0].split()[1])
    resume, resume_wall = result["resume"]
    if resume.returncode != 0:
        fail(f"LM resume worker: exit {resume.returncode}, "
             f"{resume.stderr[-4000:]}")
    with open(os.path.join(work, "lm_resumed.json")) as f:
        data = json.load(f)
    print(f"checkpointing, LM resume: the worker took {CKPT_LM_SAVE_AT} "
          f"steps, saved ({_rate(nbytes, save_s)}) and was SIGKILLed (exit "
          f"{crash.returncode}, {crash_wall:.2f} s); a fresh process "
          f"restored step {data['step']} into its model and Adam "
          f"({_rate(nbytes, data['restore_s'])}) and took "
          f"{len(data['losses'])} steps ({resume_wall:.2f} s): losses "
          f"{data['losses']} against {losses[CKPT_LM_SAVE_AT:]}; both "
          f"workers ran beside the elastic loop; {card}", flush=True)
    if data["step"] != CKPT_LM_SAVE_AT or \
            data["losses"] != losses[CKPT_LM_SAVE_AT:]:
        fail("LM resume: the resumed losses are not the uninterrupted "
             "run's")
    shutil.rmtree(base)
    return lm["launches"]


def ckpt_serving(torch, llama, bench_serving, checkpoint, serving,
                 scheduler, obs, sched, work, card):
    """Llama-3.2-1B at full width and depth, random f32 weights from seed
    0, saved as ``{"params": ...}``; the server CLI with ``--checkpoint``
    in each of ``CKPT_KINDS`` answers the scheduler phase's greedy
    requests with the ids of an in-process engine over a decoder loaded
    from the same weights without a checkpoint (quantized in process
    for a quantized kind)."""
    import shutil

    import numpy as np

    from tpu_k8s_device_plugin_torch.workloads import inference, loadclient

    cfg = bench_serving.CONFIGS[CKPT_SERVE_CONFIG]
    _room(work, 4 * cfg.n_params() + 2**30, "serving from a checkpoint")
    train = llama.train_model(cfg, device="cuda")
    bench_serving.random_init_(train, seed=0)
    params = train.state_dict()
    base = os.path.join(work, "serve")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpoint.save_checkpoint(base, 0, {"params": params})
    save_s = time.perf_counter() - t0
    nbytes = _payload_bytes(checkpoint, base, 0)
    print(f"checkpointing, serving: {CKPT_SERVE_CONFIG} train layout "
          f"({cfg.n_params() / 1e9:.3f}B f32 parameters) saved: "
          f"{_rate(nbytes, save_s)}", flush=True)
    host = {k: v.cpu() for k, v in params.items()}
    del train, params
    _fresh(torch)
    greedy = [r for r in sched["trace"] if not r[2]]
    # every kind's server boots from the checkpoint while this process's
    # engines give the ids it must answer with
    log_dir = os.path.join(work, "replicas")
    os.environ[loadclient.REPLICA_LOG_DIR_ENV] = log_dir
    boots = {}
    try:
        for kind, q in CKPT_KINDS:
            port = loadclient.free_port()
            while port in [b[0] for b in boots.values()]:
                port = loadclient.free_port()
            cmd = loadclient.server_cmd(
                None, "--config", CKPT_SERVE_CONFIG,
                *bench_serving._quant_args(q), "--checkpoint", base,
                "--n-slots", str(ENGINE_SLOTS), "--max-len", str(MAX_LEN),
                "--max-new-tokens", str(SCHED_NEW), *FLEET_ARGS,
                "--host", "127.0.0.1", "--port", str(port))
            boots[kind] = (port, time.perf_counter(), loadclient.spawn_replica(
                cmd, f"ckpt-{kind}", env=bench_serving._spawn_env()))
        want = {}
        for kind, q in CKPT_KINDS:
            tree = host if not q else (
                inference.quantize_lm_params_int4(host) if q == "int4"
                else inference.quantize_lm_params(host))
            model = llama.decoder(cfg, max_len=MAX_LEN, quantized=q,
                                  device="cuda")
            model.load_state_dict(tree)
            del tree
            eng = serving.ServingEngine(model, n_slots=ENGINE_SLOTS,
                                        logprobs_k=ENGINE_LOGPROBS, rng=0,
                                        max_new_tokens=SCHED_NEW,
                                        device="cuda")
            eng.warm_packed([SCHED_PACK])
            want[kind], _ = run_scheduled(torch, np, obs, scheduler, eng,
                                          greedy, True, True, True)
            del eng, model
            _fresh(torch)
        del host
        for kind, q in CKPT_KINDS:
            port, t0, proc = boots[kind]
            loadclient.wait_http_ok(port, "/healthz", CKPT_BOOT_S,
                                    procs=[proc])
            ready_s = time.perf_counter() - t0
            try:
                got, res, wall = serve_trace(loadclient, port, greedy,
                                             HTTP_CLIENTS)
            finally:
                proc.terminate()
                try:
                    proc.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
            text = "".join(t for n, t in _replica_logs(log_dir).items()
                           if n.startswith(f"ckpt-{kind}-"))
            m = re.search(r"restored \S+ in ([0-9.]+)s", text)
            if m is None:
                fail(f"serving {kind} from a checkpoint: no restore line in "
                     f"the server's output:\n{text[-4000:]}")
            for i in range(len(greedy)):
                if res[i].outcome != "ok" or got[i] != want[kind][i]:
                    fail(f"serving {kind} from a checkpoint: request {i} "
                         f"gave {got[i][0]} ({got[i][1]}, {res[i].outcome}) "
                         f"against the in-process {want[kind][i][0]} "
                         f"({want[kind][i][1]})")
            print(f"checkpointing, serving {kind}: the server CLI restored "
                  f"the checkpoint in {float(m.group(1)):.2f} s (restore, "
                  f"quantize, load onto the card), ready within "
                  f"{ready_s:.2f} s of its spawn (the {len(CKPT_KINDS)} "
                  f"servers booting together beside the in-process "
                  f"engines); "
                  f"the scheduler phase's {len(greedy)} greedy requests in "
                  f"{wall:.3f} s gave the in-process engine's ids and finish "
                  f"reasons; {card}", flush=True)
    except BaseException:
        for name, text in _replica_logs(log_dir).items():
            tail = "\n    ".join(text.splitlines()[-15:])
            print(f"checkpointing: replica log {name}:\n    {tail}",
                  flush=True)
        raise
    finally:
        for _, _, proc in boots.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        del os.environ[loadclient.REPLICA_LOG_DIR_ENV]
    shutil.rmtree(base)


def checkpoint_path(torch, counts, sched, card):
    """Phase 10, checkpointing, with no other model resident: the elastic
    AlexNet loop (SIGKILL, resume, a reshape exit, resume, a bit-equal
    final step), the LM resume across processes (bit-equal losses; its
    workers run beside the elastic loop's, since both are mostly process
    start) and the server CLI serving from a checkpoint (bf16, int8, int4
    with the in-process ids), under a temporary directory whose free
    bytes are printed first; each checkpoint is deleted once checked.
    Returns the launches of the elastic loop and the LM steps.  Every
    check is fatal."""
    import shutil
    import tempfile

    from tpu_k8s_device_plugin_torch import obs
    from tpu_k8s_device_plugin_torch.workloads import (
        alexnet, bench_main, bench_serving, checkpoint, llama, scheduler,
        serving, transformer)
    from tpu_k8s_device_plugin_torch.workloads import flash_attention as fa

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    print(f"checkpointing: {shutil.disk_usage(work).free} bytes free under "
          f"{work}", flush=True)
    before = _ckpt_numerics(torch)
    lm_run = None
    try:
        lm_run = ckpt_lm_start(torch, counts, fa, llama, transformer,
                               bench_serving, work)
        elastic = ckpt_elastic(torch, counts, alexnet, bench_main,
                               checkpoint, work, card)
        _fresh(torch)
        lm = ckpt_lm_finish(checkpoint, work, lm_run, card)
        ckpt_serving(torch, llama, bench_serving, checkpoint, serving,
                     scheduler, obs, sched, work, card)
    finally:
        if lm_run is not None:
            ckpt_lm_stop(lm_run)
        for (mod, name), value in before.items():
            setattr(mod, name, value)
        shutil.rmtree(work, ignore_errors=True)
    print(f"checkpointing: phase wall {time.perf_counter() - t_phase:.1f} "
          f"s; {card}", flush=True)
    return dict(elastic=elastic, lm=lm)


# -- the device plugin: discovery, the plugin, health and labels ------------

DP_FIXTURE = os.path.join("testdata", "nvidia", "h100-sxm-8")
DP_PULSE_S = 1
DP_WATCHDOG_S = 0.5
DP_PROBE_HANG = "probe:hang:1"
DP_CHILD_QUERY = ((1, 512, 8, 128), 512, 2)  # K4's prefill in the child
DP_TIMEOUT_S = 300
# the slice: two plugin processes on this host under two loopback
# hostnames (both resolve here; the first serves the rendezvous and is
# rank 0), pulsing each second; a member silent past the heartbeat
# timeout and then unhealthy past the grace is evicted
DP_SLICE_HOSTS = ("127.0.0.1", "127.0.0.2")
DP_SLICE_HEARTBEAT_TIMEOUT_S = 2
DP_SLICE_GRACE_S = 6
DP_SLICE_PULSES = 6   # frames allowed to demote, and to recover


class _StubKubelet:
    """The kubelet's Registration service on ``kubelet.sock``, from the
    port's own proto: it records each RegisterRequest."""

    def __init__(self, directory: str):
        import concurrent.futures
        import threading

        import grpc

        from tpu_k8s_device_plugin_torch.proto import (
            deviceplugin_pb2 as pb, deviceplugin_pb2_grpc as pb_grpc)

        self.dir = directory
        self.requests = []
        self.registered = threading.Event()
        self._empty = pb.Empty
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=2)
        self._server = grpc.server(self._pool)
        pb_grpc.add_RegistrationServicer_to_server(self, self._server)
        self._server.add_insecure_port(
            f"unix://{os.path.join(directory, 'kubelet.sock')}")
        self._server.start()

    def Register(self, request, context):  # noqa: N802 (gRPC API)
        self.requests.append(request)
        self.registered.set()
        return self._empty()

    def stop(self) -> None:
        self._server.stop(grace=0).wait()
        self._pool.shutdown(wait=True)


def allocate_us(impl, ctx, ids):
    """Allocate p50 and p99 in microseconds, as ``bench.py``'s
    ``bench_allocate_us`` measures them: 500 warm-ups, then the best of 5
    rounds of 2000 calls (the round with the lowest median)."""
    import statistics

    from tpu_k8s_device_plugin_torch.proto import deviceplugin_pb2 as pb

    req = pb.AllocateRequest(container_requests=[
        pb.ContainerAllocateRequest(devices_ids=ids)])
    for _ in range(500):
        impl.allocate(ctx, req)
    best = None
    for _ in range(5):
        samples = []
        for _ in range(2000):
            t0 = time.perf_counter_ns()
            impl.allocate(ctx, req)
            samples.append((time.perf_counter_ns() - t0) / 1000.0)
        samples.sort()
        stats = (statistics.median(samples),
                 samples[int(len(samples) * 0.99)])
        if best is None or stats[0] < best[0]:
            best = stats
    return best


def _exposed(nvml_mod, say):
    """Step 1: what the machine exposes of its GPUs."""
    import glob
    import stat

    drv = "/sys/bus/pci/drivers/nvidia"
    say("exposed: " + drv + ": " + (
        str(sorted(e for e in os.listdir(drv) if ":" in e))
        if os.path.isdir(drv) else "absent"))
    gpus_dir = "/proc/driver/nvidia/gpus"
    say("exposed: " + gpus_dir + ": " + (
        str(sorted(os.listdir(gpus_dir))) if os.path.isdir(gpus_dir)
        else "absent"))
    nodes = []
    for path in sorted(glob.glob("/dev/nvidia*")):
        st = os.stat(path)
        nodes.append(f"{path} " + (
            f"char {os.major(st.st_rdev)}:{os.minor(st.st_rdev)}"
            if stat.S_ISCHR(st.st_mode) else "not a char device"))
    say("exposed: device nodes " + "; ".join(nodes))
    nvml = nvml_mod.load()
    say("exposed: libnvidia-ml.so.1 " + (
        f"loads, {len(nvml.gpus())} GPU(s), driver {nvml.driver_version()}"
        if nvml is not None else "does not load"))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=pci.bus_id,uuid,name,memory.total",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    say("exposed: nvidia-smi pci.bus_id, uuid, name, memory.total: "
        + " | ".join(smi.stdout.strip().splitlines()))
    return nvml, bool(os.path.isdir(drv) and os.listdir(drv))


def _frames(stub, pb):
    """A ListAndWatch stream consumed into a queue by a thread."""
    import queue
    import threading

    frames = queue.Queue()
    call = stub.ListAndWatch(pb.Empty())

    def consume():
        try:
            for frame in call:
                frames.put(frame)
        except Exception as e:  # the stream ends when the call is cancelled
            frames.put(e)

    threading.Thread(target=consume, daemon=True).start()
    return call, frames


def _await_health(frames, gpu_id, want, pulses, what):
    """Frames until *gpu_id* reads *want*; fails past *pulses* frames."""
    for n in range(1, pulses + 1):
        frame = frames.get(timeout=DP_PULSE_S * 10 + 30)
        if isinstance(frame, Exception):
            fail(f"ListAndWatch ended while {what}: {frame}")
        health = {d.ID: d.health for d in frame.devices}.get(gpu_id)
        if health == want:
            return n
    fail(f"{what}: the GPU did not read {want} within {pulses} pulses")


def device_plugin_path(card):
    """Phase 3, the device plugin, run in a process of its own
    (:func:`device_plugin_child`): the agents' gRPC servers, threads and
    sockets end with it, so nothing of them stays in the process that
    runs every later phase.  Prints the child's lines and returns its
    result."""
    import threading

    threads = threading.active_count()
    t_phase = time.perf_counter()
    try:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker",
             "device-plugin"], capture_output=True, text=True,
            timeout=DP_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        fail(f"the device-plugin phase ran past {DP_TIMEOUT_S} s:\n"
             f"{e.stdout or ''}{e.stderr or ''}")
    lines = out.stdout.strip().splitlines()
    for line in lines[:-1]:
        print(line, flush=True)
    if out.returncode != 0 or not lines:
        fail(f"the device-plugin phase failed ({out.returncode}):\n"
             f"{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
    result = json.loads(lines[-1])
    print(f"device plugin, threads in this process: {threads} before the "
          f"phase, {threading.active_count()} after; phase wall with the "
          f"child's start {time.perf_counter() - t_phase:.1f} s; {card}",
          flush=True)
    return result


def device_plugin_child() -> int:
    """``chip_smoke.py --worker device-plugin``: the port's node agents on
    this host (discovery, the gpuprobe shim, the plugin behind a stub
    kubelet, Allocate latency, health under the probe fault, labels) and
    a child process that gets only the allocated GPU and runs K4 on it.
    Tears every agent down, reports the threads left, and prints the
    result as its last line."""
    import functools
    import shutil
    import tempfile
    import threading

    import torch

    import grpc

    from tpu_k8s_device_plugin_torch.gpu import discovery
    from tpu_k8s_device_plugin_torch.gpu import nvml as nvml_mod
    from tpu_k8s_device_plugin_torch.gpu.device_impl import GpuContainerImpl
    from tpu_k8s_device_plugin_torch.health import (
        GpuHealthServer, get_gpu_health)
    from tpu_k8s_device_plugin_torch.hostinfo import gpuprobe
    from tpu_k8s_device_plugin_torch.labeller import (
        LabelContext, generate_labels)
    from tpu_k8s_device_plugin_torch.labeller.generators import slug
    from tpu_k8s_device_plugin_torch.manager import PluginManager
    from tpu_k8s_device_plugin_torch.proto import (
        deviceplugin_pb2 as pb, deviceplugin_pb2_grpc as pb_grpc)
    from tpu_k8s_device_plugin_torch.resilience import faults
    from tpu_k8s_device_plugin_torch.types import (
        DevicePluginContext, constants)

    t_phase = time.perf_counter()
    threads = threading.active_count()
    card = card_line()

    def say(msg: str) -> None:
        print(f"device plugin, {msg}; {card}", flush=True)

    # 1. what the machine exposes
    nvml, sysfs_bound = _exposed(nvml_mod, say)
    if not sysfs_bound and nvml is None:
        fail("the machine exposes neither nvidia-bound sysfs PCI nor NVML: "
             "the card cannot be discovered")

    # 2. discovery on the real roots, matched to torch's device 0
    props = torch.cuda.get_device_properties(0)
    torch_bus = (f"{props.pci_domain_id:04x}:{props.pci_bus_id:02x}:"
                 f"{props.pci_device_id:02x}.0")
    torch_uuid = f"GPU-{props.uuid}"
    torch_name = torch.cuda.get_device_name(0)
    gpus, topo = discovery.get_gpus("/sys", "/dev", "/proc", nvml)
    say(f"discovery: {len(gpus)} GPU(s) "
        + ", ".join(f"{g.id} (index {g.index}, minor {g.minor}, {g.source})"
                    for g in gpus.values())
        + f"; NVLink cliques {topo.topology_str}")
    hit = [g for g in gpus.values() if g.pci_address == torch_bus]
    if hit:
        gpu, how = hit[0], f"by its PCI bus id {torch_bus}"
    elif len(gpus) == 1 and not next(iter(gpus.values())).pci_address:
        gpu = next(iter(gpus.values()))
        how = (f"as the only GPU: this machine exposes no PCI bus id "
               f"(torch's is {torch_bus})")
    else:
        fail(f"no discovered GPU at torch's PCI bus id {torch_bus}")
    nvml_gpu = next((n for n in (nvml.gpus() if nvml else [])
                     if n.index == gpu.index), None)
    if gpu.uuid and gpu.uuid != torch_uuid:
        fail(f"discovered UUID {gpu.uuid} is not torch's {torch_uuid}")
    uuid_line = (f"UUID {gpu.uuid} = torch's" if gpu.uuid else
                 f"UUID not exposed (NVML answers "
                 f"{nvml_gpu.uuid if nvml_gpu else None!r}; torch's is "
                 f"{torch_uuid})")
    mem_rel = abs(gpu.memory_bytes - props.total_memory) / props.total_memory
    if mem_rel > 0.01:
        fail(f"discovered memory {gpu.memory_bytes} is not within 1% of "
             f"torch's {props.total_memory}")
    if gpu.name and gpu.name != torch_name:
        fail(f"discovered name {gpu.name!r} is not torch's {torch_name!r}")
    if topo.spec is None:
        fail(f"no spec-table entry for device id {gpu.device_id!r}, "
             f"name {gpu.name!r}")
    if not gpu.dev_path or not os.path.exists(gpu.dev_path):
        fail(f"no device node for minor {gpu.minor}")
    say(f"discovered torch's device 0 {how}: {gpu.id}, {uuid_line}; "
        f"name {gpu.name!r}, device id {gpu.device_id or 'not exposed'}, "
        f"memory {gpu.memory_bytes} bytes against torch's "
        f"{props.total_memory} ({mem_rel:.4%}), NUMA node {gpu.numa_node}, "
        f"{len(gpu.nvlinks)} active NVLinks, node {gpu.dev_path}; spec "
        f"{topo.spec.product} ({topo.spec.sm_count} SMs against torch's "
        f"{props.multi_processor_count})")
    if topo.spec.sm_count != props.multi_processor_count:
        fail("the spec table's SM count is not torch's")

    # 3. the gpuprobe shim on the real node
    t0 = time.perf_counter()
    rc = gpuprobe.probe_device_node(gpu.dev_path)
    major = gpuprobe.char_device_major(gpu.dev_path)
    say(f"gpuprobe {gpuprobe.version()} (built and loaded in "
        f"{time.perf_counter() - t0:.2f} s): probe {gpu.dev_path} -> {rc}, "
        f"char major {major}")
    if rc != 0 or major != constants.NVIDIA_CHAR_MAJOR:
        fail(f"{gpu.dev_path} is not a char device of major "
             f"{constants.NVIDIA_CHAR_MAJOR}")

    work = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    kubelet_dir = os.path.join(work, "device-plugins")
    os.makedirs(kubelet_dir)
    sock = os.path.join(work, "exporter.sock")
    exporter = GpuHealthServer(sock, nvml=nvml).start()
    kubelet = _StubKubelet(kubelet_dir)
    manager = channel = call = None
    try:
        # 6 (first half). the port's health server reports the card Healthy
        health = get_gpu_health(sock, timeout_s=5.0)
        if health.get(gpu.id) != constants.HEALTHY:
            fail(f"the health server reports {health}")
        # 4. the plugin end to end
        impl = GpuContainerImpl(
            nvml=nvml, probe_watchdog_s=DP_WATCHDOG_S,
            health_fn=functools.partial(get_gpu_health, sock,
                                        timeout_s=5.0))
        manager = PluginManager(impl, pulse_seconds=DP_PULSE_S,
                                kubelet_dir=kubelet_dir,
                                kubelet_watch_interval_s=0.1)
        manager.run(block=False)
        if not kubelet.registered.wait(30):
            fail("the plugin did not register with the stub kubelet")
        reg = kubelet.requests[0]
        if (reg.resource_name != "nvidia.com/gpu"
                or reg.version != constants.KUBELET_DP_VERSION
                or not reg.options.get_preferred_allocation_available):
            fail(f"unexpected registration {reg}")
        channel = grpc.insecure_channel(
            f"unix://{os.path.join(kubelet_dir, reg.endpoint)}")
        stub = pb_grpc.DevicePluginStub(channel)
        call, frames = _frames(stub, pb)
        first = frames.get(timeout=30)
        dev = {d.ID: d for d in first.devices}.get(gpu.id)
        if (dev is None or dev.health != constants.HEALTHY
                or [n.ID for n in dev.topology.nodes] != [gpu.numa_node]):
            fail(f"ListAndWatch's first frame: {first}")
        pref = stub.GetPreferredAllocation(pb.PreferredAllocationRequest(
            container_requests=[pb.ContainerPreferredAllocationRequest(
                available_deviceIDs=list(impl.gpus), allocation_size=1)]))
        chosen = list(pref.container_responses[0].deviceIDs)
        alloc = stub.Allocate(pb.AllocateRequest(container_requests=[
            pb.ContainerAllocateRequest(devices_ids=[gpu.id])]))
        car = alloc.container_responses[0]
        mounts = [d.host_path for d in car.devices]
        controls = [os.path.join("/dev", n)
                    for n in constants.CONTROL_DEVICE_NODES
                    if os.path.exists(os.path.join("/dev", n))]
        visible = car.envs.get(constants.ENV_NVIDIA_VISIBLE_DEVICES)
        say(f"plugin: registered {reg.resource_name} at {reg.endpoint}; "
            f"first frame {[(d.ID, d.health, [n.ID for n in d.topology.nodes]) for d in first.devices]}; "
            f"preferred {chosen}; Allocate mounts {mounts}, "
            f"{constants.ENV_NVIDIA_VISIBLE_DEVICES}={visible}")
        if len(chosen) != 1 or chosen[0] not in impl.gpus:
            fail(f"GetPreferredAllocation answered {chosen}")
        if mounts != [gpu.dev_path] + controls:
            fail(f"Allocate mounted {mounts}, not {[gpu.dev_path] + controls}")
        if visible != gpu.visible_id or (gpu.uuid and visible != torch_uuid):
            fail(f"Allocate set {constants.ENV_NVIDIA_VISIBLE_DEVICES}="
                 f"{visible}")
        if constants.ENV_CUDA_VISIBLE_DEVICES in car.envs:
            fail("Allocate set CUDA_VISIBLE_DEVICES")

        # 6 (second half). the probe fault flips health and back
        faults.install(DP_PROBE_HANG)
        n_down = _await_health(frames, gpu.id, constants.UNHEALTHY, 2,
                               f"with {DP_PROBE_HANG} armed")
        faults.uninstall()
        n_up = _await_health(frames, gpu.id, constants.HEALTHY, 2,
                             "after disarming the probe fault")
        say(f"health: the server reports {health}; with {DP_PROBE_HANG} "
            f"armed (watchdog {DP_WATCHDOG_S} s) frame {n_down} after "
            f"arming read Unhealthy, and frame {n_up} after disarming "
            f"read Healthy (pulse {DP_PULSE_S} s)")
    finally:
        faults.uninstall()
        if call is not None:
            call.cancel()
        if channel is not None:
            channel.close()
        if manager is not None:
            manager.stop()
        kubelet.stop()
        exporter.stop()
        shutil.rmtree(work, ignore_errors=True)

    # 5. Allocate p50 / p99, on this host and on the 8-GPU fixture
    ctx = DevicePluginContext(constants.DEVICE_TYPE_GPU, None)
    host_us = allocate_us(impl, ctx, [gpu.id])
    fixture = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           DP_FIXTURE)
    fixture_impl = GpuContainerImpl(
        sysfs_root=os.path.join(fixture, "sys"),
        dev_root=os.path.join(fixture, "dev"),
        proc_root=os.path.join(fixture, "proc"),
        nvml=nvml_mod.load(os.path.join(fixture, "nvml.json")))
    fixture_us = allocate_us(fixture_impl, ctx, list(fixture_impl.gpus)[:4])
    say(f"Allocate p50 / p99: {host_us[0]:.2f} / {host_us[1]:.2f} us for 1 "
        f"GPU on this host; {fixture_us[0]:.2f} / {fixture_us[1]:.2f} us "
        f"for 4 of 8 on {DP_FIXTURE} (best of 5 rounds of 2000 after 500)")

    # 7. labels on the real host
    labels = generate_labels(LabelContext.collect(nvml=nvml))
    short = {k.split(".", 2)[-1]: v for k, v in labels.items()
             if k.startswith(constants.LABEL_PREFIX + ".")}
    say(f"labels: {short}")
    want = {"product-name": slug(torch_name),
            "driver-version": nvml.driver_version() if nvml else None}
    if nvml_gpu is not None and nvml_gpu.memory_total:
        want["memory"] = f"{nvml_gpu.memory_total // 2 ** 20}Mi"
    sys_version = "/sys/module/nvidia/version"
    if os.path.exists(sys_version):
        with open(sys_version) as f:
            want["driver-version"] = f.read().strip()
    if gpu.device_id:
        want["device-id"] = gpu.device_id
    for key, value in want.items():
        if value is not None and short.get(key) != value:
            fail(f"label {key}={short.get(key)!r}, want {value!r}")
    if "device-id" not in want and "device-id" in short:
        fail("a device-id label where no PCI id is exposed")

    # 8. the container contract: a child sees only the allocated GPU
    env = dict(os.environ)
    env.update(car.envs)
    env[constants.ENV_CUDA_VISIBLE_DEVICES] = visible
    out = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--worker", "container"],
        env=env, capture_output=True, text=True, timeout=600)
    lines = out.stdout.strip().splitlines()
    if out.returncode != 0 or not lines:
        fail(f"the container child failed ({out.returncode}):\n"
             f"{out.stdout[-2000:]}\n{out.stderr[-2000:]}")
    child = json.loads(lines[-1])
    say(f"container child with {constants.ENV_CUDA_VISIBLE_DEVICES}="
        f"{visible}: {child['devices']} device(s), UUID {child['uuid']}, "
        f"K4 {child['launches']} launch(es) on q {list(DP_CHILD_QUERY[0])} "
        f"bf16 causal: {child['held']}")
    if child["devices"] != 1 or child["uuid"] != torch_uuid \
            or not child["ok"] or child["launches"] < 1:
        fail(f"the container child saw {child}")

    # 9. the slice: two plugin processes, their ranks' children, a fault
    # on one member, and the survivor's reshape
    slice_result = slice_path(gpu, nvml, say)
    # 10. MIG and passthrough: what this machine exposes
    partitions = partitions_report(gpu, nvml_gpu, nvml, say)

    # the probe fault's hung call, if still asleep, ends within its 1 s
    deadline = time.monotonic() + 5
    while (threading.active_count() > threads
           and time.monotonic() < deadline):
        time.sleep(0.1)
    left = [t.name for t in threading.enumerate()
            if t is not threading.main_thread()]
    wall = time.perf_counter() - t_phase
    say(f"threads: {threads} before the agents, "
        f"{threading.active_count()} after their teardown {left}; "
        f"phase wall {wall:.1f} s")
    if threading.active_count() > threads:
        fail(f"the agents left threads running: {left}")
    print(json.dumps({"allocate_host_us": host_us,
                      "allocate_fixture_us": fixture_us,
                      "slice": slice_result, "partitions": partitions,
                      "wall_s": wall}), flush=True)
    return 0


def container_child() -> int:
    """``chip_smoke.py --worker container``: run with the Allocate
    response's env and CUDA_VISIBLE_DEVICES as the container runtime sets
    it: count the devices CUDA shows, and hold K4 on a small prefill
    against its plain version (bf16, 3e-2).  Prints one JSON line."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tpu_k8s_device_plugin_torch.workloads import flash_attention as fa

    n = torch.cuda.device_count()
    gen = torch.Generator(device="cuda").manual_seed(0)
    qs, tk, hkv = DP_CHILD_QUERY
    q, k, v, _ = _attention_inputs(torch, gen, qs, tk, hkv, torch.bfloat16)
    fa.flash_attention_cuda.launches = 0
    got = fa.flash_attention_cuda(q, k, v, True)
    want = fa.flash_attention_plain(q, k, v, True)
    torch.cuda.synchronize()
    held = _held_forward(torch, fa, got, want, q, k, v, True)
    print(json.dumps({
        "devices": n,
        "uuid": f"GPU-{torch.cuda.get_device_properties(0).uuid}",
        "launches": fa.flash_attention_cuda.launches,
        "held": _forward_line(held),
        "ok": not _forward_failed(held) and bool(torch.isfinite(got).all()),
    }), flush=True)
    return 0


class _FaultableHealth:
    """A member's health exporter (the health service on a unix socket,
    probing the real roots) whose GPU reads Unhealthy while ``fault`` is
    set: how a fault reported by one member's exporter looks to its
    plugin."""

    def __init__(self, socket_path, nvml, gpu_id):
        import concurrent.futures
        import threading

        import grpc

        from tpu_k8s_device_plugin_torch.health import probe_gpu_states
        from tpu_k8s_device_plugin_torch.proto import (
            tpuhealth_pb2 as hpb, tpuhealth_pb2_grpc as hpb_grpc)
        from tpu_k8s_device_plugin_torch.types import constants

        self.fault = threading.Event()
        outer = self

        class Servicer(hpb_grpc.TpuHealthServiceServicer):
            def List(self, request, context):  # noqa: N802 (gRPC API)
                states = probe_gpu_states(nvml=nvml)
                if outer.fault.is_set() and gpu_id in states:
                    states[gpu_id].health = constants.UNHEALTHY
                return hpb.ListTpuStateResponse(
                    states=[states[k] for k in sorted(states)])

        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=2)
        self._server = grpc.server(self._pool)
        hpb_grpc.add_TpuHealthServiceServicer_to_server(Servicer(),
                                                        self._server)
        self._server.add_insecure_port(f"unix://{socket_path}")
        self._server.start()

    def stop(self) -> None:
        self._server.stop(grace=0).wait()
        self._pool.shutdown(wait=True)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Member:
    """One slice member: the port's plugin CLI in a process of its own
    under *hostname*, its exporter and its stub kubelet here."""

    def __init__(self, hostname, work, rendezvous, master_port, nvml,
                 gpu_id):
        from tpu_k8s_device_plugin_torch.proto import (
            deviceplugin_pb2 as pb, deviceplugin_pb2_grpc as pb_grpc)

        self.pb, self.pb_grpc = pb, pb_grpc
        self.hostname = hostname
        d = os.path.join(work, hostname)
        os.makedirs(os.path.join(d, "device-plugins"))
        self.state_file = os.path.join(d, "membership.json")
        self.exporter = _FaultableHealth(os.path.join(d, "exporter.sock"),
                                         nvml, gpu_id)
        self.kubelet = _StubKubelet(os.path.join(d, "device-plugins"))
        argv = ["--kubelet-dir", self.kubelet.dir, "--pulse",
                str(DP_PULSE_S), "--exporter-socket",
                os.path.join(d, "exporter.sock"),
                "--slice-rendezvous", rendezvous, "--slice-workers",
                str(len(DP_SLICE_HOSTS)), "--slice-master-port",
                str(master_port), "--slice-reshape-grace",
                str(DP_SLICE_GRACE_S), "--slice-heartbeat-timeout",
                str(DP_SLICE_HEARTBEAT_TIMEOUT_S), "--slice-state-file",
                self.state_file]
        code = ("import socket, sys\n"
                f"sys.path.insert(0, {os.path.dirname(os.path.abspath(__file__))!r})\n"
                f"socket.gethostname = lambda: {hostname!r}\n"
                "from tpu_k8s_device_plugin_torch.cmd.device_plugin "
                "import main\n"
                f"sys.exit(main({argv!r}))")
        self.log = open(os.path.join(d, "plugin.log"), "w")
        self.proc = subprocess.Popen([sys.executable, "-c", code],
                                     stdout=self.log,
                                     stderr=subprocess.STDOUT)
        self.channel = self.call = self.frames = self.stub = None
        self._stopped = False

    def connect(self) -> None:
        import grpc

        if not self.kubelet.registered.wait(60):
            fail(f"slice member {self.hostname} did not register: "
                 f"{self.tail()}")
        reg = self.kubelet.requests[0]
        self.channel = grpc.insecure_channel(
            f"unix://{os.path.join(self.kubelet.dir, reg.endpoint)}")
        self.stub = self.pb_grpc.DevicePluginStub(self.channel)
        self.call, self.frames = _frames(self.stub, self.pb)

    def allocate(self, gpu_id) -> dict:
        pb = self.pb
        alloc = self.stub.Allocate(pb.AllocateRequest(container_requests=[
            pb.ContainerAllocateRequest(devices_ids=[gpu_id])]))
        return dict(alloc.container_responses[0].envs)

    def tail(self) -> str:
        self.log.flush()
        with open(self.log.name) as f:
            return f.read()[-3000:]

    def stop(self) -> None:
        if self._stopped:
            return
        self._stopped = True
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=15)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        if self.call is not None:
            self.call.cancel()
            self.call = None
        if self.channel is not None:
            self.channel.close()
            self.channel = None
        self.kubelet.stop()
        self.exporter.stop()
        self.log.close()


def _await_slice_health(members, gpu_id, want, what):
    """Frames on every member's stream until each reads *want*; returns
    the frames each took.  Fails past DP_SLICE_PULSES frames."""
    took = []
    for m in members:
        for n in range(1, DP_SLICE_PULSES + 1):
            frame = m.frames.get(timeout=DP_PULSE_S * 10 + 30)
            if isinstance(frame, Exception):
                fail(f"{m.hostname}'s ListAndWatch ended while {what}: "
                     f"{frame}")
            if {d.ID: d.health for d in frame.devices}.get(gpu_id) == want:
                took.append(n)
                break
        else:
            fail(f"{what}: {m.hostname}'s GPU did not read {want} within "
                 f"{DP_SLICE_PULSES} frames")
    return took


def _drain(q) -> None:
    import queue

    while True:
        try:
            q.get_nowait()
        except queue.Empty:
            return


def slice_path(gpu, nvml, say):
    """Phase 3's slice: two port plugin processes on this host form a
    2-member slice; each Allocates the card and the two envs must agree
    but for the rank; a child per rank initialises torch.distributed from
    its env alone and runs K4 on the card, meanwhile a fault on member 1
    demotes both members' devices and its clearing restores them, and
    stopping member 1 re-forms the survivor as generation 2, which its
    membership file, a fresh Allocate and a ReshapeSignal show."""
    import shutil
    import tempfile

    from tpu_k8s_device_plugin_torch.slice import load_membership
    from tpu_k8s_device_plugin_torch.types import constants
    from tpu_k8s_device_plugin_torch.workloads.checkpoint import (
        ReshapeSignal)

    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_slice_")
    rendezvous = f"{DP_SLICE_HOSTS[0]}:{_free_port()}"
    master_port = _free_port()
    members, children = [], []
    try:
        for host in DP_SLICE_HOSTS:
            members.append(_Member(host, work, rendezvous, master_port,
                                   nvml, gpu.id))
        for m in members:
            m.connect()
        # the slice forms within a few pulses of both registering
        envs = [{} for _ in members]
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and not all(
                constants.ENV_RANK in e for e in envs):
            envs = [m.allocate(gpu.id) for m in members]
            if not all(constants.ENV_RANK in e for e in envs):
                time.sleep(0.2)
        formed_s = time.perf_counter() - t0
        if not all(constants.ENV_RANK in e for e in envs):
            fail("the slice did not form within 60 s: "
                 + " | ".join(m.tail() for m in members))
        keys = (constants.ENV_MASTER_ADDR, constants.ENV_MASTER_PORT,
                constants.ENV_WORLD_SIZE, constants.ENV_PET_NNODES,
                constants.ENV_SLICE_WORKER_HOSTNAMES,
                constants.ENV_TPU_SLICE_GENERATION)
        if any(envs[0][k] != envs[1][k] for k in keys):
            fail(f"the members' slice envs disagree: {envs}")
        want = {constants.ENV_MASTER_ADDR: DP_SLICE_HOSTS[0],
                constants.ENV_MASTER_PORT: str(master_port),
                constants.ENV_WORLD_SIZE: "2",
                constants.ENV_TPU_SLICE_GENERATION: "1"}
        for rank, env in enumerate(envs):
            got = {k: env.get(k) for k in want}
            if got != want or env[constants.ENV_RANK] != str(rank) \
                    or env[constants.ENV_PET_NODE_RANK] != str(rank):
                fail(f"member {rank}'s slice env: {env}")
        say(f"slice: formed in {formed_s:.1f} s from the members' start; "
            f"Allocate envs agree but for the rank: "
            + ", ".join(f"{k}={envs[0][k]}" for k in keys)
            + f"; RANK {envs[0][constants.ENV_RANK]} and "
            f"{envs[1][constants.ENV_RANK]}")

        # a child per rank, each with its own Allocate env alone (gloo,
        # because NCCL refuses two ranks on one GPU); they run while the
        # fault and the reshape below are driven
        for env in envs:
            child_env = dict(os.environ)
            for k in keys + (constants.ENV_RANK,
                             constants.ENV_PET_NODE_RANK,
                             constants.ENV_NVIDIA_VISIBLE_DEVICES):
                child_env.pop(k, None)
            child_env.update(env)
            child_env[constants.ENV_CUDA_VISIBLE_DEVICES] = env[
                constants.ENV_NVIDIA_VISIBLE_DEVICES]
            children.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--worker",
                 "rank"], env=child_env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        # a fault on member 1: both members' devices read Unhealthy, and
        # Healthy again once it clears
        for m in members:
            _drain(m.frames)
        t_fault = time.perf_counter()
        members[1].exporter.fault.set()
        down = _await_slice_health(members, gpu.id, constants.UNHEALTHY,
                                   "member 1 faulty")
        down_s = time.perf_counter() - t_fault
        members[1].exporter.fault.clear()
        t_clear = time.perf_counter()
        up = _await_slice_health(members, gpu.id, constants.HEALTHY,
                                 "member 1's fault cleared")
        up_s = time.perf_counter() - t_clear
        say(f"slice: a fault on member 1's GPU read Unhealthy on both "
            f"members after {down} frames ({down_s:.1f} s), Healthy "
            f"again after {up} ({up_s:.1f} s); pulse {DP_PULSE_S} s")

        # member 1 stops: the survivor re-forms as generation 2
        signal = ReshapeSignal(members[0].state_file, generation=1)
        t_stop = time.perf_counter()
        members[1].stop()
        deadline = time.monotonic() + (DP_SLICE_HEARTBEAT_TIMEOUT_S
                                       + DP_SLICE_GRACE_S + 30)
        m2 = load_membership(members[0].state_file)
        while time.monotonic() < deadline and (m2 is None
                                               or m2.generation < 2):
            time.sleep(0.2)
            m2 = load_membership(members[0].state_file)
        reshape_s = time.perf_counter() - t_stop
        if m2 is None or m2.generation != 2 \
                or m2.hostnames != (DP_SLICE_HOSTS[0],) or not m2.degraded:
            fail(f"the survivor did not re-form as generation 2: {m2}")
        fired = signal.check()
        if fired is None or fired.generation != 2:
            fail(f"a ReshapeSignal on the membership file gave {fired}")
        env2 = members[0].allocate(gpu.id)
        if (env2.get(constants.ENV_WORLD_SIZE),
                env2.get(constants.ENV_RANK),
                env2.get(constants.ENV_TPU_SLICE_GENERATION)) != (
                    "1", "0", "2"):
            fail(f"the survivor's Allocate env after the reshape: {env2}")
        say(f"slice: member 1 stopped; the survivor re-formed as "
            f"generation 2 ({m2.slice_id}, reshaped from "
            f"{list(m2.reshaped_from)}, degraded) {reshape_s:.1f} s later "
            f"(heartbeat timeout {DP_SLICE_HEARTBEAT_TIMEOUT_S} s, grace "
            f"{DP_SLICE_GRACE_S} s); its membership file and a "
            f"ReshapeSignal show it, and Allocate now gives WORLD_SIZE 1")
        # the rank children ran meanwhile
        ranks = []
        for c in children:
            out, err = c.communicate(timeout=600)
            lines = out.strip().splitlines()
            if c.returncode != 0 or not lines:
                fail(f"a rank child failed ({c.returncode}):\n"
                     f"{out[-2000:]}\n{err[-3000:]}")
            ranks.append(json.loads(lines[-1]))
        for i, r in enumerate(ranks):
            if r["rank"] != i or r["world"] != 2 or not r["ok"] \
                    or r["launches"] < 1:
                fail(f"rank child {i} saw {r}")
        say("slice: rank children from the Allocate env alone "
            "(torch.distributed env://, gloo): "
            + "; ".join(f"rank {r['rank']} of {r['world']}, K4 "
                        f"{r['launches']} launch(es) on q "
                        f"{list(DP_CHILD_QUERY[0])} bf16 causal: "
                        f"{r['held']}" for r in ranks)
            + f"; all-reduced max_abs_err {ranks[0]['all_max_abs_err']:.3e}")
    finally:
        for c in children:
            if c.poll() is None:
                c.kill()
                c.communicate()
        for m in members:
            m.stop()
        shutil.rmtree(work, ignore_errors=True)
    wall = time.perf_counter() - t0
    say(f"slice: {wall:.1f} s in all")
    return dict(formed_s=formed_s, frames_down=down, frames_up=up,
                down_s=down_s, up_s=up_s, reshape_s=reshape_s,
                all_max_abs_err=ranks[0]["all_max_abs_err"], wall_s=wall)


def partitions_report(gpu, nvml_gpu, nvml, say):
    """MIG and passthrough as this machine exposes them: the card's MIG
    mode from NVML, what vfio-pci holds, the driver type autodetect
    picks; where MIG is on, one MIG device allocated and K4 run in a
    child that sees only it."""
    from tpu_k8s_device_plugin_torch.cmd.device_plugin import (
        build_parser, select_device_impl)
    from tpu_k8s_device_plugin_torch.gpu.device_impl import (
        GpuContainerImpl)
    from tpu_k8s_device_plugin_torch.proto import deviceplugin_pb2 as pb
    from tpu_k8s_device_plugin_torch.types import (
        DevicePluginContext, constants)

    mig = nvml_gpu.mig_mode if nvml_gpu is not None else ""
    vfio_dir = "/sys/bus/pci/drivers/vfio-pci"
    vfio = (sorted(e for e in os.listdir(vfio_dir) if ":" in e)
            if os.path.isdir(vfio_dir) else None)
    args = build_parser().parse_args([])
    impl, driver_type = select_device_impl(args, nvml)
    say(f"partitions: MIG mode {mig or 'not reported'}; {vfio_dir} "
        f"{'absent' if vfio is None else vfio}; autodetect picks "
        f"{driver_type} ({impl.get_resource_names()})")
    if driver_type != constants.CONTAINER:
        fail(f"autodetect picked {driver_type} on a container host")
    out = dict(mig_mode=mig, vfio_pci=vfio, driver_type=driver_type)
    if mig != "enabled" or not gpu.mig:
        say("partitions: MIG is off on this card (turning it on needs "
            "root and a GPU reset) and nothing is bound to vfio-pci, so "
            "MIG and passthrough are held on fixtures only")
        return out
    mixed = GpuContainerImpl(
        nvml=nvml,
        resource_naming_strategy=constants.RESOURCE_NAMING_STRATEGY_MIXED)
    resource = [r for r in mixed.get_resource_names() if r.startswith(
        constants.DEVICE_TYPE_MIG_PREFIX)][0]
    ctx = DevicePluginContext(resource, None)
    dev_id = mixed.enumerate(ctx)[0].ID
    car = mixed.allocate(ctx, pb.AllocateRequest(container_requests=[
        pb.ContainerAllocateRequest(devices_ids=[dev_id])
    ])).container_responses[0]
    visible = car.envs[constants.ENV_NVIDIA_VISIBLE_DEVICES]
    env = dict(os.environ)
    env[constants.ENV_CUDA_VISIBLE_DEVICES] = visible
    res = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--worker",
         "container"], env=env, capture_output=True, text=True, timeout=600)
    lines = res.stdout.strip().splitlines()
    if res.returncode != 0 or not lines:
        fail(f"the MIG child failed ({res.returncode}):\n{res.stderr[-2000:]}")
    child = json.loads(lines[-1])
    if child["devices"] != 1 or not child["ok"] or child["launches"] < 1:
        fail(f"the MIG child saw {child}")
    say(f"partitions: {resource} device {dev_id} ({visible}): mounts "
        f"{[d.host_path for d in car.devices]}; K4 in a child: "
        f"{child['held']}")
    out.update(mig_device=dev_id, mig_child=child)
    return out


def rank_child() -> int:
    """``chip_smoke.py --worker rank``: one rank of the slice, started
    with its Allocate env alone: ``torch.distributed`` initialises from
    it (env://, gloo: NCCL refuses two ranks on one GPU), K4 runs on the
    card at DP_CHILD_QUERY against its plain version, and the ranks
    all-reduce their largest error.  Prints one JSON line."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tpu_k8s_device_plugin_torch.workloads import flash_attention as fa

    dist.init_process_group("gloo", init_method="env://")
    try:
        gen = torch.Generator(device="cuda").manual_seed(0)
        qs, tk, hkv = DP_CHILD_QUERY
        q, k, v, _ = _attention_inputs(torch, gen, qs, tk, hkv,
                                       torch.bfloat16)
        fa.flash_attention_cuda.launches = 0
        got = fa.flash_attention_cuda(q, k, v, True)
        want = fa.flash_attention_plain(q, k, v, True)
        torch.cuda.synchronize()
        held = _held_forward(torch, fa, got, want, q, k, v, True)
        err = torch.tensor([held["max_abs_err"]], dtype=torch.float64)
        dist.all_reduce(err, op=dist.ReduceOp.MAX)
        result = {
            "rank": dist.get_rank(), "world": dist.get_world_size(),
            "launches": fa.flash_attention_cuda.launches,
            "held": _forward_line(held),
            "all_max_abs_err": float(err[0]),
            "ok": not _forward_failed(held)
            and bool(torch.isfinite(got).all()),
        }
    finally:
        dist.destroy_process_group()
    print(json.dumps(result), flush=True)
    return 0


# the multi-device phase: MD_RANKS gloo ranks on the one card (NCCL
# refuses two ranks on one GPU); the ring at Llama-3-8B's attention on
# the LM training call's sequence (q [1, 8192, 32, 128], K/V 8 heads,
# repeated to 32 for the flash impl), causal, in every impl and layout;
# the data x model AlexNet on a (2, 2) mesh at the training phase's size
# (224 px, 1000 classes, s2d, bf16, global batch 1024, pool pallas), 3
# steps against the single-device step; and one NCCL rank running
# bench_main --sharded under torchrun's env
MD_RANKS, MD_QUERY = 4, ((1, LM_SEQ, 32, 128), 8)
MD_RING = (("einsum", "contiguous"), ("einsum", "zigzag"),
           ("flash", "contiguous"), ("flash", "zigzag"))
# the reference tests' bf16 bars for ring attention: outputs 3e-2,
# gradients 6e-2 (x (block rms + |want|), by blocks of 64 rows)
MD_TOL = {"o": 3e-2, "grad": 6e-2}
MD_MESH, MD_ALEX_BATCH, MD_ALEX_STEPS = (2, 2), 1024, 3
# the sharded step against the single-device one, in bf16 compute: the
# batch split and the column split change GEMM shapes (and cuBLAS's and
# cuDNN's algorithms), and a Dense input's gradient is summed from two
# bf16 partials.  Each loss within 1e-4 relative (readings up to 1.6e-5);
# every parameter's change over the steps in relative norm, the Dense
# layers' within 5e-2 (the bf16 gradient bar), the conv layers' within
# 1e-1 (their gradients pass through four more bf16 backward layers:
# 3.1e-2-5.6e-2 in a CPU rehearsal at 64 px, batch 128).  A model-axis
# all-reduce or a data average left out reads 0.7-1.2 on every conv
# parameter and 3.6e-3-2.4e-2 on the losses in that rehearsal.
MD_LOSS_REL = 1e-4
MD_UPDATE_REL = {"Conv": 1e-1, "Dense": 5e-2}
MD_NCCL_ARGS = ("--sharded", "--pool", "pallas", "--batch", "256",
                "--steps", "3", "--warmup", "1")
MD_TIMEOUT_S = 480


def _md_zero(fa, mp) -> None:
    for w in (fa.flash_attention_cuda, fa.flash_attention_dq_cuda,
              fa.flash_attention_dkv_cuda, mp.max_pool_fwd_cuda,
              mp.max_pool_bwd_cuda):
        w.launches = 0
        for mode in getattr(w, "modes", {}):
            w.modes[mode] = 0


def _md_ring(torch, dist, fa, mp, ra, transformer, say):
    """This rank's part of the ring: every impl and layout, causal, on the
    whole sequence made alike on every rank; rank 0 holds the gathered
    output and gradients against the single-device flash attention (K4;
    K4 with its lse, K5 and K6 under autograd).  Returns the launches of
    each run and whether all held."""
    rank, n = dist.get_rank(), dist.get_world_size()
    gen = torch.Generator(device="cuda").manual_seed(16)
    qs, hkv = MD_QUERY
    q, k, v, do = _attention_inputs(torch, gen, qs, qs[1], hkv,
                                    torch.bfloat16)
    kr, vr = (transformer.repeat_kv(x, qs[2]) for x in (k, v))
    refs = {}
    if rank == 0:
        for name, (kk, vv) in (("einsum", (k, v)), ("flash", (kr, vr))):
            leaves = [x.detach().requires_grad_() for x in (q, kk, vv)]
            grads = torch.autograd.grad(
                fa.flash_attention(*leaves, causal=True), leaves, do)
            refs[name] = (fa.flash_attention_cuda(q, kk, vv, True), grads)
    ok, launches = True, {}
    for impl, layout in MD_RING:
        kk, vv = (k, v) if impl == "einsum" else (kr, vr)
        fn, sharding = ra.make_ring_attention(None, causal=True,
                                              layout=layout, impl=impl)
        zz = layout == "zigzag"
        order = (lambda x: ra.zigzag_permute(x, n)) if zz else (lambda x: x)
        back = (lambda x: ra.zigzag_unpermute(x, n)) if zz \
            else (lambda x: x)
        ql, kl, vl = (sharding.scatter(order(x)).requires_grad_()
                      for x in (q, kk, vv))
        dol = sharding.scatter(order(do))
        dist.barrier()
        torch.cuda.synchronize()
        _md_zero(fa, mp)
        t0 = time.perf_counter()
        out = fn(ql, kl, vl)
        grads = torch.autograd.grad(out, (ql, kl, vl), dol)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {"K4": fa.flash_attention_cuda.launches,
               "K5_f32out": fa.flash_attention_dq_cuda.modes["f32out"],
               "K6_f32out": fa.flash_attention_dkv_cuda.modes["f32out"],
               "K5_bf16": fa.flash_attention_dq_cuda.modes["bf16"],
               "K6_bf16": fa.flash_attention_dkv_cuda.modes["bf16"]}
        # blocks a rank runs: contiguous causal, r + 1; zig-zag, the
        # diagonal step's 3 tiles and 1 a step after; einsum, none
        blocks = 0 if impl == "einsum" else (
            rank + 1 if layout == "contiguous" else 3 + (n - 1))
        want = {"K4": blocks, "K5_f32out": blocks, "K6_f32out": blocks,
                "K5_bf16": 0, "K6_bf16": 0}
        name = f"{impl}-{layout}"
        launches[name] = got
        say(f"ring {name} rank {rank}: forward and backward {wall:.3f} s "
            f"(4 ranks time-slice the card); launches {got}, expected "
            f"{want}")
        ok = ok and got == want
        whole = [back(sharding.gather(x)) for x in (out.detach(), *grads)]
        if rank == 0:
            want_o, want_g = refs[impl]
            held = {"o": _held(torch, whole[0], want_o, MD_TOL["o"],
                               BLOCK_REL["bfloat16"])}
            for gname, g, w in zip(("dq", "dk", "dv"), whole[1:], want_g):
                held[gname] = _held(torch, g, w, MD_TOL["grad"],
                                    BLOCK_REL["bfloat16"])
            say(f"ring {name}: q {list(qs)} kv {list(kk.shape)} bf16 causal "
                f"over {n} ranks against the single-device flash attention: "
                + ", ".join(_held_line(hn, r) for hn, r in held.items())
                + f" (o {MD_TOL['o']}, gradients {MD_TOL['grad']} x (block "
                f"rms + |want|); block bar {BLOCK_REL['bfloat16']})")
            ok = ok and not any(r["mismatches"] for r in held.values())
        del out, grads, whole, ql, kl, vl, dol
        torch.cuda.empty_cache()
    return launches, ok


def _md_alexnet(torch, dist, alexnet, parallel, fa, mp, say):
    """This rank's part of the (2, 2) AlexNet: rank 0 runs the
    single-device step first on the same weights and batch; then every
    rank runs the sharded step, and rank 0 holds its losses and every
    gathered parameter against the single-device ones."""
    rank = dist.get_rank()
    gen = torch.Generator(device="cuda").manual_seed(0)
    images, labels = alexnet.synthetic_batch(gen, MD_ALEX_BATCH, s2d=True)
    ref = None
    if rank == 0:
        model, opt = alexnet.create_train_state(seed=0, s2d=True,
                                                pool="pallas", device="cuda")
        w0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
        losses = [float(alexnet.train_step(model, opt, images, labels))
                  for _ in range(MD_ALEX_STEPS)]
        ref = (losses, w0, {k: v.detach().clone()
                            for k, v in model.state_dict().items()})
        del model, opt
        torch.cuda.empty_cache()
    dist.barrier()
    mesh = parallel.make_mesh(model_parallel=MD_MESH[1], device="cuda")
    model, opt = alexnet.create_train_state(seed=0, s2d=True, pool="pallas",
                                            device="cuda")
    step, model, opt, (img_sh, lbl_sh) = parallel.make_sharded_train_step(
        model, opt, mesh)
    x, y = img_sh.local(images), lbl_sh.local(labels)
    del images, labels
    torch.cuda.synchronize()
    _md_zero(fa, mp)
    t0 = time.perf_counter()
    losses = [float(step(x, y)) for _ in range(MD_ALEX_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {"K1": mp.max_pool_fwd_cuda.launches,
           "K2": mp.max_pool_bwd_cuda.launches}
    want = {"K1": 3 * MD_ALEX_STEPS, "K2": 3 * MD_ALEX_STEPS}
    shape = parallel.mesh_shape(mesh)
    say(f"alexnet (2, 2) rank {rank} (data {mesh.get_local_rank('data')}, "
        f"model {mesh.get_local_rank('model')}): local batch {x.shape[0]}, "
        f"{MD_ALEX_STEPS} steps in {wall:.3f} s; launches {got}, expected "
        f"{want}")
    ok = got == want and shape == {"data": MD_MESH[0], "model": MD_MESH[1]}
    full = parallel.gather_params(model, mesh)
    if rank == 0:
        ref_losses, w0, w3 = ref
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
        upd = {k: float((full[k] - w3[k]).norm() / (w3[k] - w0[k]).norm())
               for k in w3}
        say(f"alexnet {shape} mesh, global batch {MD_ALEX_BATCH}, pool "
            f"pallas: losses {losses} against the single-device step's "
            f"{ref_losses} (relative differences {[f'{r:.3e}' for r in rel]}"
            f", limit {MD_LOSS_REL}); every gathered parameter after "
            f"{MD_ALEX_STEPS} steps, |w - w_single| / |w_single - w_0|: "
            + ", ".join(f"{k} {u:.3e}" for k, u in upd.items())
            + f" (limits {MD_UPDATE_REL})")
        ok = ok and max(rel) <= MD_LOSS_REL and all(
            math.isfinite(u) and u <= MD_UPDATE_REL[k.split("_")[0]]
            for k, u in upd.items()) \
            and all(math.isfinite(v) for v in losses)
    return got, ok


# item 6.3 on the card, in the same children: the LM mesh at Llama-3-8B's
# widths (meta-llama/Meta-Llama-3-8B; 1 layer: the depth cut, the widths
# full) on (data 1, expert 1, seq 2, model 2), zig-zag ring, batch 1 x
# 4096; at Mixtral-8x7B's (MIXTRAL, 1 layer) on (data 1, expert 2, seq 1,
# model 2), batch 2 x 4096, local attention; each one step from seed 0
# against the single-device lm_train_step on the same weights and batch,
# run alone on the card first (its f32 weights, gradients and Adam
# moments do not fit beside the ranks').  In bf16 compute (the LM path;
# Llama-3-8B's widths) the loss is held at the reference test's 2e-2; in
# f32 compute (both) also the gathered updates and gradients (Adam's
# first moment after one step, 0.1 g) of the leaves in MD_LM_KEEP, at
# MD_LM_REL in relative norm: in bf16 Adam's first update is about
# lr * sign(g), and rounding flips the sign of near-zero gradient
# entries (bf16 updates 9.0e-2-3.3e-1 from the single-device step's at
# these widths, gradients 7.2e-3-6.4e-2; f32 updates 6.8e-5-7.3e-4,
# gradients 2.7e-6-7.0e-6 on this card)
LLAMA3_8B_WIDTHS = dict(vocab=128256, d_model=4096, n_heads=32,
                        n_kv_heads=8, d_ff=14336, ffn="swiglu",
                        rope_theta=500000.0)
MD_LM = (
    ("llama3-8b", dict(LLAMA3_8B_WIDTHS, n_layers=1), (1, 2, 2),
     dict(batch=1, seq_len=4096, seq_axis="seq", attn_layout="zigzag"),
     ("bfloat16", "float32")),
    ("mixtral", dict(MIXTRAL, n_layers=1), (2, 1, 2),
     dict(batch=2, seq_len=4096, seq_axis=None), ("float32",)),
)
MD_LM_KEEP = {
    "llama3-8b": ("block_0.qkv.weight", "block_0.out_proj.weight",
                  "block_0.mlp_down.weight", "lm_head.weight"),
    "mixtral": ("block_0.qkv.weight", "block_0.out_proj.weight",
                "block_0.moe.experts_down", "lm_head.weight"),
}
MD_LM_LR, MD_LM_LOSS_RTOL, MD_LM_REL = 1e-3, 2e-2, 5e-2
# each rank's expert stacks at Mixtral's widths on expert 2 x model 2
MD_MOE_LOCAL = {"block_0.moe.experts_up": (4, 4096, 7168),
                "block_0.moe.experts_down": (4, 7168, 4096)}
# GPipe: 4 Llama-3-8B blocks (f32 parameters, flash attention) over 4
# pipe stages, 1 a stage (2 until PR 18: a depth cut to pay for the
# tensor-parallel arm), 4 microbatches of [1, 2048, 4096] bf16, forward
# and backward (a seeded cotangent) against the same blocks run one after
# another on one rank: the forward within 1e-5 (and whether it is
# bit-equal), each gathered gradient within 1e-4 in relative norm
MD_PIPE_LAYERS, MD_PIPE_MICRO, MD_PIPE_MB = 4, 4, (1, 2048)
MD_PIPE_FWD, MD_PIPE_GRAD = 1e-5, 1e-4


@contextlib.contextmanager
def _compute_dtype(transformer, dtype):
    """``make_lm_train_step`` building its model in *dtype* compute, for
    the f32 arm (``make_lm_train_step`` takes the reference's arguments,
    and so no dtype of its own)."""
    import functools

    orig = transformer.TransformerLM
    transformer.TransformerLM = functools.partial(orig, dtype=dtype)
    try:
        yield
    finally:
        transformer.TransformerLM = orig


def _gather0(torch, dist, sh, local):
    """The whole tensor of *local* pieces under the ``parallel.Sharding``
    *sh*, on rank 0's host (None on the others).  Only the ranks at
    rank 0's place on every axis the tensor is not split on send their
    piece, once: the others hold copies, and ``sh.gather`` would give
    every rank every piece."""
    rank = dist.get_rank()
    grid, names = sh.mesh.mesh, sh.mesh.mesh_dim_names
    split = [(d, a if isinstance(a, tuple) else (a,))
             for d, a in enumerate(sh.spec) if a is not None]
    split_axes = {a for _, axes in split for a in axes}

    def coord(r):
        return dict(zip(names, (grid == r).nonzero()[0].tolist()))

    owners = [r for r in grid.flatten().tolist()
              if all(c == 0 for a, c in coord(r).items()
                     if a not in split_axes)]
    local = local.detach().to("cpu").contiguous()
    if rank != 0:
        if rank in owners:
            dist.send(local, dst=0)
        return None
    sizes = dict(zip(names, grid.shape))
    shape = list(local.shape)
    for d, axes in split:
        shape[d] *= math.prod(sizes[a] for a in axes)
    full = torch.empty(shape, dtype=local.dtype)
    for r in owners:
        piece = local
        if r != 0:
            piece = torch.empty_like(local)
            dist.recv(piece, src=r)
        at = coord(r)
        idx = [slice(None)] * len(shape)
        for d, axes in split:
            i = 0
            for a in axes:
                i = i * sizes[a] + at[a]
            idx[d] = slice(i * local.shape[d], (i + 1) * local.shape[d])
        full[tuple(idx)] = piece
    return full


def _rel(torch, got, want, base=None) -> float:
    """``|got - want| / |want - base|`` (or ``/ |want|``), in f32 norms."""
    ref = want if base is None else want - base
    return float((got - want).float().norm() / ref.float().norm())


def _md_lm_arm(torch, dist, transformer, bench_serving, name, cfg, shape,
               kw, dtype, say):
    """One LM mesh arm: rank 0 runs the single-device step alone first;
    then every rank runs the sharded step, and rank 0 holds its loss (and
    in f32 its gathered updates and gradients) against it.  Returns the
    arm's figures and whether they held."""
    rank = dist.get_rank()
    keep = MD_LM_KEEP[name]
    ref = None
    if rank == 0:
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        model = transformer.TransformerLM(device="cuda", dtype=dtype, **cfg)
        bench_serving.random_init_(model, 0)
        gen = torch.Generator(device="cuda").manual_seed(0)
        batch = transformer.synthetic_lm_batch(gen, kw["batch"],
                                               kw["seq_len"], cfg["vocab"])
        params = dict(model.named_parameters())

        def host(x):
            return x.detach().to("cpu", copy=True)

        w0 = {k: host(params[k]) for k in keep}
        opt = torch.optim.Adam(model.parameters(), lr=MD_LM_LR,
                               foreach=False)
        loss = float(transformer.lm_train_step(model, opt, *batch))
        ref = (loss, w0, {k: host(params[k]) for k in keep},
               {k: host(opt.state[params[k]]["exp_avg"]) for k in keep},
               torch.cuda.max_memory_allocated(), time.perf_counter() - t0)
        del model, opt, params, batch
        _fresh(torch)
    dist.barrier()
    e, s, m = shape
    t_build = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    mesh = transformer.make_lm_mesh(seq=s, model=m, expert=e)
    with _compute_dtype(transformer, dtype):
        step, state, place = transformer.make_lm_train_step(
            mesh, learning_rate=MD_LM_LR, **cfg, **kw)
    placed = place(*state["batch"])
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t_build = t0 - t_build
    loss = float(step(*placed))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    model, sh, opt = state["model"], state["shardings"], state["opt"]
    params = dict(model.named_parameters())
    local = {k: tuple(p.shape) for k, p in params.items()}
    got = {k: tuple(_gather0(torch, dist, sh[k], x) for x in (
        params[k], opt.state[params[k]]["exp_avg"])) for k in keep}
    t_gather = time.perf_counter() - t0 - wall
    tag = f"{name} {'f32' if dtype == torch.float32 else 'bf16'}"
    say(f"lm mesh {tag} rank {rank} ({dict(zip(mesh.mesh_dim_names, mesh.shape))}"
        f"): build {t_build:.1f} s, one step {wall:.3f} s (4 ranks "
        f"time-slice the card, gloo stages through the host), gathers "
        f"{t_gather:.1f} s, peak {peak / 2**30:.2f} GiB; "
        f"local {', '.join(f'{k} {list(local[k])}' for k in keep)}")
    ok = math.isfinite(loss)
    if name == "mixtral":
        ok = ok and all(local[k] == v for k, v in MD_MOE_LOCAL.items())
    result = {"loss": loss, "wall_s": wall, "peak_gib": peak / 2**30}
    del state, step, model, opt, params, placed
    _fresh(torch)
    if rank == 0:
        t_cmp = time.perf_counter()
        want, w0, w1, m1, ref_peak, ref_wall = ref
        rel_loss = abs(loss - want) / abs(want)
        upd = {k: _rel(torch, got[k][0], w1[k], w0[k]) for k in keep}
        grad = {k: _rel(torch, got[k][1], m1[k]) for k in keep}
        held = dtype == torch.float32
        say(f"lm mesh {tag}: {cfg['n_layers']} layer at full width, batch "
            f"{kw['batch']} x {kw['seq_len']}: loss {loss:.6f} against the "
            f"single-device step's {want:.6f} (relative {rel_loss:.3e}, "
            f"limit {MD_LM_LOSS_RTOL}; that step {ref_wall:.1f} s with its "
            f"init, peak {ref_peak / 2**30:.2f} GiB alone); gathered "
            f"updates |w - w_single| / |w_single - w_0|: "
            + ", ".join(f"{k} {v:.3e}" for k, v in upd.items())
            + "; gradients (Adam's first moment): "
            + ", ".join(f"{k} {v:.3e}" for k, v in grad.items())
            + (f" (limit {MD_LM_REL})" if held else
               " (bf16: reported, not held)"))
        ok = ok and rel_loss <= MD_LM_LOSS_RTOL
        if held:
            ok = ok and all(v <= MD_LM_REL for v in (*upd.values(),
                                                     *grad.values()))
        result.update(rel_loss=rel_loss, updates=upd, gradients=grad)
        say(f"lm mesh {tag}: comparison {time.perf_counter() - t_cmp:.1f} s")
    return result, ok


def _md_lm(torch, dist, transformer, bench_serving, say):
    """The LM mesh arms of MD_LM, each printing its wall time."""
    out, ok = {}, True
    for name, cfg, shape, kw, dtypes in MD_LM:
        for dtype in dtypes:
            t0 = time.perf_counter()
            r, good = _md_lm_arm(torch, dist, transformer, bench_serving,
                                 name, cfg, shape, kw,
                                 getattr(torch, dtype), say)
            r["arm_s"] = time.perf_counter() - t0
            say(f"lm mesh {name} {dtype}: arm wall {r['arm_s']:.1f} s (the "
                "single-device step, the sharded build and step, the "
                "gathers and the comparison)")
            out[f"{name}-{dtype}"] = r
            ok = ok and good
    return out, ok


def _md_pipeline(torch, dist, transformer, pipeline, parallel,
                 bench_serving, fa, mp, say):
    """GPipe over the 4 ranks: rank 0 runs the blocks one after another
    first (each microbatch forward and backward alone), then every rank
    runs the pipeline; rank 0 holds the pipeline's output and gathered
    gradients against its own.  Returns the launches of each rank's
    stage and whether all held."""
    from torch.distributed.device_mesh import DeviceMesh

    t_arm = time.perf_counter()
    rank, n = dist.get_rank(), dist.get_world_size()
    w = LLAMA3_8B_WIDTHS
    block_kw = dict(n_kv_heads=w["n_kv_heads"], ffn="swiglu",
                    rope_theta=w["rope_theta"],
                    attn_fn=fa.flash_causal_attention)
    blk = transformer.Block(w["d_model"], w["n_heads"], w["d_ff"],
                            device="meta", **block_kw)
    mb, T = MD_PIPE_MB
    positions = torch.arange(T, dtype=torch.int32,
                             device="cuda").expand(mb, T)

    def layer_fn(p, x):
        return torch.func.functional_call(blk, p, (x, positions))

    def build_stack(layers):
        # a stage reads only its own layers of the stack: the others are
        # left unfilled on the ranks that do not run the sequential blocks
        stacked = {k: torch.empty((MD_PIPE_LAYERS, *p.shape),
                                  device="cuda")
                   for k, p in blk.named_parameters()}
        for i in layers:
            layer = transformer.Block(w["d_model"], w["n_heads"], w["d_ff"],
                                      device="cuda", **block_kw)
            bench_serving.random_init_(layer, 100 + i)
            for k, p in layer.named_parameters():
                stacked[k][i].copy_(p.detach())
            del layer
        return stacked

    gen = torch.Generator(device="cuda").manual_seed(17)
    x, dy = (torch.randn((MD_PIPE_MICRO, mb, T, w["d_model"]), generator=gen,
                         device="cuda").to(torch.bfloat16) for _ in range(2))
    ref = None
    if rank == 0:
        stacked = build_stack(range(MD_PIPE_LAYERS))
        leaves = {k: v.requires_grad_() for k, v in stacked.items()}
        outs = []
        for m in range(MD_PIPE_MICRO):
            h = x[m]
            for i in range(MD_PIPE_LAYERS):
                h = layer_fn({k: v[i] for k, v in leaves.items()}, h)
            outs.append(h.detach())
            h.backward(dy[m])
        ref = (torch.stack(outs), {k: v.grad for k, v in leaves.items()})
        stacked = {k: v.detach() for k, v in leaves.items()}
        del leaves, outs, h
        _fresh(torch)
    dist.barrier()
    if rank != 0:
        per = MD_PIPE_LAYERS // n
        stacked = build_stack(range(rank * per, (rank + 1) * per))
    mesh = DeviceMesh("cuda", torch.arange(n).reshape(1, n),
                      mesh_dim_names=("data", "pipe"))
    apply, params, in_sh = pipeline.make_pipeline(mesh, layer_fn, stacked)
    del stacked
    _fresh(torch)
    xl, dyl = in_sh.local(x), in_sh.local(dy)
    dist.barrier()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _md_zero(fa, mp)
    t0 = time.perf_counter()
    out = apply(params, xl)
    out.backward(dyl)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {"K4": fa.flash_attention_cuda.launches,
           "K5": fa.flash_attention_dq_cuda.launches,
           "K6": fa.flash_attention_dkv_cuda.launches}
    per_stage = MD_PIPE_LAYERS // n * MD_PIPE_MICRO
    want = {"K4": per_stage, "K5": per_stage, "K6": per_stage}
    say(f"pipeline rank {rank}: stage of {MD_PIPE_LAYERS // n} blocks, "
        f"{MD_PIPE_MICRO} microbatches forward and backward in {wall:.3f} s "
        f"(4 ranks time-slice the card), peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
        f"{got}, expected {want}")
    ok = got == want and bool(torch.isfinite(out).all())
    stage = parallel.Sharding(mesh, ("pipe",))
    grads = {}
    for k, p in params.items():
        g = _gather0(torch, dist, stage, p.grad)
        if rank == 0:
            grads[k] = _rel(torch, g, ref[1][k].cpu())
        del g
    if rank == 0:
        diff = float((out.float() - ref[0].float()).abs().max())
        say(f"pipeline: {MD_PIPE_LAYERS} Llama-3-8B blocks over {n} stages, "
            f"{MD_PIPE_MICRO} microbatches of {[*MD_PIPE_MB, w['d_model']]} "
            f"bf16, against the blocks one after another on one rank: "
            f"forward max |diff| {diff:.3e} (limit {MD_PIPE_FWD}; bit-equal "
            f"{bool(torch.equal(out, ref[0]))}), gathered gradients "
            f"|g - g_seq| / |g_seq|: "
            + ", ".join(f"{k} {v:.3e}" for k, v in grads.items())
            + f" (limit {MD_PIPE_GRAD})")
        ok = ok and diff <= MD_PIPE_FWD and all(
            v <= MD_PIPE_GRAD for v in grads.values())
    del out, params, ref
    _fresh(torch)
    say(f"pipeline: arm wall {time.perf_counter() - t_arm:.1f} s")
    return got, ok


# tensor-parallel serving (phase 4b, after GPipe): Llama-3-8B at full
# width, cut in depth, on a (1, 1, 1, 4) mesh of the four gloo ranks (op
# by op: gloo stages CUDA tensors through host buffers, which a CUDA
# graph cannot hold).  In bf16 at MD_TP_LAYERS layers: greedy_generate
# of a 1024-token prompt (K4 on each rank's 8 query and 2 KV heads,
# MD_TP_LAYERS launches a rank), its last prefill logits within
# MD_TP_BAR of the single-device model's and each step's id the
# single-device argmax of the same prefix or within MD_TP_BAR of it (the
# ranks' partial sums are added in another order than one device's
# dots); the engine's four requests (greedy with logprobs, greedy with a
# stop id, two seeded sampled) the same on every rank, and the greedy
# ones the single-device engine's up to the first step whose top-2
# logprob gap there is under MD_TP_BAR; then an EngineServer on rank 0
# over the engine (tp_driver) answers two HTTP requests.  In f32 at
# MD_TP_F32_LAYERS layers, every id of all of it equals the
# single-device run's.
MD_TP_LAYERS, MD_TP_F32_LAYERS = 4, 2
MD_TP_PROMPT, MD_TP_STEPS, MD_TP_MAXLEN = 1024, 16, 1280
MD_TP_REQ_PROMPT, MD_TP_NEW = 64, 16
# 16 bf16 ulps at the logits' scale (about 4 at these random weights):
# the four ranks' bf16 partial sums, added in f32 and rounded once, part
# from one device's dots by a few ulps a layer
MD_TP_BAR = 0.25


def _tp_requests(torch, vocab, stop):
    """The engine arm's four requests: (prompt, admit keywords)."""
    gen = torch.Generator().manual_seed(19)
    prompts = [torch.randint(0, vocab, (MD_TP_REQ_PROMPT,),
                             generator=gen).tolist() for _ in range(4)]
    return [(prompts[0], dict(logprobs=2)),
            (prompts[1], dict(logprobs=2, stop=[stop])),
            (prompts[2], dict(logprobs=2, temperature=0.8, top_p=0.95,
                              seed=7)),
            (prompts[3], dict(logprobs=2, temperature=1.0, top_k=50,
                              presence_penalty=0.5, seed=8))]


def _tp_serve(eng, reqs):
    """Admit every request and decode one window of MD_TP_NEW steps; per
    request its ids, finish reason and top-2 logprobs a step.  The slots
    are released."""
    slots = [eng.admit(p, **kw) for p, kw in reqs]
    eng.run_scan(MD_TP_NEW)
    out = [(eng.output(s), eng.finish_reason(s),
            [[lp for _, lp in top] for _, top in eng.token_logprobs(s)])
           for s in slots]
    for s in slots:
        eng.release(s)
    return out


def _first_diff(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                None if len(a) == len(b) else min(len(a), len(b)))


def _md_tp(torch, dist, fa, mp, say):
    """This rank's part of tensor-parallel serving (see MD_TP_LAYERS).
    Returns its K4 launches on the bf16 and f32 prefills, whether its
    checks held, and the arm's figures (rank 0's)."""
    from tpu_k8s_device_plugin_torch.workloads import (
        bench_serving, inference, llama, serving, tp_driver, transformer)
    from tpu_k8s_device_plugin_torch.workloads import server as srv_mod

    t_arm = time.perf_counter()
    rank, n = dist.get_rank(), dist.get_world_size()
    mesh = transformer.make_lm_mesh(seq=1, model=n, expert=1)
    ctrl = dist.new_group(backend="gloo")
    cfg0 = llama.LLAMA3_8B
    prompt = torch.randint(0, cfg0.vocab, (1, MD_TP_PROMPT),
                           generator=torch.Generator().manual_seed(18))
    ok, launches, figures = True, {}, {}
    for dtype, layers in (("bfloat16", MD_TP_LAYERS),
                          ("float32", MD_TP_F32_LAYERS)):
        dt = getattr(torch, dtype)
        cfg = dataclasses.replace(cfg0, n_layers=layers)
        ref = None
        box = [None]
        if rank == 0:
            t0 = time.perf_counter()
            _, whole = bench_serving.build_model_and_params(
                cfg, MD_TP_MAXLEN, "cuda", dtype=dt)
            ids, logits = inference.greedy_generate(whole, prompt,
                                                    MD_TP_STEPS)
            box[0] = int(inference.greedy_generate(
                whole, [_tp_requests(torch, cfg.vocab, 0)[1][0]], 5)[0][0, 4])
            reqs = _tp_requests(torch, cfg.vocab, box[0])
            eng = serving.ServingEngine(whole, n_slots=4, logprobs_k=2,
                                        device=whole.device)
            ref = (ids[0].tolist(), logits[0, -1].float().cpu(),
                   _tp_serve(eng, reqs))
            del eng
            say(f"tp {dtype}: the single-device reference in "
                f"{time.perf_counter() - t0:.1f} s")
        dist.broadcast_object_list(box, src=0)
        reqs = _tp_requests(torch, cfg.vocab, box[0])
        t0 = time.perf_counter()
        _, tp = bench_serving.build_model_and_params(
            cfg, MD_TP_MAXLEN, "cuda", dtype=dt, mesh=mesh)
        build_s = time.perf_counter() - t0
        dist.barrier()
        torch.cuda.synchronize()
        _md_zero(fa, mp)
        t0 = time.perf_counter()
        tp_ids, tp_logits = inference.greedy_generate(tp, prompt,
                                                      MD_TP_STEPS)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        k4 = fa.flash_attention_cuda.launches
        launches[dtype] = k4
        ok = ok and k4 == layers
        eng = serving.ServingEngine(tp, n_slots=4, logprobs_k=2, mesh=mesh,
                                    device=tp.device)
        t0 = time.perf_counter()
        outs = _tp_serve(eng, reqs)
        serve_s = time.perf_counter() - t0
        say(f"tp {dtype} rank {rank}: {layers} of 32 layers, pieces built "
            f"in {build_s:.1f} s; greedy_generate (prompt {MD_TP_PROMPT}, "
            f"{MD_TP_STEPS} tokens) {gen_s:.2f} s with K4 x{k4} (expected "
            f"{layers}); the engine's 4 requests {serve_s:.2f} s, steps "
            f"{eng.stats()['tp_steps']}")
        mine = (tp_ids[0].tolist(), [(o[0], o[1]) for o in outs])
        every = [None] * n
        dist.all_gather_object(every, mine)
        ok = ok and all(e == every[0] for e in every)
        if rank == 0:
            ids, last, ref_outs = ref
            got = tp_ids[0].tolist()
            if any(e != every[0] for e in every):
                say(f"tp {dtype}: the ranks' ids differ: {every}")
            if dtype == "float32":
                held = got == ids and all(
                    o[0] == r[0] and o[1] == r[1]
                    for o, r in zip(outs, ref_outs))
                say(f"tp float32: greedy_generate's {len(got)} ids and the "
                    f"4 requests' ids and finish reasons equal the "
                    f"single-device run's: {held}")
                ok = ok and held
            else:
                diff = float((tp_logits[0, -1].float().cpu() - last)
                             .abs().max())
                seq = torch.cat([prompt[0], torch.tensor(got[:-1])])[None]
                # each step's single-device logits on the TP ids' prefix
                with torch.no_grad():
                    full, _ = inference._prefill(
                        whole, seq.to(whole.device),
                        inference._positions(1, seq.shape[1], whole.device))
                rows = full[0, MD_TP_PROMPT - 1:].float().cpu()
                gaps = []
                for t, tok in enumerate(got):
                    top = int(rows[t].argmax())
                    if tok != top:
                        gaps.append((t, float(rows[t, top] - rows[t, tok])))
                del full
                eng_held, notes = True, []
                for i, (o, r) in enumerate(zip(outs, ref_outs)):
                    d = _first_diff(o[0], r[0])
                    if i < 2 and d is not None and d < len(r[2]):
                        top2 = r[2][d]
                        gap = top2[0] - top2[1] if len(top2) > 1 else 0.0
                        near = gap <= MD_TP_BAR
                        eng_held = eng_held and near
                        notes.append(f"request {i} parts at step {d} "
                                     f"(single-device top-2 gap {gap:.4f})")
                    elif d is not None:
                        notes.append(f"request {i} parts at step {d}")
                held = (diff <= MD_TP_BAR and eng_held
                        and all(g <= MD_TP_BAR for _, g in gaps))
                figures.update(tp_logit_diff=diff, tp_gaps=gaps)
                say(f"tp bfloat16: last prefill logits max |tp - single| "
                    f"{diff:.4f} (bar {MD_TP_BAR}); greedy ids against the "
                    f"single-device argmax of each prefix: "
                    f"{len(got) - len(gaps)} of {len(got)} equal, the rest "
                    f"within {max([g for _, g in gaps], default=0.0):.4f} "
                    f"of it; first difference from the single-device "
                    f"greedy_generate at step {_first_diff(got, ids)}; "
                    f"engine: {'; '.join(notes) or 'every request equal'}; "
                    f"held: {held}")
                ok = ok and held
        if dtype == "bfloat16":
            served = None
            if rank == 0:
                leader = tp_driver.EngineLeader(eng, ctrl)
                srv = srv_mod.EngineServer(leader, window=8,
                                           max_new_tokens=MD_TP_NEW)
                srv.start(host="127.0.0.1", port=0)
                try:
                    t0 = time.perf_counter()
                    served = []
                    for p, kw in reqs[:2]:
                        status, _, body = _http(srv.port, "POST",
                                                "/generate", {
                                                    "tokens": p,
                                                    "max_new_tokens": 8,
                                                    "stop": kw.get("stop"),
                                                    "stream": False})
                        served.append((status, json.loads(body)))
                    http_s = time.perf_counter() - t0
                finally:
                    srv.stop()
                    leader.close()
                # the stop request may end sooner on the wire, where the
                # stop id is not sent
                got_http = [b.get("tokens") or [] for _, b in served]
                held = (all(s == 200 for s, _ in served)
                        and got_http[0] == outs[0][0][:8]
                        and len(got_http[1]) >= 1
                        and got_http[1] == outs[1][0][:len(got_http[1])])
                say(f"tp EngineServer on rank 0 over the TP engine: 2 "
                    f"requests in {http_s:.2f} s, statuses "
                    f"{[s for s, _ in served]}, ids equal to the engine's "
                    f"own: {held}")
                ok = ok and held
            else:
                tp_driver.follow(eng, ctrl)
        del eng, tp
        whole = None
        _fresh(torch)
        dist.barrier()
    say(f"tp: arm wall {time.perf_counter() - t_arm:.1f} s")
    return launches, ok, figures


def md_rank_child(arms=()) -> int:
    """``chip_smoke.py --worker md-rank [ARM ...]``: one rank of the
    multi-device phase, on a gloo group from its env (the ranks share the
    one card, and NCCL refuses two ranks on one GPU: ``PERF.md`` §6); the
    kernels are already built by the parent.  Runs every arm (ring,
    alexnet, lm, pipeline, tp), or the named ones.  Prints its lines,
    then one JSON line: its launches and whether its checks held."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tpu_k8s_device_plugin_torch.workloads import (
        alexnet, bench_serving, parallel, pipeline, transformer)
    from tpu_k8s_device_plugin_torch.workloads import flash_attention as fa
    from tpu_k8s_device_plugin_torch.workloads import pool as mp
    from tpu_k8s_device_plugin_torch.workloads import ring_attention as ra

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method="env://")
    rank = dist.get_rank()

    def say(line):
        print(f"[rank {rank}] {line}", flush=True)

    runs = {
        "ring": lambda: _md_ring(torch, dist, fa, mp, ra, transformer, say),
        "alexnet": lambda: _md_alexnet(torch, dist, alexnet, parallel, fa,
                                       mp, say),
        "lm": lambda: _md_lm(torch, dist, transformer, bench_serving, say),
        "pipeline": lambda: _md_pipeline(torch, dist, transformer, pipeline,
                                         parallel, bench_serving, fa, mp,
                                         say),
        "tp": lambda: _md_tp(torch, dist, fa, mp, say)[:2]}
    result, ok = {"rank": rank}, True
    try:
        for name in arms or runs:
            result[name], held = runs[name]()
            ok = ok and held
            _fresh(torch)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    print(json.dumps({**result, "ok": ok}), flush=True)
    return 0


def md_nccl_lm_child() -> int:
    """``chip_smoke.py --worker md-nccl-lm``: ``make_lm_train_step`` on a
    (1, 1, 1, 1) mesh over NCCL at world size 1 (torchrun's env), the
    reference tests' tiny config, 3 steps: the loss's sums over the
    token axes are real NCCL calls.  Prints one JSON line."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tpu_k8s_device_plugin_torch import dryrun
    from tpu_k8s_device_plugin_torch.workloads import transformer

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method="env://")
    try:
        mesh = transformer.make_lm_mesh(seq=1, model=1, expert=1)
        step, state, place = transformer.make_lm_train_step(
            mesh, vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            seq_len=32, batch=4)
        batch = place(*state["batch"])
        losses = [float(step(*batch)) for _ in range(3)]
        backend = dist.get_backend()
        t0 = time.perf_counter()
        line = dryrun.dryrun_multichip(1, "cuda")
        dryrun_s = time.perf_counter() - t0
        captured = _nccl_captured_step(torch)
    finally:
        dist.destroy_process_group()
    print(json.dumps({"backend": backend, "losses": losses,
                      "mesh": list(mesh.shape), "dryrun": line,
                      "dryrun_s": dryrun_s, "captured": captured,
                      "ok": all(map(math.isfinite, losses))
                      and losses[-1] < losses[0]
                      and "steps captured" in line
                      and captured["ok"]}), flush=True)
    return 0


def _nccl_captured_step(torch):
    """A TP engine on a model axis of one NCCL rank (the tiny config,
    bf16): its decode step captured as a CUDA graph with the row pieces'
    all-reduces and the LM head's all-gather inside (counted as they are
    called while the stream captures), its replays giving the ids of the
    same engine's op-by-op steps.  The NCCL kernels a replay runs under
    ``torch.profiler`` are reported (NCCL may run a group of one's sums
    without a kernel of its own)."""
    import torch.distributed as dist

    from tpu_k8s_device_plugin_torch.workloads import (
        bench_serving, serving, transformer)

    mesh = transformer.make_lm_mesh(seq=1, model=1, expert=1)
    _, model = bench_serving.build_model_and_params("tiny", 128, "cuda",
                                                    mesh=mesh)
    in_capture = {"all_reduce": 0, "all_gather": 0}
    orig = {name: getattr(dist, name) for name in in_capture}

    def counted(name):
        def call(*args, **kwargs):
            if torch.cuda.is_current_stream_capturing():
                in_capture[name] += 1
            return orig[name](*args, **kwargs)
        return call

    outs, kernels = [], {}
    for graphs in (True, False):
        eng = serving.ServingEngine(model, n_slots=4, mesh=mesh,
                                    device=model.device)
        eng._use_graphs = graphs
        slots = [eng.admit([5 + i, 17, 3, 70, 2]) for i in range(4)]
        if graphs:
            for name in in_capture:
                setattr(dist, name, counted(name))
            try:
                eng.run_scan(8)
            finally:
                for name, fn in orig.items():
                    setattr(dist, name, fn)
            replays = eng.graph_replays
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                eng.step()
                torch.cuda.synchronize()
            for e in prof.key_averages():
                if "nccl" in e.key.lower():
                    kernels[e.key[:60]] = e.count
            mode = eng.stats()["tp_steps"]
            replays = eng.graph_replays - replays
        else:
            eng.run_scan(8)
            eng.step()
        outs.append([eng.output(s) for s in slots])
    # a step: 2 row sums a layer and the LM head's gather
    want = {"all_reduce": 2 * model.n_layers, "all_gather": 1}
    return {"mode": mode, "replays": replays, "calls_in_capture":
            in_capture, "calls_per_step": want, "nccl_kernels": kernels,
            "ids_equal": outs[0] == outs[1],
            "ok": mode == "captured" and replays >= 1 and outs[0] == outs[1]
            and all(in_capture[k] >= v for k, v in want.items())}


def multi_device_path(card, arms=()):
    """Phase 4b, multi-device: MD_RANKS rank children (``--worker
    md-rank``) on one gloo group on this card run the ring in every impl
    and layout, the (2, 2) AlexNet, the LM mesh arms (MD_LM), GPipe and
    tensor-parallel serving (MD_TP_LAYERS); beside them two NCCL ranks
    run ``bench_main --sharded`` and ``--worker md-nccl-lm`` (the LM
    step, the dry run analog and a TP engine's captured step) under
    torchrun's env (world size 1: the one form of NCCL this machine
    allows).  *arms* runs only the rank arms named (then without
    ``bench_main --sharded`` unless the AlexNet is one).  Every child's
    failure fails the phase.  Returns the ring's, the AlexNet's, the
    pipeline's and the TP prefills' launches by rank."""
    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    base = {k: v for k, v in os.environ.items()
            if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                         "MASTER_PORT")}
    port, nccl_port = _free_port(), _free_port()
    # the ranks share the card: expandable segments keep what one rank's
    # allocator has cached from holding memory another needs
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", "md-rank",
         *arms],
        env={**base, "RANK": str(r), "WORLD_SIZE": str(MD_RANKS),
             "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
             "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=root) for r in range(MD_RANKS)]
    nccl_lm_port = _free_port()
    nccl_children = [
        (["-m", "tpu_k8s_device_plugin_torch.workloads.bench_main",
          *MD_NCCL_ARGS], nccl_port),
        ([os.path.abspath(__file__), "--worker", "md-nccl-lm"],
         nccl_lm_port)]
    if arms and "alexnet" not in arms:
        nccl_children = nccl_children[1:]
    for argv, nport in nccl_children:
        procs.append(subprocess.Popen(
            [sys.executable, *argv],
            env={**base, "RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                 "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(nport)},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=root))
    outs = []
    try:
        deadline = time.perf_counter() + MD_TIMEOUT_S
        for p in procs:
            out, _ = p.communicate(
                timeout=max(1.0, deadline - time.perf_counter()))
            outs.append((p.returncode, out))
    except subprocess.TimeoutExpired:
        fail(f"the multi-device phase ran past {MD_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for i, (rc, out) in enumerate(outs):
        lines = out.strip().splitlines()
        what = f"rank {i}" if i < MD_RANKS else f"NCCL child {i - MD_RANKS}"
        for line in lines[:-1]:
            print(line, flush=True)
        try:
            last = json.loads(lines[-1]) if lines else None
        except ValueError:
            last = None
        if rc != 0 or last is None:
            fail(f"multi-device: {what} failed ({rc}):\n{out[-4000:]}")
        results.append(last)
    for r in results[:MD_RANKS]:
        if not r["ok"]:
            fail(f"multi-device: rank {r['rank']}'s checks failed (see its "
                 "lines above)")
    if len(nccl_children) == 2:
        nccl = results[MD_RANKS]["extra"]
        print(f"multi-device, bench_main --sharded under torchrun's env: "
              f"backend {nccl['backend']}, mesh {nccl['mesh']}, "
              f"{nccl['total_images_per_sec']:.1f} images/s at batch "
              f"{nccl['batch']} (pool {nccl['pool']}; beside the 4 gloo "
              f"ranks on this card: not a speed)", flush=True)
        if nccl["backend"] != "nccl" or nccl["mesh"] != {"data": 1,
                                                         "model": 1}:
            fail(f"multi-device: the NCCL rank ran {nccl}")
    nccl_lm = results[-1]
    cap = nccl_lm["captured"]
    print(f"multi-device, make_lm_train_step on a {nccl_lm['mesh']} mesh "
          f"over {nccl_lm['backend']} at world size 1, the tiny config: "
          f"losses {nccl_lm['losses']}", flush=True)
    print(f"multi-device, the dry run analog over NCCL at world size 1 in "
          f"{nccl_lm['dryrun_s']:.1f} s: {nccl_lm['dryrun']}", flush=True)
    print(f"multi-device, a TP engine (tiny, bf16) on a model axis of one "
          f"NCCL rank: steps {cap['mode']}; NCCL calls made while its "
          f"graphs were captured {cap['calls_in_capture']} (a step makes "
          f"{cap['calls_per_step']}); {cap['replays']} replay(s) of one "
          f"step() ran NCCL kernels {cap['nccl_kernels'] or 'none'}; ids "
          f"equal to its op-by-op steps: {cap['ids_equal']}; {card}",
          flush=True)
    if nccl_lm["backend"] != "nccl" or not nccl_lm["ok"]:
        fail(f"multi-device: the NCCL LM rank ran {nccl_lm}")
    print(f"multi-device: phase wall {time.perf_counter() - t_phase:.1f} s "
          f"with the children's start; {card}", flush=True)
    ranks = results[:MD_RANKS]
    out = {"tp": {r["rank"]: r["tp"] for r in ranks if "tp" in r}}
    if arms:
        return out
    ring = {r["rank"]: r["ring"] for r in ranks}
    return {**out, "ring": ring,
            "alexnet": {r["rank"]: r["alexnet"] for r in results[:MD_RANKS]},
            "f32out": {k: sum(ring[r][f"{impl}-{layout}"][f"{k}_f32out"]
                              for r in ring for impl, layout in MD_RING)
                       for k in ("K5", "K6")},
            "K4": sum(ring[r][f"flash-{layout}"]["K4"] for r in ring
                      for layout in ("contiguous", "zigzag")),
            "pipeline": {k: sum(r["pipeline"][k] for r in results[:MD_RANKS])
                         for k in ("K4", "K5", "K6")}}


# the chaos phase: the soak's in-process serving episodes over Llama-3-8B
# at full width, bf16, CHAOS_LAYERS of its 32 layers, with captured steps,
# each restarting episode CHAOS_ROUNDS times on one server; episode 17 on
# replicas of the server CLI serving Llama-3.2-1B at full width and depth
CHAOS_LAYERS, CHAOS_MAX_LEN, CHAOS_ROUNDS = 4, 80, 3
CHAOS_SPILL_CONFIG, CHAOS_SPILL_LEN = "llama3-1b", 256
# on the card a stream of 8 tokens ends before the burst lands: episode
# 9's batch stream decodes 48 (the pool, pages of 8 rows, holds one
# full-length sequence of CHAOS_MAX_LEN, 10 pages, and not the batch's
# and both interactive prompts' 12), episode 11's anchor 64
CHAOS_BATCH_TOKENS, CHAOS_KV_PAGES, CHAOS_ANCHOR_TOKENS = 48, 10, 64
CHAOS_CONTROL = [1, 91, 64, 15, 98, 37]
CHAOS_TIMEOUT_S = 420


class RestartProbe:
    """The chaos episodes' ``probe(server, stage)``: once the baseline
    answered ("before"), and after each supervised restart before any
    other request reaches the restarted loop, send one greedy control
    request (retried past a restart still draining) and read what the
    restart left: the ids (equal to the baseline's, bit for bit), the
    captured-step replays that request made (on CUDA at least one: the
    restarted loop replays its captured steps, it does not run eagerly),
    a ``torch.cuda.synchronize()`` that must raise nothing, and
    ``torch.cuda.memory_allocated()`` (no growth from one restart to the
    next).  ``rows`` keeps one entry a stage for the episode's line:
    ``restart_ms`` from the crash to the supervisor's restart (both
    journaled), ``recover_ms`` from the crash to the control request's
    answer."""

    def __init__(self, torch, cuda: bool, capture_lock):
        self.torch, self.cuda, self.capture_lock = torch, cuda, capture_lock
        self.reset()

    def reset(self):
        self.rows, self._ids, self._mem, self._base = [], None, None, 0

    def _control(self, srv):
        import http.client

        deadline = time.monotonic() + 60.0
        while True:
            conn = http.client.HTTPConnection("127.0.0.1", srv.port,
                                              timeout=120)
            try:
                conn.request("POST", "/generate", json.dumps(
                    {"tokens": CHAOS_CONTROL, "max_new_tokens": 8,
                     "ignore_eos": True, "stream": False}),
                    {"Content-Type": "application/json"})
                resp = conn.getresponse()
                status, body = resp.status, resp.read()
            finally:
                conn.close()
            if status == 200:
                return json.loads(body)["tokens"]
            if time.monotonic() > deadline:
                fail(f"chaos: the control request answered {status} for "
                     f"60 s after the restart: {body[:200]!r}")
            time.sleep(0.1)

    def __call__(self, srv, stage):
        import gc
        import threading

        torch, eng = self.torch, srv.engine
        replays, captures = eng.graph_replays, eng.graph_captures
        ids = self._control(srv)
        t_answer = time.time()
        replays = eng.graph_replays - replays
        # a worker the schedule watchdog abandoned holds its iteration's
        # tensors until its hang ends and it bails at the supersession
        # check: wait for it (and for it to make no CUDA call that
        # breaks the synchronize below)
        for th in threading.enumerate():
            if th.name.startswith("watchdog-"):
                th.join(timeout=60)
        if self.cuda:
            torch.cuda.synchronize()
        # what a crashed iteration's frames hold sits in reference
        # cycles until the collector runs: collect first, under the
        # capture lock (a collection inside a capture would break it)
        with self.capture_lock:
            gc.collect()
        mem = torch.cuda.memory_allocated() if self.cuda else 0
        row = dict(stage=stage, replays=replays,
                   captures=eng.graph_captures - captures, mem=mem)
        if stage == "before":
            self._ids, self._base = ids, mem
        else:
            crash = srv.recorder.events(name="tpu_serve_scheduler_crash")
            back = srv.recorder.events(name="tpu_serve_scheduler_restart")
            k = len(self.rows) - 1
            row.update(
                ids_equal=ids == self._ids, mem_delta=mem - self._base,
                restart_ms=1e3 * (back[k]["t_wall"] - crash[k]["t_wall"]),
                recover_ms=1e3 * (t_answer - crash[k]["t_wall"]))
            if not row["ids_equal"]:
                fail(f"chaos: {stage}: the control request gave {ids}, "
                     f"{self._ids} before the fault")
            if self.cuda and replays < 1:
                fail(f"chaos: {stage}: the control request replayed no "
                     "captured step (the restarted loop ran eagerly)")
            if self._mem is not None and mem > self._mem:
                fail(f"chaos: {stage}: memory_allocated grew from "
                     f"{self._mem} to {mem} bytes since the last restart "
                     f"(stages so far: {self.rows + [row]})")
            self._mem = mem
        self.rows.append(row)


def chaos_child(argv) -> int:
    """``chip_smoke.py --worker chaos [DEVICE]``: the soak's episodes 5
    (``serve.step`` crash), 6 (``serve.schedule`` hang), 9 (a tenant
    burst under page pressure) and 11 (a kill in a packed prefill) on
    an ``EngineServer`` over Llama-3-8B at CHAOS_LAYERS layers, and 17
    (a session spilled through a SIGKILL) on server CLI replicas of
    CHAOS_SPILL_CONFIG; prints one line an episode, then a JSON
    summary.  ``cpu`` rehearses it with the soak's tiny decoder."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tpu_k8s_device_plugin_torch.tools import chaos_soak as cs
    from tpu_k8s_device_plugin_torch.workloads import (bench_serving,
                                                       inference, llama)

    device = argv[0] if argv else "cuda"
    cuda = device == "cuda"
    if cuda:
        cfg = dataclasses.replace(llama.LLAMA3_8B, n_layers=CHAOS_LAYERS)
        _, model = bench_serving.build_model_and_params(cfg, CHAOS_MAX_LEN,
                                                        device)
        spill, batch_kw, anchor = CHAOS_SPILL_CONFIG, dict(
            batch_new_tokens=CHAOS_BATCH_TOKENS,
            kv_pages=CHAOS_KV_PAGES), CHAOS_ANCHOR_TOKENS
    else:
        model = cs.tiny_model(device, 64)
        spill, batch_kw, anchor = "tiny", {}, 40
    probe = RestartProbe(torch, cuda, inference.CAPTURE_LOCK)
    episodes = [
        (5, lambda: cs.episode_scheduler_crash(
            1, device, model, rounds=CHAOS_ROUNDS, probe=probe)),
        (6, lambda: cs.episode_scheduler_hang(
            1, device, model, rounds=CHAOS_ROUNDS, probe=probe)),
        (9, lambda: cs.episode_tenant_burst_page_pressure(
            1, device, model, **batch_kw)),
        (11, lambda: cs.episode_packed_prefill_kill(
            1, device, model, anchor_new_tokens=anchor, probe=probe)),
        (17, lambda: cs.episode_session_spill_crash_resume(
            1, device, spill, CHAOS_SPILL_LEN)),
    ]
    out = []
    for n, run in episodes:
        probe.reset()
        t0 = time.perf_counter()
        run()
        row = dict(episode=n, name=cs.EPISODE_TITLES[n],
                   wall_s=round(time.perf_counter() - t0, 3),
                   restarts=[r for r in probe.rows
                             if r["stage"] != "before"])
        if cuda:
            torch.cuda.synchronize()
        print("chaos: " + json.dumps(row), flush=True)
        out.append(row)
    print(json.dumps({"episodes": out}), flush=True)
    return 0


def chaos_path(card):
    """The chaos phase, in a ``--worker chaos`` child (its servers,
    replicas and abandoned watchdog workers end with it).  Prints the
    child's lines and returns its summary."""
    t_phase = time.perf_counter()
    try:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker",
             "chaos"], capture_output=True, text=True,
            timeout=CHAOS_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        fail(f"the chaos phase ran past {CHAOS_TIMEOUT_S} s:\n"
             f"{(e.stdout or '')[-3000:]}{(e.stderr or '')[-3000:]}")
    lines = out.stdout.strip().splitlines()
    for line in lines[:-1]:
        print(line, flush=True)
    if out.returncode != 0 or not lines:
        fail(f"the chaos phase failed ({out.returncode}):\n"
             f"{out.stdout[-2000:]}\n{out.stderr[-6000:]}")
    result = json.loads(lines[-1])
    print(f"chaos: phase wall with the child's start "
          f"{time.perf_counter() - t_phase:.1f} s; {card}", flush=True)
    return result


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
        scheduler, serving, speculative, transformer)
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
    # each phase's wall, printed at the end: the host's speed varies from
    # machine to machine, and these say where a slow run lost its time
    laps = [("start", t_start)]

    def lap(name):
        laps.append((name, time.perf_counter()))

    lap("build")
    device_plugin_path(card)
    lap("device plugin")

    counts = Counts(flash_attn_fwd=fa.flash_attention_cuda,
                    flash_attn_dq=fa.flash_attention_dq_cuda,
                    flash_attn_dkv=fa.flash_attention_dkv_cuda,
                    maxpool_fwd=mp.max_pool_fwd_cuda,
                    maxpool_bwd=mp.max_pool_bwd_cuda,
                    conv_pool_fwd=cp.conv_pool_cuda)
    flash = check_flash(torch, fa)
    flash_train = check_flash_training(torch, fa)
    flash_f32 = check_flash_f32_modes(torch, fa,
                                      flash_train["dq"]["library_ms"])
    pool = check_pool(torch, mp)
    conv_pool = check_conv_pool(torch, cp)
    _fresh(torch)
    lap("kernels")
    multi = multi_device_path(card)
    lap("multi-device")
    launches, bf16, engine = main_path(torch, counts, inference, llama,
                                       bench_serving, serving, grammar, obs,
                                       scheduler, card)
    _fresh(torch)
    lap("generation to http")
    train, train_modes = training_path(torch, counts, alexnet, bench_main)
    _fresh(torch)
    lap("alexnet")
    lm = lm_training_path(torch, counts, fa, llama, transformer,
                          bench_serving)
    _fresh(torch)
    lap("lm training")
    rest = rest_of_model_path(torch, counts, fa, inference, llama,
                              transformer, bench_serving, serving, scheduler,
                              speculative, obs, bf16, engine, card)
    _fresh(torch)
    lap("rest of the model")
    fleet_path(torch, llama.LLAMA3_8B, engine["scheduler"], card)
    _fresh(torch)
    lap("fleet")
    ckpt = checkpoint_path(torch, counts, engine["scheduler"], card)
    lap("checkpointing")
    _fresh(torch)
    chaos_path(card)
    lap("chaos")

    csrc = "tpu_k8s_device_plugin_torch/csrc/"
    ref = "tpu_k8s_device_plugin/workloads/"
    kernels = [
        dict(name="flash_attn_fwd", route="cuda",
             source=csrc + "flash_attn_fwd.cu",
             replaces=ref + "flash_attention.py:101",
             launches=launches, **flash,
             note="launches and times: greedy_generate's prefill, without "
                  "the lse write; under lse_mode, the same for one "
                  "lm_train_step, whose forward writes the lse; the "
                  "launches_* keys count the same kernel on the int8, int4 "
                  "and MoE prefills, each rank's tensor-parallel prefills "
                  "(bf16 and f32) and the MoE training step",
             launches_int8_prefill=rest["quant"]["int8"]["launches"],
             launches_int4_prefill=rest["quant"]["int4"]["launches"],
             launches_moe_prefill=rest["moe"]["serve_launches"][
                 "flash_attn_fwd"],
             launches_tp_prefill_by_rank={
                 r: v["bfloat16"] for r, v in multi["tp"].items()},
             launches_tp_f32_prefill_by_rank={
                 r: v["float32"] for r, v in multi["tp"].items()},
             lse_mode=dict(launches=lm["flash_attn_fwd"],
                           launches_moe_train=rest["moe"][
                               "train_launches"]["flash_attn_fwd"],
                           launches_checkpoint_lm=ckpt["lm"][
                               "flash_attn_fwd"],
                           launches_ring=multi["K4"],
                           launches_pipeline=multi["pipeline"]["K4"],
                           **flash_train["lse"])),
        dict(name="flash_attn_dq", route="cuda",
             source=csrc + "flash_attn_bwd.cu",
             replaces=ref + "flash_attention.py:208",
             launches=lm["flash_attn_dq"], **flash_train["dq"],
             launches_moe_train=rest["moe"]["train_launches"][
                 "flash_attn_dq"],
             launches_checkpoint_lm=ckpt["lm"]["flash_attn_dq"],
             launches_pipeline=multi["pipeline"]["K5"],
             note="plain_ms is the plain backward (dQ, dK and dV) at the "
                  "head slice; library_ms is sdpa's whole backward, the "
                  "yardstick for K5 and K6 together"),
        dict(name="flash_attn_dkv", route="cuda",
             source=csrc + "flash_attn_bwd.cu",
             replaces=ref + "flash_attention.py:254",
             launches=lm["flash_attn_dkv"], **flash_train["dkv"],
             launches_moe_train=rest["moe"]["train_launches"][
                 "flash_attn_dkv"],
             launches_checkpoint_lm=ckpt["lm"]["flash_attn_dkv"],
             launches_pipeline=multi["pipeline"]["K6"],
             note="plain_ms is the plain backward (dQ, dK and dV) at the "
                  "head slice; library_ms is sdpa's whole backward, the "
                  "yardstick for K5 and K6 together"),
        dict(name="flash_attn_dq_f32out", route="cuda",
             source=csrc + "flash_attn_bwd.cu",
             replaces=ref + "flash_attention.py:351",
             launches=multi["f32out"]["K5"], **flash_f32["dq"],
             note="K5's f32 output mode (the block form's dQ partials, "
                  "the reference's keep_f32): launches summed over the "
                  "ring phase's 4 ranks, contiguous and zig-zag flash "
                  "rings; ms at the full call beside bf16_mode_ms"),
        dict(name="flash_attn_dkv_f32out", route="cuda",
             source=csrc + "flash_attn_bwd.cu",
             replaces=ref + "flash_attention.py:377",
             launches=multi["f32out"]["K6"], **flash_f32["dkv"],
             note="K6's f32 output mode (the block form's dK/dV "
                  "partials): launches summed over the ring phase's 4 "
                  "ranks, contiguous and zig-zag flash rings"),
        dict(name="maxpool_fwd", route="cuda", source=csrc + "maxpool.cu",
             replaces=ref + "pool.py:150",
             launches=train["pallas"]["maxpool_fwd"], **pool["fwd"],
             launches_checkpoint_elastic=ckpt["elastic"]["maxpool_fwd"],
             launches_sharded_rank0=multi["alexnet"][0]["K1"],
             load_modes=train_modes["pallas"]["maxpool_fwd"]),
        dict(name="maxpool_bwd", route="cuda", source=csrc + "maxpool.cu",
             replaces=ref + "pool.py:169",
             launches=train["pallas"]["maxpool_bwd"], **pool["bwd"],
             note="launches: the pool=pallas step; the pool=fused step's "
                  "are under launches_fused",
             launches_fused=train["fused"]["maxpool_bwd"],
             launches_checkpoint_elastic=ckpt["elastic"]["maxpool_bwd"],
             launches_sharded_rank0=multi["alexnet"][0]["K2"],
             load_modes=train_modes["pallas"]["maxpool_bwd"],
             load_modes_fused=train_modes["fused"]["maxpool_bwd"]),
        dict(name="conv_pool_fwd", route="cuda",
             source=csrc + "conv_pool_fwd.cu",
             replaces=ref + "convpool.py:83",
             launches=train["fused"]["conv_pool_fwd"], **conv_pool),
    ]
    print("chip_smoke: phase walls " + ", ".join(
        f"{name} {t - laps[i][1]:.1f} s"
        for i, (name, t) in enumerate(laps[1:])), flush=True)
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        sys.exit(worker(sys.argv[2:]))
    sys.exit(main())
