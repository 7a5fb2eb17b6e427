"""Serving benchmark: tokens/sec of the decode loop, and the prefill time.

The uniform mode of the JAX package's ``bench_serving``: one batch of
prompts of one length, greedy, prefill once, then the decode loop timed
best-of-rounds.  Weights are random, built on the device from a seed:

    python -m tpu_k8s_device_plugin_torch.workloads.bench_serving \\
        --config llama3-8b --batch 4 --prompt-len 1024 --steps 32 \\
        --max-len 2048

prints one JSON line.  ``--engine`` times the same decode through the
continuous-batching ``ServingEngine`` instead: one request a slot,
``run_scan`` windows of ``--steps`` steps.  The HTTP, speculative and
quantized modes of the JAX benchmark are not yet ported.
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


def run(config: str, quantized, batch: int, steps: int, prompt_len: int,
        max_len: int, engine: bool = False, spec: int = 0,
        http_clients: int = 0, seed: int = 0, device=None):
    """Uniform-batch decode benchmark; returns the stats dict of
    ``decode_throughput`` (or, with *engine*, of the engine's windows)
    with the config and device added.  The JAX package's arguments in
    its order, then the port's seed and device; the modes not yet ported
    raise ``NotImplementedError``."""
    for flag, on in (("--spec", spec), ("--http", http_clients),
                     ("--quantized", quantized)):
        if on:
            raise NotImplementedError(f"{flag} is not yet ported")
    budget = steps * ((_ENGINE_WARMUP + _ENGINE_ROUNDS) if engine else 1)
    if prompt_len + budget > max_len:
        raise ValueError(
            f"prompt_len {prompt_len} + decode budget {budget} exceed "
            f"max_len {max_len}")
    device = resolve_device(device)
    cfg, model = build_model_and_params(config, max_len, device, seed)
    gen = torch.Generator().manual_seed(seed + 1)
    prompt = torch.randint(0, cfg.vocab, (batch, prompt_len),
                           generator=gen).to(device)
    if engine:
        stats = _engine_throughput(model, prompt, steps)
    else:
        stats = decode_throughput(model, prompt, steps)
    stats["config"] = config
    stats["prompt_len"] = float(prompt_len)
    stats["device"] = (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu")
    return stats


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
    p.add_argument("--quantized", action="store_true",
                   help="not yet ported")
    for flag in ("--spec", "--http"):
        p.add_argument(flag, type=int, default=0, help="not yet ported")
    args = p.parse_args(argv)
    try:
        stats = run(args.config, args.quantized, args.batch, args.steps,
                    args.prompt_len, args.max_len, engine=args.engine,
                    spec=args.spec, http_clients=args.http, seed=args.seed,
                    device=args.device)
    except (ValueError, NotImplementedError) as e:
        p.error(str(e))
    print(json.dumps(stats), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
