"""AlexNet training benchmark: the port of the JAX package's
``bench_main.py`` single-device path.

    python -m tpu_k8s_device_plugin_torch.workloads.bench_main \\
        --pool fused --batch 1024

trains on synthetic data (224 px, 1000 classes, space-to-depth input,
bf16 compute with f32 parameters, random weights from a seed) and
prints one JSON line: images/sec on one GPU and the model FLOP
utilisation.  FLOPs are counted analytically from the layer shapes
(``AlexNet.train_flops_per_image``), so they are the same whatever
``--pool`` implements the stages; the peak comes from a table keyed by
the card's name.  ``--sharded`` and ``--checkpoint-dir`` are not yet
ported.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Optional

import torch

from .alexnet import create_train_state, synthetic_batch, train_step
from .transformer import resolve_device

# dense bf16 tensor-core peaks in FLOP/s (NVIDIA data sheets), matched
# against torch.cuda.get_device_name() in order: the PCIe part's name
# says "PCIe", the SXM part's ("NVIDIA H100 80GB HBM3") does not
PEAK_BF16 = (
    ("H100 PCIe", 756e12),
    ("H100", 989e12),
)


def peak_flops(device: torch.device) -> Optional[float]:
    """The card's dense bf16 peak, or None for a card not in the table
    (or the CPU)."""
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    for key, peak in PEAK_BF16:
        if key in name:
            return peak
    return None


def _timed_loop(step: Callable[[], torch.Tensor], batch: int, steps: int,
                warmup: int, rounds: int = 1) -> float:
    """Images/sec: *warmup* steps, then the best of *rounds* rounds of
    *steps* steps, each synchronised by reading the last loss (the
    fastest round is the steady state: a shared host only ever slows a
    round down)."""
    loss = None
    for _ in range(warmup):
        loss = step()
    if loss is not None:
        float(loss)
    best = None
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(steps):
            loss = step()
        float(loss)
        ips = batch * steps / (time.perf_counter() - t0)
        best = ips if best is None or ips > best else best
    return best


def _resolve_pool(pool: Optional[str]) -> str:
    """The stage implementation: explicit argument, else
    ``$ALEXNET_POOL``, else "xla"."""
    return pool or os.environ.get("ALEXNET_POOL", "xla")


def run_single(batch: int, steps: int, warmup: int, s2d: bool = True,
               want_flops: bool = False, rounds: int = 1,
               pool: Optional[str] = None, device=None):
    """Images/sec of ``train_step`` on one device (and, with
    *want_flops*, the FLOPs of one step).  Runs on CUDA unless *device*
    is given."""
    device = resolve_device(device)
    model, opt = create_train_state(seed=0, s2d=s2d,
                                    pool=_resolve_pool(pool), device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    images, labels = synthetic_batch(gen, batch, s2d=s2d)
    ips = _timed_loop(lambda: train_step(model, opt, images, labels),
                      batch, steps, warmup, rounds=rounds)
    if want_flops:
        return ips, model.train_flops_per_image() * batch
    return ips


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="alexnet-torch-bench")
    p.add_argument("--batch", type=int, default=256,
                   help="per-device batch size (default 256)")
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--pool", choices=("xla", "pallas", "fused"),
                   default=None,
                   help="conv->pool stages (default: $ALEXNET_POOL or xla)")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; raises without it)")
    p.add_argument("--sharded", action="store_true",
                   help="not yet ported (ROADMAP queue 1, item 6)")
    p.add_argument("--checkpoint-dir", default="",
                   help="not yet ported (ROADMAP queue 1, item 7)")
    args = p.parse_args(argv)
    if args.steps < 1:
        p.error("--steps must be >= 1")
    if args.sharded:
        raise NotImplementedError(
            "--sharded waits for multi-device training (ROADMAP queue 1, "
            "item 6)")
    if args.checkpoint_dir:
        raise NotImplementedError(
            "--checkpoint-dir waits for checkpointing (ROADMAP queue 1, "
            "item 7)")
    device = resolve_device(args.device)
    pool = _resolve_pool(args.pool)
    ips, flops = run_single(args.batch, args.steps, args.warmup,
                            want_flops=True, pool=pool, device=device)
    per_image = flops // args.batch
    peak = peak_flops(device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else str(device)
    print(json.dumps({
        "metric": "alexnet_images_per_sec_per_gpu", "value": ips,
        "unit": "images/sec",
        "extra": {"pool": pool, "batch": args.batch,
                  "mfu": None if peak is None else ips * per_image / peak,
                  "flops_per_image": per_image, "device": name}}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
