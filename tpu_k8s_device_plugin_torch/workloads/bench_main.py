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
the card's name.

``--checkpoint-dir DIR`` runs the elastic loop instead (``run_elastic``):
it resumes from the newest whole checkpoint under DIR, saves every
``--checkpoint-every`` steps, and when the slice membership file
(``--slice-state``) moves past the generation in
``$TPU_SLICE_GENERATION``, saves and exits with 77 so that the
orchestrator restarts it under the new identity.

``--sharded`` trains over a ``data`` x ``model`` mesh of every rank
(``parallel.make_mesh``) with ``--batch`` a data rank, so the global
batch is ``--batch`` times the data axis.  It runs one process a rank
under torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``) and initialises the group from it:
NCCL on CUDA, one rank a GPU (``LOCAL_RANK`` picks it), gloo under
``--device cpu``.  Rank 0 prints the line.
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
from ..types import constants

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


def run_sharded(batch: int, steps: int, warmup: int, s2d: bool = True,
                pool: Optional[str] = None, device=None) -> float:
    """Images/sec of the sharded step over ``make_mesh`` of every rank of
    the initialised group, counting the global batch: *batch* a data
    rank, so the batch is multiplied by the data axis and each chip keeps
    its per-device batch.  Every rank
    makes the global batch from seed 0 and takes its slice.  Runs on CUDA
    unless *device* is given."""
    from .parallel import make_mesh, make_sharded_train_step, mesh_shape

    device = resolve_device(device)
    mesh = make_mesh(device=device)
    batch *= mesh_shape(mesh)["data"]
    model, opt = create_train_state(seed=0, s2d=s2d,
                                    pool=_resolve_pool(pool), device=device)
    step, model, opt, (img_sh, lbl_sh) = make_sharded_train_step(
        model, opt, mesh)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    images, labels = synthetic_batch(gen, batch, s2d=s2d)
    images, labels = img_sh.local(images), lbl_sh.local(labels)
    return _timed_loop(lambda: step(images, labels), batch, steps, warmup)


def run_elastic(
    batch: int,
    steps: int,
    checkpoint_dir: str,
    checkpoint_every: int,
    slice_state: str,
    s2d: bool = True,
    sharded: bool = False,
    pool: Optional[str] = None,
    signal=None,
    device=None,
) -> int:
    """Checkpointed train loop for elastic slices: resume from the
    newest whole checkpoint, save every *checkpoint_every* steps, and —
    when the slice reshapes under us (ReshapeSignal observes the
    membership generation moving past the one our TPU_SLICE_GENERATION
    identity was issued for) — checkpoint immediately and exit with
    RESHAPE_EXIT_CODE so the orchestrator restarts this pod under the
    new generation's identity.  Reformation becomes a restart, not a
    loss.  The state is ``{"params": model.state_dict(), "opt_state":
    opt.state_dict()}``; the batch is the same synthetic one every step,
    from seed 0, so a resumed run ends where an uninterrupted one does.
    With *sharded*, the step is the sharded one over ``make_mesh`` of the
    initialised group (*batch* is then the global batch, split on
    ``data``), each rank saves its pieces and a restore puts them onto
    this run's mesh, whatever the shape of the one that saved them.
    Runs on CUDA unless *device* is given."""
    from . import checkpoint as ckpt

    device = resolve_device(device)
    if signal is None:
        signal = ckpt.ReshapeSignal(slice_state)
    model, opt = create_train_state(seed=0, s2d=s2d,
                                    pool=_resolve_pool(pool), device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    images, labels = synthetic_batch(gen, batch, s2d=s2d)
    shardings = None
    if sharded:
        from .parallel import (make_mesh, make_sharded_train_step,
                               train_state_shardings)

        mesh = make_mesh(device=device)
        step_fn, model, opt, (img_sh, lbl_sh) = make_sharded_train_step(
            model, opt, mesh)
        images, labels = img_sh.local(images), lbl_sh.local(labels)
        shardings = train_state_shardings(mesh, model,
                                          ckpt.optimizer_template(opt))
    else:
        def step_fn(images, labels):
            return train_step(model, opt, images, labels)

    start = 0
    if ckpt.latest_step(checkpoint_dir) is not None:
        start, restored = ckpt.restore_latest(checkpoint_dir, template={
            "params": model.state_dict(),
            "opt_state": ckpt.optimizer_template(opt)}, shardings=shardings)
        model.load_state_dict(restored["params"])
        opt.load_state_dict(restored["opt_state"])
        del restored
        print(f"resumed from checkpoint step {start}", flush=True)

    def save(done_steps):
        ckpt.save_checkpoint(
            checkpoint_dir, done_steps,
            {"params": model.state_dict(), "opt_state": opt.state_dict()},
            keep_last=3, shardings=shardings)

    loss = None
    for i in range(start, steps):
        loss = step_fn(images, labels)
        done = i + 1
        membership = signal.check()
        if membership is not None:
            # save_checkpoint drains the device before it serializes
            save(done)
            print(
                f"slice reshaped to gen {membership.generation} "
                f"({membership.num_workers} worker(s)"
                f"{', degraded' if membership.degraded else ''}); "
                f"checkpointed step {done}; exiting "
                f"{ckpt.RESHAPE_EXIT_CODE} for restart under the new "
                "identity", flush=True,
            )
            return ckpt.RESHAPE_EXIT_CODE
        if checkpoint_every and done % checkpoint_every == 0 \
                and done < steps:
            save(done)
    if loss is not None:
        print(f"final loss after {steps} steps: {float(loss):.4f}",
              flush=True)
    if steps > start:
        save(steps)
    return 0


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
                   help="train over a data x model mesh of every rank "
                        "(one process a rank, torchrun's env)")
    p.add_argument("--checkpoint-dir", default="",
                   help="elastic mode: checkpoint/resume under this dir "
                        "(PVC mount); on a slice reshape the loop saves "
                        "and exits 77 for a restart under the new "
                        "identity")
    p.add_argument("--checkpoint-every", type=int, default=10,
                   help="steps between periodic checkpoints in elastic "
                        "mode (default 10; 0 = only reshape/final saves)")
    p.add_argument("--slice-state", default=None,
                   help="slice membership file the reshape watch reads "
                        "(default: the device plugin's standard path)")
    args = p.parse_args(argv)
    if args.steps < 1:
        p.error("--steps must be >= 1")
    device = resolve_device(args.device)
    if args.sharded:
        _init_group(device)
        try:
            return _main(args, device)
        finally:
            torch.distributed.destroy_process_group()
    return _main(args, device)


def _init_group(device: torch.device) -> None:
    """The process group from torchrun's environment: NCCL for CUDA
    ranks (the one ``LOCAL_RANK`` names), gloo on the CPU."""
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    torch.distributed.init_process_group(
        "nccl" if device.type == "cuda" else "gloo", init_method="env://")


def _main(args, device: torch.device) -> int:
    if args.checkpoint_dir:
        return run_elastic(
            args.batch, args.steps, args.checkpoint_dir,
            args.checkpoint_every,
            args.slice_state or constants.SLICE_STATE_FILE,
            sharded=args.sharded, pool=args.pool, device=device)
    pool = _resolve_pool(args.pool)
    if args.sharded:
        return _print_sharded(args, pool, device)
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


def _print_sharded(args, pool: str, device: torch.device) -> int:
    """``--sharded``: rank 0 prints images/sec over the whole mesh and a
    chip's share of it."""
    from .parallel import default_model_parallel

    ips = run_sharded(args.batch, args.steps, args.warmup, pool=pool,
                      device=device)
    world = torch.distributed.get_world_size()
    model = default_model_parallel(world)
    if torch.distributed.get_rank() == 0:
        name = torch.cuda.get_device_name(device) \
            if device.type == "cuda" else str(device)
        print(json.dumps({
            "metric": "alexnet_images_per_sec_per_gpu", "value": ips / world,
            "unit": "images/sec",
            "extra": {"pool": pool, "batch": args.batch, "sharded": True,
                      "mesh": {"data": world // model, "model": model},
                      "backend": torch.distributed.get_backend(),
                      "total_images_per_sec": ips, "device": name}}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
