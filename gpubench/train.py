"""Training cells: the port's ``transformer.lm_train_step`` on its
``TransformerLM`` (f32 parameters, bf16 compute, the flash kernels K4
with its lse, K5 and K6) and ``torch.optim.Adam``.

Set-up builds one model and optimizer from the seed and drives it
through its first three steps, through the same call and feed as the
window; those three are what the reference follows: each step's loss,
each leaf's first gradient as Adam holds it after step 1 (its first
moment over ``1 - beta1``), and each leaf's change over the three
steps.  The window then runs further steps, each on a new batch, for
``--seconds``, and ends with a synchronise; with ``--trace 1`` the
profiler then records ``trace_steps`` steps more.
"""

from __future__ import annotations

import gc
import sys
import time
from typing import Dict, List

import torch

from . import weights
from .feed import Feed
from .trace import Tracer

def build(cfg: Dict, mix: Dict, seed: int, device):
    """The program under test: the training model at the
    configuration's widths with the benchmark's weights (f32), and its
    optimizer as the mix states it."""
    from tpu_k8s_device_plugin_torch.workloads import (flash_attention,
                                                        transformer)

    m = weights.dims(cfg)
    if m["dh"] * m["h"] != m["d"]:
        raise ValueError("the port's model takes head_dim = "
                         "hidden_size / num_attention_heads")
    model = transformer.TransformerLM(
        vocab=m["vocab"], d_model=m["d"], n_heads=m["h"],
        n_layers=m["layers"], d_ff=m["f"], dtype=torch.bfloat16,
        attn_fn=flash_attention.flash_causal_attention,
        n_kv_heads=m["hkv"], ffn="swiglu",
        rope_theta=float(cfg["rope_theta"]), device="meta")
    flat, norms = weights.make(cfg, seed, device, torch.float32)
    weights.bind_(model, cfg, flat, norms)
    del flat, norms
    a = mix["train"]["adam"]
    opt = torch.optim.Adam(model.parameters(), lr=float(a["lr"]),
                           betas=tuple(a["betas"]), eps=float(a["eps"]))
    return model, opt


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    vals = torch.stack([tensors[n].float().norm() for n in names]).tolist()
    return dict(zip(names, vals))


def run(cfg: Dict, mix: Dict, seed: int, seconds: float, trace: bool,
        device, t_process: float, fault=None) -> Dict:
    """One training run; the run record.  *fault* (tests only) replaces
    the step function."""
    from tpu_k8s_device_plugin_torch.workloads import transformer

    tr = mix["train"]
    m = weights.dims(cfg)
    t_build = time.perf_counter()
    model, opt = build(cfg, mix, seed, device)
    feed = Feed(m["vocab"], int(tr["batch"]), int(tr["seq"]), seed, device)
    step_fn = fault or transformer.lm_train_step

    def step():
        tokens, labels = feed.next()
        return step_fn(model, opt, tokens, labels, feed.positions)

    params = dict(model.named_parameters())
    beta1 = float(tr["adam"]["betas"][0])
    losses = [step()]
    grads = {}
    for n, p in params.items():
        st = opt.state.get(p, {})
        grads[n] = (st["exp_avg"] / (1.0 - beta1) if "exp_avg" in st
                    else torch.zeros_like(p))
    g1 = _norms(grads)
    del grads
    losses += [step(), step()]
    losses = [float(x) for x in losses]
    flat0, norms0 = weights.make(cfg, seed, device, torch.float32)
    start = weights.leaves(cfg, flat0, norms0)
    dp = _norms({n: p.detach() - start[n] for n, p in params.items()})
    del flat0, norms0, start
    tracer = Tracer()
    n_trace = int(tr.get("trace_steps", 2))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    setup_s = t0 - t_process
    n = 0
    last = None
    while time.perf_counter() - t0 < seconds:
        last = step()
        n += 1
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t1 = time.perf_counter()
    if trace:
        tracer.start()
        for _ in range(n_trace):
            with tracer.phase("step"):
                step()
        tracer.stop()
    failed = 0 if last is None or torch.isfinite(last).item() else 1
    peak = 0
    if device.type == "cuda":
        peak = torch.cuda.max_memory_allocated(device)
    print(f"gpubench train: process to build {t_build - t_process:.2f} s, "
          f"set-up {t0 - t_build:.2f} s, window {t1 - t0:.3f} s, {n} steps "
          f"({1e3 * (t1 - t0) / max(n, 1):.3f} ms a step); losses "
          f"{losses}; peak {peak / 2**30:.2f} GiB", file=sys.stderr,
          flush=True)
    record = dict(kind="train", t0=t0, t1=t1, steps=n, setup_s=setup_s,
                  attempted=n, failed=failed, losses=losses, g1=g1, dp=dp,
                  trace=tracer.result or None, trace_steps=n_trace,
                  memory_peak_bytes=peak, dims=m, train=tr)
    del model, opt, params, feed, last
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return record


def _worst(prog: Dict[str, float], ref: Dict[str, float],
           names: List[str]) -> float:
    """The worst leaf's gap between the program's norm and the
    reference's, over the larger of that leaf's reference norm and the
    median leaf's."""
    med = sorted(ref[n] for n in names)[len(names) // 2]
    return max(abs(prog[n] - ref[n]) / max(ref[n], med) for n in names)


def gaps(record: Dict, ref: Dict) -> Dict[str, float]:
    """The three numbers compared: the first step's relative loss gap,
    the worst leaf's first-gradient gap, the worst leaf's change gap
    (leaves whose reference gradient is under a thousandth of the
    median leaf's left out: Adam moves those by round-off alone).
    Steps 2 and 3's loss gaps are read (``loss_gaps``) and not compared:
    after Adam's first, nearly sign-sized update the two trajectories
    part by whatever small gradients changed sign under rounding, so
    they swing from seed to seed (PERF.md)."""
    names = sorted(ref["g1"])
    med_g = sorted(ref["g1"][n] for n in names)[len(names) // 2]
    moved = [n for n in names if ref["g1"][n] >= 1e-3 * med_g]
    steps = [abs(a - b) / abs(b)
             for a, b in zip(record["losses"], ref["losses"])]
    return dict(loss_gap=steps[0],
                grad_gap=_worst(record["g1"], ref["g1"], names),
                update_gap=_worst(record["dp"], ref["dp"], moved),
                loss_gaps=steps)


def checks(record: Dict, limits: Dict, seed: int, cfg: Dict, device,
           control: bool) -> Dict[str, Dict]:
    """The compared numbers beside their limits; with *control*, the
    reference's own steps with float8 e4m3 matmuls are judged in the
    program's place."""
    from .reference import train as ref_train

    tr = record["train"]
    ref = ref_train.steps(cfg, tr, seed, device)
    if control:
        record = ref_train.steps(cfg, tr, seed, device,
                                 quant=ref_train.fp8_e4m3)
    got = gaps(record, ref)
    print(f"loss gaps by step {got.pop('loss_gaps')}", file=sys.stderr,
          flush=True)
    return {k: dict(value=v, limit=float(limits[k]["limit"]),
                    ok=v <= float(limits[k]["limit"]))
            for k, v in got.items()}
