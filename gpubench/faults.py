"""Faults planted under a run, for the checks that must catch them.

    python3 -m gpubench.faults --workload <cell> --fault <name> --seed <n> --seconds <s>

runs the cell as ``gpubench.run`` does with the timed path broken
underneath and prints the result line (``correct`` should read false).
The CPU tests plant the same functions at a tiny size.

* ``frozen`` (training): a step that computes the loss and gradients
  and leaves the parameters and the optimizer as they were.
* ``half_batch`` (training): half of each batch left out, the mean taken
  over the rest: half the rows where the batch has several, else the
  second half of the sequence's labels.
* ``altered_token`` (serving): the 4th output token of every request
  changed where the host loop takes it from the engine.
"""

from __future__ import annotations

import argparse
import json
import sys


def frozen(model, opt, tokens, labels, positions):
    from tpu_k8s_device_plugin_torch.workloads import transformer

    opt.zero_grad(set_to_none=True)
    loss = transformer.lm_loss(model, tokens, labels, positions)
    loss.backward()
    return loss.detach()


def half_batch(model, opt, tokens, labels, positions):
    from tpu_k8s_device_plugin_torch.workloads import transformer

    b = tokens.shape[0]
    if b > 1:
        h = b // 2
        return transformer.lm_train_step(model, opt, tokens[:h], labels[:h],
                                         positions[:h])
    t = labels.shape[1]
    cut = labels.clone()
    cut[:, t // 2:] = -1
    return transformer.lm_train_step(model, opt, tokens, cut, positions)


def altered_token(vocab: int):
    def alter(q, new):
        j = 3 - len(q.tokens)
        if 0 <= j < len(new):
            new = list(new)
            new[j] = (new[j] + 1) % vocab
        return new

    return alter


def main(argv=None) -> int:
    from . import run, spec, weights

    p = argparse.ArgumentParser(prog="gpubench.faults")
    p.add_argument("--workload", required=True)
    p.add_argument("--fault", required=True,
                   choices=("frozen", "half_batch", "altered_token"))
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    run.set_env()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    bench = spec.benchmark()
    cell = spec.cell(args.workload, bench)
    fault = {"frozen": frozen, "half_batch": half_batch}.get(args.fault)
    if fault is None:
        cfg = spec.config(cell["config"], bench)
        fault = altered_token(weights.dims(cfg)["vocab"])
    out = run.run_cell(args.workload, args.seed, args.seconds, False,
                       torch.device("cuda", 0),
                       dict(platform="gpu",
                            kind=torch.cuda.get_device_name(0), count=1),
                       bench=bench, fault=fault)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
