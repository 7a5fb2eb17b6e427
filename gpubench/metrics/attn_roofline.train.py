"""Kernels: causal attention's least time over the device time of the
kernels that attention launched in the traced steps, in percent.

The least time is the larger of the operations the inputs need at the
bf16 peak (12 * head_dim per visible (query, key) pair per query head:
forward 4, backward 8, no recomputation counted) and the bytes they
need at the HBM peak (q, k, v, o, do, dq, dk, dv once each in bf16, the
f32 row statistics).  Attention kernels are matched by name: the port's
K4-K6 and the library's flash, memory-efficient and cuDNN forms."""

import re

from gpubench import peaks

PATTERN = re.compile(r"flash|fmha|sdpa|attention|attn", re.IGNORECASE)


def least_s(dims, seq, batch):
    h, hkv, dh = dims["h"], dims["hkv"], dims["dh"]
    pairs = seq * (seq + 1) // 2
    ops = 12 * dh * pairs * h * batch
    q = batch * seq * h * dh * 2
    kv = batch * seq * hkv * dh * 2
    # read q, k, v; write o; read q, k, v, o, do; write dq, dk, dv;
    # lse and delta in f32
    nbytes = 6 * q + 6 * kv + 3 * batch * seq * h * 4
    return max(ops / peaks.BF16_FLOPS, nbytes / peaks.HBM_BYTES_PER_S)


def read(run):
    if run.get("kind") != "train" or not run.get("trace"):
        return None
    busy = sum(b - a for name, a, b in run["trace"]["ops"]
               if PATTERN.search(name))
    if busy <= 0:
        return None
    tr = run["train"]
    least = (least_s(run["dims"], int(tr["seq"]), int(tr["batch"]))
             * run["dims"]["layers"] * run["trace_steps"])
    return 100.0 * least / busy
