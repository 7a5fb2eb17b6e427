"""LM training step: analytic FLOPs of a step (``lm_flops``, copied from
the port's ``chip_smoke.lm_flops_per_step``) over ``train_step_ms`` and
the bf16 peak, in percent."""

from gpubench import peaks, readings


def lm_flops(dims, seq, batch=1):
    """6 per matmul parameter per token (the embedding is a gather and
    counts nothing) and 12 * head_dim per visible (query, key) pair per
    query head per layer (forward 4, backward 8; the backward's
    recomputed scores are not counted)."""
    mp = readings.matmul_params(dims)
    pairs = seq * (seq + 1) // 2
    return batch * (6 * (mp["blocks"] + mp["head"]) * seq
                    + 12 * dims["dh"] * pairs * dims["h"] * dims["layers"])


def read(run):
    if run.get("kind") != "train" or not run["steps"]:
        return None
    step_s = (run["t1"] - run["t0"]) / run["steps"]
    f = lm_flops(run["dims"], int(run["train"]["seq"]),
                 int(run["train"]["batch"]))
    return 100.0 * f / step_s / peaks.BF16_FLOPS
