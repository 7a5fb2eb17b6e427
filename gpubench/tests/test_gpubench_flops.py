"""The metric files' work counts against counts made by hand."""

from gpubench import readings, spec, weights


def _dims(name):
    return weights.dims(spec.config(name, spec.benchmark()))


def test_parameters_by_hand():
    m = _dims("mistral-7b-v0.3")
    # qkv 4096 x (32 + 16) x 128, out 4096^2, three 4096 x 14336
    per_layer = 4096 * 6144 + 4096 * 4096 + 3 * 4096 * 14336
    assert per_layer == 218_103_808
    mp = readings.matmul_params(m)
    assert mp["blocks"] == 32 * per_layer
    assert mp["head"] == 4096 * 32768
    # 7.25 B with the embedding
    assert mp["blocks"] + 2 * mp["head"] == 7_247_757_312
    d = _dims("deepseek-llm-7b")
    per_layer = 4096 * 3 * 4096 + 4096 * 4096 + 3 * 4096 * 11008
    mp = readings.matmul_params(d)
    assert mp["blocks"] == 30 * per_layer
    assert mp["blocks"] + 2 * mp["head"] == 6_910_115_840


def test_serve_flops_by_hand():
    m = _dims("mistral-7b-v0.3")
    blocks = 32 * 218_103_808
    head = 4096 * 32768
    attn = 4 * 128 * 32 * 32
    # a 300-token prompt, 256 of it from the prefix cache, first token
    # at t 1.5 and two more at t 2.0 and t 3.5 (outside the window)
    req = dict(due=0.0, pull=1.0, first=1.5, done=None,
               times=[1.5, 2.0, 2.0, 3.5], prompt_len=300, reused=256,
               n_out=4, caller=-1)
    run = dict(kind="serve", t0=1.0, t1=3.0, requests=[req], dims=m,
               steps=[])
    prefill = 2 * blocks * 44 + attn * sum(range(257, 301))
    out = 3 * 2 * head + 2 * (2 * blocks) + attn * (301 + 302)
    assert readings.serve_flops(run) == prefill + out


def test_training_flops_by_hand():
    m = _dims("mistral-7b-v0.3-pp4")
    lm = spec.reader("mfu.train").__globals__["lm_flops"]
    got = lm(m, 8192)
    matmul = 8 * 218_103_808 + 4096 * 32768
    want = 6 * matmul * 8192 + 12 * 128 * (8192 * 8193 // 2) * 32 * 8
    assert got == want
    assert abs(got - 1.0555e14) / 1.0555e14 < 1e-3


def test_attention_least_time_by_hand():
    m = _dims("mistral-7b-v0.3-pp4")
    least = spec.reader("attn_roofline.train").__globals__["least_s"]
    ops = 12 * 128 * (8192 * 8193 // 2) * 32
    assert least(m, 8192, 1) == ops / 989e12
