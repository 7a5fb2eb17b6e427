"""The plain reference against the port at a tiny preset on the CPU,
and the lower-precision control reading a wider gap than the program.
(A run with the control in the program's place is judged not correct
in ``test_gpubench_harness.py`` and ``test_gpubench_train.py``.)"""

import torch

from gpubench import check, weights
from gpubench.reference import model as ref
from gpubench.tests.conftest import TINY


def _port_logits(cfg, seed, ids, dtype):
    from tpu_k8s_device_plugin_torch.workloads import inference

    m = weights.dims(cfg)
    dec = inference.make_decoder(
        vocab=m["vocab"], d_model=m["d"], n_heads=m["h"],
        n_layers=m["layers"], d_ff=m["f"], max_len=128, dtype=dtype,
        n_kv_heads=m["hkv"], ffn="swiglu",
        rope_theta=float(cfg["rope_theta"]), device="cpu")
    flat, norms = weights.make(cfg, seed, "cpu", dtype)
    weights.bind_(dec, cfg, flat, norms)
    cache = inference.init_cache(dec, 1)
    pos = torch.arange(len(ids), dtype=torch.int32)[None]
    with torch.no_grad():
        return dec(torch.tensor([ids]), pos, cache)[0]


def test_reference_matches_the_port_in_f32():
    ids = list(range(3, 3 + 40))
    seed = 2**31 + 77
    got = _port_logits(TINY, seed, ids, torch.float32)
    flat, norms = weights.make(TINY, seed, "cpu", torch.float32)
    table = weights.leaves(TINY, flat, norms)
    want = ref.forward_logits(TINY, table.__getitem__,
                              [torch.tensor(ids)],
                              [torch.arange(len(ids))])[0]
    assert (got - want).abs().max() < 1e-4 * want.abs().max()


def test_served_tokens_of_the_reference_read_no_gap():
    flat, norms = weights.make(TINY, 5, "cpu", torch.bfloat16)
    table = weights.leaves(TINY, flat, norms)
    prompt = [7, 8, 9, 10, 11]
    seq = list(prompt)
    for _ in range(12):   # the reference's own greedy tokens
        lg = ref.forward_logits(TINY, table.__getitem__,
                                [torch.tensor(seq)],
                                [torch.tensor([len(seq) - 1])])[0]
        seq.append(int(lg.argmax()))
    got = check.served_gaps(TINY, 5, [dict(prompt=prompt,
                                           served=seq[len(prompt):])],
                            "cpu")
    assert got["logit_gap"] == 0.0 and got["tokens"] == 12


def test_fp8_rounds_coarser_than_bf16():
    x = torch.randn(4096)
    e8 = (ref.fp8_e4m3(x) - x).abs().mean()
    e16 = (x.bfloat16().float() - x).abs().mean()
    assert e8 > 8 * e16
