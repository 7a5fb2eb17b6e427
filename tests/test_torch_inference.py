"""The port's decoder against the JAX package's, on converted weights.

Two models: the gelu ``TransformerLM`` of tests/test_inference.py and
``llama.train_model(TINY_LLAMA)`` (SwiGLU, GQA 4:1, theta 5e5).  Both
are initialised by JAX, converted with ``convert.params_from_jax`` and
run on the CPU.  Prompts come from numpy with a seed.  In f32 the
logits agree to 1e-4 (the two frameworks sum in different orders) and
greedy ids agree exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_k8s_device_plugin.workloads import inference as jinf
from tpu_k8s_device_plugin.workloads import llama as jllama
from tpu_k8s_device_plugin.workloads.transformer import TransformerLM
from tpu_k8s_device_plugin_torch.convert import params_from_jax
from tpu_k8s_device_plugin_torch.workloads import bench_serving as tbench
from tpu_k8s_device_plugin_torch.workloads import inference as tinf

GELU = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64)
_L = jllama.TINY_LLAMA
LLAMA = dict(vocab=_L.vocab, d_model=_L.d_model, n_heads=_L.n_heads,
             n_layers=_L.n_layers, d_ff=_L.d_ff, n_kv_heads=_L.n_kv_heads,
             ffn="swiglu", rope_theta=_L.rope_theta)
_DT = {"f32": (jnp.float32, torch.float32),
       "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module", params=["gelu", "llama"])
def trained(request):
    """(decoder kwargs, JAX params) — the training models' own init."""
    tokens = jnp.zeros((2, 8), jnp.int32)
    if request.param == "gelu":
        params = TransformerLM(**GELU).init(
            jax.random.PRNGKey(3), tokens)["params"]
        return GELU, params
    params = jllama.train_model(_L).init(
        jax.random.PRNGKey(4), tokens)["params"]
    return LLAMA, params


def _pair(trained, max_len=32, dtype="f32"):
    kw, params = trained
    jd, td = _DT[dtype]
    jdec = jinf.make_decoder(**kw, max_len=max_len, dtype=jd)
    tdec = tinf.make_decoder(**kw, max_len=max_len, dtype=td, device="cpu")
    tdec.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return jdec, params, tdec


def _prompt(vocab, shape, seed):
    return np.random.default_rng(seed).integers(
        0, vocab, shape).astype(np.int32)


def _jax_prefill(jdec, params, prompt):
    B, T = prompt.shape
    pos = jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32), (B, T))
    logits, mut = jdec.apply(
        {"params": params, "cache": jinf.init_cache(jdec, B)},
        jnp.asarray(prompt), pos, mutable=["cache"])
    return np.asarray(logits), mut["cache"]


def _port_prefill(tdec, prompt):
    B, T = prompt.shape
    pos = torch.arange(T, dtype=torch.int32).expand(B, T)
    logits, cache = tinf._prefill(tdec, torch.from_numpy(prompt), pos)
    return logits.numpy(), cache


def test_prefill_logits_and_cache_match(trained):
    jdec, params, tdec = _pair(trained)
    prompt = _prompt(jdec.vocab, (2, 8), 1)
    want, jcache = _jax_prefill(jdec, params, prompt)
    got, tcache = _port_prefill(tdec, prompt)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    assert set(tcache) == set(jcache)
    for name, layer in jcache.items():
        for key, arr in layer.items():
            assert tuple(tcache[name][key].shape) == arr.shape, key
            np.testing.assert_allclose(
                tcache[name][key].numpy(), np.asarray(arr),
                atol=1e-4, rtol=1e-4)


def test_forced_flash_prefill_matches(trained, monkeypatch):
    """The flash branch of prefill, forced on a short prompt by the same
    threshold in both packages (tests/test_inference.py does this for
    JAX alone)."""
    monkeypatch.setattr(jinf, "_FLASH_PREFILL_MIN_T", 8)
    monkeypatch.setattr(tinf, "_FLASH_PREFILL_MIN_T", 8)
    jdec, params, tdec = _pair(trained, max_len=64)
    prompt = _prompt(jdec.vocab, (2, 16), 2)
    want, _ = _jax_prefill(jdec, params, prompt)
    got, _ = _port_prefill(tdec, prompt)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_cache_lens_advance(trained):
    _, _, tdec = _pair(trained)
    logits, cache = tinf._prefill(
        tdec, torch.zeros(1, 4, dtype=torch.long),
        torch.arange(4, dtype=torch.int32)[None])
    assert cache["block_0"]["cache_lens"].tolist() == [4]
    _, cache = tinf.extend_step(
        tdec, cache, torch.zeros(1, 1, dtype=torch.long),
        torch.full((1, 1), 4, dtype=torch.int32))
    assert cache["block_0"]["cache_lens"].tolist() == [5]
    assert cache["block_0"]["cache_lens"].dtype == torch.int32


def test_greedy_ids_identical_f32(trained):
    jdec, params, tdec = _pair(trained)
    prompt = _prompt(jdec.vocab, (2, 6), 3)
    want, want_logits = jinf.greedy_generate(
        jdec, params, jnp.asarray(prompt), 12)
    got, got_logits = tinf.greedy_generate(tdec, prompt, 12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               atol=1e-4, rtol=1e-4)


def test_request_errors(trained):
    _, _, tdec = _pair(trained, max_len=16)
    with pytest.raises(ValueError, match="max_len"):
        tinf.greedy_generate(tdec, np.zeros((1, 10), np.int32), 8)
    with pytest.raises(ValueError, match="n_steps"):
        tinf.greedy_generate(tdec, np.zeros((1, 4), np.int32), 0)
    with pytest.raises(ValueError, match="top_k"):
        tinf.sample_generate(tdec, np.zeros((1, 4), np.int32), 4, 0,
                             top_k=tdec.vocab + 1)


@pytest.mark.parametrize("kw", [dict(temperature=1e-4), dict(top_k=1)])
def test_sampling_recovers_greedy(trained, kw):
    _, _, tdec = _pair(trained)
    prompt = _prompt(tdec.vocab, (2, 5), 4)
    greedy, _ = tinf.greedy_generate(tdec, prompt, 8)
    sampled = tinf.sample_generate(tdec, prompt, 8, 0, **kw)
    np.testing.assert_array_equal(sampled.numpy(), greedy.numpy())


def test_sampling_reproducible_and_seed_sensitive(trained):
    _, _, tdec = _pair(trained)
    prompt = _prompt(tdec.vocab, (2, 4), 5)

    def draw(key):
        return tinf.sample_generate(tdec, prompt, 8, key,
                                    temperature=2.0).numpy()

    np.testing.assert_array_equal(draw(7), draw(7))
    assert not np.array_equal(draw(7), draw(8))


def test_bf16_prefill_close(trained):
    """bf16 end to end in both packages.  The frameworks round at other
    places (GEMM output, gelu/silu, the residual adds), so only the
    logits are held: these reach |4|, where one bf16 ulp is 1/64, and
    the bound allows about four ulps (two were seen).  Ids are not
    asserted, since a near tie may flip."""
    jdec, params, tdec = _pair(trained, dtype="bf16")
    prompt = _prompt(jdec.vocab, (2, 8), 6)
    want, _ = _jax_prefill(jdec, params, prompt)
    got, _ = _port_prefill(tdec, prompt)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=6e-2, rtol=0)


def test_unported_features_raise():
    """Quantized weights, experts and adapters are ported now: each
    builds a decoder that generates.  The paged pool is ported: a
    ``kv_page_size`` decoder builds, its extend needs block tables and
    its prefill raises as the reference's does; a contiguous decoder
    ignores block tables."""
    for kw in (dict(quantized=True), dict(quantized="int4"),
               dict(n_experts=4), dict(n_adapters=2)):
        model = tinf.DecodeTransformerLM(**GELU, max_len=16, device="cpu",
                                         dtype=torch.float32, **kw)
        gen = torch.Generator().manual_seed(1)
        for p in model.parameters():
            if p.is_floating_point():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
        ids, _ = tinf.greedy_generate(model, [[1, 2, 3]], 4)
        assert tuple(ids.shape) == (1, 4)
    paged = tinf.DecodeTransformerLM(**GELU, device="cpu", kv_page_size=8)
    pool = tinf.init_pool_cache(paged, 1, 4, 8)
    tok = torch.zeros(1, 1, dtype=torch.long)
    pos = torch.zeros(1, 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="block_tables"):
        tinf.extend_step(paged, pool, tok, pos)
    with pytest.raises(NotImplementedError, match="EXTEND path only"):
        paged(tok, pos, pool)
    tdec = tinf.make_decoder(**GELU, max_len=16, dtype=torch.float32,
                             device="cpu")
    gen = torch.Generator().manual_seed(0)
    for p in tdec.parameters():
        p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    cache = tinf.init_cache(tdec, 1)
    want, _ = tinf.extend_step(tdec, tinf.init_cache(tdec, 1), tok, pos)
    # a decoder without adapters ignores adapter ids, as the reference's
    got, _ = tinf.extend_step(tdec, tinf.init_cache(tdec, 1), tok, pos,
                              adapter_ids=torch.zeros(1, dtype=torch.int32))
    assert torch.equal(got, want)
    got, _ = tinf.extend_step(
        tdec, cache, tok, pos,
        block_tables=torch.zeros(1, 2, dtype=torch.int32))
    assert torch.equal(got, want)


def test_converter_rejects_quantized_tree():
    """Quantized trees convert now: an int8 kernel keeps its [in, out]
    layout and dtype (a packed int4 one too: never transposed), its
    scale is as it is; a leaf of no LM layer is still refused."""
    w8 = np.arange(32, dtype=np.int8).reshape(4, 8)
    w4 = np.arange(16, dtype=np.int8).reshape(4, 4)
    tree = {"block_0": {"qkv": {"kernel_int8": w8,
                                "scale": np.ones(8, np.float32)},
                        "mlp_up": {"kernel_int4": w4,
                                   "scale": np.ones((1, 8), np.float32)}}}
    sd = params_from_jax(tree)
    assert sd["block_0.qkv.kernel_int8"].dtype == torch.int8
    np.testing.assert_array_equal(sd["block_0.qkv.kernel_int8"].numpy(), w8)
    np.testing.assert_array_equal(sd["block_0.mlp_up.kernel_int4"].numpy(),
                                  w4)
    assert sd["block_0.qkv.scale"].dtype == torch.float32
    with pytest.raises(ValueError, match="not an LM parameter"):
        params_from_jax({"block_0": {"qkv": {"bias": np.ones(8)}}})


def test_decode_throughput_smoke(trained):
    _, _, tdec = _pair(trained)
    stats = tinf.decode_throughput(
        tdec, np.zeros((2, 4), np.int32), n_steps=4, rounds=1)
    assert stats["tokens_per_sec"] > 0 and stats["prefill_ms"] > 0


def test_random_init_matches_flax_scales():
    """The benchmark's random weights have flax's initializer scales:
    lecun-normal Dense kernels (truncated at 2 sd) and the Embed
    default, normal with sd 1/sqrt(d_model)."""
    import flax.linen as nn

    model = tinf.make_decoder(**LLAMA, max_len=16, device="cpu")
    tbench.random_init_(model, seed=0)
    key = jax.random.PRNGKey(0)
    d, f, v = LLAMA["d_model"], LLAMA["d_ff"], LLAMA["vocab"]
    flax_gate = nn.Dense(f).init(key, jnp.zeros((1, d)))["params"]["kernel"]
    flax_embed = nn.Embed(v, d).init(
        key, jnp.zeros((1,), jnp.int32))["params"]["embedding"]
    for ours, theirs in ((model.embed.weight, flax_embed),
                         (model.block_0.mlp_gate.weight, flax_gate)):
        ours = ours.float().numpy()
        theirs = np.asarray(theirs)
        np.testing.assert_allclose(ours.std(), theirs.std(), rtol=0.05)
        np.testing.assert_allclose(np.abs(ours).max(), np.abs(theirs).max(),
                                   rtol=0.2)
    assert (model.block_1.attn_norm.scale == 1).all()


def test_bench_serving_cli(capsys):
    import json

    assert tbench.main(["--config", "tiny", "--device", "cpu", "--batch",
                        "2", "--prompt-len", "8", "--steps", "4",
                        "--max-len", "32"]) == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["device"] == "cpu" and stats["tokens_per_sec"] > 0
    # --spec, --quantized and --int4 are ported: each prints its JSON line
    for flag, key in ((["--spec", "2"], "breakeven_accept"),
                      (["--quantized"], "tokens_per_sec"),
                      (["--int4", "--engine"], "tokens_per_sec")):
        assert tbench.main(["--config", "tiny", "--device", "cpu",
                            "--prompt-len", "8", "--steps", "4",
                            "--max-len", "64", *flag]) == 0
        stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert stats[key] >= 0 and stats["device"] == "cpu"
    assert stats["quantized"] == "int4"
    with pytest.raises(SystemExit):
        tbench.main(["--config", "tiny", "--device", "cpu", "--quantized",
                     "--int4"])
    assert "mutually exclusive" in capsys.readouterr().err
