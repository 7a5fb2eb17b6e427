"""The port's weight-only int8 and int4 decoders against the JAX
package's, on the CPU, in f32.

Mirrors tests/test_int4.py (and the int8 half of tests/test_llama.py's
quantized cases): the int4 packing is lossless over the whole [-8, 7]
grid; the port's ``quantize_lm_params`` and ``quantize_lm_params_int4``
of converted weights equal ``convert.params_from_jax`` of the
reference's quantized trees bit for bit; the int8 and int4 decoders'
greedy ids equal the JAX decoders', through the loop and the engine;
``random_quantized_params`` builds the tree the quantizer would; int4
with experts is refused."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_k8s_device_plugin.workloads import inference as jinf
from tpu_k8s_device_plugin.workloads import llama as jllama
from tpu_k8s_device_plugin.workloads import serving as jserving
from tpu_k8s_device_plugin_torch.convert import params_from_jax
from tpu_k8s_device_plugin_torch.workloads import inference as tinf
from tpu_k8s_device_plugin_torch.workloads import llama as tllama
from tpu_k8s_device_plugin_torch.workloads import serving as tserving

CFG = dict(vocab=96, d_model=64, n_heads=4, n_layers=2, d_ff=128)
QUANT = {"int8": (True, jinf.quantize_lm_params, tinf.quantize_lm_params),
         "int4": ("int4", jinf.quantize_lm_params_int4,
                  tinf.quantize_lm_params_int4)}


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def trained():
    model = jinf.make_decoder(**CFG, max_len=64, dtype=jnp.float32)
    tokens = jnp.zeros((1, 8), jnp.int32)
    pos = jnp.broadcast_to(jnp.arange(8, dtype=jnp.int32), (1, 8))
    return _host(model.init(jax.random.PRNGKey(0), tokens, pos)["params"])


def test_pack_unpack_exact_over_full_grid():
    """Every value of the grid in both nibbles of a byte, bit for bit,
    and the same bytes as the reference's packing."""
    lo, hi = np.meshgrid(np.arange(-8, 8), np.arange(-8, 8))
    vals = np.stack([lo.ravel(), hi.ravel()], axis=1).reshape(16, 32)
    vals = vals.astype(np.int8)
    packed = tinf.pack_int4(torch.from_numpy(vals))
    assert packed.dtype == torch.int8 and tuple(packed.shape) == (16, 16)
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jinf.pack_int4(vals)))
    np.testing.assert_array_equal(tinf.unpack_int4(packed).numpy(), vals)
    every_byte = np.arange(-128, 128, dtype=np.int8).reshape(16, 16)
    np.testing.assert_array_equal(
        tinf.unpack_int4(torch.from_numpy(every_byte)).numpy(),
        np.asarray(jinf.unpack_int4(jnp.asarray(every_byte))))
    w = np.random.default_rng(1).integers(-8, 8, (32, 48)).astype(np.int8)
    np.testing.assert_array_equal(
        tinf.unpack_int4(tinf.pack_int4(torch.from_numpy(w))).numpy(), w)


@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("config", ["gelu", "llama"])
def test_quantized_tree_equals_reference(trained, kind, config):
    """The port's quantizer over converted f32 weights gives the
    reference quantizer's tree, converted: the same keys, dtypes and
    shapes, every int8 byte and every f32 scale bit for bit."""
    _, jquant, tquant = QUANT[kind]
    params = trained
    if config == "llama":
        base = jllama.train_model(jllama.TINY_LLAMA, dtype=jnp.float32)
        params = _host(base.init(
            jax.random.PRNGKey(2), jnp.zeros((1, 8), jnp.int32),
            jnp.broadcast_to(jnp.arange(8, dtype=jnp.int32), (1, 8)))[
                "params"])
    want = params_from_jax(_host(jquant(params)))
    got = tquant(params_from_jax(params))
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        assert g.dtype == w.dtype and g.shape == w.shape, key
        np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=key)
    quantized = [k for k in got if k.endswith(("kernel_int8",
                                               "kernel_int4"))]
    n_proj = 4 if config == "gelu" else 5
    assert len(quantized) == 2 * n_proj + 1  # the blocks and the head


def _pair(trained, kind, max_len=64):
    flag, jquant, _ = QUANT[kind]
    jp = _host(jquant(trained))
    jdec = jinf.make_decoder(**CFG, max_len=max_len, dtype=jnp.float32,
                             quantized=flag)
    tdec = tinf.make_decoder(**CFG, max_len=max_len, dtype=torch.float32,
                             quantized=flag, device="cpu")
    tdec.load_state_dict(params_from_jax(jp))
    return jdec, jp, tdec


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_quantized_greedy_ids_match_reference(trained, kind):
    """Prefill logits within 1e-4 and greedy ids identical to the JAX
    decoder's, at two batch sizes."""
    jdec, jp, tdec = _pair(trained, kind)
    for batch in (1, 3):
        prompt = np.random.default_rng(batch).integers(
            0, CFG["vocab"], (batch, 7)).astype(np.int32)
        want, wlog = jinf.greedy_generate(jdec, jp, jnp.asarray(prompt), 9)
        got, glog = tinf.greedy_generate(tdec, prompt, 9)
        np.testing.assert_allclose(glog.numpy(), np.asarray(wlog),
                                   atol=1e-4, rtol=0)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_quantized_engine_ids_match_reference(trained, kind):
    """Three requests through both engines: the same ids, and each the
    plain loop's."""
    jdec, jp, tdec = _pair(trained, kind)
    prompts = [[5, 17, 3], [11, 2, 9, 40, 41, 8, 1, 3, 60], [77]]
    jeng = jserving.ServingEngine(jdec, jp, n_slots=3, max_new_tokens=6)
    teng = tserving.ServingEngine(tdec, n_slots=3, max_new_tokens=6,
                                  device="cpu")
    for eng in (jeng, teng):
        for p in prompts:
            eng.admit(p)
        eng.run_scan(5)
    for s, p in enumerate(prompts):
        assert teng.finished(s)
        assert teng.output(s) == jeng.output(s)
        solo, _ = tinf.greedy_generate(tdec, [p], 6)
        assert teng.output(s) == solo[0].tolist()


def test_int4_chunked_rows_equal_one_piece(trained, monkeypatch):
    """The row chunks of ``Quant4Dense`` run each row through the same
    operations: a budget that makes one row a chunk gives the one-piece
    result up to the GEMM's summation order (f32, 1e-5)."""
    _, _, tdec = _pair(trained, "int4")
    x = torch.randn(5, 3, CFG["d_model"], generator=torch.Generator()
                    .manual_seed(0))
    layer = tdec.block_0.mlp_up
    whole = layer(x)
    monkeypatch.setattr(tinf, "_INT4_PARTIAL_BYTES", 1)
    torch.testing.assert_close(layer(x), whole, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bits", [8, 4])
def test_random_quantized_params_match_the_quantizer_layout(bits):
    """``random_quantized_params`` gives the keys, shapes and dtypes of
    the port's quantizer over a TINY_LLAMA state dict (the decoder's
    embedding in the compute dtype), and it loads and decodes."""
    cfg = tllama.TINY_LLAMA
    flag = "int4" if bits == 4 else True
    base = tllama.decoder(cfg, dtype=torch.float32, device="cpu")
    quant = (tinf.quantize_lm_params_int4 if bits == 4
             else tinf.quantize_lm_params)
    want = quant(base.state_dict())
    got = tllama.random_quantized_params(cfg, bits=bits, device="cpu",
                                         dtype=torch.float32)
    assert set(got) == set(want)
    for key, w in want.items():
        assert got[key].shape == w.shape and got[key].dtype == w.dtype, key
    model = tllama.decoder(cfg, quantized=flag, dtype=torch.float32,
                           device="cpu")
    model.load_state_dict(got)
    ids, _ = tinf.greedy_generate(model, [[3, 200, 100]], 4)
    assert tuple(ids.shape) == (1, 4)
    with pytest.raises(ValueError, match="bits"):
        tllama.random_quantized_params(cfg, bits=3, device="cpu")


def test_int4_moe_rejected(trained):
    with pytest.raises(NotImplementedError, match="int4"):
        tinf.make_decoder(**CFG, max_len=64, dtype=torch.float32,
                          quantized="int4", n_experts=4, device="cpu")
    bad = {"block_0.moe.experts_up": torch.zeros(2, 4, 8)}
    with pytest.raises(NotImplementedError, match="int8"):
        tinf.quantize_lm_params_int4(bad)


def test_int8_moe_tree_equals_reference_and_decodes():
    """int8 expert stacks with per-(expert, out-channel) scales: the
    port's quantizer gives the reference's tree, and the int8 MoE
    decoder's ids equal the JAX one's."""
    kw = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
              n_experts=4, moe_capacity_factor=2.0)
    jmodel = jinf.make_decoder(**kw, max_len=32, dtype=jnp.float32)
    params = _host(jmodel.init(
        jax.random.PRNGKey(3), jnp.zeros((1, 4), jnp.int32),
        jnp.broadcast_to(jnp.arange(4, dtype=jnp.int32), (1, 4)))[
            "params"])
    jq = _host(jinf.quantize_lm_params(params))
    want = params_from_jax(jq)
    got = tinf.quantize_lm_params(params_from_jax(params))
    assert set(got) == set(want)
    assert "block_0.moe.experts_up_int8" in got
    for key, w in want.items():
        np.testing.assert_array_equal(got[key].numpy(), w.numpy(),
                                      err_msg=key)
    jdec = jinf.make_decoder(**kw, max_len=32, dtype=jnp.float32,
                             quantized=True)
    tdec = tinf.make_decoder(**kw, max_len=32, dtype=torch.float32,
                             quantized=True, device="cpu")
    tdec.load_state_dict(want)
    prompt = np.asarray([[3, 9, 27, 17, 51]], np.int32)
    want_ids, _ = jinf.greedy_generate(jdec, jq, jnp.asarray(prompt), 8)
    got_ids, _ = tinf.greedy_generate(tdec, prompt, 8)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
