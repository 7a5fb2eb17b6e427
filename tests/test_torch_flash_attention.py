"""The port's flash attention against the JAX package's.

On the CPU the port's ``flash_attention`` is its plain version; the JAX
function runs its Pallas kernel in interpret mode, as
tests/test_flash_attention.py runs it.  Inputs come from numpy with a
seed and go to both.  Tolerances are the JAX package's own contract:
2e-5 in f32, 3e-2 in bf16."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_k8s_device_plugin.workloads.transformer import repeat_kv

from tpu_k8s_device_plugin_torch.workloads import flash_attention as tfa

# the JAX package's workloads/__init__ re-exports the function under the
# module's name, so its module is looked up by the full name
jfa = importlib.import_module(
    "tpu_k8s_device_plugin.workloads.flash_attention")


def _inputs(shape, kv_heads=None, seed=0):
    rng = np.random.default_rng(seed)
    kv_shape = shape[:2] + (kv_heads or shape[2], shape[3])
    return (rng.standard_normal(shape, np.float32),
            rng.standard_normal(kv_shape, np.float32),
            rng.standard_normal(kv_shape, np.float32))


def _jax(q, k, v, causal, dtype=jnp.float32, **blocks):
    q, k, v = (jnp.asarray(x, dtype) for x in (q, k, v))
    k, v = repeat_kv(k, q.shape[2]), repeat_kv(v, q.shape[2])
    out = jfa.flash_attention(q, k, v, causal=causal, **blocks)
    return np.asarray(out, np.float32)


def _port(q, k, v, causal, dtype=torch.float32):
    q, k, v = (torch.from_numpy(x).to(dtype) for x in (q, k, v))
    return tfa.flash_attention(q, k, v, causal=causal).float().numpy()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize(
    "shape,blocks",
    [
        ((2, 64, 2, 16), (32, 32)),
        ((1, 128, 2, 8), (64, 32)),
        ((2, 32, 1, 32), (64, 64)),
        ((1, 96, 1, 8), (64, 64)),    # T does not divide the block
    ],
)
def test_matches_jax_f32(causal, shape, blocks):
    q, k, v = _inputs(shape)
    want = _jax(q, k, v, causal, block_q=blocks[0], block_k=blocks[1])
    np.testing.assert_allclose(_port(q, k, v, causal), want,
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_grouped_kv_matches_jax_repeat_kv(causal):
    """The port takes grouped K/V as they are; JAX expands them with
    repeat_kv first.  Same function."""
    q, k, v = _inputs((2, 64, 4, 16), kv_heads=2, seed=1)
    np.testing.assert_allclose(_port(q, k, v, causal),
                               _jax(q, k, v, causal),
                               atol=2e-5, rtol=2e-5)


def test_bf16_matches_jax():
    q, k, v = _inputs((2, 64, 2, 16), seed=2)
    got = _port(q, k, v, True, torch.bfloat16)
    want = _jax(q, k, v, True, jnp.bfloat16)
    np.testing.assert_allclose(got, want, atol=3e-2, rtol=3e-2)


def test_causal_adapter_ignores_positions():
    q, k, v = (torch.from_numpy(x) for x in _inputs((1, 32, 4, 16), 2, 3))
    pos = torch.arange(32).expand(1, 32)
    torch.testing.assert_close(
        tfa.flash_causal_attention(q, k, v, pos),
        tfa.flash_attention(q, k, v, causal=True), rtol=0, atol=0)


def test_shape_errors():
    q = torch.zeros(1, 8, 4, 16)
    with pytest.raises(ValueError, match="Tq == Tk"):
        tfa.flash_attention(q, torch.zeros(1, 9, 4, 16),
                            torch.zeros(1, 9, 4, 16), causal=True)
    with pytest.raises(ValueError, match="must divide"):
        tfa.flash_attention(q, torch.zeros(1, 8, 3, 16),
                            torch.zeros(1, 8, 3, 16))


def test_kernel_wrapper_takes_only_cuda_tensors():
    """The kernel wrapper never computes on the CPU: a CPU tensor is
    refused before any build or launch, and the count does not move."""
    q = torch.zeros(1, 8, 2, 16)
    before = tfa.flash_attention_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_cuda(q, q, q, causal=True)
    assert tfa.flash_attention_cuda.launches == before
