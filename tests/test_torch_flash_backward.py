"""The port's flash-attention training form against the JAX package's.

On the CPU the port's wrappers take their plain versions, through the
same ``torch.autograd.Function`` the kernels use on the card: the
forward's logsumexp residual, delta from the stored output, then the
dQ and dK/dV steps.  The JAX functions run their Pallas kernels in
interpret mode, as tests/test_flash_attention.py runs them, at that
file's shapes.  Inputs come from numpy with a seed and go to both.
Tolerances are the JAX package's own contract: the forward and its lse
at 2e-5 in f32, gradients at 5e-4 in f32 and 5e-2 in bf16."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_k8s_device_plugin_torch.workloads import flash_attention as tfa

# the JAX package's workloads/__init__ re-exports the function under the
# module's name, so its module is looked up by the full name
jfa = importlib.import_module(
    "tpu_k8s_device_plugin.workloads.flash_attention")

FWD_SHAPES = [((2, 64, 2, 16), (32, 32)), ((1, 128, 2, 8), (64, 32)),
              ((2, 32, 1, 32), (64, 64))]
BWD_SHAPES = [((1, 64, 2, 16), (32, 32)), ((2, 128, 1, 8), (64, 32)),
              ((1, 128, 2, 8), (32, 64))]


def _arrays(shape, n, seed, kv_heads=None):
    rng = np.random.default_rng(seed)
    kv = shape[:2] + (kv_heads or shape[2], shape[3])
    return [rng.standard_normal(shape if i in (0, 3) else kv, np.float32)
            for i in range(n)]


def _t(x, dtype=torch.float32, grad=False):
    return torch.from_numpy(x).to(dtype).requires_grad_(grad)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape,blocks", FWD_SHAPES)
def test_forward_and_lse_match_flash_block_forward(causal, shape, blocks):
    q, k, v = _arrays(shape, 3, seed=0)
    jo, jlse = jfa.flash_block_forward(
        *(jnp.asarray(x) for x in (q, k, v)), causal=causal,
        block_q=blocks[0], block_k=blocks[1])
    o, lse = tfa.flash_attention_fwd_plain(_t(q), _t(k), _t(v), causal)
    assert lse.shape == (shape[0], shape[2], shape[1])
    assert lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(lse.transpose(1, 2).numpy(),
                               np.asarray(jlse), atol=2e-5, rtol=2e-5)


def test_lse_of_a_row_with_no_visible_key_is_minus_inf():
    q, k, v = (torch.zeros(1, 4, 1, 16) for _ in range(3))
    o, lse = tfa.flash_attention_fwd_plain(q, k[:, :0], v[:, :0])
    assert torch.isneginf(lse).all() and not o.any()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-4),
                                       (torch.bfloat16, 5e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_matches_flash_block_grads(causal, dtype, tol):
    """Given the same global lse and delta, the plain dQ/dK/dV equal the
    JAX block gradients (both f32 out)."""
    shape, blocks = BWD_SHAPES[1]
    q, k, v, do = (x.astype(np.float32) for x in _arrays(shape, 4, seed=1))
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    # the inputs as the working dtype holds them, for both packages
    q, k, v, do = (_t(x, dtype).float().numpy() for x in (q, k, v, do))
    jo, jlse = jfa.flash_block_forward(
        *(jnp.asarray(x, jd) for x in (q, k, v)), causal=causal,
        block_q=blocks[0], block_k=blocks[1])
    delta = np.sum(np.asarray(jo, np.float32) * do, axis=-1)  # [B, T, H]
    jlse = np.asarray(jlse)
    want = jfa.flash_block_grads(
        *(jnp.asarray(x, jd) for x in (q, k, v, do)), jnp.asarray(jlse),
        jnp.asarray(delta), causal=causal, block_q=blocks[0],
        block_k=blocks[1])
    got = tfa.flash_attention_bwd_plain(
        _t(q, dtype), _t(k, dtype), _t(v, dtype), _t(do, dtype),
        torch.from_numpy(jlse.copy()).transpose(1, 2).contiguous(),
        torch.from_numpy(delta).transpose(1, 2).contiguous(), causal)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol,
                                   rtol=tol)


def _jax_grads(q, k, v, causal, dtype=jnp.float32, **blocks):
    def loss(q, k, v):
        out = jfa.flash_attention(q, k, v, causal=causal, **blocks)
        return jnp.sum(out.astype(jnp.float32) ** 2)

    args = tuple(jnp.asarray(x, dtype) for x in (q, k, v))
    return [np.asarray(g, np.float32)
            for g in jax.grad(loss, argnums=(0, 1, 2))(*args)]


def _port_grads(q, k, v, causal, dtype=torch.float32):
    ts = [_t(x, dtype, grad=True) for x in (q, k, v)]
    out = tfa.flash_attention(*ts, causal=causal)
    (out.float() ** 2).sum().backward()
    return [t.grad.float().numpy() for t in ts]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape,blocks", BWD_SHAPES)
def test_gradients_match_jax_f32(causal, shape, blocks):
    q, k, v = _arrays(shape, 3, seed=3)
    want = _jax_grads(q, k, v, causal, block_q=blocks[0],
                      block_k=blocks[1])
    for g, w in zip(_port_grads(q, k, v, causal), want):
        np.testing.assert_allclose(g, w, atol=5e-4, rtol=5e-4)


def test_gradients_match_jax_bf16():
    q, k, v = (_t(x, torch.bfloat16).float().numpy()
               for x in _arrays((1, 64, 2, 16), 3, seed=5))
    want = _jax_grads(q, k, v, True, jnp.bfloat16)
    got = _port_grads(q, k, v, True, torch.bfloat16)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=5e-2, rtol=5e-2)


@pytest.mark.parametrize("kv_heads", [2, 1])
def test_grouped_kv_gradients_match_jax_repeat_kv(kv_heads):
    """The port takes grouped K/V as they are and sums each KV head's
    gradient over its query heads; JAX repeats K/V before the kernel, so
    repeat_kv's gradient does that sum."""
    q, k, v = _arrays((1, 64, 4, 16), 3, seed=7, kv_heads=kv_heads)

    def loss(q, k, v):
        pos = jnp.broadcast_to(jnp.arange(64), (1, 64))
        return jnp.sum(jfa.flash_causal_attention(q, k, v, pos) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    got = _port_grads(q, k, v, True)
    assert got[1].shape == k.shape and got[2].shape == v.shape
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=5e-4, rtol=5e-4)


def test_cpu_backward_runs_the_ports_backward(monkeypatch):
    """A CPU gradient goes through the Function's own backward (the plain
    dQ/dK/dV), not autograd through the plain forward."""
    calls = []
    plain = tfa.flash_attention_bwd_plain

    def counting(*args):
        calls.append(1)
        return plain(*args)

    monkeypatch.setattr(tfa, "flash_attention_bwd_plain", counting)
    _port_grads(*_arrays((1, 32, 2, 16), 3, seed=2), True)
    assert calls == [1]


def test_inference_path_saves_nothing():
    """Under no_grad (and with no input needing a gradient) the call is
    the primal path: no autograd node, nothing saved; with gradients on
    it is the training form."""
    q, k, v = (_t(x, grad=True) for x in _arrays((1, 32, 2, 16), 3, 4))
    with torch.no_grad():
        out = tfa.flash_attention(q, k, v, causal=True)
    assert out.grad_fn is None
    out = tfa.flash_attention(q.detach(), k.detach(), v.detach(), True)
    assert out.grad_fn is None
    out = tfa.flash_attention(q, k, v, causal=True)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    torch.testing.assert_close(
        out, tfa.flash_attention_plain(q, k, v, True).detach(), rtol=0,
        atol=0)


def test_delta_uses_the_stored_output():
    do = torch.randn(1, 8, 2, 16, generator=torch.Generator().manual_seed(0))
    o = do.flip(1).to(torch.bfloat16)
    want = (do * o.float()).sum(-1).transpose(1, 2)
    got = tfa.attention_delta(do, o)
    assert got.is_contiguous() and got.dtype == torch.float32
    torch.testing.assert_close(got, want)


@pytest.mark.parametrize("wrapper", ["flash_attention_dq_cuda",
                                     "flash_attention_dkv_cuda"])
def test_backward_wrappers_take_only_cuda_tensors(wrapper):
    """The kernel wrappers never compute on the CPU: a CPU tensor is
    refused before any build or launch, and the count does not move."""
    fn = getattr(tfa, wrapper)
    q = torch.zeros(1, 8, 2, 16)
    rows = torch.zeros(1, 2, 8)
    before = fn.launches
    with pytest.raises(ValueError, match="CUDA"):
        fn(q, q, q, q, rows, rows, True)
    assert fn.launches == before
