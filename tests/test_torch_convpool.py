"""The port's fused conv+pool against the JAX package's ``conv_pool``.

The JAX function falls back to interpret mode on the CPU, as its own
tests run it; the port's takes its plain version for CPU tensors (the
arithmetic K3 is held to on the card), and its backward runs K2's plain
version and PyTorch's conv gradients.  Inputs come from numpy with a
seed.  Tolerances are tests/test_convpool.py's: the two frameworks sum
the conv in different orders."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_k8s_device_plugin.workloads import convpool as jconv
from tpu_k8s_device_plugin_torch.workloads import convpool as tconv


def _inputs(shape, window, feat, seed, scale=0.2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    k = (rng.standard_normal((window, window, shape[-1], feat)) * scale
         ).astype(np.float32)
    return x, k


def _jax(x, k, loss, dtype=jnp.float32):
    xj, kj = jnp.asarray(x).astype(dtype), jnp.asarray(k).astype(dtype)
    y = jconv.conv_pool(xj, kj)
    gx, gk = jax.grad(lambda a, b: loss(jconv.conv_pool(a, b)),
                      argnums=(0, 1))(xj, kj)
    return [np.asarray(t.astype(jnp.float32)) for t in (y, gx, gk)]


def _torch(x, k, loss, dtype=torch.float32):
    xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
    kt = torch.from_numpy(k).to(dtype).requires_grad_(True)
    y = tconv.conv_pool(xt, kt)
    loss(y).backward()
    return [t.detach().float().numpy() for t in (y, xt.grad, kt.grad)]


@pytest.mark.parametrize("window,shape,feat", [
    (3, (4, 8, 8, 6), 8),    # even spatial
    (5, (2, 9, 9, 4), 8),    # odd spatial + the 5x5 window
    (3, (2, 7, 7, 4), 6),    # odd input
])
def test_matches_jax_fwd_and_grad(window, shape, feat):
    x, k = _inputs(shape, window, feat, seed=window + feat)
    want = _jax(x, k, lambda y: (y ** 2).sum())
    got = _torch(x, k, lambda y: (y ** 2).sum())
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
    for name, a, b in zip(("dx", "dk"), got[1:], want[1:]):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4,
                                   err_msg=name)


def test_index_matches_jax():
    x, k = _inputs((2, 9, 9, 4), 5, 8, seed=1)
    _, idx = tconv.conv_pool_plain(torch.from_numpy(x), torch.from_numpy(k))
    _, jidx = jconv._fused_fwd_impl(jnp.asarray(x), jnp.asarray(k), True)
    np.testing.assert_array_equal(
        idx.numpy(), np.asarray(jidx).transpose(3, 0, 1, 2))


def test_tie_break_matches_jax():
    # constant input: exact ties in every pool window, so the gradient
    # depends entirely on the first-offset tie-break
    x = np.ones((2, 8, 8, 4), np.float32)
    k = np.full((3, 3, 4, 6), 0.1, np.float32)
    want = _jax(x, k, lambda y: y.sum())
    got = _torch(x, k, lambda y: y.sum())
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_bf16_matches_jax():
    x, k = _inputs((2, 8, 8, 4), 3, 8, seed=2)
    want = _jax(x, k, lambda y: y.astype(jnp.float32).sum(), jnp.bfloat16)
    got = _torch(x, k, lambda y: y.float().sum(), torch.bfloat16)
    # both accumulate in f32 and round to bf16, in different orders
    np.testing.assert_allclose(got[0], want[0], rtol=2e-2, atol=2e-2)


def test_bad_kernel_shapes_rejected():
    x = torch.zeros(2, 8, 8, 4)
    with pytest.raises(ValueError, match="odd-square"):
        tconv.conv_pool(x, torch.zeros(2, 2, 4, 8))
    with pytest.raises(ValueError, match="odd-square"):
        tconv.conv_pool(x, torch.zeros(3, 3, 5, 8))
    # the kernel wrapper takes CUDA tensors only
    with pytest.raises(ValueError, match="CUDA"):
        tconv.conv_pool_cuda(x, torch.zeros(3, 3, 4, 64))
