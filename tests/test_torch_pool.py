"""The port's max-pool against the JAX package's, bit for bit.

The JAX ``max_pool`` runs in interpret mode on the CPU, as its own tests
run it; the port's takes its plain version for CPU tensors (the
arithmetic K1 and K2 are held to on the card).  Inputs come from numpy
with a seed and go to both.  Forward values, the int8 index and the
gradients of ``sum(y.float() ** 2)`` must be equal, ties included."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_k8s_device_plugin.workloads import pool as jpool
from tpu_k8s_device_plugin_torch.workloads import pool as tpool

# the cases of tests/test_pool.py
CASES = [
    ((2, 56, 56, 64), 3, 2),   # AlexNet stage 1
    ((2, 27, 27, 192), 3, 2),  # AlexNet stage 2 (odd spatial)
    ((2, 13, 13, 256), 3, 2),  # AlexNet stage 5
    ((3, 10, 10, 16), 2, 2),   # non-overlapping window
    ((1, 9, 9, 8), 3, 3),      # stride == window
    ((2, 8, 12, 4), 3, 1),     # stride 1 (fully overlapping)
]


def _jax(x_np, window, stride, dtype=jnp.float32):
    """(y, idx [B, OH, OW, C], dy) from the JAX package."""
    x = jnp.asarray(x_np).astype(dtype)
    y, idx = jpool._pool_fwd_impl(x, window, stride, True)
    dy = jax.grad(lambda a: jnp.sum(
        jpool.max_pool(a, window, stride, interpret=True)
        .astype(jnp.float32) ** 2))(x)
    idx = np.asarray(idx).transpose(3, 0, 1, 2)[:x.shape[0]]
    return (np.asarray(y.astype(jnp.float32)), idx,
            np.asarray(dy.astype(jnp.float32)))


def _torch(x_np, window, stride, dtype=torch.float32):
    x = torch.from_numpy(np.asarray(x_np, np.float32)).to(dtype)
    _, idx = tpool.max_pool_fwd_plain(x, window, stride)
    x.requires_grad_(True)
    y = tpool.max_pool(x, window, stride)
    (y.float() ** 2).sum().backward()
    assert y.dtype == dtype and x.grad.dtype == dtype
    return (y.detach().float().numpy(), idx.numpy(),
            x.grad.float().numpy())


def _assert_same(jax_out, torch_out):
    for name, a, b in zip(("y", "idx", "dy"), jax_out, torch_out):
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("shape,window,stride", CASES)
def test_matches_jax_exactly(shape, window, stride):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    _assert_same(_jax(x, window, stride), _torch(x, window, stride))


def test_tie_break_matches_jax():
    # quantised values force many exact ties inside windows
    x = np.round(np.random.default_rng(2).standard_normal(
        (4, 20, 20, 8)) * 2).astype(np.float32)
    _assert_same(_jax(x, 3, 2), _torch(x, 3, 2))


def test_constant_plateau_routes_to_first_offset():
    x = np.ones((1, 5, 5, 4), np.float32)
    got = _torch(x, 3, 2)
    _assert_same(_jax(x, 3, 2), got)
    assert not got[1].any()  # every window's index is offset 0


def test_bfloat16_matches_jax():
    x = np.random.default_rng(3).standard_normal(
        (2, 27, 27, 64)).astype(np.float32)
    _assert_same(_jax(x, 3, 2, jnp.bfloat16),
                 _torch(x, 3, 2, torch.bfloat16))


def test_bfloat16_overlap_sums_round_each_add():
    # overlapping windows (stride 1) with many ties send several bf16
    # gradients (2 * 1.0078125 and the like) to one element, whose sums
    # need more than bf16's 8 bits: they round after every add, in
    # ascending offset order, as the JAX kernel's planes do
    x = (1 + np.random.default_rng(6).integers(0, 3, (2, 9, 9, 8)) / 128
         ).astype(np.float32)
    _assert_same(_jax(x, 3, 1, jnp.bfloat16),
                 _torch(x, 3, 1, torch.bfloat16))


def test_all_neg_inf():
    x = np.full((1, 7, 7, 8), -np.inf, np.float32)
    got = _torch(x, 3, 2)
    _assert_same(_jax(x, 3, 2), got)
    assert np.isneginf(got[0]).all() and not got[1].any()


def test_nan_window_gives_nan_and_index_0():
    x = np.random.default_rng(7).standard_normal((1, 7, 7, 4)).astype(
        np.float32)
    x[0, 3, 4, 1] = np.nan  # inside windows (1, 1) and (1, 2)
    y, idx = tpool.max_pool_fwd_plain(torch.from_numpy(x), 3, 2)
    jy, jidx = jpool._pool_fwd_impl(jnp.asarray(x), 3, 2, True)
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))  # NaN == NaN
    np.testing.assert_array_equal(
        idx.numpy(), np.asarray(jidx).transpose(3, 0, 1, 2))
    assert torch.isnan(y[0, 1, 1:3, 1]).all()
    assert not idx[0, 1, 1:3, 1].any()


def test_batch_5():
    x = np.random.default_rng(5).standard_normal(
        (5, 12, 12, 8)).astype(np.float32)
    _assert_same(_jax(x, 3, 2), _torch(x, 3, 2))


def test_refusals():
    x = torch.zeros(2, 8, 8, 4)
    with pytest.raises(ValueError, match="smaller"):
        tpool.max_pool(x, 9, 2)
    with pytest.raises(ValueError, match="NHWC"):
        tpool.max_pool(torch.zeros(8, 8, 4), 3, 2)
    # the kernel wrappers take CUDA tensors only
    with pytest.raises(ValueError, match="CUDA"):
        tpool.max_pool_fwd_cuda(x, 3, 2)
    with pytest.raises(TypeError):
        tpool.max_pool_fwd_cuda(x.half(), 3, 2)


def test_alexnet_pallas_pool_matches_xla_pool():
    """The model-level choice: same parameters, both pool paths,
    identical logits and gradients to float rounding (224 px, as
    tests/test_pool.py)."""
    from tpu_k8s_device_plugin_torch.workloads import alexnet

    img = np.random.default_rng(0).standard_normal(
        (2, 224, 224, 3)).astype(np.float32)
    x = alexnet.space_to_depth(torch.from_numpy(img))
    labels = torch.tensor([3, 7])
    models = {}
    for pool in ("xla", "pallas"):
        model = alexnet.AlexNet(num_classes=10, dtype=torch.float32,
                                s2d=True, pool=pool, device="cpu")
        alexnet.init_params_(model, seed=0)
        models[pool] = model
    lx = models["xla"](x)
    lp = models["pallas"](x)
    assert torch.equal(lx, lp)
    for model in models.values():
        alexnet.loss_fn(model, x, labels).backward()
    for (name, a), b in zip(models["xla"].named_parameters(),
                            models["pallas"].parameters()):
        np.testing.assert_allclose(b.grad.numpy(), a.grad.numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
