"""The port's ring attention (``workloads/ring_attention.py``) on a gloo
group of 8 processes (and a group of 4 of them), case by case against
``tests/test_ring_attention.py``: the same inputs (the reference's own
``qkv``, as numpy), held to the reference's outputs and gradients with
its tolerances (f32 outputs 2e-5, f32 gradients 5e-4, bf16 outputs
3e-2, bf16 gradients 6e-2).  The reference's side runs in this process
on its 8 virtual CPU devices: its ring (the flash impl in interpret
mode) and its oracle, ``full_attention``, with ``jax.grad`` through it.
On the CPU the port's flash impl runs the block forms' plain versions.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import mesh_utils
from jax.sharding import Mesh

from test_torch_parallel import GlooPool
from tpu_k8s_device_plugin.workloads import ring_attention as jring
from tpu_k8s_device_plugin_torch.workloads import ring_attention as tring

import torch

WORLD = 8
ALL = tuple(range(WORLD))
FOUR = (0, 1, 2, 3)
F32_OUT, F32_GRAD, BF16_OUT, BF16_GRAD = 2e-5, 5e-4, 3e-2, 6e-2


@pytest.fixture(scope="module")
def pool():
    p = GlooPool(WORLD)
    yield p
    p.close()


@functools.lru_cache(maxsize=None)
def qkv(dtype="float32", B=2, T=64, H=2, D=16):
    """The reference test's inputs, as f32 numpy arrays (bf16 values
    when *dtype* is bf16)."""
    ks = jax.random.split(jax.random.PRNGKey(7), 3)
    dt = getattr(jnp, dtype)
    return tuple(np.asarray(jax.random.normal(k, (B, T, H, D), dt),
                            np.float32) for k in ks)


def _jax(arrays, dtype):
    return tuple(jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays)


@functools.lru_cache(maxsize=None)
def _mesh(n):
    return Mesh(mesh_utils.create_device_mesh((n,), devices=jax.devices()[:n]),
                axis_names=("seq",))


def reference_ring(arrays, dtype, causal, layout, impl, n):
    """The reference's ring output on *n* virtual devices, natural
    order."""
    ring_fn, sharding = jring.make_ring_attention(
        _mesh(n), "seq", causal=causal, layout=layout, impl=impl)
    x = _jax(arrays, dtype)
    if layout == "zigzag":
        x = tuple(jring.zigzag_permute(a, n) for a in x)
    out = ring_fn(*(jax.device_put(a, sharding) for a in x))
    if layout == "zigzag":
        out = jring.zigzag_unpermute(out, n)
    return np.asarray(out, np.float32)


def oracle(arrays, dtype, causal):
    return np.asarray(jring.full_attention(*_jax(arrays, dtype), causal),
                      np.float32)


def oracle_grads(arrays, dtype, causal):
    def loss(q, k, v):
        out = jring.full_attention(q, k, v, causal=causal)
        return jnp.sum(out.astype(jnp.float32) ** 2)

    got = jax.grad(loss, argnums=(0, 1, 2))(*_jax(arrays, dtype))
    return [np.asarray(g, np.float32) for g in got]


def run(pool, arrays, dtype="float32", causal=False, layout="contiguous",
        impl="einsum", ranks=ALL, grads=False):
    return pool.run("ring", arrays, dtype, causal, layout, impl, ranks,
                    grads)[0]


def close(got, want, tol):
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


def held(pool, arrays, dtype, causal, layout, impl, n, tol):
    """The port's ring against the reference's ring and its oracle."""
    ranks = ALL[:n]
    got = run(pool, arrays, dtype, causal, layout, impl, ranks)
    assert got["dtype"] == f"torch.{dtype}"
    close(got["out"], oracle(arrays, dtype, causal), tol)
    close(got["out"], reference_ring(arrays, dtype, causal, layout, impl, n),
          tol)
    return got


@pytest.mark.parametrize("causal", [False, True])
def test_matches_full_attention(pool, causal):
    held(pool, qkv(), "float32", causal, "contiguous", "einsum", 8, F32_OUT)


def test_output_stays_sequence_sharded(pool):
    got = run(pool, qkv())
    # each rank holds exactly its local T/8 sequence slice
    assert got["local_shape"] == (2, 64 // 8, 2, 16)
    _, sharding = tring.make_ring_attention()
    assert sharding.spec == (None, "seq", None, None)


def test_bf16_inputs(pool):
    held(pool, qkv("bfloat16"), "bfloat16", True, "contiguous", "einsum", 8,
         BF16_OUT)


def test_grouped_kv_rotates_compact_heads(pool):
    """The einsum impl takes K/V with fewer heads and expands them after
    the hop: the reference's ``repeat_kv`` before the oracle."""
    q, k, v = qkv(H=4)
    got = run(pool, (q, k[:, :, ::2].copy(), v[:, :, ::2].copy()),
              causal=True, grads=True)
    kr, vr = (np.repeat(x[:, :, ::2], 2, axis=2) for x in (k, v))
    close(got["out"], oracle((q, kr, vr), "float32", True), F32_OUT)
    dq, dk, dv = oracle_grads((q, kr, vr), "float32", True)
    close(got["grads"][0], dq, F32_GRAD)
    # the grouped gradient sums each KV head's query heads
    close(got["grads"][1], dk.reshape(2, 64, 2, 2, 16).sum(3), F32_GRAD)
    close(got["grads"][2], dv.reshape(2, 64, 2, 2, 16).sum(3), F32_GRAD)


class TestZigzag:
    def test_permute_roundtrip(self):
        x = torch.arange(2 * 32 * 3).reshape(2, 32, 3).float()
        z = tring.zigzag_permute(x, 4)
        assert z.shape == x.shape
        torch.testing.assert_close(tring.zigzag_unpermute(z, 4), x,
                                   rtol=0, atol=0)
        # rank 0's shard (first T/4) must hold chunks 0 and 7 of 8
        torch.testing.assert_close(
            z[:, :8], torch.cat([x[:, 0:4], x[:, 28:32]], dim=1),
            rtol=0, atol=0)
        # and the reference's order
        np.testing.assert_array_equal(
            z.numpy(), np.asarray(jring.zigzag_permute(jnp.asarray(
                x.numpy()), 4)))

    @pytest.mark.parametrize("n_devs,T", [(4, 32), (8, 64)])
    def test_matches_full_attention(self, pool, n_devs, T):
        held(pool, qkv(T=T), "float32", True, "zigzag", "einsum", n_devs,
             F32_OUT)

    def test_bf16(self, pool):
        held(pool, qkv("bfloat16"), "bfloat16", True, "zigzag", "einsum", 8,
             BF16_OUT)

    def test_non_causal_rejected(self):
        with pytest.raises(ValueError):
            tring.make_ring_attention(causal=False, layout="zigzag")

    def test_indivisible_seq_rejected(self):
        with pytest.raises(ValueError):
            tring.zigzag_permute(torch.zeros(1, 30, 1, 4), 4)  # 30 % 8


def test_uneven_causal_first_block_rows(pool):
    """Row 0 attends only to itself: the fully masked correction path
    (exp of -inf maxima) must not give NaN."""
    arrays = qkv(B=1, T=16, H=1, D=8)
    got = held(pool, arrays, "float32", True, "contiguous", "einsum", 4,
               F32_OUT)
    assert not np.isnan(got["out"]).any()


class TestFlashImpl:
    @pytest.mark.parametrize("causal", [False, True])
    def test_matches_full_attention(self, pool, causal):
        held(pool, qkv(), "float32", causal, "contiguous", "flash", 8,
             F32_OUT)

    @pytest.mark.parametrize("causal", [False, True])
    def test_gradients_match_oracle(self, pool, causal):
        """The custom backward (dK/dV partials riding the ring, the block
        grads with the global lse) equals autodiff through the oracle."""
        arrays = qkv(B=1, T=32, H=2, D=8)
        got = run(pool, arrays, causal=causal, impl="flash", grads=True)
        for g, w in zip(got["grads"], oracle_grads(arrays, "float32",
                                                   causal)):
            close(g, w, F32_GRAD)

    def test_bf16(self, pool):
        held(pool, qkv("bfloat16"), "bfloat16", True, "contiguous", "flash",
             8, BF16_OUT)

    def test_bf16_gradients(self, pool):
        """f32 partials, one rounding at the end: bf16 gradients track
        the oracle about as closely as the dense flash kernel's."""
        arrays = qkv("bfloat16", B=1, T=32, H=2, D=16)
        got = run(pool, arrays, "bfloat16", True, impl="flash", grads=True)
        for g, w in zip(got["grads"], oracle_grads(arrays, "bfloat16",
                                                   True)):
            close(g, w, BF16_GRAD)

    def test_matches_einsum_impl(self, pool):
        flash = run(pool, qkv(), causal=True, impl="flash")
        einsum = run(pool, qkv(), causal=True, impl="einsum")
        close(flash["out"], einsum["out"], F32_OUT)

    def test_unknown_impl_rejected(self):
        with pytest.raises(ValueError):
            tring.make_ring_attention(impl="fused")


class TestZigzagFlash:
    def test_matches_full_attention(self, pool):
        held(pool, qkv(), "float32", True, "zigzag", "flash", 8, F32_OUT)

    def test_matches_einsum_zigzag(self, pool):
        flash = run(pool, qkv(), causal=True, layout="zigzag", impl="flash")
        einsum = run(pool, qkv(), causal=True, layout="zigzag")
        close(flash["out"], einsum["out"], F32_OUT)

    def test_gradients_match_oracle(self, pool):
        arrays = qkv(B=1, T=32, H=2, D=8)
        got = run(pool, arrays, causal=True, layout="zigzag", impl="flash",
                  grads=True)
        for g, w in zip(got["grads"], oracle_grads(arrays, "float32",
                                                   True)):
            close(g, w, F32_GRAD)


def test_errors(pool):
    """The reference's errors; and a ``spec`` with the batch on another
    axis of a mesh, which runs (each rank's block of a (data 4, seq 2)
    mesh) and agrees with the oracle's block."""
    seen = pool.run("ring_errors", ALL)[0]
    assert seen["layout"][0] == "ValueError"
    assert seen["zigzag_non_causal"][0] == "ValueError"
    assert seen["impl"][0] == "ValueError"
    assert seen["heads"][0] == "ValueError" and "repeat_kv" in \
        seen["heads"][1]
    assert seen["spec"][0] == (1, 4, 2, 4)
    assert seen["spec"][1] <= F32_OUT
