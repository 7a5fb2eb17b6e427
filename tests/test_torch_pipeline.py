"""The port's GPipe pipeline (``workloads/pipeline.py``) on a (data 2,
pipe 4) mesh of 8 gloo processes, case by case against
``tests/test_pipeline.py``: the reference's ``make_pipeline`` on its 8
virtual CPU devices and the port's, on the same numpy parameters and
microbatches, forward within 1e-5 and gradients within 1e-4 (the
reference test's bars); the stage parameters split on ``pipe``, the
microbatches' batch dim on ``data``, and the reference's errors.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import mesh_utils
from jax.sharding import Mesh

from test_torch_parallel import GlooPool
from tpu_k8s_device_plugin.workloads import pipeline as jpipe

WORLD, N_LAYERS, D = 8, 8, 16
FWD_TOL, GRAD_TOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def pool():
    p = GlooPool(WORLD)
    yield p
    p.close()


def mlp_layer(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


@functools.lru_cache(maxsize=None)
def stacked():
    """The reference test's parameters (``build_params``), stacked, as
    numpy."""
    rs = np.random.RandomState(0)
    per_layer = [{"w": (rs.randn(D, D) * 0.3).astype(np.float32),
                  "b": (rs.randn(D) * 0.1).astype(np.float32)}
                 for _ in range(N_LAYERS)]
    return {k: np.asarray(v) for k, v in
            jpipe.stack_layer_params(per_layer).items()}


def microbatches(n_micro, mb, seed):
    return np.random.RandomState(seed).randn(n_micro, mb, D).astype(
        np.float32)


def reference(x, grads=False):
    """The reference's pipelined forward on its (data 2, pipe 4) mesh,
    and with *grads* the gradients of ``sum(out ** 2)``."""
    mesh = Mesh(mesh_utils.create_device_mesh((2, 4)),
                axis_names=("data", "pipe"))
    params = {k: jnp.asarray(v) for k, v in stacked().items()}
    apply, params_sh, in_sh = jpipe.make_pipeline(mesh, mlp_layer, params)
    placed = jax.device_put(jnp.asarray(x), in_sh)
    out = np.asarray(apply(params_sh, placed))
    if not grads:
        return out, None
    got = jax.grad(lambda p: jnp.sum(apply(p, placed) ** 2))(params_sh)
    return out, {k: np.asarray(v) for k, v in got.items()}


def sequential(x):
    """The unpipelined oracle of the reference test, in numpy."""
    p = stacked()
    for i in range(N_LAYERS):
        x = np.tanh(x @ p["w"][i] + p["b"][i])
    return x


class TestPipelineForward:
    @pytest.mark.parametrize("n_micro", [1, 4, 6])
    def test_matches_sequential_oracle(self, pool, n_micro):
        x = microbatches(n_micro, 4, 1)
        got = pool.run("pipeline_run", stacked(), x, False)
        want, _ = reference(x)
        for r in got:
            np.testing.assert_allclose(r["out"], want, atol=FWD_TOL,
                                       rtol=FWD_TOL)
        np.testing.assert_allclose(got[0]["out"], sequential(x),
                                   atol=FWD_TOL, rtol=FWD_TOL)

    def test_stage_params_are_sharded(self, pool):
        got = pool.run("pipeline_run", stacked(), microbatches(4, 4, 1),
                       False)
        for r in got:
            assert r["params"] == {"w": (N_LAYERS // 4, D, D),
                                   "b": (N_LAYERS // 4, D)}

    def test_batch_rides_data_axis(self, pool):
        """DP x PP: the microbatches' batch dim stays split on ``data``."""
        x = microbatches(4, 8, 2)
        got = pool.run("pipeline_run", stacked(), x, False)
        want, _ = reference(x)
        for r in got:
            assert r["in_spec"] == (None, "data")
            assert r["in"] == (4, 8 // 2, D)
            np.testing.assert_allclose(r["out"], want, atol=FWD_TOL,
                                       rtol=FWD_TOL)

    def test_rejects_indivisible_layer_count(self, pool):
        seen = pool.run("pipeline_errors", stacked())[0]
        assert "not divisible" in seen["layers"]

    def test_rejects_explicit_missing_batch_axis(self, pool):
        """An explicitly named batch axis must exist; only the default
        degrades (``pipeline.py:142-149``)."""
        seen = pool.run("pipeline_errors", stacked())[0]
        assert "is not a mesh axis" in seen["batch_axes"]
        with pytest.raises(ValueError, match="is not a mesh axis"):
            mesh = Mesh(mesh_utils.create_device_mesh((2, 4)),
                        axis_names=("data", "pipe"))
            jpipe.make_pipeline(mesh, mlp_layer, stacked(),
                                batch_axes="model")


class TestPipelineBackward:
    def test_gradients_match_sequential_oracle(self, pool):
        """Autograd through the schedule (the rotations' backward, the
        final sum's identity backward, the data sum) gives the reference's
        ``jax.grad`` of the pipelined forward."""
        x = microbatches(4, 4, 3)
        got = pool.run("pipeline_run", stacked(), x, True)
        _, want = reference(x, grads=True)
        for r in got:
            for k, w in want.items():
                np.testing.assert_allclose(r["grads"][k], w, atol=GRAD_TOL,
                                           rtol=GRAD_TOL, err_msg=k)
