"""The port's data x model AlexNet (``workloads/parallel.py``) on a gloo
group of 8 processes, against the JAX package's sharded step on its 8
virtual CPU devices; and the harness the port's multi-process tests
share (:class:`GlooPool`).

The pool is started once a module, with the ``spawn`` context: 8 rank
processes (``tests/torch_gloo_ranks.py``, torch and numpy only) join one
gloo group and run the cases the test sends them through queues.  The
reference's side runs here, in the pytest process, and goes to the
ranks as numpy arrays.

Counterparts of ``tests/test_workloads.py``'s mesh tests (the mesh's
shapes and errors, the Dense rule, the sharded step) and of
``tests/test_checkpoint.py``'s two mesh restores (onto a mesh, and from
one mesh shape onto another).  The AlexNet is the reference tests'
small one (64 px, 16 classes, s2d), in f32: the sharded step's losses
agree with the reference's to 1e-5 and its parameters after 3 steps to
1e-4 (as ``tests/test_torch_alexnet.py`` holds the single-device step),
and with the port's single-device step at the global batch alike.
"""

import multiprocessing
import queue
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import torch_gloo_ranks
from tpu_k8s_device_plugin.workloads import alexnet as jalex
from tpu_k8s_device_plugin.workloads import parallel as jpar
from tpu_k8s_device_plugin_torch.convert import alexnet_params_from_jax
from tpu_k8s_device_plugin_torch.workloads import parallel as tpar

WORLD = 8
CLASSES = 16
LR = 0.01
STEPS = 3
# a case's answer from every rank; beyond it the group is lost
CASE_TIMEOUT_S = 240


class GlooPool:
    """*n* rank processes on one gloo group, fed cases through queues;
    a case that fails or times out on any rank fails the test and
    restarts the pool for the next one."""

    def __init__(self, n: int):
        self.n = n
        self._start()

    def _start(self):
        ctx = multiprocessing.get_context("spawn")
        port = torch_gloo_ranks.free_port()
        self.inboxes = [ctx.Queue() for _ in range(self.n)]
        self.outbox = ctx.Queue()
        self.procs = [ctx.Process(target=torch_gloo_ranks.rank_main,
                                  args=(r, self.n, port, self.inboxes[r],
                                        self.outbox), daemon=True)
                      for r in range(self.n)]
        for p in self.procs:
            p.start()

    def run(self, case: str, *args):
        """``[rank 0's result, rank 1's, ...]`` of ``torch_gloo_ranks.
        <case>(*args)``."""
        for box in self.inboxes:
            box.put((case, args))
        results, errors = [None] * self.n, []
        try:
            for _ in range(self.n):
                rank, ok, value = self.outbox.get(timeout=CASE_TIMEOUT_S)
                if ok:
                    results[rank] = value
                else:
                    errors.append(f"rank {rank}:\n{value}")
        except queue.Empty:
            errors.append(f"no answer within {CASE_TIMEOUT_S} s")
        if errors:
            self.close()
            self._start()
            raise AssertionError(f"{case} failed:\n" + "\n".join(errors))
        return results

    def close(self):
        for box in self.inboxes:
            box.put(None)
        for p in self.procs:
            p.join(timeout=20)
            if p.is_alive():
                p.terminate()
                p.join()


@pytest.fixture(scope="module")
def pool():
    p = GlooPool(WORLD)
    yield p
    p.close()


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(n, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((n, 64, 64, 3)).astype(np.float32)
    labels = rng.integers(0, CLASSES, n).astype(np.int64)
    return np.asarray(jalex.space_to_depth(jnp.asarray(img))), labels


@pytest.fixture(scope="module")
def reference():
    """The reference's sharded step on its (4, 2) mesh of virtual
    devices, f32: its initial parameters, batch, losses and parameters
    after STEPS steps."""
    mesh = jpar.make_mesh(jax.devices())
    assert dict(mesh.shape) == {"data": 4, "model": 2}
    model = jalex.AlexNet(num_classes=CLASSES, dtype=jnp.float32, s2d=True)
    images, labels = _batch(mesh.shape["data"] * 2)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(images),
                        train=False)["params"]
    init = _np_tree(params)
    tx = optax.sgd(LR, momentum=0.9)
    step, params, opt_state, (img_sh, lbl_sh) = jpar.make_sharded_train_step(
        model, tx, mesh, params, tx.init(params))
    x = jax.device_put(jnp.asarray(images), img_sh)
    y = jax.device_put(jnp.asarray(labels.astype(np.int32)), lbl_sh)
    losses = []
    for _ in range(STEPS):
        params, opt_state, loss = step(params, opt_state, x, y)
        losses.append(float(loss))
    state = {k: v.numpy() for k, v in alexnet_params_from_jax(init).items()}
    after = {k: v.numpy()
             for k, v in alexnet_params_from_jax(_np_tree(params)).items()}
    return state, images, labels, losses, after


def test_make_mesh_shapes(pool):
    results = pool.run("mesh_shapes")
    for shapes, _ in results:
        assert shapes == [{"data": 4, "model": 2}, {"data": 8, "model": 1}]
    # ranks fill the mesh row by row, as the reference's device grid
    assert [coord for _, coord in results] == [(r // 2, r % 2)
                                               for r in range(WORLD)]
    with pytest.raises(ValueError):
        tpar.make_mesh(range(6), model_parallel=4, device="cpu")


def test_make_mesh_needs_a_group():
    with pytest.raises(RuntimeError, match="init_process_group"):
        tpar.make_mesh(device="cpu")


def test_dense_kernels_are_model_sharded(pool, reference):
    state = reference[0]
    specs, shapes = pool.run("dense_specs", state, CLASSES)[0]
    assert specs["Dense_0.weight"] == ("model", None)
    assert specs["Dense_0.bias"] == ("model",)
    assert specs["Conv_0.weight"] == ()
    # each rank holds 1/model of a Dense layer's columns, and every conv
    assert shapes["Dense_0.weight"] == (
        state["Dense_0.weight"].shape[0] // 2,
        state["Dense_0.weight"].shape[1])
    assert shapes["Dense_2.bias"] == (CLASSES // 2,)
    assert shapes["Conv_0.weight"] == state["Conv_0.weight"].shape


def test_sharded_train_step_matches_reference(pool, reference):
    state, images, labels, want_losses, want = reference
    results = pool.run("sharded_steps", state, CLASSES, images, labels,
                       STEPS, None)
    losses, params, single_losses, single, shapes, local_batch = results[0]
    assert local_batch == images.shape[0] // 4
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(losses, single_losses, rtol=1e-5, atol=1e-5)
    for name, w in want.items():
        np.testing.assert_allclose(params[name], w, rtol=1e-4, atol=1e-4,
                                   err_msg=name)
        np.testing.assert_allclose(params[name], single[name], rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    # parameters keep their layout across steps, and every rank agrees
    assert shapes["Dense_0.weight"][0] == want["Dense_0.weight"].shape[0] // 2
    for r in results[1:]:
        assert r[0] == losses
        for name in params:
            np.testing.assert_array_equal(r[1][name], params[name])


def _check_pieces(results, state, model_parallel):
    for pieces, (d, m), loss in results:
        assert np.isfinite(loss)
        rows = state["Dense_0.weight"].shape[0] // model_parallel
        np.testing.assert_array_equal(
            pieces["Dense_0.weight"],
            state["Dense_0.weight"][m * rows:(m + 1) * rows])
        width = CLASSES // model_parallel
        np.testing.assert_array_equal(
            pieces["Dense_2.bias"],
            state["Dense_2.bias"][m * width:(m + 1) * width])
        np.testing.assert_array_equal(pieces["Conv_0.weight"],
                                      state["Conv_0.weight"])
    assert sorted({r[1] for r in results}) == sorted(
        (r // model_parallel, r % model_parallel) for r in range(WORLD))


@pytest.fixture
def ckpt_dir(tmp_path):
    """A checkpoint dir, removed after the test: every rank writes its
    payload (8 of them, each up to the whole 64 px AlexNet's 70 MB)."""
    base = tmp_path / "ckpt"
    yield str(base)
    shutil.rmtree(base, ignore_errors=True)


def test_sharded_restore_onto_mesh(pool, reference, ckpt_dir):
    state = reference[0]
    results = pool.run("restore_onto_mesh", state, CLASSES, ckpt_dir,
                       False, 2)
    _check_pieces(results, state, 2)


def test_restore_onto_different_mesh_shape(pool, reference, ckpt_dir):
    """Saved as the pieces of a model=2 mesh, restored onto model=4:
    values exact, and the restored tree trains a step there."""
    state = reference[0]
    results = pool.run("restore_onto_mesh", state, CLASSES, ckpt_dir,
                       True, 4)
    _check_pieces(results, state, 4)


def test_run_elastic_sharded_resumes(pool, tmp_path, ckpt_dir):
    """``run_elastic(sharded=True)``: every rank saves its pieces; a
    second run resumes from the last step onto the same mesh and
    finishes."""
    state = str(tmp_path / "none.json")
    first = pool.run("elastic_sharded", ckpt_dir, state, 1, 0)
    assert all(r == (0, [1]) for r in first)
    again = pool.run("elastic_sharded", ckpt_dir, state, 2, 0)
    assert all(r == (0, [1, 2]) for r in again)
