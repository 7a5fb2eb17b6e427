"""The port's AlexNet training step against the JAX package's.

For each ``pool`` (``xla``, ``pallas``, ``fused``) the JAX ``AlexNet``
(10 classes, f32, s2d, 64 px: the stage chain 16 -> 7 -> 3 -> 1, as
tests/test_convpool.py) is initialised by JAX, converted with
``convert.alexnet_params_from_jax`` and run on the CPU beside the port's
model with the same ``pool``.  Images and labels come from numpy with a
seed.  Logits agree to 1e-4, parameter gradients to 2e-3 (the
frameworks sum in different orders), and two SGD-momentum steps give
the same losses to 1e-5 and the same parameters to 1e-4."""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_gloo_ranks
from tpu_k8s_device_plugin.workloads import alexnet as jalex
from tpu_k8s_device_plugin_torch.convert import (
    alexnet_params_from_jax,
    params_from_jax,
)
from tpu_k8s_device_plugin_torch.workloads import alexnet as talex
from tpu_k8s_device_plugin_torch.workloads import bench_main

LR = 0.01
POOLS = ("xla", "pallas", "fused")

# the JAX pool="fused" tree names the conv+pool stages FusedConvPool_i
# (tests/test_convpool.py `_remap_params`)
_FUSED = {"Conv_0": "FusedConvPool_0", "Conv_1": "FusedConvPool_1",
          "Conv_2": "Conv_0", "Conv_3": "Conv_1", "Conv_4": "FusedConvPool_2"}


def _tree_for(pool, params):
    if pool != "fused":
        return params
    return {_FUSED.get(k, k): v for k, v in params.items()}


def _batch(seed=0, size=64):
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((2, size, size, 3)).astype(np.float32)
    return img, np.array([3, 7], np.int64)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_params():
    img, _ = _batch()
    x = jalex.space_to_depth(jnp.asarray(img))
    model = jalex.AlexNet(num_classes=10, dtype=jnp.float32, s2d=True)
    return _np_tree(model.init(jax.random.PRNGKey(0), x,
                               train=False)["params"])


@pytest.fixture(scope="module", params=POOLS)
def jax_run(request, jax_params):
    """One pool mode through JAX: logits, first gradients, and the
    losses and parameters of two SGD-momentum steps (what
    ``alexnet.train_step`` does)."""
    pool = request.param
    img, labels = _batch()
    x = jalex.space_to_depth(jnp.asarray(img))
    y = jnp.asarray(labels.astype(np.int32))
    model = jalex.AlexNet(num_classes=10, dtype=jnp.float32, s2d=True,
                          pool=pool)
    params = _tree_for(pool, jax_params)

    def loss_and_logits(p):
        logits = model.apply({"params": p}, x, train=True)
        loss = optax.softmax_cross_entropy_with_integer_labels(logits, y)
        return loss.mean(), logits

    grad_fn = jax.value_and_grad(loss_and_logits, has_aux=True)
    tx = optax.sgd(LR, momentum=0.9)
    opt_state = tx.init(params)
    losses, p = [], params
    for step in range(2):
        (loss, logits), grads = grad_fn(p)
        if step == 0:
            first = (np.asarray(logits), _np_tree(grads))
        updates, opt_state = tx.update(grads, opt_state, p)
        p = optax.apply_updates(p, updates)
        losses.append(float(loss))
    return pool, params, first, losses, _np_tree(p)


def _port_model(pool, tree):
    model, opt = talex.create_train_state(
        seed=1, image_size=64, num_classes=10, learning_rate=LR, s2d=True,
        pool=pool, dtype=torch.float32, device="cpu")
    model.load_state_dict(alexnet_params_from_jax(tree))
    return model, opt


def test_training_matches_jax(jax_run):
    pool, params, (logits, grads), losses, after = jax_run
    img, labels = _batch()
    x = talex.space_to_depth(torch.from_numpy(img))
    y = torch.from_numpy(labels)
    model, opt = _port_model(pool, params)

    np.testing.assert_allclose(model(x).detach().numpy(), logits,
                               rtol=1e-4, atol=1e-4)
    talex.loss_fn(model, x, y).backward()
    want = alexnet_params_from_jax(grads)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=2e-3, atol=2e-3, err_msg=name)

    got = [float(talex.train_step(model, opt, x, y)) for _ in range(2)]
    np.testing.assert_allclose(got, losses, rtol=1e-5, atol=1e-5)
    want = alexnet_params_from_jax(after)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def test_space_to_depth_matches_jax():
    img = np.random.default_rng(1).standard_normal(
        (2, 16, 12, 3)).astype(np.float32)
    got = talex.space_to_depth(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jalex.space_to_depth(jnp.asarray(img))))


def test_raw_first_conv_matches_jax():
    """s2d=False: the 11x11/s4 conv with TF-style SAME padding (3 before,
    4 after at 224 px; 3 and 4 at 64 px too)."""
    img, _ = _batch(seed=2)
    model = jalex.AlexNet(num_classes=10, dtype=jnp.float32, s2d=False)
    params = model.init(jax.random.PRNGKey(1), jnp.asarray(img),
                        train=False)["params"]
    want = model.apply({"params": params}, jnp.asarray(img), train=False)
    tmodel = talex.AlexNet(num_classes=10, dtype=torch.float32, s2d=False,
                           image_size=64, device="cpu")
    tmodel.load_state_dict(alexnet_params_from_jax(_np_tree(params)))
    got = tmodel(torch.from_numpy(img)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)


def test_same_names_under_every_pool():
    names = {pool: [n for n, _ in talex.AlexNet(
        num_classes=10, s2d=True, pool=pool, image_size=64,
        device="cpu").named_parameters()] for pool in POOLS}
    assert names["xla"] == names["pallas"] == names["fused"]
    assert names["xla"][0] == "Conv_0.weight"


def test_refusals(monkeypatch):
    with pytest.raises(ValueError, match="s2d"):
        talex.AlexNet(s2d=False, pool="fused", device="cpu")
    with pytest.raises(ValueError, match="unknown pool"):
        talex.AlexNet(s2d=True, pool="cudnn", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        talex.AlexNet()


def test_params_from_jax_refuses_conv_kernels(jax_params):
    # a 4-D conv kernel through the decoder's converter would come out
    # with H and W swapped by .T; it must raise instead
    with pytest.raises(ValueError, match="2-D"):
        params_from_jax({"Conv_0": {"kernel": jax_params["Conv_0"]["kernel"]}})
    out = params_from_jax({"Dense_0": {"kernel": np.ones((3, 5))}})
    assert tuple(out["Dense_0.weight"].shape) == (5, 3)


def test_flop_count_matches_flop_counter():
    """The analytic count against PyTorch's FLOP counter over one
    training step of the xla model: the counter sees every conv and
    matmul that runs, and no input gradient of the first conv."""
    from torch.utils.flop_counter import FlopCounterMode

    model, opt = talex.create_train_state(
        image_size=64, num_classes=10, s2d=True, dtype=torch.float32,
        device="cpu")
    gen = torch.Generator().manual_seed(0)
    images, labels = talex.synthetic_batch(gen, 2, image_size=64,
                                           num_classes=10, s2d=True)
    assert images.dtype == torch.bfloat16 and images.shape == (2, 16, 16, 48)
    with FlopCounterMode(display=False) as counter:
        talex.train_step(model, opt, images.float(), labels)
    analytic = model.train_flops_per_image() * 2
    first_conv_dx = 2 * model.layer_macs()[0][1] * 2
    assert analytic <= counter.get_total_flops() <= analytic + first_conv_dx


def test_flops_per_image_at_224():
    model = talex.AlexNet(s2d=True, device="cpu")
    assert model.feature_side() == 6
    assert model.Dense_0.weight.shape == (4096, 6 * 6 * 256)
    assert abs(model.train_flops_per_image() / 4.2e9 - 1) < 0.01


def test_bench_main_prints_one_json_line(capsys):
    assert bench_main.main(["--device", "cpu", "--batch", "2", "--steps",
                            "1", "--warmup", "0"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["metric"] == "alexnet_images_per_sec_per_gpu"
    assert rec["unit"] == "images/sec" and rec["value"] > 0
    assert rec["extra"]["pool"] == "xla" and rec["extra"]["batch"] == 2
    assert rec["extra"]["device"] == "cpu" and rec["extra"]["mfu"] is None
    assert rec["extra"]["flops_per_image"] == \
        talex.AlexNet(s2d=True, device="cpu").train_flops_per_image()


def test_bench_main_unported_modes(tmp_path, monkeypatch, capsys):
    """``--sharded`` (item 6.1) initialises a gloo group from torchrun's
    env under ``--device cpu`` and prints one JSON line for the mesh;
    ``--checkpoint-dir`` (item 7) runs the elastic loop and leaves the
    final step's checkpoint (AlexNet cut to 64 px and 10 classes
    here)."""
    small = dict(image_size=64, num_classes=10)
    monkeypatch.setattr(bench_main, "create_train_state", functools.partial(
        talex.create_train_state, **small))
    monkeypatch.setattr(bench_main, "synthetic_batch", functools.partial(
        talex.synthetic_batch, **small))
    for name, value in (("RANK", "0"), ("WORLD_SIZE", "1"),
                        ("LOCAL_RANK", "0"), ("MASTER_ADDR", "127.0.0.1"),
                        ("MASTER_PORT", str(torch_gloo_ranks.free_port()))):
        monkeypatch.setenv(name, value)
    assert bench_main.main(["--device", "cpu", "--sharded", "--batch", "2",
                            "--steps", "1", "--warmup", "0"]) == 0
    assert not torch.distributed.is_initialized()
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["value"] > 0 and rec["extra"]["sharded"] is True
    assert rec["extra"]["mesh"] == {"data": 1, "model": 1}
    assert rec["extra"]["backend"] == "gloo"
    ckpt = tmp_path / "ckpt"
    assert bench_main.main(["--device", "cpu", "--batch", "2", "--steps",
                            "1", "--checkpoint-dir", str(ckpt),
                            "--slice-state", str(tmp_path / "none.json")]
                           ) == 0
    assert sorted(os.listdir(ckpt)) == ["step_1"]
    assert capsys.readouterr().out.startswith("final loss after 1 steps: ")


def test_resolve_pool(monkeypatch):
    monkeypatch.delenv("ALEXNET_POOL", raising=False)
    assert bench_main._resolve_pool(None) == "xla"
    monkeypatch.setenv("ALEXNET_POOL", "fused")
    assert bench_main._resolve_pool(None) == "fused"
    assert bench_main._resolve_pool("pallas") == "pallas"
