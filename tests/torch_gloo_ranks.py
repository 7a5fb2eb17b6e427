"""The rank side of the port's multi-process tests (``GlooPool`` in
``tests/test_torch_parallel.py``; also ``tests/test_torch_ring_attention.py``,
``test_torch_lm_mesh.py`` and ``test_torch_pipeline.py``): each rank is a
process started with
the ``spawn`` context, joins one gloo group, and runs the cases the
pytest parent sends it through its queue, answering with numpy arrays.
It imports torch and numpy only (and the port), never JAX: the parent
computes the reference's side and sends it over as numpy arrays.

A case is a function of this module, called on every rank with the
same arguments; what rank 0 returns is the case's result.
"""

from __future__ import annotations

import contextlib
import datetime
import socket
import traceback

import numpy as np
import torch
import torch.distributed as dist

# a case that does not return within this time has lost a rank
GROUP_TIMEOUT_S = 120


def rank_main(rank: int, world: int, port: int, inbox, outbox) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        while True:
            job = inbox.get()
            if job is None:
                break
            name, args = job
            try:
                outbox.put((rank, True, globals()[name](*args)))
            except Exception:  # the parent fails the test with the trace
                outbox.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def solo_group(backend: str = "gloo"):
    """A group of this process alone (world size 1) on *backend*,
    destroyed on exit."""
    dist.init_process_group(
        backend, init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
        world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


_GROUPS = {}


def subgroup(ranks):
    """The group of *ranks* (created once, by every rank, in one order);
    None on a rank outside it."""
    ranks = tuple(ranks)
    if ranks not in _GROUPS:
        _GROUPS[ranks] = dist.new_group(list(ranks))
    return _GROUPS[ranks] if dist.get_rank() in ranks else None


def np32(x: torch.Tensor) -> np.ndarray:
    return x.detach().to(torch.float32).numpy()


# --- item 6.1: the data x model AlexNet --------------------------------


def mesh_shapes():
    from tpu_k8s_device_plugin_torch.workloads import parallel

    shapes = [parallel.mesh_shape(parallel.make_mesh(device="cpu")),
              parallel.mesh_shape(parallel.make_mesh(model_parallel=1,
                                                     device="cpu"))]
    mesh = parallel.make_mesh(device="cpu")
    coord = (mesh.get_local_rank("data"), mesh.get_local_rank("model"))
    return shapes, coord


def _tiny_model(state, classes, pool="xla"):
    from tpu_k8s_device_plugin_torch.workloads import alexnet

    model, opt = alexnet.create_train_state(
        seed=1, image_size=64, num_classes=classes, s2d=True, pool=pool,
        dtype=torch.float32, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return model, opt


def dense_specs(state, classes):
    from tpu_k8s_device_plugin_torch.workloads import parallel

    model, opt = _tiny_model(state, classes)
    mesh = parallel.make_mesh(device="cpu")
    sh = parallel.tree_shardings(mesh, model.state_dict())
    _, model, opt, _ = parallel.make_sharded_train_step(model, opt, mesh)
    return ({k: s.spec for k, s in sh.items()},
            {k: tuple(v.shape) for k, v in model.state_dict().items()})


def sharded_steps(state, classes, images, labels, steps, model_parallel):
    """The sharded step on a mesh of every rank, and the single-device
    step at the global batch, from the same weights: each one's losses
    and parameters after *steps* steps."""
    from tpu_k8s_device_plugin_torch.workloads import alexnet, parallel

    images, labels = torch.from_numpy(images), torch.from_numpy(labels)
    mesh = parallel.make_mesh(model_parallel=model_parallel, device="cpu")
    model, opt = _tiny_model(state, classes)
    step, model, opt, (img_sh, lbl_sh) = parallel.make_sharded_train_step(
        model, opt, mesh)
    x, y = img_sh.local(images), lbl_sh.local(labels)
    losses = [float(step(x, y)) for _ in range(steps)]
    local_shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    params = {k: np32(v) for k, v in
              parallel.gather_params(model, mesh).items()}
    single, sopt = _tiny_model(state, classes)
    single_losses = [float(alexnet.train_step(single, sopt, images, labels))
                     for _ in range(steps)]
    single_params = {k: np32(v) for k, v in single.state_dict().items()}
    return (losses, params, single_losses, single_params, local_shapes,
            x.shape[0])


def restore_onto_mesh(state, classes, base, sharded_save, model_parallel):
    """Save *state* (whole, or as the pieces of a model=2 mesh when
    *sharded_save*), restore it onto a mesh of *model_parallel* with
    ``shardings``; returns the restored pieces of Dense_0 and Conv_0,
    and the loss of one step on the new placement."""
    from tpu_k8s_device_plugin_torch.workloads import (alexnet, checkpoint,
                                                       parallel)

    model, opt = _tiny_model(state, classes)
    if sharded_save:
        mesh1 = parallel.make_mesh(model_parallel=2, device="cpu")
        _, model, opt, _ = parallel.make_sharded_train_step(model, opt,
                                                            mesh1)
        checkpoint.save_checkpoint(
            base, 0, {"params": model.state_dict()},
            shardings={"params": parallel.tree_shardings(
                mesh1, model.state_dict())})
    else:
        checkpoint.save_checkpoint(base, 0, {"params": model.state_dict()})
    mesh2 = parallel.make_mesh(model_parallel=model_parallel, device="cpu")
    fresh, fopt = alexnet.create_train_state(
        seed=5, image_size=64, num_classes=classes, s2d=True,
        dtype=torch.float32, device="cpu")
    step, fresh, fopt, (img_sh, lbl_sh) = parallel.make_sharded_train_step(
        fresh, fopt, mesh2)
    template = {"params": fresh.state_dict()}
    restored = checkpoint.restore_checkpoint(
        base, template=template,
        shardings={"params": parallel.tree_shardings(mesh2,
                                                     template["params"])})
    fresh.load_state_dict(restored["params"])
    gen = torch.Generator().manual_seed(0)
    images, labels = alexnet.synthetic_batch(gen, 8, image_size=64,
                                             num_classes=classes, s2d=True)
    loss = float(step(img_sh.local(images), lbl_sh.local(labels)))
    pieces = {k: np32(restored["params"][k])
              for k in ("Dense_0.weight", "Dense_2.bias", "Conv_0.weight")}
    coord = (mesh2.get_local_rank("data"), mesh2.get_local_rank("model"))
    dist.barrier()
    return pieces, coord, loss


def elastic_sharded(base, state_path, steps, every):
    """``run_elastic(sharded=True)`` at 64 px and 16 classes: its return
    code and the steps on disk."""
    import functools

    from tpu_k8s_device_plugin_torch.workloads import (alexnet, bench_main,
                                                       checkpoint)

    small = dict(image_size=64, num_classes=16)
    saved = bench_main.create_train_state, bench_main.synthetic_batch
    bench_main.create_train_state = functools.partial(
        alexnet.create_train_state, **small)
    bench_main.synthetic_batch = functools.partial(alexnet.synthetic_batch,
                                                   **small)
    try:
        rc = bench_main.run_elastic(8, steps, base, every, state_path,
                                    sharded=True, device="cpu")
    finally:
        bench_main.create_train_state, bench_main.synthetic_batch = saved
    dist.barrier()
    return rc, checkpoint.list_steps(base)


# --- item 6.2: ring attention -------------------------------------------


def _ring_inputs(arrays, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]


def ring(arrays, dtype, causal, layout, impl, ranks, grads):
    """Ring attention over the group of *ranks* on whole [B, T, H, D]
    inputs: the gathered output in natural order (and, with *grads*,
    the gathered gradients of sum(out^2) in f32) and each rank's output
    block shape."""
    from tpu_k8s_device_plugin_torch.workloads import ring_attention as ra

    group = subgroup(ranks)
    if group is None:
        return None
    n = len(ranks)
    fn, sharding = ra.make_ring_attention(group, causal=causal,
                                          layout=layout, impl=impl)
    zz = layout == "zigzag"
    q, k, v = (sharding.scatter(ra.zigzag_permute(x, n) if zz else x)
               .requires_grad_(grads) for x in _ring_inputs(arrays, dtype))
    out = fn(q, k, v)
    local_shape = tuple(out.shape)
    order = (lambda x: ra.zigzag_unpermute(x, n)) if zz else (lambda x: x)
    result = {"out": np32(order(sharding.gather(out.detach()))),
              "dtype": str(out.dtype), "local_shape": local_shape}
    if grads:
        (out.to(torch.float32) ** 2).sum().backward()
        result["grads"] = [np32(order(sharding.gather(x.grad)))
                           for x in (q, k, v)]
    return result


def ring_errors(ranks):
    """The errors ``make_ring_attention`` and its functions raise."""
    from tpu_k8s_device_plugin_torch.workloads import ring_attention as ra

    group = subgroup(ranks)
    if group is None:
        return None
    seen = {}
    for name, kw in (("layout", dict(layout="diagonal")),
                     ("zigzag_non_causal", dict(layout="zigzag",
                                                causal=False)),
                     ("impl", dict(impl="fused"))):
        try:
            ra.make_ring_attention(group, **kw)
            seen[name] = None
        except (ValueError, NotImplementedError) as e:
            seen[name] = (type(e).__name__, str(e))
    # batch on another axis of a mesh: the ring runs over "seq" only
    from tpu_k8s_device_plugin_torch.workloads import parallel
    from torch.distributed.device_mesh import DeviceMesh

    mesh = DeviceMesh("cpu", torch.tensor(ranks).reshape(-1, 2),
                      mesh_dim_names=("data", "seq"))
    spec = ("data", "seq", None, None)
    fn, sharding = ra.make_ring_attention(mesh, causal=True, spec=spec,
                                          seq_axis="seq")
    x = torch.randn(4, 8, 2, 4, generator=torch.Generator().manual_seed(0))
    local = sharding.scatter(x)
    want = parallel.Sharding(mesh, spec).local(
        ra.full_attention(x, x, x, causal=True))
    seen["spec"] = (tuple(local.shape),
                    float((fn(local, local, local) - want).abs().max()))
    fn, _ = ra.make_ring_attention(group, causal=True, impl="flash",
                                   spec=(None, "seq", None, None))
    q = torch.zeros(1, 8, 4, 16)
    try:
        fn(q, q[:, :, :2], q[:, :, :2])
        seen["heads"] = None
    except ValueError as e:
        seen["heads"] = (type(e).__name__, str(e))
    return seen



# --- item 6.3: the LM mesh and the pipeline ------------------------------


@contextlib.contextmanager
def compute_dtype(dtype):
    """``make_lm_train_step`` building its model in *dtype* compute (a
    name; None keeps bf16): where parameter updates are compared, f32,
    since bf16 rounding flips the sign of near-zero gradient entries and
    Adam's first update is about ``lr * sign(g)``."""
    import functools

    from tpu_k8s_device_plugin_torch.workloads import transformer as tr

    orig = tr.TransformerLM
    if dtype is not None:
        tr.TransformerLM = functools.partial(orig,
                                             dtype=getattr(torch, dtype))
    try:
        yield
    finally:
        tr.TransformerLM = orig


def lm_mesh(shape, ranks=None):
    """``make_lm_mesh`` with ``(expert, seq, model)`` *shape* over *ranks*
    (every rank by default), or ``("legacy", data, seq, model)``: a
    3-axis ``data x seq x model`` mesh, which has no expert axis."""
    from torch.distributed.device_mesh import DeviceMesh

    from tpu_k8s_device_plugin_torch.workloads import transformer as tr

    if shape[0] == "legacy":
        grid = torch.arange(dist.get_world_size()).reshape(shape[1:])
        return DeviceMesh("cpu", grid,
                          mesh_dim_names=("data", "seq", "model"))
    expert, seq, model = shape
    return tr.make_lm_mesh(ranks, seq=seq, model=model, expert=expert,
                           device="cpu")


def lm_steps(shape, kw, params, batch, steps, dtype=None, ranks=None,
             keep=()):
    """``make_lm_train_step`` on the mesh *shape* (see :func:`lm_mesh`)
    with the whole parameters *params* (numpy, the port's names) loaded
    into this rank's pieces, then *steps* steps on the whole
    natural-order *batch*: the losses, the gathered parameters named in
    *keep* after the steps, and each parameter's local shape and spec.
    None on a rank outside *ranks*."""
    from tpu_k8s_device_plugin_torch.workloads import transformer as tr

    mesh = lm_mesh(shape, ranks)
    if ranks is not None and dist.get_rank() not in ranks:
        return None
    with compute_dtype(dtype):
        step, state, place = tr.make_lm_train_step(mesh, **kw)
    model, sh = state["model"], state["shardings"]
    model.load_state_dict({k: sh[k].local(torch.from_numpy(v))
                           for k, v in params.items()})
    placed = place(*(torch.from_numpy(b) for b in batch))
    losses = [float(step(*placed)) for _ in range(steps)]
    local = model.state_dict()
    after = {k: np32(sh[k].gather(local[k])) for k in keep}
    return (losses, after, {k: tuple(v.shape) for k, v in local.items()},
            {k: sh[k].spec for k in local})


def lm_specs(params, quantized):
    """``lm_tree_shardings``' specs of the whole tree *params* (numpy) on
    a ``(seq 1, model 2)`` mesh of every rank, and of *quantized* (the
    int8 tree)."""
    from tpu_k8s_device_plugin_torch.workloads import transformer as tr

    mesh = lm_mesh((1, 1, 2))
    return [{k: s.spec for k, s in tr.lm_tree_shardings(
        mesh, {k: torch.from_numpy(v) for k, v in tree.items()}).items()}
        for tree in (params, quantized)]


def lm_restore(params, base, sharded_save, model_parallel, kw, batch):
    """Save the whole LM tree *params* (or, with *sharded_save*, each
    rank's pieces on a model=2 mesh), restore it with
    ``lm_tree_shardings`` onto a ``(seq 1, model *model_parallel*)``
    mesh: this rank's restored pieces of ``mlp_gate`` and ``out_proj``,
    its model coordinate, and the loss of one step of the restored tree
    there."""
    from tpu_k8s_device_plugin_torch.workloads import checkpoint
    from tpu_k8s_device_plugin_torch.workloads import transformer as tr

    whole = {k: torch.from_numpy(v) for k, v in params.items()}
    if sharded_save:
        mesh1 = lm_mesh((1, 1, 2))
        sh1 = tr.lm_tree_shardings(mesh1, whole)
        checkpoint.save_checkpoint(
            base, 0, {"params": {k: sh1[k].local(v)
                                 for k, v in whole.items()}},
            shardings={"params": sh1})
    else:
        checkpoint.save_checkpoint(base, 0, {"params": whole})
    mesh2 = lm_mesh((1, 1, model_parallel))
    step, state, place = tr.make_lm_train_step(mesh2, **kw)
    sh2 = state["shardings"]
    template = {"params": state["model"].state_dict()}
    restored = checkpoint.restore_checkpoint(
        base, template=template, shardings={"params": sh2})
    state["model"].load_state_dict(restored["params"])
    loss = float(step(*place(*(torch.from_numpy(b) for b in batch))))
    pieces = {k: np32(restored["params"][k]) for k in
              ("block_0.mlp_gate.weight", "block_0.out_proj.weight",
               "embed.weight")}
    dist.barrier()
    return pieces, mesh2.get_local_rank("model"), loss


def sharding_cases():
    """``parallel.Sharding`` with a joint spec entry on a (data 2,
    expert 2, seq 2, model 1) mesh: this rank's piece of an [8, 6]
    arange, its coordinates, whether ``gather`` gives the whole back; and
    ``fit_spec`` on splits that do and do not fit."""
    from tpu_k8s_device_plugin_torch.workloads import parallel

    mesh = lm_mesh((2, 2, 1))
    x = torch.arange(48.0).reshape(8, 6)
    sh = parallel.Sharding(mesh, (("data", "expert"), "seq"))
    local = sh.local(x)
    coord = tuple(mesh.get_local_rank(a) for a in ("data", "expert", "seq"))
    fits = [parallel.fit_spec(mesh, spec, shape) for spec, shape in (
        ((("data", "expert"), "seq"), (8, 6)),
        ((("data", "expert"), "seq"), (6, 6)),
        (("seq", "model"), (3, 5)),
        (("pipe", None), (4, 4)))]
    return np32(local), coord, bool(torch.equal(sh.gather(local), x)), fits


def mlp_layer(p, x):
    """``tests/test_pipeline.py``'s layer."""
    return torch.tanh(x @ p["w"] + p["b"])


def pipe_mesh(data=2, pipe=4):
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh("cpu", torch.arange(data * pipe).reshape(data, pipe),
                      mesh_dim_names=("data", "pipe"))


def pipeline_run(stacked, x, grads):
    """``make_pipeline`` of :func:`mlp_layer` over a (data 2, pipe 4) mesh
    on *stacked* (numpy, whole) and the whole microbatches *x*: the
    gathered output, each rank's stage params' and input block's shapes,
    and with *grads* the gathered gradients of ``sum(out ** 2)``."""
    from tpu_k8s_device_plugin_torch.workloads import parallel
    from tpu_k8s_device_plugin_torch.workloads import pipeline as pl

    mesh = pipe_mesh()
    apply, params, in_sh = pl.make_pipeline(
        mesh, mlp_layer, {k: torch.from_numpy(v) for k, v in stacked.items()})
    placed = in_sh.local(torch.from_numpy(x))
    out = apply(params, placed)
    result = {"out": np32(in_sh.gather(out.detach())),
              "params": {k: tuple(v.shape) for k, v in params.items()},
              "in": tuple(placed.shape), "in_spec": in_sh.spec}
    if grads:
        (out ** 2).sum().backward()
        stage = parallel.Sharding(mesh, ("pipe",))
        result["grads"] = {k: np32(stage.gather(v.grad))
                           for k, v in params.items()}
    return result


def pipeline_errors(stacked):
    """What ``make_pipeline`` raises for 6 layers over 4 stages, and for
    an explicit batch axis the mesh lacks."""
    from tpu_k8s_device_plugin_torch.workloads import pipeline as pl

    mesh = pipe_mesh()
    seen = {}
    six = {k: torch.from_numpy(v[:6]) for k, v in stacked.items()}
    whole = {k: torch.from_numpy(v) for k, v in stacked.items()}
    for name, args, kw in (("layers", (six,), {}),
                           ("batch_axes", (whole,), {"batch_axes": "model"})):
        try:
            pl.make_pipeline(mesh, mlp_layer, *args, **kw)
            seen[name] = None
        except ValueError as e:
            seen[name] = str(e)
    return seen


def call(module, name, *args):
    """A case of another rank-side module: ``module.name(*args)``."""
    import importlib

    return getattr(importlib.import_module(module), name)(*args)
