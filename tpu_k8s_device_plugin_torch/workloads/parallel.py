"""Sharded AlexNet training over a ``data`` x ``model`` mesh of ranks: the
port of the JAX package's ``workloads/parallel.py``.

The JAX package puts ``NamedSharding`` annotations on its trees and lets
one ``jit`` of the step place the collectives.  The port runs one
process a rank on a ``torch.distributed`` group that the caller has
initialised (:mod:`.collectives`), over a ``DeviceMesh`` with the same
axes and the same rule (:func:`_pspec`):

- the batch is split on ``data``;
- each Dense layer is column-parallel on ``model``: its ``weight [out,
  in]`` (the JAX kernel ``[in, out]`` split on ``out``) and its bias are
  split on dim 0, its input enters through :func:`.copy_to_group` (the
  gradient is all-reduced over ``model``) and its output leaves through
  :func:`.gather_from_group`, so everything after it is replicated;
- everything else is replicated;
- gradients are summed over ``data`` and divided by its size, so the
  update is the global batch's mean, as the reference's ``jit``
  computes it.

Each rank holds its shards as plain ``Parameter``s, so
``torch.optim.SGD`` with momentum runs locally and needs nothing of
DTensor: DTensor's redistributions and the optimizer's ops on it would
need collectives that gloo does not have for CUDA tensors (a
reduce-scatter among them), and ranks that share one GPU can only use
gloo.  A :class:`Sharding` says where a tensor lives (its ``spec`` names
the mesh axis each dim is split on, as a JAX ``PartitionSpec`` does), and
gives this rank's slice of a whole tensor or gathers one back, on any
``DeviceMesh`` (the LM's 4-axis one and the pipeline's among them), and
:func:`fit_spec` turns a split that a dim cannot take into replication.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from . import collectives
from .alexnet import AlexNet, Dense, loss_fn
from .transformer import resolve_device

AXES = ("data", "model")


def default_model_parallel(n: int) -> int:
    """The model axis :func:`make_mesh` gives *n* ranks: 2 when *n* is
    even, else 1."""
    return 2 if n % 2 == 0 else 1


def make_mesh(ranks: Optional[Sequence[int]] = None,
              model_parallel: Optional[int] = None,
              device=None) -> DeviceMesh:
    """``data`` x ``model`` mesh over *ranks* (default: every rank of the
    default group, which the caller has initialised).  The model axis is
    2 when the rank count is even, else 1; pass 1 for pure data
    parallelism.  Raises ``ValueError`` when the count does not divide.
    The mesh's device type is CUDA unless *device* says otherwise."""
    n = len(ranks) if ranks is not None else None
    if n is None:
        if not torch.distributed.is_initialized():
            raise RuntimeError(
                "make_mesh needs an initialised torch.distributed group "
                "(init_process_group: NCCL for one rank a GPU, gloo on "
                "the CPU)")
        n = torch.distributed.get_world_size()
        ranks = range(n)
    if model_parallel is None:
        model_parallel = default_model_parallel(n)
    if model_parallel < 1 or n % model_parallel:
        raise ValueError(f"{n} ranks not divisible by model="
                         f"{model_parallel}")
    device = resolve_device(device)
    grid = torch.tensor(list(ranks)).reshape(n // model_parallel,
                                              model_parallel)
    return DeviceMesh(device.type, grid, mesh_dim_names=AXES)


def mesh_shape(mesh: DeviceMesh) -> Dict[str, int]:
    """``{axis: size}`` in mesh order, as the JAX mesh's ``shape``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on *mesh*: the current CUDA device for a CUDA
    mesh, else the mesh's device type."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _axes(axis) -> Tuple[str, ...]:
    """A spec entry's axes: one name, or a tuple of names split jointly
    (the first outermost)."""
    return axis if isinstance(axis, tuple) else (axis,)


def fit_spec(mesh: DeviceMesh, spec: Sequence, shape: Sequence[int]
             ) -> Tuple:
    """*spec* for a tensor of *shape* on *mesh*: each split whose axes the
    mesh lacks, or whose axes' sizes do not divide the dim, becomes
    replication (always numerically valid), as the JAX package's
    ``lm_tree_shardings`` degrades it."""
    sizes = mesh_shape(mesh)
    fixed = []
    for dim, axis in enumerate(spec):
        if axis is not None:
            if not all(a in sizes for a in _axes(axis)):
                axis = None
            elif shape[dim] % math.prod(sizes[a] for a in _axes(axis)):
                axis = None
        fixed.append(axis)
    return tuple(fixed)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Where a tensor lives on *mesh*: ``spec[i]`` names the mesh axis
    that dim *i* is split on evenly (a tuple of axes splits it over them
    jointly, the first outermost), or is None; dims past the spec and an
    empty spec are replicated."""

    mesh: DeviceMesh
    spec: Tuple = ()

    def _split(self):
        return [(i, _axes(a)) for i, a in enumerate(self.spec)
                if a is not None]

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's piece of the whole tensor *full* (a copy)."""
        sizes = mesh_shape(self.mesh)
        for dim, axes in self._split():
            n, index = 1, 0
            for a in axes:
                n, index = n * sizes[a], index * sizes[a] + \
                    self.mesh.get_local_rank(a)
            full = collectives.seq_chunk(full, dim=dim, n=n, index=index)
        return full.contiguous()

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The whole tensor, from every rank's piece."""
        for dim, axes in self._split():
            for a in reversed(axes):
                local = collectives.all_gather(
                    local, self.mesh.get_group(a), dim)
        return local


def _pspec(name: str, leaf) -> Tuple[Optional[str], ...]:
    """The sharding rule by a leaf's path: Dense weights ``[out, in]``
    split on dim 0 over ``model`` (the JAX kernel's ``P(None, "model")``)
    and Dense biases on ``model``; everything else replicated.  Conv
    kernels are small; replicating them keeps their gradients a pure
    data-parallel sum."""
    if not isinstance(leaf, torch.Tensor) or "Dense" not in name:
        return ()
    if name.endswith("weight") and leaf.dim() == 2:
        return ("model", None)
    if name.endswith("bias") and leaf.dim() == 1:
        return ("model",)
    return ()


def tree_shardings(mesh: DeviceMesh, tree: Any,
                   param_names: Sequence[str] = (),
                   rule: Callable[[str, torch.Tensor], Tuple] = _pspec
                   ) -> Any:
    """A tree of :class:`Sharding` mirroring *tree* (dicts, lists and
    tuples) under *rule* (a leaf's name and the leaf to its spec; the
    AlexNet's :func:`_pspec` by default), None for a leaf that is not a
    tensor.  A torch optimizer's state dict names parameters by index:
    *param_names* (``[n for n, _ in model.named_parameters()]``) maps
    those indices back to names."""

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, path + (i,))
                              for i, v in enumerate(node))
        if not isinstance(node, torch.Tensor):
            return None
        # an optimizer buffer ("state/<index>/momentum_buffer") follows
        # its parameter
        named = [param_names[p] for p in path
                 if isinstance(p, int) and p < len(param_names)]
        name = named[0] if named else "/".join(map(str, path))
        return Sharding(mesh, rule(name, node))

    return walk(tree, ())


def train_state_shardings(mesh: DeviceMesh, model: nn.Module,
                          opt_state: Dict[str, Any]) -> Dict[str, Any]:
    """Shardings of ``{"params": model.state_dict(), "opt_state":
    opt_state}``, the train loop's checkpointed state."""
    names = [n for n, _ in model.named_parameters()]
    return {"params": tree_shardings(mesh, model.state_dict()),
            "opt_state": tree_shardings(mesh, opt_state, names)}


class ColumnParallelDense(nn.Module):
    """This rank's columns of a :class:`.alexnet.Dense`: ``weight`` and
    ``bias`` are its slices on dim 0 over the mesh's ``model`` axis (f32,
    cast to the input's dtype at use, as ``Dense``'s); the output is
    gathered, so it is the whole layer's on every rank."""

    def __init__(self, dense: Dense, mesh: DeviceMesh):
        super().__init__()
        self.group = mesh.get_group("model")
        for name in ("weight", "bias"):
            full = getattr(dense, name).detach()
            sh = Sharding(mesh, _pspec(f"Dense.{name}", full))
            setattr(self, name, nn.Parameter(sh.local(full)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = collectives.copy_to_group(x, self.group)
        y = F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))
        return collectives.gather_from_group(y, self.group, dim=-1)


def _average_over_data(params, mesh: DeviceMesh) -> None:
    """Every gradient summed over ``data`` and divided by its size, in
    one all-reduce of the flattened f32 gradients."""
    d = mesh_shape(mesh)["data"]
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1).to(torch.float32) for g in grads])
    flat = collectives.all_reduce(flat, mesh.get_group("data")) / d
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def make_sharded_train_step(model: AlexNet, opt: torch.optim.Optimizer,
                            mesh: DeviceMesh):
    """Shard *model* over *mesh* in place (each Dense layer replaced by
    this rank's :class:`ColumnParallelDense`; the parameter names stay
    ``Dense_i.weight`` and ``Dense_i.bias``) and rebuild *opt* over the
    sharded parameters with the same options; returns
    ``(step, model, opt, (image_sharding, label_sharding))``.

    ``step(images, labels)`` takes this rank's slices of the global batch
    (``image_sharding.local(images)``), runs the forward and backward,
    averages the gradients over ``data``, updates in place and returns
    the global batch's mean loss (the same on every rank)."""
    if any(opt.state.values()):
        raise ValueError("make_sharded_train_step takes a fresh optimizer "
                         "(its state would belong to the unsharded "
                         "parameters)")
    for i in range(3):
        name = f"Dense_{i}"
        setattr(model, name, ColumnParallelDense(getattr(model, name), mesh))
    params = list(model.parameters())
    opt = type(opt)(params, **opt.defaults)
    data_group = mesh.get_group("data")
    d = mesh_shape(mesh)["data"]

    def step(images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(model, images, labels)
        loss.backward()
        _average_over_data(params, mesh)
        opt.step()
        return collectives.all_reduce(loss.detach(), data_group) / d

    shardings = (Sharding(mesh, ("data", None, None, None)),
                 Sharding(mesh, ("data",)))
    return step, model, opt, shardings


def gather_params(model: nn.Module, mesh: DeviceMesh
                  ) -> Dict[str, torch.Tensor]:
    """The whole (unsharded) state dict of a sharded *model*, on every
    rank."""
    state = model.state_dict()
    shardings = tree_shardings(mesh, state)
    return {k: shardings[k].gather(v) for k, v in state.items()}

