"""Pipeline parallelism: a GPipe microbatch pipeline over a mesh axis; the
port of the JAX package's ``workloads/pipeline.py``.

Layer parameters are stacked on a leading layer axis
(:func:`stack_layer_params`) and split over the ``pipe`` axis of a
``DeviceMesh``, so stage *s* holds only its ``L/S`` layers.  Where the
JAX package runs one ``shard_map`` program, the port runs the same
per-rank schedule in each process: ``n_micro + n_stages - 1`` ticks of
inject (stage 0 takes microbatch t) -> the stage's layers -> record (the
last stage keeps microbatch ``t - (S - 1)``) -> ``ring_rotate`` (every
stage's activation to the next), then a sum over the axis that gives
every rank the last stage's outputs.  A tick on which a stage holds no
microbatch (the fill and drain bubbles) runs no layer: the JAX package
computes on what it holds there and records nothing of it, so the
results are the same.

The backward comes from autograd through those steps: ``ring_rotate``
sends the gradients back round the ring, and the final sum passes its
gradient through unchanged (:func:`.collectives.reduce_from_group`), so
only the last stage's recorded outputs take it: every rank computes its
loss on the same copy, and an all-reducing backward would multiply the
gradient by the number of stages.  Every rotation's output is used on
every rank (the injected microbatch and the returned outputs carry a
zero that depends on it), so every rank runs every rotation's backward,
in the same order.  The stage's parameters enter through
:func:`.collectives.copy_to_group` over the batch axis, so their
gradients come out summed over it, as ``jax.grad`` sums a replicated
parameter's.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Sequence

import torch

from . import collectives, parallel

# layer_fn: (one layer's parameters, activations) -> activations
LayerFn = Callable[[Any, torch.Tensor], torch.Tensor]

_DEFAULT_BATCH_AXES = object()  # only the default degrades when missing


def _map(fn, *trees):
    """*fn* over the tensors of dicts, lists and tuples of the same
    structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def stack_layer_params(per_layer_params: Sequence) -> Any:
    """Stack per-layer parameter trees (dicts, lists or tuples of tensors)
    along a new leading layer axis, the axis the ``pipe`` axis splits."""
    return _map(lambda *leaves: torch.stack(leaves), *per_layer_params)


def _pipeline_shard(params_local, inputs: torch.Tensor, layer_fn: LayerFn,
                    group, stage: int, n_stages: int) -> torch.Tensor:
    """This rank's GPipe schedule over its stage's layers."""
    n_micro = inputs.shape[0]
    n_local = _leaves(params_local)[0].shape[0]
    state = torch.zeros_like(inputs[0])
    if torch.is_grad_enabled() and (inputs.requires_grad or any(
            p.requires_grad for p in _leaves(params_local))):
        # on a stage that holds nothing yet, the first rotations carry
        # this zero: it must take part in autograd, or the stage would
        # skip their backward, which its neighbours wait on
        state.requires_grad_()
    outputs = []
    for t in range(n_micro + n_stages - 1):
        if stage == 0 and t < n_micro:
            state = inputs[t] + collectives.tie(inputs[t], state)
        if 0 <= t - stage < n_micro:
            for i in range(n_local):
                state = layer_fn(_map(lambda p: p[i], params_local), state)
        if stage == n_stages - 1 and t >= n_stages - 1:
            outputs.append(state)
        (state,) = collectives.ring_rotate([state], group)
    held = torch.stack(outputs) if outputs else torch.zeros_like(inputs)
    held = held + collectives.tie(held, state)
    return collectives.reduce_from_group(held, group)


def make_pipeline(mesh, layer_fn: LayerFn, stacked_params,
                  pipe_axis: str = "pipe", batch_axes=_DEFAULT_BATCH_AXES):
    """A pipelined forward over *mesh*'s *pipe_axis*: returns ``(apply,
    params_sharded, in_sharding)``.

    *stacked_params*: a tree with a leading layer axis on every leaf
    (:func:`stack_layer_params`), whole on every rank; the layer count
    must divide by the axis's size.  ``params_sharded`` is this rank's
    ``L/S`` layers, as leaf tensors on the mesh's device that require
    gradients.  ``apply(params_sharded, microbatches)`` takes this rank's
    block ``[n_micro, mb, ...]`` (``in_sharding.local`` of the whole
    input: dim 1 split on *batch_axes*, whose default ``"data"`` becomes
    replication on a mesh without it; a named axis the mesh lacks raises
    ``ValueError``) and returns the outputs in the same layout, on every
    stage.  *layer_fn* is functional, ``(one layer's parameters, x) ->
    x``; for a module, ``torch.func.functional_call``."""
    names = tuple(mesh.mesh_dim_names)
    n_stages = parallel.mesh_shape(mesh)[pipe_axis]
    n_layers = _leaves(stacked_params)[0].shape[0]
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers not divisible by {n_stages} "
                         "pipeline stages")
    if batch_axes is _DEFAULT_BATCH_AXES:
        batch_axes = "data" if "data" in names else None
    elif batch_axes is not None and batch_axes not in names:
        raise ValueError(f"batch_axes {batch_axes!r} is not a mesh axis "
                         f"{names}")
    device = parallel.mesh_device(mesh)
    group = mesh.get_group(pipe_axis)
    stage = mesh.get_local_rank(pipe_axis)
    stage_sh = parallel.Sharding(mesh, (pipe_axis,))
    params_sharded = _map(
        lambda leaf: stage_sh.local(leaf.detach()).to(device)
        .requires_grad_(), stacked_params)
    batch_group = None
    if batch_axes and parallel.mesh_shape(mesh)[batch_axes] > 1:
        batch_group = mesh.get_group(batch_axes)

    def apply(params: Dict, microbatches: torch.Tensor) -> torch.Tensor:
        if batch_group is not None:
            params = _map(lambda p: collectives.copy_to_group(p, batch_group),
                          params)
        return _pipeline_shard(params, microbatches, layer_fn, group, stage,
                               n_stages)

    return apply, params_sharded, parallel.Sharding(mesh, (None, batch_axes))
