"""The collectives of the port's multi-device paths, on a
``torch.distributed`` group that the caller has initialised.

The JAX package leaves its collectives to XLA (``psum``, all-gathers
placed by shardings, ``lax.ppermute``).  The port calls them itself, and
only those that every backend it runs on has: all-reduce, all-gather and
point-to-point sends.  The backend is the caller's choice, made where the
group is initialised (NCCL for one rank a GPU; gloo for ranks on the CPU,
or for several ranks sharing one GPU, which NCCL refuses); nothing here
chooses or changes it.

Gloo's point-to-point calls take host tensors, so on a gloo group a CUDA
tensor travels through a pinned host buffer: copied out, sent or reduced,
copied back.  That is the transport of such a group, not a fallback: the
compute stays on the card.  16-bit floats travel as their bytes where no
arithmetic is done on them, and are summed in f32 where it is.

The differentiable ones are the port's own ``torch.autograd.Function``s:

- :func:`copy_to_group`: identity forward, all-reduce backward (the input
  of a column-parallel layer: each rank's gradient is partial);
- :func:`gather_from_group`: all-gather forward, backward that keeps this
  rank's slice (everything downstream is replicated over the group, so
  every rank holds the whole gradient and no communication is needed);
- :func:`ring_rotate`: send to ``rank + 1``, receive from ``rank - 1``;
  its backward rotates the other way (``lax.ppermute``'s transpose).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist


def _staged(group, x: torch.Tensor) -> bool:
    """Whether *x* travels through host memory on *group*."""
    return x.device.type != "cpu" and dist.get_backend(group) == "gloo"


def _to_wire(x: torch.Tensor, staged: bool) -> torch.Tensor:
    """*x* as the collective sends it: contiguous, on the host when
    *staged* (pinned, so the copies run at the link's rate), 16-bit
    floats on the host as their bytes."""
    x = x.contiguous()
    if staged:
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x)
        x = host
    if x.element_size() == 2 and x.is_floating_point() and \
            x.device.type == "cpu":
        x = x.view(torch.uint8)
    return x


def _from_wire(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if w.dtype != like.dtype:
        w = w.view(like.dtype)
    return w.to(like.device)


def _empty_wire(like: torch.Tensor, staged: bool) -> torch.Tensor:
    if staged or like.device.type == "cpu":
        w = torch.empty(like.shape, dtype=like.dtype,
                        pin_memory=staged)
        if w.element_size() == 2 and w.is_floating_point():
            w = w.view(torch.uint8)
        return w
    return torch.empty_like(like, memory_format=torch.contiguous_format)


def all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of *x* over *group*, as a new tensor of *x*'s dtype and
    device (16-bit floats are summed in f32, then rounded once)."""
    staged = _staged(group, x)
    wide = x.to(torch.float32) if x.element_size() < 4 and \
        x.is_floating_point() else x
    w = _to_wire(wide, staged)
    if w is wide:
        w = w.clone()
    dist.all_reduce(w, group=group)
    return w.to(device=x.device, dtype=x.dtype)


def all_gather(x: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """The ranks' *x* concatenated along *dim*, in rank order."""
    staged = _staged(group, x)
    w = _to_wire(x, staged)
    parts = [torch.empty_like(w) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, w, group=group)
    return torch.cat([_from_wire(p, x) for p in parts], dim=dim)


def _peer(group, shift: int) -> int:
    """The global rank *shift* places along *group*'s ring."""
    n = dist.get_world_size(group)
    peer = (dist.get_rank(group) + shift) % n
    return peer if group is None else dist.get_global_rank(group, peer)


def ring_pass(tensors: Sequence[torch.Tensor], group=None,
              shift: int = 1) -> List[torch.Tensor]:
    """One ring hop: each of *tensors* goes to the rank *shift* places on,
    and the ones of the rank *shift* places back come in, as new tensors
    on the inputs' devices.  Every send is posted with its receive
    (``batch_isend_irecv``), so no ring can deadlock.  A ring of one rank
    hands the tensors back: gloo cannot send to its own rank."""
    if dist.get_world_size(group) == 1:
        return [t.clone() for t in tensors]
    send_to, recv_from = _peer(group, shift), _peer(group, -shift)
    staged = [_staged(group, t) for t in tensors]
    outgoing = [_to_wire(t, s) for t, s in zip(tensors, staged)]
    incoming = [_empty_wire(t, s) for t, s in zip(tensors, staged)]
    ops = []
    for tag, (o, i) in enumerate(zip(outgoing, incoming)):
        ops.append(dist.P2POp(dist.isend, o, send_to, group, tag))
        ops.append(dist.P2POp(dist.irecv, i, recv_from, group, tag))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [_from_wire(i, t) for i, t in zip(incoming, tensors)]


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        ctx.rank, ctx.width = dist.get_rank(group), x.shape[dim]
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.width, ctx.width), None, None


class _RingRotate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, shift, *xs):
        ctx.group, ctx.shift = group, shift
        return tuple(ring_pass(xs, group, shift))

    @staticmethod
    def backward(ctx, *gs):
        gs = [torch.zeros_like(g) if g is None else g for g in gs]
        return (None, None, *ring_pass(gs, ctx.group, -ctx.shift))


def copy_to_group(x: torch.Tensor, group=None) -> torch.Tensor:
    """Identity forward; all-reduce of the gradient over *group*."""
    return _CopyToGroup.apply(x, group)


def gather_from_group(x: torch.Tensor, group=None,
                      dim: int = -1) -> torch.Tensor:
    """All-gather along *dim* forward; this rank's slice of the gradient
    backward."""
    return _GatherFromGroup.apply(x, group, dim % x.dim())


def ring_rotate(xs: Sequence[torch.Tensor], group=None,
                shift: int = 1) -> List[torch.Tensor]:
    """:func:`ring_pass`, differentiable: the gradients go back round the
    ring the other way."""
    return list(_RingRotate.apply(group, shift, *xs))


def seq_chunk(x: torch.Tensor, group=None, dim: int = 1,
              n: Optional[int] = None, index: Optional[int] = None
              ) -> torch.Tensor:
    """This rank's even slice of *x* along *dim* (a copy)."""
    n = dist.get_world_size(group) if n is None else n
    index = dist.get_rank(group) if index is None else index
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split "
                         f"evenly over {n} ranks")
    return x.chunk(n, dim)[index].contiguous()
