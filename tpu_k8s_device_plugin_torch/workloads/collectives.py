"""The collectives of the port's multi-device paths, on a
``torch.distributed`` group that the caller has initialised.

The JAX package leaves its collectives to XLA (``psum``, all-gathers
and all-to-alls placed by shardings, ``lax.ppermute``).  The port calls
them itself, and only those that every backend it runs on has:
all-reduce, all-gather, all-to-all and point-to-point sends.  The
backend is the caller's choice, made where the group is initialised
(NCCL for one rank a GPU; gloo for ranks on the CPU, or for several
ranks sharing one GPU, which NCCL refuses); nothing here chooses or
changes it.

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
- :func:`reduce_from_group`: all-reduce forward, identity backward (the
  output of a row-parallel layer, and a sum that broadcasts what one rank
  holds: every rank then computes on the same copy, and only the rank
  that held it needs the gradient);
- :func:`ring_rotate`: send to ``rank + 1``, receive from ``rank - 1``;
  its backward rotates the other way (``lax.ppermute``'s transpose);
- :func:`all_to_all`: each rank's pieces scattered to the group's ranks;
  its backward is the reverse all-to-all.
"""

from __future__ import annotations

import math
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


def _empty_wire(like: torch.Tensor, staged: bool,
                shape: Optional[Sequence[int]] = None) -> torch.Tensor:
    """A receive buffer for a tensor of *like*'s dtype and device (of
    *shape*, *like*'s when None), as :func:`_to_wire` would send it."""
    shape = like.shape if shape is None else shape
    if staged or like.device.type == "cpu":
        w = torch.empty(shape, dtype=like.dtype, pin_memory=staged)
        if w.element_size() == 2 and w.is_floating_point():
            w = w.view(torch.uint8)
        return w
    return torch.empty(shape, dtype=like.dtype, device=like.device)


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


def _split_sizes(n: int, size: int, sizes: Optional[Sequence[int]]
                 ) -> List[int]:
    if sizes is None:
        if size % n:
            raise ValueError(f"a dim of size {size} does not split evenly "
                             f"over {n} ranks")
        return [size // n] * n
    if len(sizes) != n or sum(sizes) != size:
        raise ValueError(f"split sizes {list(sizes)} do not cover a dim of "
                         f"size {size} over {n} ranks")
    return list(sizes)


def all_to_all_dims(x: torch.Tensor, group=None, split_dim: int = 0,
                    cat_dim: int = 0,
                    send: Optional[Sequence[int]] = None,
                    recv: Optional[Sequence[int]] = None) -> torch.Tensor:
    """*x* split along *split_dim* into one piece a rank of *group*
    (sizes *send*, even when None), piece j sent to rank j; returns the
    pieces received from ranks 0, 1, ... concatenated along *cat_dim*
    (sizes *recv* along *split_dim*, *send*'s when None: what rank i
    sends here must have the size this rank expects)."""
    n = dist.get_world_size(group)
    send = _split_sizes(n, x.shape[split_dim], send)
    recv = send if recv is None else list(recv)
    pieces = x.split(send, split_dim)
    shapes = []
    for size in recv:
        shape = list(x.shape)
        shape[split_dim] = size
        shapes.append(shape)
    # one flat buffer each way (gloo's list all-to-all wants equal
    # pieces; the single-tensor form takes split sizes)
    staged = _staged(group, x)
    out = _to_wire(torch.cat([p.reshape(-1) for p in pieces]), staged)
    per = x.element_size() // out.element_size()  # wire elements a value
    inc = _empty_wire(x, staged, (sum(math.prod(s) for s in shapes),))
    dist.all_to_all_single(
        inc, out, [math.prod(s) * per for s in shapes],
        [p.numel() * per for p in pieces], group=group)
    got = _from_wire(inc, x).split([math.prod(s) for s in shapes])
    return torch.cat([g.view(s) for g, s in zip(got, shapes)], dim=cat_dim)


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


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, cat_dim, send, recv):
        n = dist.get_world_size(group)
        send = _split_sizes(n, x.shape[split_dim], send)
        recv = send if recv is None else list(recv)
        ctx.args = (group, split_dim, cat_dim, send, recv)
        return all_to_all_dims(x, group, split_dim, cat_dim, send, recv)

    @staticmethod
    def backward(ctx, g):
        # each received piece's gradient goes back to its sender, who puts
        # it where the piece came from
        group, split_dim, cat_dim, send, recv = ctx.args
        if split_dim == cat_dim:
            g = all_to_all_dims(g, group, split_dim, split_dim, recv, send)
        else:
            g = all_to_all_dims(g, group, cat_dim, split_dim)
        return g, None, None, None, None, None


class _Tie(torch.autograd.Function):
    @staticmethod
    def forward(ctx, like, *xs):
        ctx.shapes = [(x.shape, x.dtype, x.device) for x in xs]
        return torch.zeros_like(like)

    @staticmethod
    def backward(ctx, g):
        return (None, *(torch.zeros(s, dtype=d, device=dev)
                        for s, d, dev in ctx.shapes))


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


def reduce_from_group(x: torch.Tensor, group=None) -> torch.Tensor:
    """All-reduce (sum) forward; the gradient passes through as it is."""
    return _ReduceFromGroup.apply(x, group)


def all_to_all(x: torch.Tensor, group=None, split_dim: int = 0,
               cat_dim: int = 0, send: Optional[Sequence[int]] = None,
               recv: Optional[Sequence[int]] = None) -> torch.Tensor:
    """:func:`all_to_all_dims`, differentiable: the gradient goes back to
    the senders by the reverse all-to-all.  Uneven pieces (*send*,
    *recv*) need ``split_dim == cat_dim``."""
    split_dim, cat_dim = split_dim % x.dim(), cat_dim % x.dim()
    if split_dim != cat_dim and (send is not None or recv is not None):
        raise ValueError("uneven all-to-all pieces need split_dim == "
                         "cat_dim")
    return _AllToAll.apply(x, group, split_dim, cat_dim,
                           None if send is None else tuple(send),
                           None if recv is None else tuple(recv))


def ring_rotate(xs: Sequence[torch.Tensor], group=None,
                shift: int = 1) -> List[torch.Tensor]:
    """:func:`ring_pass`, differentiable: the gradients go back round the
    ring the other way."""
    return list(_RingRotate.apply(group, shift, *xs))


def tie(like: torch.Tensor, *xs: torch.Tensor) -> torch.Tensor:
    """Zeros of *like*'s shape that depend on *xs* with zero gradient.
    Added to a result, it keeps the last of a chain of ring passes on
    every rank's graph, so every rank runs every pass's backward, in the
    chain's order: a rank whose result does not otherwise depend on a
    pass would skip its backward, which its neighbours wait on."""
    return _Tie.apply(like, *xs)


def seq_chunk(x: torch.Tensor, group=None, dim: int = 1,
              n: Optional[int] = None, index: Optional[int] = None
              ) -> torch.Tensor:
    """This rank's even slice of *x* along *dim* (a copy)."""
    n = dist.get_world_size(group) if n is None else n
    index = dist.get_rank(group) if index is None else index
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split "
                         f"evenly over {n} ranks")
    # a clone, not .contiguous(): a chunk along dim 0 is contiguous
    # already, and a view would keep the whole tensor's storage alive
    return x.chunk(n, dim)[index].clone(
        memory_format=torch.contiguous_format)
