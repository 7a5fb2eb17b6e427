"""Ring attention: sequence-parallel attention over a ring of ranks; the
port of the JAX package's ``workloads/ring_attention.py``.

The sequence is split over the ranks of a ``torch.distributed`` group
(the caller initialises it); each rank keeps its query block and passes
its K/V block round the ring (:func:`.collectives.ring_rotate`, send to
``rank + 1``, receive from ``rank - 1``) while it accumulates attention
with the numerically stable online softmax, so a rank holds O(T / n) of
the sequence.  Where the JAX package runs one SPMD program under
``shard_map``, the port runs the same per-rank body in each process;
every decision that decides a collective (the skipped last hop) is the
same on every rank, or the ring would deadlock.

Two impls, two layouts:

- ``impl="einsum"``: the f32 online-softmax update in torch ops,
  differentiable by autograd, the K/V rotations included (their
  backward rotates the gradients the other way).  Grouped K/V rotate at
  their own head count and are expanded after the hop.
- ``impl="flash"``: each (query block, K/V block) pair through the flash
  kernels' block forms (:func:`.flash_attention.flash_block_forward`,
  K4 with its lse; :func:`.flash_attention.flash_block_grads`, K5 and K6
  writing f32), the partials merged by logsumexp algebra
  (:func:`_lse_merge`); forward and backward are one
  ``torch.autograd.Function`` whose backward passes K/V round the ring
  again with the dK/dV partials riding beside them in f32, home after n
  hops, each step using the *global* lse and delta.  On CUDA tensors it
  launches the kernels; CPU tensors take the block forms' plain
  versions.  It needs equal Q and K/V head counts.
- ``layout="contiguous"``: rank r holds tokens ``[r T/n, (r+1) T/n)``;
  under a causal mask rank r does r + 1 blocks of work.
- ``layout="zigzag"`` (causal only): the sequence in 2n chunks, rank r
  holding chunks r and 2n-1-r (:func:`zigzag_permute`), so every rank
  does the same work.

The ring sums f32 partials in rotation order, so results are held to
tolerances, not bits.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from . import collectives
from .flash_attention import flash_block_forward, flash_block_grads
from .transformer import f32_rsqrt, repeat_kv

_NEG_INF = float("-inf")


def _online_softmax_update(o, l, m, q_blk, k_blk, v_blk, scale, mask=None):
    """One K/V block's online-softmax accumulation in f32.  *mask* is an
    optional [Tq, Tk] boolean of visible positions.  Fully masked rows
    keep a -inf running max; the isinf-guarded correction keeps
    exp(-inf - -inf) from giving NaN.  Grouped K/V (fewer heads than Q)
    are expanded here, after the hop, so the ring moves the compact
    heads."""
    if k_blk.shape[2] != q_blk.shape[2]:
        k_blk = repeat_kv(k_blk, q_blk.shape[2])
        v_blk = repeat_kv(v_blk, q_blk.shape[2])
    f32 = torch.float32
    scores = torch.einsum("bqhd,bkhd->bqhk", q_blk.to(f32),
                          k_blk.to(f32)) * scale
    if mask is not None:
        scores = scores.masked_fill(~mask[None, :, None, :], _NEG_INF)
    m_new = torch.maximum(m, scores.amax(dim=-1))          # [B, Tq, H]
    safe_m = torch.where(torch.isinf(m_new), torch.zeros_like(m_new), m_new)
    p = torch.exp(scores - safe_m[..., None])
    correction = torch.where(
        torch.isinf(m),
        torch.where(torch.isinf(m_new), torch.ones_like(m),
                    torch.zeros_like(m)),
        torch.exp(m - safe_m))
    l = l * correction + p.sum(dim=-1)
    o = o * correction[..., None] + torch.einsum(
        "bqhk,bkhd->bqhd", p, v_blk.to(f32))
    return o, l, m_new


def _zero_state(q: torch.Tensor, rows: int):
    B, _, H, D = q.shape
    f32 = torch.float32
    return (q.new_zeros((B, rows, H, D), dtype=f32),
            q.new_zeros((B, rows, H), dtype=f32),
            q.new_full((B, rows, H), _NEG_INF, dtype=f32))


def _normalise(o, l, dtype):
    """Rows with no visible keys (l = 0) give 0."""
    denom = torch.where(l == 0.0, torch.ones_like(l), l)
    return (o / denom[..., None]).to(dtype)


def _rotate_kv(k_blk, v_blk, s: int, n: int, group, differentiable: bool):
    """One ring hop for the K/V pair, skipping the dead last one (its
    result is never read); the skip depends on the step alone, so every
    rank takes it alike."""
    if s >= n - 1:
        return k_blk, v_blk
    if differentiable:
        return tuple(collectives.ring_rotate([k_blk, v_blk], group))
    return tuple(collectives.ring_pass([k_blk, v_blk], group))


def _ring_attention_shard(q, k, v, group, causal: bool):
    """Per-rank body, einsum impl, contiguous layout: online-softmax
    accumulation over every K/V block, one hop a step."""
    n, my_idx = dist.get_world_size(group), dist.get_rank(group)
    Tq, Tk = q.shape[1], k.shape[1]
    scale = f32_rsqrt(q.shape[3])
    o, l, m = _zero_state(q, Tq)
    k_blk, v_blk = k, v
    q_pos = my_idx * Tq + torch.arange(Tq, device=q.device)[:, None]
    for s in range(n):
        kv_idx = (my_idx - s) % n
        # entirely-future blocks contribute nothing: skip their FLOPs (rank
        # r does r + 1 blocks: use layout="zigzag" for uniform work)
        if not causal or kv_idx <= my_idx:
            mask = None
            if causal:
                k_pos = kv_idx * Tk + torch.arange(Tk, device=q.device)
                mask = q_pos >= k_pos[None, :]
            o, l, m = _online_softmax_update(o, l, m, q, k_blk, v_blk, scale,
                                             mask)
        k_blk, v_blk = _rotate_kv(k_blk, v_blk, s, n, group, True)
    out = _normalise(o, l, q.dtype)
    return out + collectives.tie(out, k_blk, v_blk)


# ---------------------------------------------------------------------------
# Zig-zag layout: balanced causal ring attention.  The sequence is split
# into 2n chunks and rank r holds chunks {r, 2n-1-r}: every rank owns one
# early and one late chunk, and for any K/V block exactly half of the
# quarter-interactions are visible, so the work of a step is the same on
# every rank (2 C x C tiles, 3 on the diagonal step).
# ---------------------------------------------------------------------------


def _zigzag_indices(T: int, n_shards: int) -> np.ndarray:
    n_chunks = 2 * n_shards
    if T % n_chunks:
        raise ValueError(f"sequence length {T} not divisible by {n_chunks}")
    C = T // n_chunks
    order = []
    for r in range(n_shards):
        order.extend((r, n_chunks - 1 - r))
    return np.concatenate([np.arange(c * C, (c + 1) * C) for c in order])


def zigzag_permute(x: torch.Tensor, n_shards: int,
                   axis: int = 1) -> torch.Tensor:
    """Reorder a contiguous sequence into the zig-zag layout (chunk order
    0, 2n-1, 1, 2n-2, ...), so an even split over n ranks gives rank r
    chunks {r, 2n-1-r}.  Runs once at ingress, not per step."""
    idx = _zigzag_indices(x.shape[axis], n_shards)
    return x.index_select(axis, torch.from_numpy(idx).to(x.device))


def zigzag_unpermute(x: torch.Tensor, n_shards: int,
                     axis: int = 1) -> torch.Tensor:
    """Inverse of :func:`zigzag_permute` (egress to natural order)."""
    fwd = _zigzag_indices(x.shape[axis], n_shards)
    inv = np.empty_like(fwd)
    inv[fwd] = np.arange(len(fwd))
    return x.index_select(axis, torch.from_numpy(inv).to(x.device))


def _zigzag_branch(j: int, my_idx: int) -> int:
    """The step's branch, shared by every zig-zag body: 0 = diagonal (own
    block), 1 = holder earlier (only the late query half attends,
    unmasked), 2 = holder later (both halves attend the early K half)."""
    return 0 if j == my_idx else (1 if my_idx < j else 2)


def _causal_branch(kv_idx: int, my_idx: int) -> int:
    """The contiguous flash step's branch, shared by its forward and
    backward: 0 = future block (skip), 1 = diagonal (causal kernel),
    2 = past (unmasked kernel)."""
    return 0 if kv_idx > my_idx else (1 if kv_idx == my_idx else 2)


def _diag_mask(rows: int, cols: int, device) -> torch.Tensor:
    return torch.ones(rows, cols, dtype=torch.bool, device=device).tril()


def _ring_attention_shard_zigzag(q, k, v, group):
    """Per-rank body, einsum impl, zig-zag layout (causal).  Holder i
    against block owner j: i < j, only the late query half attends (to
    all of k); i > j, both halves attend the early K half; i == j, the
    early half's diagonal, late against early in full, the late half's
    diagonal."""
    n, my_idx = dist.get_world_size(group), dist.get_rank(group)
    C = q.shape[1] // 2
    scale = f32_rsqrt(q.shape[3])
    q_lo, q_hi = q[:, :C], q[:, C:]
    lo, hi = _zero_state(q, C), _zero_state(q, C)
    k_blk, v_blk = k, v

    def tile(acc, q_part, k_part, v_part, diag):
        mask = (_diag_mask(q_part.shape[1], k_part.shape[1], q.device)
                if diag else None)
        return _online_softmax_update(*acc, q_part, k_part, v_part, scale,
                                      mask)

    for s in range(n):
        j = (my_idx - s) % n
        k_lo, k_hi = k_blk[:, :C], k_blk[:, C:]
        v_lo, v_hi = v_blk[:, :C], v_blk[:, C:]
        branch = _zigzag_branch(j, my_idx)
        if branch == 0:
            lo = tile(lo, q_lo, k_lo, v_lo, True)
            hi = tile(hi, q_hi, k_lo, v_lo, False)
            hi = tile(hi, q_hi, k_hi, v_hi, True)
        elif branch == 1:
            hi = tile(hi, q_hi, k_blk, v_blk, False)
        else:
            lo = tile(lo, q_lo, k_lo, v_lo, False)
            hi = tile(hi, q_hi, k_lo, v_lo, False)
        k_blk, v_blk = _rotate_kv(k_blk, v_blk, s, n, group, True)
    out = torch.cat([_normalise(lo[0], lo[1], q.dtype),
                     _normalise(hi[0], hi[1], q.dtype)], dim=1)
    return out + collectives.tie(out, k_blk, v_blk)


# ---------------------------------------------------------------------------
# impl="flash": the same schedules over the flash kernels' block forms.
# ---------------------------------------------------------------------------


def _lse_merge(o_acc, lse_acc, o_s, lse_s):
    """Merge a normalised partial (o_s, lse_s) into the running (o_acc,
    lse_acc).  A -inf lse (no visible keys) has weight 0; rows -inf in
    both stay (0, -inf) without NaN."""
    m = torch.maximum(lse_acc, lse_s)
    safe_m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    zero = torch.zeros_like(m)
    a = torch.where(torch.isinf(lse_acc), zero, torch.exp(lse_acc - safe_m))
    b = torch.where(torch.isinf(lse_s), zero, torch.exp(lse_s - safe_m))
    tot = a + b
    denom = torch.where(tot == 0.0, torch.ones_like(tot), tot)
    o = (o_acc * (a / denom)[..., None]
         + o_s.to(torch.float32) * (b / denom)[..., None])
    lse = torch.where(tot == 0.0, torch.full_like(tot, _NEG_INF),
                      safe_m + torch.log(denom))
    return o, lse


def _check_heads(q, k):
    if k.shape[2] != q.shape[2]:
        raise ValueError(
            "impl='flash' ring attention requires equal Q/KV head counts; "
            "repeat_kv before the ring (the einsum impl rotates grouped "
            "heads natively)")


def _flash_state(q, rows: int):
    B, _, H, D = q.shape
    return (q.new_zeros((B, rows, H, D), dtype=torch.float32),
            q.new_full((B, rows, H), _NEG_INF, dtype=torch.float32))


def _ring_flash_fwd(q, k, v, group, causal: bool):
    n, my_idx = dist.get_world_size(group), dist.get_rank(group)
    o_acc, lse_acc = _flash_state(q, q.shape[1])
    k_blk, v_blk = k, v
    for s in range(n):
        branch = (_causal_branch((my_idx - s) % n, my_idx) if causal
                  else 2)
        if branch:
            o_s, lse_s = flash_block_forward(q, k_blk, v_blk,
                                             causal=branch == 1)
            o_acc, lse_acc = _lse_merge(o_acc, lse_acc, o_s, lse_s)
        k_blk, v_blk = _rotate_kv(k_blk, v_blk, s, n, group, False)
    return o_acc.to(q.dtype), lse_acc


def _delta(g, out):
    """sum_d dO * O per row, [B, T, H] f32 (global, like the lse)."""
    return (g.to(torch.float32) * out.to(torch.float32)).sum(dim=-1)


def _pass_grads(dk_blk, dv_blk, k_blk, v_blk, s: int, n: int, group):
    """dK/dV ride all n hops (block j's partial sums are home at rank j
    after the last); K/V skip the dead last one.  One batch of sends a
    step."""
    if s < n - 1:
        return collectives.ring_pass([dk_blk, dv_blk, k_blk, v_blk], group)
    return (*collectives.ring_pass([dk_blk, dv_blk], group), k_blk, v_blk)


class _RingFlash(torch.autograd.Function):
    """The contiguous flash ring, forward and backward."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal):
        out, lse = _ring_flash_fwd(q, k, v, group, causal)
        ctx.group, ctx.causal = group, causal
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        group, causal = ctx.group, ctx.causal
        n, my_idx = dist.get_world_size(group), dist.get_rank(group)
        delta = _delta(g, out)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk_blk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv_blk = torch.zeros_like(dk_blk)
        k_blk, v_blk = k, v
        for s in range(n):
            branch = (_causal_branch((my_idx - s) % n, my_idx) if causal
                      else 2)
            if branch:
                dq_c, dk_c, dv_c = flash_block_grads(
                    q, k_blk, v_blk, g, lse, delta, causal=branch == 1)
                dq += dq_c
                dk_blk += dk_c
                dv_blk += dv_c
            dk_blk, dv_blk, k_blk, v_blk = _pass_grads(
                dk_blk, dv_blk, k_blk, v_blk, s, n, group)
        return dq.to(q.dtype), dk_blk.to(k.dtype), dv_blk.to(v.dtype), \
            None, None


def _ring_flash_zz_fwd(q, k, v, group):
    n, my_idx = dist.get_world_size(group), dist.get_rank(group)
    C = q.shape[1] // 2
    q_lo, q_hi = q[:, :C], q[:, C:]
    lo, hi = _flash_state(q, C), _flash_state(q, C)
    k_blk, v_blk = k, v

    def tile(acc, q_part, k_part, v_part, diag):
        return _lse_merge(*acc, *flash_block_forward(q_part, k_part, v_part,
                                                     causal=diag))

    for s in range(n):
        k_lo, k_hi = k_blk[:, :C], k_blk[:, C:]
        v_lo, v_hi = v_blk[:, :C], v_blk[:, C:]
        branch = _zigzag_branch((my_idx - s) % n, my_idx)
        if branch == 0:
            lo = tile(lo, q_lo, k_lo, v_lo, True)
            hi = tile(hi, q_hi, k_lo, v_lo, False)
            hi = tile(hi, q_hi, k_hi, v_hi, True)
        elif branch == 1:
            hi = tile(hi, q_hi, k_blk, v_blk, False)
        else:
            # both halves against the same early K half, unmasked: one
            # launch over the whole query, split after
            o_s, lse_s = flash_block_forward(q, k_lo, v_lo, causal=False)
            lo = _lse_merge(*lo, o_s[:, :C], lse_s[:, :C])
            hi = _lse_merge(*hi, o_s[:, C:], lse_s[:, C:])
        k_blk, v_blk = _rotate_kv(k_blk, v_blk, s, n, group, False)
    out = torch.cat([lo[0], hi[0]], dim=1).to(q.dtype)
    return out, torch.cat([lo[1], hi[1]], dim=1)


class _RingFlashZigzag(torch.autograd.Function):
    """The zig-zag flash ring (causal), forward and backward.  Each
    branch's dK/dV terms are placed in the whole rotating block's f32
    buffers."""

    @staticmethod
    def forward(ctx, q, k, v, group):
        out, lse = _ring_flash_zz_fwd(q, k, v, group)
        ctx.group = group
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        group = ctx.group
        n, my_idx = dist.get_world_size(group), dist.get_rank(group)
        C = q.shape[1] // 2
        delta = _delta(g, out)
        half = lambda x: (x[:, :C], x[:, C:])  # noqa: E731
        q_lo, q_hi = half(q)
        g_lo, g_hi = half(g)
        lse_lo, lse_hi = half(lse)
        delta_lo, delta_hi = half(delta)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dq_lo, dq_hi = half(dq)
        dk_blk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv_blk = torch.zeros_like(dk_blk)
        k_blk, v_blk = k, v
        for s in range(n):
            k_lo, k_hi = half(k_blk)
            v_lo, v_hi = half(v_blk)
            dk_lo, dk_hi = half(dk_blk)
            dv_lo, dv_hi = half(dv_blk)
            branch = _zigzag_branch((my_idx - s) % n, my_idx)
            if branch == 0:
                for args, dq_part, dk_part, dv_part in (
                        ((q_lo, k_lo, v_lo, g_lo, lse_lo, delta_lo, True),
                         dq_lo, dk_lo, dv_lo),
                        ((q_hi, k_lo, v_lo, g_hi, lse_hi, delta_hi, False),
                         dq_hi, dk_lo, dv_lo),
                        ((q_hi, k_hi, v_hi, g_hi, lse_hi, delta_hi, True),
                         dq_hi, dk_hi, dv_hi)):
                    a, b, c = flash_block_grads(*args[:6], causal=args[6])
                    dq_part += a
                    dk_part += b
                    dv_part += c
            elif branch == 1:
                a, b, c = flash_block_grads(q_hi, k_blk, v_blk, g_hi,
                                            lse_hi, delta_hi, causal=False)
                dq_hi += a
                dk_blk += b
                dv_blk += c
            else:
                # one launch over the whole query against k_lo: dq comes
                # back whole and the two halves' dk_lo/dv_lo terms summed
                a, b, c = flash_block_grads(q, k_lo, v_lo, g, lse, delta,
                                            causal=False)
                dq += a
                dk_lo += b
                dv_lo += c
            dk_blk, dv_blk, k_blk, v_blk = _pass_grads(
                dk_blk, dv_blk, k_blk, v_blk, s, n, group)
        return dq.to(q.dtype), dk_blk.to(k.dtype), dv_blk.to(v.dtype), None


def _ring_attention_shard_flash(q, k, v, group, causal: bool):
    _check_heads(q, k)
    return _RingFlash.apply(q, k, v, group, causal)


def _ring_attention_shard_zigzag_flash(q, k, v, group):
    _check_heads(q, k)
    return _RingFlashZigzag.apply(q, k, v, group)


@dataclasses.dataclass(frozen=True)
class SequenceSharding:
    """[B, T, H, D] tensors with T split evenly over *group*'s ranks, in
    rank order (the JAX ``NamedSharding`` with ``spec``); on a *mesh* of
    several axes, batch and heads split as *spec* names them too."""

    group: object = None
    spec: tuple = (None, "seq", None, None)
    mesh: Optional[DeviceMesh] = None

    def scatter(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of the whole sequence *x* (a copy)."""
        if self.mesh is not None:
            from .parallel import Sharding

            return Sharding(self.mesh, self.spec).local(x)
        return collectives.seq_chunk(x, self.group, dim=1)

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The whole sequence, from every rank's block (on every rank)."""
        if self.mesh is not None:
            from .parallel import Sharding

            return Sharding(self.mesh, self.spec).gather(local)
        return collectives.all_gather(local, self.group, dim=1)


def _resolve_group(group, seq_axis: Optional[str]):
    """A process group, from a group, a ``DeviceMesh`` (its *seq_axis*;
    a 1-D mesh's only axis when None) or None (the default group); and
    the sequence axis's name."""
    if isinstance(group, DeviceMesh):
        names = group.mesh_dim_names
        if seq_axis is None:
            if group.ndim != 1:
                raise ValueError("ring attention over a mesh of several "
                                 "axes needs the name of its seq_axis")
            seq_axis = names[0] if names else "seq"
        return group.get_group(seq_axis if names else None), seq_axis
    return group, seq_axis or "seq"


def make_ring_attention(group=None, causal: bool = False,
                        layout: str = "contiguous",
                        spec: Optional[Sequence] = None,
                        impl: str = "einsum",
                        seq_axis: Optional[str] = None):
    """Ring attention over *group* (a process group, a ``DeviceMesh`` or
    None for the default group): returns ``(fn, sharding)``.  On a mesh
    of several axes the ring runs over *seq_axis* (the JAX package's
    argument), and *spec* may put batch and heads on its other axes, as
    the LM mesh's ``(batch_axes, "seq", head_axis, None)``: the other
    axes only shrink the local block.

    ``fn(q, k, v)`` takes this rank's blocks [B, T/n, H, D] (K/V may
    carry fewer, grouped heads under ``impl="einsum"``) and returns this
    rank's block of the output; it is differentiable.
    ``sharding.scatter`` gives a rank its block of a whole [B, T, H, D]
    sequence and ``sharding.gather`` puts blocks back together.

    ``layout="zigzag"`` (causal only) expects inputs permuted with
    :func:`zigzag_permute` over n shards and returns the output in the
    same order.  ``impl="flash"`` runs the flash kernels' block forms."""
    if layout not in ("contiguous", "zigzag"):
        raise ValueError(f"unknown layout {layout!r}")
    if layout == "zigzag" and not causal:
        raise ValueError("zigzag layout only pays off for causal attention")
    if impl not in ("einsum", "flash"):
        raise ValueError(f"unknown impl {impl!r}")
    mesh = group if isinstance(group, DeviceMesh) and group.ndim > 1 \
        else None
    group, axis = _resolve_group(group, seq_axis)
    spec = (None, axis, None, None) if spec is None else tuple(spec)
    if len(spec) != 4 or spec[1] != axis or spec[3] is not None:
        raise ValueError(f"spec {spec} must split T on the sequence axis "
                         f"{axis!r} and leave the head dim whole")
    if mesh is None and any(a is not None for i, a in enumerate(spec)
                            if i != 1):
        raise ValueError(f"spec {spec} puts batch or heads on mesh axes: "
                         "pass the mesh")
    if layout == "zigzag" and impl == "flash":
        def fn(q, k, v):
            return _ring_attention_shard_zigzag_flash(q, k, v, group)
    elif layout == "zigzag":
        def fn(q, k, v):
            return _ring_attention_shard_zigzag(q, k, v, group)
    elif impl == "flash":
        def fn(q, k, v):
            return _ring_attention_shard_flash(q, k, v, group, causal)
    else:
        def fn(q, k, v):
            return _ring_attention_shard(q, k, v, group, causal)
    return fn, SequenceSharding(group, spec, mesh)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = False) -> torch.Tensor:
    """Single-device attention in f32 (the correctness oracle)."""
    T, S = q.shape[1], k.shape[1]
    f32 = torch.float32
    scores = torch.einsum("bqhd,bkhd->bqhk", q.to(f32), k.to(f32)) \
        * f32_rsqrt(q.shape[-1])
    if causal:
        keep = torch.ones(T, S, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~keep[None, :, None, :], _NEG_INF)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bqhk,bkhd->bqhd", w, v.to(f32)).to(q.dtype)
