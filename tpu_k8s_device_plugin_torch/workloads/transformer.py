"""The LM's transformer: the training model (``TransformerLM``, ``Block``,
``lm_loss``, ``lm_train_step``, ``synthetic_lm_batch``) and the building
blocks it shares with the serving model in ``inference.py``: rotary
embeddings, the oracle causal attention, the fused-qkv split, the
grouped-query helpers and the parameter layers.

Same math, the same [B, T, H, D] layout and the same parameter names as
the JAX package's ``workloads/transformer.py``; the port's tests hold
each function against it, and ``convert.params_from_jax`` loads the JAX
training tree (which its decoder shares) key for key.

The training model keeps flax's defaults: every parameter is f32 and
trains, and is cast to the compute dtype at each use (flax's ``dtype``
with its f32 ``param_dtype``); the logits come back in f32.  The serving
model builds the same layers with its parameters stored in the compute
dtype and gradients off.

Sharded training (the JAX package's ``data x expert x seq x model``
mesh): ``make_lm_mesh``, ``lm_tree_shardings`` and ``make_lm_train_step``
run one process a rank on a ``torch.distributed`` group that the caller
has initialised, each rank holding its pieces of the parameters as
plain ``Parameter``s (``parallel.Sharding``): the projections
Megatron-style on ``model``, the expert stacks on ``expert``
(``moe.ExpertParallelMoEFFN``), the sequence on ``seq`` through ring
attention, the batch on ``(data, expert)``.

Every entry point runs on CUDA unless the caller passes ``device="cpu"``;
without CUDA and without that argument it raises.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

COMPUTE_DTYPE = torch.bfloat16

# attention callable: (q, k, v, positions) -> out, all [B, T, H, D] (+ [B, T])
AttnFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor],
                  torch.Tensor]


def resolve_device(device=None) -> torch.device:
    """*device* as a ``torch.device``; ``None`` means CUDA, and raises
    when there is none (the port never falls back to the CPU by
    itself)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run on "
                "the CPU")
        return torch.device("cuda")
    return torch.device(device)


# elements per random-fill chunk: bounds the f32 scratch of the fill to
# about 256 MB whatever the leaf
_FILL_ELEMS = 1 << 26
# flax's truncated normal cuts at two standard deviations and rescales
# so that the truncated distribution has the asked-for deviation
_TRUNC_STD = 0.87962566103423978


def _fill_(w: torch.Tensor, gen: torch.Generator, std: float,
           truncated: bool) -> None:
    """Fill *w* in place with N(0, std^2), truncated at +-2 sd (and
    rescaled like ``jax.nn.initializers.truncated_normal``) when
    *truncated*; drawn in f32 chunks of rows and cast into *w*.

    The truncated draw maps uniforms through the normal quantile
    ``torch.special.ndtri``.  Not through ``torch.erfinv``: on the CPU the
    first ``erfinv`` of a process has given one intra-op thread's share
    of its elements other values than every later call, so two fills
    from one seed differed."""
    rows = max(1, _FILL_ELEMS // max(1, w[0].numel()))
    # the normal CDF at -2 and +2
    lo = 0.5 * math.erfc(math.sqrt(2))
    hi = 1.0 - lo
    for r0 in range(0, w.shape[0], rows):
        part = w[r0:r0 + rows]
        if truncated:
            u = torch.rand(part.shape, generator=gen, device=w.device,
                           dtype=torch.float32)
            x = torch.special.ndtri(u * (hi - lo) + lo)
            x = x.clamp_(-2.0, 2.0) * (std / _TRUNC_STD)
        else:
            x = torch.randn(part.shape, generator=gen, device=w.device,
                            dtype=torch.float32) * std
        part.copy_(x)


def f32_rsqrt(n: int) -> float:
    """``1 / sqrt(n)`` rounded as f32 arithmetic rounds it (the JAX
    package's ``1.0 / jnp.sqrt(jnp.array(n, f32))``), as a Python float:
    a scalar, so scaling a device tensor by it needs no host-to-device
    copy."""
    return float(np.float32(1.0) / np.sqrt(np.float32(n)))


def apply_rope(
    x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0
) -> torch.Tensor:
    """Rotary position embedding on [B, T, H, D] with explicit positions
    [B, T]; the two halves of D rotate together (split, not
    interleaved).  Computed in f32 and cast back to ``x.dtype``."""
    d_half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (
        torch.arange(d_half, dtype=torch.float32, device=x.device) / d_half))
    angles = positions[..., None].to(torch.float32) * freqs  # [B, T, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def local_causal_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    positions: torch.Tensor,
) -> torch.Tensor:
    """Whole-sequence causal attention in f32 (the oracle path).  The
    mask comes from *positions*, not the storage order; grouped K/V are
    expanded to the query head count here."""
    k = repeat_kv(k, q.shape[2])
    v = repeat_kv(v, q.shape[2])
    scores = torch.einsum(
        "bqhd,bkhd->bqhk", q.to(torch.float32), k.to(torch.float32)
    ) * f32_rsqrt(q.shape[-1])
    mask = positions[:, :, None] >= positions[:, None, :]  # [B, Tq, Tk]
    scores = scores.masked_fill(~mask[:, :, None, :], float("-inf"))
    w = torch.softmax(scores, dim=-1)
    return torch.einsum(
        "bqhk,bkhd->bqhd", w, v.to(torch.float32)
    ).to(q.dtype)


def split_qkv_heads(qkv: torch.Tensor, n_heads: int, n_kv_heads: int,
                    head_dim: int):
    """Split a fused projection [B, T, (H + 2*Hkv)*Dh], laid out
    ``q | k | v``, into q [B, T, H, Dh] and k/v [B, T, Hkv, Dh] (views
    of *qkv*)."""
    B, T, _ = qkv.shape
    q_dim = n_heads * head_dim
    kv_dim = n_kv_heads * head_dim
    q = qkv[..., :q_dim].view(B, T, n_heads, head_dim)
    k = qkv[..., q_dim:q_dim + kv_dim].view(B, T, n_kv_heads, head_dim)
    v = qkv[..., q_dim + kv_dim:].view(B, T, n_kv_heads, head_dim)
    return q, k, v


def _validate_attn_ffn(n_heads: int, n_kv: int, ffn: str) -> None:
    """Reject a misspelled ffn or a KV head count that does not divide
    the query head count, before they become shape errors."""
    if ffn not in ("gelu", "swiglu"):
        raise ValueError(f"unknown ffn {ffn!r}: expected 'gelu' or 'swiglu'")
    if n_kv > n_heads or n_heads % n_kv:
        raise ValueError(
            f"n_kv_heads={n_kv} must divide n_heads={n_heads}"
        )


def repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Broadcast grouped K/V heads [B, T, Hkv, Dh] to the query head
    count (each KV head serves H/Hkv consecutive query heads)."""
    n_kv = k.shape[2]
    if n_kv == n_heads:
        return k
    return torch.repeat_interleave(k, n_heads // n_kv, dim=2)


# ---------------------------------------------------------------------------
# parameter layers
# ---------------------------------------------------------------------------


class RMSNorm(nn.Module):
    """flax ``nn.RMSNorm``: statistics in f32, eps 1e-6, the f32 scale
    multiplies the reciprocal rms before it meets ``x``, one cast to
    the module dtype at the end."""

    def __init__(self, dim: int, dtype: torch.dtype, device,
                 eps: float = 1e-6):
        super().__init__()
        self.dtype, self.eps = dtype, eps
        self.scale = nn.Parameter(
            torch.ones(dim, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        mul = torch.rsqrt(xf.square().mean(-1, keepdim=True) + self.eps)
        return (xf * (mul * self.scale)).to(self.dtype)


class Dense(nn.Module):
    """Bias-free projection with its weight stored ``[out, in]`` in
    *param_dtype* (the module dtype unless given); input and weight are
    cast to the module dtype at use, which is what a flax Dense with
    ``dtype`` does to both operands.  The weight is left uninitialised:
    load it, or fill it."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype, device,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(
            d_out, d_in, dtype=param_dtype or dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype))


class Embed(nn.Module):
    """Token embedding ``[vocab, d_model]`` stored in *param_dtype* (the
    module dtype unless given); the rows come out in the module dtype
    (uninitialised until loaded or filled)."""

    def __init__(self, vocab: int, dim: int, dtype: torch.dtype, device,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(
            vocab, dim, dtype=param_dtype or dtype, device=device))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return F.embedding(tokens, self.weight).to(self.dtype)


# ---------------------------------------------------------------------------
# the training model
# ---------------------------------------------------------------------------


class Block(nn.Module):
    """Pre-norm transformer block: RMSNorm -> attention -> residual,
    RMSNorm -> FFN -> residual.  Multi-head or grouped-query attention
    (``n_kv_heads < n_heads``: K/V reach ``attn_fn`` grouped); the FFN is
    the dense GELU MLP (tanh approximation, as flax's ``nn.gelu``),
    SwiGLU (``mlp_down(silu(mlp_gate(h)) * mlp_up(h))``) or, with
    ``n_experts > 0``, a routed expert FFN (``moe``, see ``moe.MoEFFN``)
    whose capacity slots go by position.  Parameters are *param_dtype*
    (f32, flax's default) and train.  *dense* builds each projection
    from ``(d_in, d_out)`` (the serving model's quantized layers)."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int,
                 dtype: torch.dtype = COMPUTE_DTYPE,
                 attn_fn: AttnFn = local_causal_attention,
                 n_kv_heads: Optional[int] = None, ffn: str = "gelu",
                 rope_theta: float = 10000.0, n_experts: int = 0,
                 device=None, param_dtype: torch.dtype = torch.float32,
                 moe_k: int = 2, moe_capacity_factor: float = 1.25,
                 dense: Optional[Callable[[int, int], nn.Module]] = None,
                 moe_quantized: bool = False, keep_aux: bool = True):
        super().__init__()
        device = resolve_device(device)
        self.n_heads = n_heads
        self.n_kv = n_kv_heads or n_heads
        _validate_attn_ffn(n_heads, self.n_kv, ffn)
        self.d_model, self.head_dim = d_model, d_model // n_heads
        self.attn_fn, self.ffn, self.rope_theta = attn_fn, ffn, rope_theta
        self.n_experts = n_experts
        if dense is None:
            def dense(d_in, d_out):
                return Dense(d_in, d_out, dtype, device, param_dtype)
        self.attn_norm = RMSNorm(d_model, dtype, device)
        self.qkv = dense(d_model, (n_heads + 2 * self.n_kv) * self.head_dim)
        self.out_proj = dense(d_model, d_model)
        self.mlp_norm = RMSNorm(d_model, dtype, device)
        if n_experts > 0:
            from .moe import MoEFFN

            self.moe = MoEFFN(
                n_experts, d_model, d_ff, k=moe_k,
                capacity_factor=moe_capacity_factor, dtype=dtype,
                quantized=moe_quantized, device=device,
                param_dtype=param_dtype, keep_aux=keep_aux)
            return
        if ffn == "swiglu":
            self.mlp_gate = dense(d_model, d_ff)
        self.mlp_up = dense(d_model, d_ff)
        self.mlp_down = dense(d_ff, d_model)

    def proj(self, name: str, x: torch.Tensor,
             adapter_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The projection *name* of *x* (the serving block adds its
        per-request adapter delta here)."""
        return getattr(self, name)(x)

    def attention_inputs(self, x: torch.Tensor, positions: torch.Tensor,
                         adapter_ids: Optional[torch.Tensor] = None):
        """q [B, T, H, Dh] and k [B, T, Hkv, Dh] with RoPE applied, and v
        (a view of the fused projection)."""
        q, k, v = split_qkv_heads(
            self.proj("qkv", self.attn_norm(x), adapter_ids), self.n_heads,
            self.n_kv, self.head_dim)
        return (apply_rope(q, positions, self.rope_theta),
                apply_rope(k, positions, self.rope_theta), v)

    def finish(self, x: torch.Tensor, att: torch.Tensor,
               positions: Optional[torch.Tensor] = None,
               adapter_ids: Optional[torch.Tensor] = None,
               capacity: Optional[int] = None) -> torch.Tensor:
        """The attention residual, then the FFN and its residual; an
        expert FFN takes *positions* as its slot priority and *capacity*
        in place of its own."""
        B, T, _ = x.shape
        # the heads' width: d_model, or this rank's share of it when the
        # heads are split over a mesh's model axis
        x = x + self.proj("out_proj", att.reshape(B, T, -1), adapter_ids)
        h = self.mlp_norm(x)
        if self.n_experts > 0:
            return x + self.moe(h, positions, capacity)
        if self.ffn == "swiglu":
            return x + self.proj(
                "mlp_down", F.silu(self.proj("mlp_gate", h, adapter_ids))
                * self.proj("mlp_up", h, adapter_ids), adapter_ids)
        return x + self.proj(
            "mlp_down", F.gelu(self.proj("mlp_up", h, adapter_ids),
                               approximate="tanh"), adapter_ids)

    def forward(self, x: torch.Tensor, positions: torch.Tensor
                ) -> torch.Tensor:
        q, k, v = self.attention_inputs(x, positions)
        return self.finish(x, self.attn_fn(q, k, v, positions), positions)


class TransformerLM(nn.Module):
    """Next-token LM: embedding, blocks named ``block_i``, final RMSNorm,
    ``lm_head``; f32 logits.  ``attn_fn`` swaps the einsum attention for
    the flash kernels (``flash_attention.flash_causal_attention``)
    without touching any other part of the model; ``n_experts > 0``
    swaps every block's MLP for a routed expert FFN (``moe_k`` experts a
    token, ``moe_capacity_factor``).  Parameters are f32 and left
    uninitialised: load a converted tree, or fill them
    (``bench_serving.random_init_``)."""

    def __init__(self, vocab: int, d_model: int = 256, n_heads: int = 4,
                 n_layers: int = 2, d_ff: int = 1024,
                 dtype: torch.dtype = COMPUTE_DTYPE,
                 attn_fn: AttnFn = local_causal_attention,
                 n_kv_heads: Optional[int] = None, ffn: str = "gelu",
                 rope_theta: float = 10000.0, n_experts: int = 0,
                 device=None, moe_k: int = 2,
                 moe_capacity_factor: float = 1.25):
        super().__init__()
        device = resolve_device(device)
        self.vocab, self.n_layers, self.dtype = vocab, n_layers, dtype
        self.n_experts = n_experts
        f32 = torch.float32
        self.embed = Embed(vocab, d_model, dtype, device, f32)
        for i in range(n_layers):
            self.add_module(f"block_{i}", Block(
                d_model, n_heads, d_ff, dtype=dtype, attn_fn=attn_fn,
                n_kv_heads=n_kv_heads, ffn=ffn, rope_theta=rope_theta,
                n_experts=n_experts, device=device, moe_k=moe_k,
                moe_capacity_factor=moe_capacity_factor))
        self.final_norm = RMSNorm(d_model, dtype, device)
        self.lm_head = Dense(d_model, vocab, dtype, device, f32)

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, T = tokens.shape
        if positions is None:
            positions = torch.arange(
                T, dtype=torch.int32, device=tokens.device).expand(B, T)
        x = self.embed(tokens)
        for i in range(self.n_layers):
            x = getattr(self, f"block_{i}")(x, positions)
        return self.lm_head(self.final_norm(x)).to(torch.float32)

    def aux_loss(self) -> torch.Tensor:
        """The sum of every expert layer's last auxiliary term (already
        scaled by its weight): what flax's ``losses`` collection holds
        after a forward.  0 without experts."""
        terms = [getattr(self, f"block_{i}").moe.aux
                 for i in range(self.n_layers) if self.n_experts > 0]
        return sum(terms) if terms else torch.zeros(())


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def lm_loss(model: TransformerLM, tokens: torch.Tensor,
            labels: torch.Tensor,
            positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross entropy of the f32 logits over the labels
    >= 0 (a negative label, such as the -1 in the last slot, is
    ignored); 0 when every label is ignored, as in the JAX package.
    The expert layers' load-balancing terms are added on top."""
    logits = model(tokens, positions)
    labels = labels.long().masked_fill(labels < 0, -1)
    total = F.cross_entropy(logits.flatten(0, 1), labels.flatten(),
                            ignore_index=-1, reduction="sum")
    ce = total / (labels >= 0).sum().clamp(min=1)
    if model.n_experts > 0:
        return ce + model.aux_loss()
    return ce


def lm_train_step(model: TransformerLM, opt: torch.optim.Optimizer,
                  tokens: torch.Tensor, labels: torch.Tensor,
                  positions: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """One optimizer step in place: zero the gradients, backward through
    :func:`lm_loss`, step.  Returns the loss (not synchronised).  The
    JAX package's optax ``adam(lr)`` is ``torch.optim.Adam(params, lr,
    betas=(0.9, 0.999), eps=1e-8)``: both add eps to the square root of
    the bias-corrected second moment."""
    opt.zero_grad(set_to_none=True)
    loss = lm_loss(model, tokens, labels, positions)
    loss.backward()
    opt.step()
    return loss.detach()


def synthetic_lm_batch(gen: torch.Generator, batch: int, seq_len: int,
                       vocab: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(tokens, labels, positions) on *gen*'s device, in natural order:
    uniform int64 tokens, labels the tokens shifted left with -1 in the
    ignored last slot, int32 positions 0..T-1."""
    tokens = torch.randint(0, vocab, (batch, seq_len), generator=gen,
                           device=gen.device)
    labels = torch.cat(
        [tokens[:, 1:], torch.full((batch, 1), -1, dtype=tokens.dtype,
                                   device=tokens.device)], dim=1)
    positions = torch.arange(seq_len, dtype=torch.int32,
                             device=tokens.device).expand(batch, seq_len)
    return tokens, labels, positions


# ---------------------------------------------------------------------------
# sharded training over a data x expert x seq x model mesh
# ---------------------------------------------------------------------------

LM_AXES = ("data", "expert", "seq", "model")

# the projections whose output dim the model axis splits (column
# parallel), and those whose input dim it splits (row parallel)
_COLUMN = ("qkv", "mlp_up", "mlp_gate", "lm_head")
_ROW = ("out_proj", "mlp_down")


def make_lm_mesh(ranks=None, seq: int = 2, model: int = 2, expert: int = 1,
                 device=None):
    """``data x expert x seq x model`` mesh (a ``DeviceMesh``) over *ranks*
    (default: every rank of the default group, which the caller has
    initialised): data parallelism outermost, expert next (tokens are
    split over ``(data, expert)`` jointly), sequence and tensor
    parallelism innermost.  Raises ``ValueError`` when the rank count
    does not divide; the mesh's device type is CUDA unless *device* says
    otherwise."""
    from torch.distributed.device_mesh import DeviceMesh

    if ranks is None:
        if not torch.distributed.is_initialized():
            raise RuntimeError(
                "make_lm_mesh needs an initialised torch.distributed group")
        ranks = range(torch.distributed.get_world_size())
    ranks = list(ranks)
    n, inner = len(ranks), expert * seq * model
    if n % inner:
        raise ValueError(f"{n} ranks not divisible by "
                         f"expert*seq*model={inner}")
    device = resolve_device(device)
    grid = torch.tensor(ranks).reshape(n // inner, expert, seq, model)
    return DeviceMesh(device.type, grid, mesh_dim_names=LM_AXES)


def _lm_pspec(name: str, leaf, axes=LM_AXES) -> tuple:
    """Megatron-style tensor parallelism on ``model`` by a leaf's
    state-dict name, in the port's layouts: qkv, mlp_gate/up and lm_head
    column-split (a ``weight [out, in]`` on dim 0), out_proj and mlp_down
    row-split (on dim 1), embeddings and norms replicated; the expert
    stacks ``[E, D, F]`` / ``[E, F, D]`` split on ``expert`` over E and
    on ``model`` over F, their int8 scales by the out channel they scale.
    The quantized leaves keep the JAX package's ``[in, out]`` layout and
    so its spec: ``kernel_int8`` / ``kernel_int4`` and the int4 group
    scales split the out dim of a column layer and the in dim of a row
    one, a 1-D ``scale`` follows a column layer's out dim.  A split on an
    axis the mesh lacks is replication (a legacy 3-axis mesh keeps
    working with experts)."""
    ex = "expert" if "expert" in axes else None
    mdl = "model" if "model" in axes else None
    dim = leaf.dim()
    if dim == 3 and "experts" in name:
        return (ex, None, mdl) if "experts_up" in name else (ex, mdl, None)
    if dim == 2 and "experts" in name:
        return (ex, mdl) if "experts_up" in name else (ex, None)
    column = any(k in name for k in _COLUMN)
    row = any(k in name for k in _ROW)
    if dim == 2 and (column or row):
        # the JAX [in, out] layout's spec; a torch weight is [out, in]
        spec = (None, mdl) if column else (mdl, None)
        return spec[::-1] if name.endswith("weight") else spec
    if dim == 1 and name.endswith("scale") and column:
        return (mdl,)
    return ()


def lm_tree_shardings(mesh, tree, param_names=()):
    """A tree of ``parallel.Sharding`` mirroring *tree* (a state dict of
    whole tensors, or an optimizer's state dict with *param_names*) under
    :func:`_lm_pspec`, each split that the whole dim does not allow
    degraded to replication (``parallel.fit_spec``)."""
    from . import parallel

    axes = tuple(mesh.mesh_dim_names)
    return parallel.tree_shardings(
        mesh, tree, param_names,
        rule=lambda name, leaf: parallel.fit_spec(
            mesh, _lm_pspec(name, leaf, axes), leaf.shape))


class _ModelParallelDense(nn.Module):
    """This rank's piece of a :class:`Dense` on the mesh's ``model`` axis
    (its ``weight`` is the piece, f32, cast at use as ``Dense`` casts),
    run in one of four modes:

    - ``"column"``: the weight split on its out dim; the input enters
      through ``copy_to_group`` and the output stays split (the next
      layer is row-parallel);
    - ``"gather"``: the same, with the output gathered (everything after
      it is replicated);
    - ``"regroup"``: the fused qkv, whose stored piece is a contiguous
      run of its out dim and so not whole heads: the piece's rows are
      taken in the order of the ranks whose heads they hold (a fixed
      permutation of the local weight) and one all-to-all sends each
      rank its heads' columns, so each rank ends with ``q | k | v`` of
      its own query and KV heads (*regroup*: the rows to send, and the
      columns to receive from each rank);
    - ``"row"``: the weight split on its in dim; the input is this
      rank's part and the partial outputs are summed over the group.
    """

    def __init__(self, dense: Dense, sharding, group, mode: str,
                 regroup=None):
        super().__init__()
        self.dtype, self.group, self.mode = dense.dtype, group, mode
        self.weight = nn.Parameter(sharding.local(dense.weight.detach()))
        if regroup is not None:
            order, self.send, self.recv = regroup
            self.register_buffer("order", order.to(self.weight.device),
                                 persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from . import collectives

        w = self.weight
        if self.mode == "row":
            y = F.linear(x.to(self.dtype), w.to(self.dtype))
            return collectives.reduce_from_group(y, self.group)
        x = collectives.copy_to_group(x, self.group)
        if self.mode == "regroup":
            w = w.index_select(0, self.order)
        y = F.linear(x.to(self.dtype), w.to(self.dtype))
        if self.mode == "gather":
            return collectives.gather_from_group(y, self.group, dim=-1)
        if self.mode == "regroup":
            return collectives.all_to_all(y, self.group, -1, -1, self.send,
                                          self.recv)
        return y


class _GatheredDense(nn.Module):
    """A :class:`Dense` whose stored weight is split on the model axis
    where its neighbours cannot use the split: the weight is gathered at
    each use and the layer runs whole (replicated)."""

    def __init__(self, dense: Dense, sharding, group):
        super().__init__()
        self.dtype, self.group = dense.dtype, group
        self.dim = next(i for i, a in enumerate(sharding.spec) if a)
        self.weight = nn.Parameter(sharding.local(dense.weight.detach()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from . import collectives

        w = collectives.gather_from_group(self.weight, self.group, self.dim)
        return F.linear(x.to(self.dtype), w.to(self.dtype))


def _qkv_regroup(n_heads: int, n_kv: int, head_dim: int, m: int, r: int):
    """For rank *r* of *m* on the model axis: the order of its stored qkv
    rows (a contiguous 1/m of ``q | k | v``) by destination rank, the
    rows it sends each rank, and the rows it receives from each.  Rank j
    computes query heads ``[j H/m, (j+1) H/m)`` and KV heads ``[j Hkv/m,
    (j+1) Hkv/m)``."""
    hq, hk = n_heads // m, n_kv // m

    def owner(head: int) -> int:
        if head < n_heads:
            return head // hq
        return (head - n_heads) % n_kv // hk

    per = (n_heads + 2 * n_kv) // m     # heads a rank stores
    owners = [owner(h) for h in range(n_heads + 2 * n_kv)]
    mine = owners[r * per:(r + 1) * per]
    order = sorted(range(per), key=lambda i: mine[i])  # stable: ascending
    rows = torch.tensor([(i * head_dim + d) for i in order
                         for d in range(head_dim)])
    send = [mine.count(j) * head_dim for j in range(m)]
    recv = [owners[i * per:(i + 1) * per].count(r) * head_dim
            for i in range(m)]
    return rows, send, recv


def _shard_lm_(model: TransformerLM, mesh, shardings, attn_fn: AttnFn,
               seq_axis: Optional[str]) -> None:
    """Replace *model*'s layers, in place, with this rank's pieces under
    *shardings* (the names stay): the projections model-parallel as
    :class:`_ModelParallelDense` where the split pairs up (qkv with
    out_proj when the query and KV heads divide the model axis, the MLP's
    column layers with mlp_down, lm_head gathered), gathered at use
    (:class:`_GatheredDense`) where it does not; the expert FFNs
    expert-parallel (``moe.ExpertParallelMoEFFN``); every block's
    attention *attn_fn*."""
    from . import parallel

    sizes = parallel.mesh_shape(mesh)
    m = sizes.get("model", 1)
    group = mesh.get_group("model") if m > 1 else None
    r = mesh.get_local_rank("model") if m > 1 else 0

    def split(name):
        return m > 1 and "model" in shardings[name + ".weight"].spec

    def piece(name, layer, mode=None, regroup=None):
        sh = shardings[name + ".weight"]
        if mode is None:
            return _GatheredDense(layer, sh, group)
        return _ModelParallelDense(layer, sh, group, mode, regroup)

    for i in range(model.n_layers):
        pre = f"block_{i}"
        blk = getattr(model, pre)
        blk.attn_fn = attn_fn
        heads = (m > 1 and blk.n_heads % m == 0 and blk.n_kv % m == 0)
        if heads:
            blk.qkv = piece(pre + ".qkv", blk.qkv, "regroup", _qkv_regroup(
                blk.n_heads, blk.n_kv, blk.head_dim, m, r))
            blk.n_heads, blk.n_kv = blk.n_heads // m, blk.n_kv // m
            blk.out_proj = piece(pre + ".out_proj", blk.out_proj, "row")
        else:
            if split(pre + ".qkv"):
                blk.qkv = piece(pre + ".qkv", blk.qkv, "gather")
            if split(pre + ".out_proj"):
                blk.out_proj = piece(pre + ".out_proj", blk.out_proj)
        if blk.n_experts > 0:
            from .moe import ExpertParallelMoEFFN

            blk.moe = ExpertParallelMoEFFN(
                blk.moe, mesh, {k: shardings[f"{pre}.moe.{k}"] for k in
                                ("router", "experts_up", "experts_down")},
                seq_axis)
        elif split(pre + ".mlp_down"):
            for name in ("mlp_gate", "mlp_up"):
                if hasattr(blk, name):
                    setattr(blk, name, piece(f"{pre}.{name}",
                                             getattr(blk, name), "column"))
            blk.mlp_down = piece(pre + ".mlp_down", blk.mlp_down, "row")
    if split("lm_head"):
        model.lm_head = piece("lm_head", model.lm_head, "gather")


def _sum_over(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """*x* summed over the mesh *axes* (one all-reduce an axis)."""
    from . import collectives

    for a in axes:
        x = collectives.all_reduce(x, mesh.get_group(a))
    return x


def make_lm_train_step(
    mesh,
    vocab: int = 512,
    d_model: int = 256,
    n_heads: int = 4,
    n_layers: int = 2,
    d_ff: int = 1024,
    seq_axis: Optional[str] = "seq",
    attn_layout: str = "zigzag",
    learning_rate: float = 1e-2,
    rng=None,
    batch: int = 4,
    seq_len: int = 64,
    n_experts: int = 0,
    moe_k: int = 2,
    moe_capacity_factor: float = 1.25,
    n_kv_heads: Optional[int] = None,
    ffn: str = "gelu",
    rope_theta: float = 10000.0,
):
    """A sharded LM train step over *mesh* (``make_lm_mesh``, or any
    ``DeviceMesh`` with some of its axes), on this rank's device (the
    mesh's type: the current CUDA device, or the CPU): returns ``(step,
    state, place)``.

    The model is initialised whole from *rng* (an int seed, 0 by
    default; ``bench_serving.random_init_``'s scales), the same on every
    rank, and each rank keeps its pieces (``lm_tree_shardings``).  With
    *seq_axis*, attention is causal ring attention over that axis
    (*attn_layout* "contiguous" or "zigzag"; the heads split on ``model``
    when the query and KV head counts both divide it); without it, the
    local einsum attention.  Tokens are split over ``(data, expert)``
    jointly and over *seq_axis*; ``n_experts > 0`` makes the MLPs routed
    expert FFNs on the ``expert`` axis.

    ``place(tokens, labels, positions)`` takes the whole natural-order
    batch, applies the zig-zag permutation when it is selected and gives
    this rank's block.  ``step(tokens, labels, positions)`` takes those
    blocks, runs the forward and backward (the cross entropy summed over
    this rank's labels over the global count of valid ones), sums each
    gradient over the token axes that its leaf is not split on, steps
    ``torch.optim.Adam(learning_rate)`` (optax's ``adam``) on this
    rank's pieces in place, and returns the global loss.  ``state`` holds
    ``model`` (this rank's pieces, under the whole model's names),
    ``opt``, ``batch`` (the whole natural-order batch), ``mesh`` and
    ``shardings`` (one ``parallel.Sharding`` a parameter)."""
    from . import parallel
    from .bench_serving import random_init_
    from .ring_attention import make_ring_attention, zigzag_permute

    sizes = parallel.mesh_shape(mesh)
    device = parallel.mesh_device(mesh)
    seed = 0 if rng is None else int(rng)
    n_seq = sizes[seq_axis] if seq_axis else 1
    batch_axes = tuple(a for a in ("data", "expert") if a in sizes)
    token_axes = batch_axes + ((seq_axis,) if seq_axis else ())

    if seq_axis:
        m = sizes.get("model", 1)
        n_kv = n_kv_heads or n_heads
        head_axis = "model" if n_heads % m == 0 and n_kv % m == 0 else None
        ring_fn, _ = make_ring_attention(
            mesh, causal=True, layout=attn_layout, seq_axis=seq_axis,
            spec=(batch_axes or None, seq_axis, head_axis, None))

        def attn(q, k, v, positions):
            del positions  # causality comes from the ring layout
            return ring_fn(q, k, v)
    else:
        attn = local_causal_attention

    model = TransformerLM(
        vocab=vocab, d_model=d_model, n_heads=n_heads, n_layers=n_layers,
        d_ff=d_ff, n_kv_heads=n_kv_heads, ffn=ffn, rope_theta=rope_theta,
        n_experts=n_experts, moe_k=moe_k,
        moe_capacity_factor=moe_capacity_factor, device=device)
    random_init_(model, seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    whole = synthetic_lm_batch(gen, batch, seq_len, vocab)
    shardings = lm_tree_shardings(mesh, model.state_dict())
    _shard_lm_(model, mesh, shardings, attn, seq_axis)
    # one leaf at a time (not torch's multi-tensor form): the step's
    # scratch is then one leaf's size, not a copy of every piece, which
    # matters where ranks share a card
    opt = torch.optim.Adam(model.parameters(), lr=learning_rate,
                           foreach=False)

    # the token axes each gradient is summed over: those of size > 1 that
    # its leaf is not split on
    reduce_over = []
    for name, p in model.named_parameters():
        split = {a for entry in shardings[name].spec if entry
                 for a in (entry if isinstance(entry, tuple) else (entry,))}
        axes = tuple(a for a in token_axes
                     if sizes[a] > 1 and a not in split)
        if axes:
            reduce_over.append((p, axes))

    def step(tokens, labels, positions):
        opt.zero_grad(set_to_none=True)
        labels = labels.long().masked_fill(labels < 0, -1)
        total = F.cross_entropy(model(tokens, positions).flatten(0, 1),
                                labels.flatten(), ignore_index=-1,
                                reduction="sum")
        count = _sum_over((labels >= 0).sum(), mesh, token_axes)
        ce = total / count.clamp(min=1)
        aux = model.aux_loss().to(ce.device)
        (ce + aux).backward()
        # leaf by leaf: the scratch is one leaf's, not a flat copy of them
        for p, axes in reduce_over:
            if p.grad is not None:
                p.grad.copy_(_sum_over(p.grad, mesh, axes))
        opt.step()
        return _sum_over(ce.detach(), mesh, token_axes) + aux.detach()

    tok_sh = parallel.Sharding(mesh, (batch_axes or None, seq_axis))

    def place(tokens, labels, positions):
        out = []
        for x in (tokens, labels, positions):
            if seq_axis and attn_layout == "zigzag":
                x = zigzag_permute(x, n_seq, axis=1)
            out.append(tok_sh.local(x.to(device)))
        return tuple(out)

    state = {"model": model, "opt": opt, "batch": whole, "mesh": mesh,
             "shardings": shardings}
    return step, state, place
