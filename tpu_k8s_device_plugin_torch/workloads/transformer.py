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


def _unported(**features) -> None:
    """Raise for a feature of the JAX models that the port does not have
    yet, naming where ROADMAP.md puts it."""
    later = {
        "quantized": "int8/int4 weights arrive with the quantization "
                     "slice (ROADMAP.md, queue 1, item 1b)",
        # the serving CLI's options (workloads/server.py)
        "int4": "int4 weights arrive with the quantization slice "
                "(ROADMAP.md, queue 1, item 1b)",
        "draft_config": "speculative decoding arrives with its slice "
                        "(ROADMAP.md, queue 1, item 1b)",
        "spec_ngram": "speculative decoding arrives with its slice "
                      "(ROADMAP.md, queue 1, item 1b)",
        "tp": "tensor-parallel serving arrives with multi-device "
              "(ROADMAP.md, queue 1, item 6)",
        "checkpoint": "restoring weights arrives with checkpointing "
                      "(ROADMAP.md, queue 1, item 7)",
        "n_experts": "MoE FFNs (moe.py) were left out of the LM-training "
                     "slice; they come after the fleet tier (ROADMAP.md, "
                     "queue 1, item 3)",
        "n_adapters": "LoRA adapters arrive with the quantization and "
                      "adapter slice (ROADMAP.md, queue 1, item 1b)",
        "adapter_ids": "LoRA adapters arrive with the quantization and "
                       "adapter slice (ROADMAP.md, queue 1, item 1b)",
        # the serving engine's arguments (workloads/serving.py)
        "mesh": "tensor-parallel serving arrives with multi-device "
                "(ROADMAP.md, queue 1, item 6)",
        "draft": "speculative decoding arrives with its slice "
                 "(ROADMAP.md, queue 1, item 1b)",
        "adapter": "LoRA adapters arrive with the quantization and "
                   "adapter slice (ROADMAP.md, queue 1, item 1b)",
        "spec_round": "speculative decoding arrives with its slice "
                      "(ROADMAP.md, queue 1, item 1b)",
    }
    for name, value in features.items():
        if isinstance(value, torch.Tensor) or value not in (None, False, 0):
            raise NotImplementedError(f"{name}: not yet ported; "
                                      f"{later[name]}")


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
    the dense GELU MLP (tanh approximation, as flax's ``nn.gelu``) or
    SwiGLU (``mlp_down(silu(mlp_gate(h)) * mlp_up(h))``).  Parameters
    are *param_dtype* (f32, flax's default) and train."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int,
                 dtype: torch.dtype = COMPUTE_DTYPE,
                 attn_fn: AttnFn = local_causal_attention,
                 n_kv_heads: Optional[int] = None, ffn: str = "gelu",
                 rope_theta: float = 10000.0, n_experts: int = 0,
                 device=None, param_dtype: torch.dtype = torch.float32):
        super().__init__()
        _unported(n_experts=n_experts)
        device = resolve_device(device)
        self.n_heads = n_heads
        self.n_kv = n_kv_heads or n_heads
        _validate_attn_ffn(n_heads, self.n_kv, ffn)
        self.d_model, self.head_dim = d_model, d_model // n_heads
        self.attn_fn, self.ffn, self.rope_theta = attn_fn, ffn, rope_theta
        self.attn_norm = RMSNorm(d_model, dtype, device)
        self.qkv = Dense(
            d_model, (n_heads + 2 * self.n_kv) * self.head_dim, dtype,
            device, param_dtype)
        self.out_proj = Dense(d_model, d_model, dtype, device, param_dtype)
        self.mlp_norm = RMSNorm(d_model, dtype, device)
        if ffn == "swiglu":
            self.mlp_gate = Dense(d_model, d_ff, dtype, device, param_dtype)
        self.mlp_up = Dense(d_model, d_ff, dtype, device, param_dtype)
        self.mlp_down = Dense(d_ff, d_model, dtype, device, param_dtype)

    def attention_inputs(self, x: torch.Tensor, positions: torch.Tensor):
        """q [B, T, H, Dh] and k [B, T, Hkv, Dh] with RoPE applied, and v
        (a view of the fused projection)."""
        q, k, v = split_qkv_heads(
            self.qkv(self.attn_norm(x)), self.n_heads, self.n_kv,
            self.head_dim)
        return (apply_rope(q, positions, self.rope_theta),
                apply_rope(k, positions, self.rope_theta), v)

    def finish(self, x: torch.Tensor, att: torch.Tensor) -> torch.Tensor:
        """The attention residual, then the FFN and its residual."""
        B, T, _ = x.shape
        x = x + self.out_proj(att.reshape(B, T, self.d_model))
        h = self.mlp_norm(x)
        if self.ffn == "swiglu":
            return x + self.mlp_down(
                F.silu(self.mlp_gate(h)) * self.mlp_up(h))
        return x + self.mlp_down(
            F.gelu(self.mlp_up(h), approximate="tanh"))

    def forward(self, x: torch.Tensor, positions: torch.Tensor
                ) -> torch.Tensor:
        q, k, v = self.attention_inputs(x, positions)
        return self.finish(x, self.attn_fn(q, k, v, positions))


class TransformerLM(nn.Module):
    """Next-token LM: embedding, blocks named ``block_i``, final RMSNorm,
    ``lm_head``; f32 logits.  ``attn_fn`` swaps the einsum attention for
    the flash kernels (``flash_attention.flash_causal_attention``)
    without touching any other part of the model.  Parameters are f32
    and left uninitialised: load a converted tree, or fill them
    (``bench_serving.random_init_``)."""

    def __init__(self, vocab: int, d_model: int = 256, n_heads: int = 4,
                 n_layers: int = 2, d_ff: int = 1024,
                 dtype: torch.dtype = COMPUTE_DTYPE,
                 attn_fn: AttnFn = local_causal_attention,
                 n_kv_heads: Optional[int] = None, ffn: str = "gelu",
                 rope_theta: float = 10000.0, n_experts: int = 0,
                 device=None):
        super().__init__()
        _unported(n_experts=n_experts)
        device = resolve_device(device)
        self.vocab, self.n_layers, self.dtype = vocab, n_layers, dtype
        f32 = torch.float32
        self.embed = Embed(vocab, d_model, dtype, device, f32)
        for i in range(n_layers):
            self.add_module(f"block_{i}", Block(
                d_model, n_heads, d_ff, dtype=dtype, attn_fn=attn_fn,
                n_kv_heads=n_kv_heads, ffn=ffn, rope_theta=rope_theta,
                device=device))
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


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def lm_loss(model: TransformerLM, tokens: torch.Tensor,
            labels: torch.Tensor,
            positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross entropy of the f32 logits over the labels
    >= 0 (a negative label, such as the -1 in the last slot, is
    ignored); 0 when every label is ignored, as in the JAX package."""
    logits = model(tokens, positions)
    labels = labels.long().masked_fill(labels < 0, -1)
    total = F.cross_entropy(logits.flatten(0, 1), labels.flatten(),
                            ignore_index=-1, reduction="sum")
    return total / (labels >= 0).sum().clamp(min=1)


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
