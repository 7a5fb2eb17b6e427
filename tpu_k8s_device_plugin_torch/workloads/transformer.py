"""Transformer building blocks shared by the LM's training and serving
models: rotary embeddings, the oracle causal attention, the fused-qkv
split and the grouped-query helpers.

Same math and the same [B, T, H, D] layout as the JAX package's
``workloads/transformer.py``; the port's tests hold each function
against it.
"""

from __future__ import annotations

import numpy as np
import torch

COMPUTE_DTYPE = torch.bfloat16


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
