"""Llama-family model configs over the port's decoder and trainer.

The three Llama ingredients on the same ``DecodeTransformerLM`` and
``TransformerLM``: grouped-query attention (``n_kv_heads < n_heads``),
the SwiGLU MLP and a large RoPE base.  The configs are the JAX package's,
value for value.

Memory on one H100 (80 GB): Llama-3-8B's bf16 weights take about 16 GB
(``LLAMA3_8B.n_params() * 2`` bytes), and its grouped KV cache
8 heads x 128 dims x 2 (K and V) x 2 bytes x 32 layers = 131 kB per
token, so the whole model serves from one card without quantization.  Training
is another matter: f32 parameters, their gradients and Adam's two
moments take 16 bytes per parameter, 128 GB for the 8.03 B of
Llama-3-8B, so one card trains it at full width with fewer layers.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .inference import DecodeTransformerLM, make_decoder
from .transformer import COMPUTE_DTYPE, TransformerLM


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    n_layers: int
    d_ff: int
    rope_theta: float = 500000.0
    max_len: int = 8192

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def n_params(self) -> int:
        """Parameter count (embed + blocks + head), for sizing checks."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        kv = self.n_kv_heads * self.head_dim
        per_block = (
            d * (d + 2 * kv)      # qkv
            + d * d               # out_proj
            + 3 * d * f           # gate, up, down
            + 2 * d               # two RMSNorm scales
        )
        return v * d + self.n_layers * per_block + d + d * v


# Llama-3-8B (meta-llama/Meta-Llama-3-8B): 32 layers, d=4096, 32 heads /
# 8 KV heads, d_ff=14336, vocab 128256, rope theta 500000
LLAMA3_8B = LlamaConfig(
    vocab=128256, d_model=4096, n_heads=32, n_kv_heads=8,
    n_layers=32, d_ff=14336,
)

# Llama-2-7B-shaped: MHA (n_kv == n_heads), theta 10000, vocab 32000
LLAMA2_7B = LlamaConfig(
    vocab=32000, d_model=4096, n_heads=32, n_kv_heads=32,
    n_layers=32, d_ff=11008, rope_theta=10000.0, max_len=4096,
)

# Llama-3.2-1B-shaped: the speculative draft for the 8B target
LLAMA32_1B = LlamaConfig(
    vocab=128256, d_model=2048, n_heads=32, n_kv_heads=8,
    n_layers=16, d_ff=8192,
)

# the full Llama shape grammar (GQA 4:1, SwiGLU, big theta) at test size
TINY_LLAMA = LlamaConfig(
    vocab=256, d_model=128, n_heads=8, n_kv_heads=2,
    n_layers=2, d_ff=352, max_len=128,
)

# 1-layer draft for TINY_LLAMA
TINY_DRAFT = LlamaConfig(
    vocab=256, d_model=64, n_heads=4, n_kv_heads=2,
    n_layers=1, d_ff=128, max_len=128,
)


def train_model(cfg: LlamaConfig, dtype: torch.dtype = COMPUTE_DTYPE,
                device=None, **overrides) -> TransformerLM:
    """Training model for *cfg* (f32 parameters, uninitialised: load or
    fill them); ``attn_fn`` and the rest through *overrides*, as in the
    JAX package."""
    return TransformerLM(
        vocab=cfg.vocab, d_model=cfg.d_model, n_heads=cfg.n_heads,
        n_layers=cfg.n_layers, d_ff=cfg.d_ff, dtype=dtype,
        n_kv_heads=cfg.n_kv_heads, ffn="swiglu",
        rope_theta=cfg.rope_theta, device=device, **overrides,
    )


def decoder(
    cfg: LlamaConfig,
    max_len: Optional[int] = None,
    quantized=False,
    dtype: torch.dtype = COMPUTE_DTYPE,
    device=None,
) -> DecodeTransformerLM:
    """Serving model for *cfg* (weights uninitialised: load or fill).
    The JAX package's arguments in its order; ``quantized`` (int8 or
    int4 weights) raises ``NotImplementedError`` until it is ported."""
    return make_decoder(
        vocab=cfg.vocab, d_model=cfg.d_model, n_heads=cfg.n_heads,
        n_layers=cfg.n_layers, d_ff=cfg.d_ff,
        max_len=max_len or cfg.max_len, dtype=dtype, quantized=quantized,
        n_kv_heads=cfg.n_kv_heads, ffn="swiglu",
        rope_theta=cfg.rope_theta, device=device,
    )
