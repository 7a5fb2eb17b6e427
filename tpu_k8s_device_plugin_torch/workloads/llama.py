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
Weight-only int8 takes its projections to 7.5 GB and int4 to 3.8 GB
(``random_quantized_params`` builds those trees directly, for
benchmarking).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from .inference import DecodeTransformerLM, _int4_group, make_decoder
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
    The JAX package's arguments in its order; ``quantized`` is False,
    True (int8 projections) or ``"int4"``."""
    return make_decoder(
        vocab=cfg.vocab, d_model=cfg.d_model, n_heads=cfg.n_heads,
        n_layers=cfg.n_layers, d_ff=cfg.d_ff,
        max_len=max_len or cfg.max_len, dtype=dtype, quantized=quantized,
        n_kv_heads=cfg.n_kv_heads, ffn="swiglu",
        rope_theta=cfg.rope_theta, device=device,
    )


@torch.no_grad()
def random_quantized_params(cfg: LlamaConfig, seed: int = 0,
                            dtype: torch.dtype = COMPUTE_DTYPE,
                            bits: int = 8, device=None
                            ) -> Dict[str, torch.Tensor]:
    """Random weight-only quantized state dict for ``decoder(cfg,
    quantized=True)`` (*bits* 8) or ``quantized="int4"`` (*bits* 4),
    built directly in that layout on *device* (CUDA unless given), so no
    full-precision copy of the model is ever made: int8 kernels uniform
    in [-127, 127] with scales 0.01, or packed int4 bytes uniform over
    all 256 values with group scales 0.01, as the JAX package's
    ``random_quantized_params``; the embedding normal with sd 0.02 in
    *dtype* (the decoder stores it so) and norm scales 1.  The values
    come from a torch generator seeded with *seed*, not from JAX's
    keys; only their layout and distribution are the reference's."""
    return dict(random_quantized_leaves(cfg, seed, dtype, bits, device))


def random_quantized_leaves(cfg: LlamaConfig, seed: int = 0,
                            dtype: torch.dtype = COMPUTE_DTYPE,
                            bits: int = 8, device=None):
    """:func:`random_quantized_params`'s ``(name, leaf)`` pairs, each drawn
    when it is asked for, in the order of the whole dict: a sharded
    build keeps its piece of one leaf before the next is drawn."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    from .transformer import resolve_device

    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab
    qkv_out = (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim
    f32 = dict(dtype=torch.float32, device=device)

    def kern(prefix, din, dout):
        if bits == 4:
            g = _int4_group(din)
            return {
                f"{prefix}.kernel_int4": torch.randint(
                    -128, 128, (din, dout // 2), generator=gen,
                    dtype=torch.int8, device=device),
                f"{prefix}.scale": torch.full((din // g, dout), 0.01, **f32),
            }
        return {
            f"{prefix}.kernel_int8": torch.randint(
                -127, 128, (din, dout), generator=gen, dtype=torch.int8,
                device=device),
            f"{prefix}.scale": torch.full((dout,), 0.01, **f32),
        }

    emb = torch.empty(v, d, dtype=dtype, device=device)
    rows = max(1, (1 << 26) // d)
    for r0 in range(0, v, rows):
        emb[r0:r0 + rows] = torch.randn(
            (min(rows, v - r0), d), generator=gen, **f32) * 0.02
    yield "embed.weight", emb
    del emb
    yield "final_norm.scale", torch.ones(d, **f32)
    yield from kern("lm_head", d, v).items()
    for i in range(cfg.n_layers):
        b = f"block_{i}"
        yield f"{b}.attn_norm.scale", torch.ones(d, **f32)
        yield f"{b}.mlp_norm.scale", torch.ones(d, **f32)
        for name, din, dout in (("qkv", d, qkv_out), ("out_proj", d, d),
                                ("mlp_gate", d, f), ("mlp_up", d, f),
                                ("mlp_down", f, d)):
            yield from kern(f"{b}.{name}", din, dout).items()
