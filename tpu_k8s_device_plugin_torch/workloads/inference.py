"""Autoregressive inference with a KV cache: the serving-side model.

The dense, full-precision, contiguous-cache subset of the JAX package's
``workloads/inference.py``, in PyTorch:

* ``DecodeTransformerLM`` / ``CachedBlock`` carry the same parameters
  as the JAX decoder, under the same names (``block_i.qkv`` ...), so a
  converted tree loads key for key (``convert.params_from_jax``).
* prefill runs the whole prompt with causal attention and fills the
  cache; prompts of ``_FLASH_PREFILL_MIN_T`` tokens or more go through
  the flash kernel, shorter ones through the f32 einsum.
* extend (``decode=True``, any T >= 1) appends at each slot's own depth
  and attends banded-causally against the cache.
* the cache is the dict ``init_cache`` builds, with the JAX package's
  keys and shapes.  JAX donates the cache buffers to each step; here
  every step updates them in place, and returns the same dict.

The decode loop is a Python loop over extends: the first token comes
from the prefill logits, then ``n_steps - 1`` extends follow.

Every entry point runs on the model's device, which is CUDA unless the
caller passes ``device="cpu"``; without CUDA and without that argument
the model refuses to build.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from .flash_attention import flash_attention
from .transformer import (
    COMPUTE_DTYPE,
    Block,
    Dense,
    Embed,
    RMSNorm,
    _unported,
    f32_rsqrt,
    local_causal_attention,
    resolve_device,
)

# prompts at or above this length prefill through the flash kernel (no
# [T, T] score matrix in memory); shorter ones use the einsum
_FLASH_PREFILL_MIN_T = 512

Cache = Dict[str, Dict[str, torch.Tensor]]


class CachedBlock(Block):
    """Pre-norm transformer block with a KV cache; the training
    ``Block``'s layers and FFN with its parameters stored in the compute
    dtype, and the attention against the cache.

    The cache of one layer holds ``cached_k`` / ``cached_v``
    ``[B, max_len, Hkv, Dh]`` (the grouped head count) and
    ``cache_lens [B]`` int32.  Prefill (``decode=False``) writes the
    prompt's K/V at the head of the cache and sets every slot's length
    to T.  Extend (``decode=True``) writes at each slot's own length,
    with the start clamped to ``[0, max_len - T]`` as
    ``lax.dynamic_update_slice`` clamps it, and query t of slot b sees
    cache positions below ``lens[b] + t + 1``."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int,
                 max_len: int, dtype: torch.dtype = COMPUTE_DTYPE,
                 n_kv_heads: Optional[int] = None, ffn: str = "gelu",
                 rope_theta: float = 10000.0, device=None):
        super().__init__(d_model, n_heads, d_ff, dtype=dtype,
                         n_kv_heads=n_kv_heads, ffn=ffn,
                         rope_theta=rope_theta, device=device,
                         param_dtype=dtype)
        self.max_len = max_len

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                layer_cache: Dict[str, torch.Tensor],
                decode: bool = False) -> torch.Tensor:
        B, T, _ = x.shape
        q, k, v = self.attention_inputs(x, positions)
        cached_k = layer_cache["cached_k"]
        cached_v = layer_cache["cached_v"]
        lens = layer_cache["cache_lens"]

        if not decode:
            if T > self.max_len:
                raise ValueError(
                    f"prompt {T} exceeds max_len {self.max_len}")
            cached_k[:, :T] = k
            cached_v[:, :T] = v
            lens.fill_(T)
            # the natural prompt order makes the positions mask equal to
            # the storage-order causal mask the kernel applies; the
            # kernel takes the grouped K/V as they are
            if T >= _FLASH_PREFILL_MIN_T:
                att = flash_attention(q, k, v, causal=True)
            else:
                att = local_causal_attention(q, k, v, positions)
        else:
            start = torch.clamp(lens, min=0, max=self.max_len - T)
            idx = start.long()[:, None] + torch.arange(T, device=x.device)
            rows = torch.arange(B, device=x.device)[:, None]
            cached_k[rows, idx] = k
            cached_v[rows, idx] = v
            att = _decode_attention(q, cached_k, cached_v, lens)
            lens += T
        return self.finish(x, att)


def _decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor,
                      lens: torch.Tensor) -> torch.Tensor:
    """Tq query positions against the cache, [B, Tq, H, Dh] x
    [B, T_max, Hkv, Dh] in f32: query t of slot b sees cache positions
    below ``lens[b] + t + 1``.  Grouped heads run as a grouped einsum,
    so the cache is read at its compact size."""
    B, Tq, H, Dh = q.shape
    n_kv = k_cache.shape[2]
    g = H // n_kv
    qg = q.reshape(B, Tq, n_kv, g, Dh).to(torch.float32)
    scores = torch.einsum(
        "bqhgd,bkhd->bqhgk", qg, k_cache.to(torch.float32)
    ) * f32_rsqrt(Dh)
    limit = lens[:, None] + torch.arange(1, Tq + 1, device=q.device)
    valid = (torch.arange(k_cache.shape[1], device=q.device)[None, None, :]
             < limit[:, :, None])  # [B, Tq, T_max]
    scores = scores.masked_fill(~valid[:, :, None, None, :], float("-inf"))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bqhgk,bkhd->bqhgd", w, v_cache.to(torch.float32))
    return out.reshape(B, Tq, H, Dh).to(q.dtype)


class DecodeTransformerLM(nn.Module):
    """Serving twin of the JAX ``TransformerLM``: embedding, cached
    blocks named ``block_i``, final RMSNorm, ``lm_head``; logits in f32.
    The engine assumes the natural token order (positions 0..T-1 at
    prefill)."""

    def __init__(self, vocab: int, d_model: int = 256, n_heads: int = 4,
                 n_layers: int = 2, d_ff: int = 1024, max_len: int = 512,
                 dtype: torch.dtype = COMPUTE_DTYPE, quantized=False,
                 n_experts: int = 0, moe_k: int = 2,
                 moe_capacity_factor: float = 1.25,
                 n_kv_heads: Optional[int] = None, ffn: str = "gelu",
                 rope_theta: float = 10000.0, n_adapters: int = 0,
                 lora_rank: int = 8, lora_scale: float = 1.0,
                 kv_page_size: int = 0, kv_quant: bool = False,
                 device=None):
        super().__init__()
        # moe_k and moe_capacity_factor shape the experts, lora_rank and
        # lora_scale the adapters: they take effect with n_experts and
        # n_adapters, which raise until ported
        _unported(quantized=quantized, n_experts=n_experts,
                  n_adapters=n_adapters, kv_page_size=kv_page_size,
                  kv_quant=kv_quant)
        device = resolve_device(device)
        self.vocab, self.d_model, self.n_heads = vocab, d_model, n_heads
        self.n_layers, self.max_len, self.dtype = n_layers, max_len, dtype
        self.n_kv_heads = n_kv_heads or n_heads
        self.embed = Embed(vocab, d_model, dtype, device)
        for i in range(n_layers):
            self.add_module(f"block_{i}", CachedBlock(
                d_model, n_heads, d_ff, max_len, dtype=dtype,
                n_kv_heads=n_kv_heads, ffn=ffn, rope_theta=rope_theta,
                device=device))
        self.final_norm = RMSNorm(d_model, dtype, device)
        self.lm_head = Dense(d_model, vocab, dtype, device)
        self.requires_grad_(False)

    @property
    def device(self) -> torch.device:
        return self.embed.weight.device

    def forward(self, tokens: torch.Tensor, positions: torch.Tensor,
                cache: Cache, decode: bool = False,
                adapter_ids: Optional[torch.Tensor] = None,
                block_tables: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        _unported(adapter_ids=adapter_ids, block_tables=block_tables)
        x = self.embed(tokens)
        for i in range(self.n_layers):
            x = getattr(self, f"block_{i}")(
                x, positions, cache[f"block_{i}"], decode)
        x = self.final_norm(x)
        return self.lm_head(x).to(torch.float32)


def make_decoder(
    vocab: int,
    d_model: int = 256,
    n_heads: int = 4,
    n_layers: int = 2,
    d_ff: int = 1024,
    max_len: int = 512,
    dtype: torch.dtype = COMPUTE_DTYPE,
    quantized=False,
    n_experts: int = 0,
    moe_k: int = 2,
    moe_capacity_factor: float = 1.25,
    n_kv_heads: Optional[int] = None,
    ffn: str = "gelu",
    rope_theta: float = 10000.0,
    n_adapters: int = 0,
    lora_rank: int = 8,
    lora_scale: float = 1.0,
    kv_quant: bool = False,
    device=None,
) -> DecodeTransformerLM:
    """A decoder on *device* (CUDA unless given) with uninitialised
    weights: load a converted tree or fill them.  The JAX package's
    arguments in its order, then ``kv_quant`` (its decoder's field) and
    the device."""
    return DecodeTransformerLM(
        vocab=vocab, d_model=d_model, n_heads=n_heads,
        n_layers=n_layers, d_ff=d_ff, max_len=max_len, dtype=dtype,
        quantized=quantized, n_experts=n_experts, moe_k=moe_k,
        moe_capacity_factor=moe_capacity_factor, n_kv_heads=n_kv_heads,
        ffn=ffn, rope_theta=rope_theta, n_adapters=n_adapters,
        lora_rank=lora_rank, lora_scale=lora_scale, kv_quant=kv_quant,
        device=device,
    )


def init_cache(model: DecodeTransformerLM, batch: int) -> Cache:
    """Fresh all-zero cache for a *batch*-sized request, with the JAX
    package's keys and shapes."""
    head_dim = model.d_model // model.n_heads
    kv = (batch, model.max_len, model.n_kv_heads, head_dim)
    dev = model.device
    return {
        f"block_{i}": {
            "cached_k": torch.zeros(kv, dtype=model.dtype, device=dev),
            "cached_v": torch.zeros(kv, dtype=model.dtype, device=dev),
            "cache_lens": torch.zeros(batch, dtype=torch.int32, device=dev),
        }
        for i in range(model.n_layers)
    }


@torch.no_grad()
def extend_step(model: DecodeTransformerLM, cache: Cache,
                tokens: torch.Tensor, positions: torch.Tensor,
                adapter_ids: Optional[torch.Tensor] = None,
                block_tables: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Cache]:
    """One banded extend (any T >= 1): returns ``(logits, cache)``.
    The cache is updated in place and returned, so the JAX idiom
    ``logits, cache = extend_step(...)`` reads the same."""
    logits = model(tokens, positions, cache, decode=True,
                   adapter_ids=adapter_ids, block_tables=block_tables)
    return logits, cache


@torch.no_grad()
def _prefill(model: DecodeTransformerLM, prompt: torch.Tensor,
             positions: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
    cache = init_cache(model, prompt.shape[0])
    logits = model(prompt, positions, cache)
    return logits, cache


def _check_request(model: DecodeTransformerLM, prompt: torch.Tensor,
                   n_steps: int) -> Tuple[int, int]:
    B, T_p = prompt.shape
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    if T_p + n_steps > model.max_len:
        raise ValueError(
            f"prompt {T_p} + steps {n_steps} exceeds max_len {model.max_len}"
        )
    return B, T_p


def validate_top_k(model: DecodeTransformerLM, top_k) -> None:
    """Shared top-k range check for the sampling entry points."""
    if top_k is not None and not 1 <= top_k <= model.vocab:
        raise ValueError(
            f"top_k {top_k} outside [1, vocab={model.vocab}]")


def _greedy_pick(logits, generator, top_k, temperature):
    """Deterministic next-token rule (ignores the generator); int32 ids,
    as the JAX package's."""
    del generator, top_k, temperature
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _sample_pick(logits, generator, top_k, temperature):
    """Temperature-scaled, optionally top-k truncated sampling, drawn
    as the argmax of logits plus Gumbel noise from *generator*."""
    scaled = logits / max(float(temperature), 1e-6)
    if top_k is not None:
        kth = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
        scaled = scaled.masked_fill(scaled < kth, float("-inf"))
    u = torch.rand(scaled.shape, generator=generator,
                   device=generator.device, dtype=torch.float32)
    u = u.to(scaled.device).clamp_(min=torch.finfo(torch.float32).tiny)
    return torch.argmax(scaled - torch.log(-torch.log(u)),
                        dim=-1).to(torch.int32)


@torch.no_grad()
def _decode_loop(model: DecodeTransformerLM, cache: Cache,
                 prefill_logits_last: torch.Tensor, n_steps: int,
                 pos0: torch.Tensor, top_k, pick, temperature,
                 generator) -> torch.Tensor:
    """``n_steps`` tokens: the first from the prefill logits, then one
    extend per token, ``n_steps - 1`` in all.  Returns [B, n_steps]."""
    tok = pick(prefill_logits_last, generator, top_k, temperature)
    toks = [tok]
    pos = pos0
    for _ in range(n_steps - 1):
        logits, cache = extend_step(model, cache, tok[:, None],
                                    pos[:, None])
        tok = pick(logits[:, -1, :], generator, top_k, temperature)
        toks.append(tok)
        pos = pos + 1
    return torch.stack(toks, dim=1)


def _positions(B: int, T: int, device) -> torch.Tensor:
    return torch.arange(T, dtype=torch.int32, device=device).expand(B, T)


def greedy_generate(
    model: DecodeTransformerLM,
    prompt,           # [B, T_prompt] integer ids
    n_steps: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy decoding: one prefill, then ``n_steps - 1`` extends.
    Returns ``(generated [B, n_steps] int32, prefill_logits
    [B, T_p, V] f32)``."""
    prompt = torch.as_tensor(prompt, device=model.device)
    B, T_p = _check_request(model, prompt, n_steps)
    logits, cache = _prefill(model, prompt, _positions(B, T_p, model.device))
    pos0 = torch.full((B,), T_p, dtype=torch.int32, device=model.device)
    toks = _decode_loop(model, cache, logits[:, -1, :], n_steps, pos0,
                        None, _greedy_pick, 1.0, None)
    return toks, logits


def sample_generate(
    model: DecodeTransformerLM,
    prompt,
    n_steps: int,
    generator: torch.Generator,
    temperature: float = 1.0,
    top_k: Optional[int] = None,
) -> torch.Tensor:
    """Temperature / top-k sampling over the same loop as
    :func:`greedy_generate`; returns ``generated [B, n_steps]``,
    reproducible from *generator*'s state.  ``temperature -> 0`` and
    ``top_k=1`` recover greedy."""
    validate_top_k(model, top_k)
    prompt = torch.as_tensor(prompt, device=model.device)
    B, T_p = _check_request(model, prompt, n_steps)
    logits, cache = _prefill(model, prompt, _positions(B, T_p, model.device))
    pos0 = torch.full((B,), T_p, dtype=torch.int32, device=model.device)
    return _decode_loop(model, cache, logits[:, -1, :], n_steps, pos0,
                        top_k, _sample_pick, temperature, generator)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def decode_throughput(
    model: DecodeTransformerLM, prompt, n_steps: int, rounds: int = 3,
) -> Dict[str, float]:
    """Tokens/sec of the decode loop, best of *rounds* after one warm
    run; the prefill runs outside that timed region, and its own best
    of *rounds* (after one warm run) is reported as ``prefill_ms``.
    Each decode round starts from a copy of the prefilled cache."""
    prompt = torch.as_tensor(prompt, device=model.device)
    B, T_p = _check_request(model, prompt, n_steps)
    positions = _positions(B, T_p, model.device)
    prefill_best = None
    for r in range(rounds + 1):
        _sync(model.device)
        t0 = time.perf_counter()
        logits, cache = _prefill(model, prompt, positions)
        _sync(model.device)
        dt = time.perf_counter() - t0
        if r and (prefill_best is None or dt < prefill_best):
            prefill_best = dt
    last = logits[:, -1, :]
    pos0 = torch.full((B,), T_p, dtype=torch.int32, device=model.device)

    best = None
    for r in range(rounds + 1):
        run_cache = {name: {key: t.clone() for key, t in layer.items()}
                     for name, layer in cache.items()}
        _sync(model.device)
        t0 = time.perf_counter()
        _decode_loop(model, run_cache, last, n_steps, pos0, None,
                     _greedy_pick, 1.0, None)
        _sync(model.device)
        dt = time.perf_counter() - t0
        if r and (best is None or dt < best):
            best = dt
    return {
        "tokens_per_sec": B * n_steps / best,
        "tokens_per_sec_per_seq": n_steps / best,
        "prefill_ms": prefill_best * 1e3,
        "batch": float(B),
        "steps": float(n_steps),
    }
