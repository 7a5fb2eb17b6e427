"""Autoregressive inference with a KV cache: the serving-side model.

The dense, full-precision subset of the JAX package's
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
* paged extend (a model cloned with ``kv_page_size``): the cache is the
  page pool ``init_pool_cache`` builds, addressed through per-slot
  block tables; the extend scatters its K/V into the pool, gathers the
  pool back into the contiguous ``[B, max_len]`` view and runs the same
  attention.  With ``kv_quant`` the pool holds int8 rows and f32
  per-row scales.

The decode loop takes the first token from the prefill logits, then
runs ``n_steps - 1`` extends.  On CUDA the step (extend and pick) is
captured once as a CUDA graph over static buffers and replayed, the
counterpart of the JAX package's one-executable ``lax.scan``; on the
CPU it runs op by op.  Sampling draws from a counter-based hash of
(key, draw index, row, vocab index), so no generator state is carried.

Every entry point runs on the model's device, which is CUDA unless the
caller passes ``device="cpu"``; without CUDA and without that argument
the model refuses to build.
"""

from __future__ import annotations

import copy
import gc
import threading
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
    cache positions below ``lens[b] + t + 1``.

    Paged extend (*block_tables* given): ``cached_k`` / ``cached_v`` are
    pools ``[P + 1, page, Hkv, Dh]`` (int8, with ``k_scale`` /
    ``v_scale`` ``[P + 1, page, Hkv]``, when quantized) and row r of
    slot b lives at page ``block_tables[b, r // page]``, offset
    ``r % page``.  The start is clamped as above, so a parked slot's
    writes stay in its own tail pages or the scratch page.

    With *attend_rows* (contiguous extend only) the first *attend_rows*
    rows attend one at a time, each at the shape of a one-row batch, and
    the rest attend to nothing (zeros): the admission extend's form, in
    which a row's arithmetic does not depend on how many rows are real
    (see ``serving._ChunkBatch``)."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int,
                 max_len: int, dtype: torch.dtype = COMPUTE_DTYPE,
                 n_kv_heads: Optional[int] = None, ffn: str = "gelu",
                 rope_theta: float = 10000.0, device=None):
        super().__init__(d_model, n_heads, d_ff, dtype=dtype,
                         n_kv_heads=n_kv_heads, ffn=ffn,
                         rope_theta=rope_theta, device=device,
                         param_dtype=dtype)
        self.max_len = max_len
        self.dtype = dtype

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                layer_cache: Dict[str, torch.Tensor],
                decode: bool = False,
                block_tables: Optional[torch.Tensor] = None,
                attend_rows: Optional[int] = None
                ) -> torch.Tensor:
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
            if block_tables is None:
                rows = torch.arange(B, device=x.device)[:, None]
                cached_k[rows, idx] = k
                cached_v[rows, idx] = v
                if attend_rows is None:
                    att = _decode_attention(q, cached_k, cached_v, lens)
                else:
                    att = _rowwise_attention(q, cached_k, cached_v, lens,
                                             attend_rows)
            else:
                att = self._paged_extend(q, k, v, idx, layer_cache,
                                         block_tables)
            lens += T
        return self.finish(x, att)

    def _paged_extend(self, q, k, v, idx, layer_cache, block_tables):
        """Scatter this call's K/V rows *idx* [B, T] into the pool pages
        the block tables name, in place, then attend against the
        gathered contiguous view."""
        cached_k = layer_cache["cached_k"]
        cached_v = layer_cache["cached_v"]
        lens = layer_cache["cache_lens"]
        ps = cached_k.shape[1]
        tables = block_tables.long()
        phys = tables.gather(1, idx // ps)
        off = idx % ps
        if "k_scale" in layer_cache:
            k_scale, v_scale = layer_cache["k_scale"], layer_cache["v_scale"]
            kq, ks = quantize_kv_rows(k)
            vq, vs = quantize_kv_rows(v)
            cached_k[phys, off] = kq
            cached_v[phys, off] = vq
            k_scale[phys, off] = ks
            v_scale[phys, off] = vs
            view_k = _gather_pool_view(cached_k, tables, self.dtype, k_scale)
            view_v = _gather_pool_view(cached_v, tables, self.dtype, v_scale)
        else:
            cached_k[phys, off] = k.to(cached_k.dtype)
            cached_v[phys, off] = v.to(cached_v.dtype)
            view_k = _gather_pool_view(cached_k, tables, self.dtype)
            view_v = _gather_pool_view(cached_v, tables, self.dtype)
        return _decode_attention(q, view_k, view_v, lens)


# int8 KV rows: one symmetric f32 scale per (token row, KV head) over the
# head dim
_KV_QMAX = 127.0


def quantize_kv_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., Hkv, Dh] K/V rows -> (int8 values, f32 per-row scales
    [..., Hkv]).  Symmetric: q = round(x / s * 127), s = max|x| over Dh
    (0-rows get scale 1 so they round-trip to exact zeros)."""
    xf = x.to(torch.float32)
    s = xf.abs().amax(dim=-1)
    s = torch.where(s == 0.0, torch.ones_like(s), s)
    q = torch.clamp(torch.round(xf / s[..., None] * _KV_QMAX), -127, 127)
    return q.to(torch.int8), s


def dequantize_kv_rows(q: torch.Tensor, s: torch.Tensor,
                       dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`quantize_kv_rows` (values, not bits)."""
    return (q.to(torch.float32) * (s / _KV_QMAX)[..., None]).to(dtype)


def _gather_pool_view(pool: torch.Tensor, block_tables: torch.Tensor,
                      dtype: torch.dtype,
                      scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pool pages -> the contiguous logical view ``[B, max_len, Hkv, Dh]``
    the banded attention masks: one gather by block table, reshaped.
    With *scale* the pool is int8 and rows dequantize on the way out.
    Rows of unmapped (scratch) entries hold whatever finite values were
    written there; all of them sit at logical positions >= the slot's
    lens, where the -inf mask gives them a weight of exactly 0."""
    B = block_tables.shape[0]
    tables = block_tables.long()
    v = pool[tables]                 # [B, n_pages, page, Hkv, Dh]
    if scale is not None:
        v = dequantize_kv_rows(v, scale[tables], dtype)
    return v.reshape(B, -1, v.shape[-2], v.shape[-1])


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


def _rowwise_attention(q: torch.Tensor, k_cache: torch.Tensor,
                       v_cache: torch.Tensor, lens: torch.Tensor,
                       n_rows: int) -> torch.Tensor:
    """:func:`_decode_attention` for the first *n_rows* rows, one row at a
    time at the shape of a one-row batch; zeros for the other rows."""
    outs = [_decode_attention(q[i:i + 1], k_cache[i:i + 1], v_cache[i:i + 1],
                              lens[i:i + 1]) for i in range(n_rows)]
    if n_rows < q.shape[0]:
        outs.append(q.new_zeros((q.shape[0] - n_rows,) + q.shape[1:]))
    return torch.cat(outs)


class DecodeTransformerLM(nn.Module):
    """Serving twin of the JAX ``TransformerLM``: embedding, cached
    blocks named ``block_i``, final RMSNorm, ``lm_head``; logits in f32.
    The engine assumes the natural token order (positions 0..T-1 at
    prefill).  ``kv_page_size > 0`` makes the extend paged (the cache is
    a page pool and the call passes ``block_tables``); ``kv_quant`` says
    the pool stores int8 rows.  :meth:`clone` gives such a twin over the
    same weights."""

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
                  n_adapters=n_adapters)
        device = resolve_device(device)
        self.vocab, self.d_model, self.n_heads = vocab, d_model, n_heads
        self.n_layers, self.max_len, self.dtype = n_layers, max_len, dtype
        self.n_kv_heads = n_kv_heads or n_heads
        self.n_experts = n_experts  # 0: an expert FFN raises above
        self.kv_page_size, self.kv_quant = int(kv_page_size), bool(kv_quant)
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

    def clone(self, **fields) -> "DecodeTransformerLM":
        """A twin of this model over the same weights with *fields*
        (``kv_page_size``, ``kv_quant``) replaced: the counterpart of
        flax's ``Module.clone``."""
        for name in fields:
            if name not in ("kv_page_size", "kv_quant"):
                raise TypeError(f"clone cannot change {name!r}")
        twin = copy.copy(self)
        twin.kv_page_size = int(fields.get("kv_page_size",
                                           self.kv_page_size))
        twin.kv_quant = bool(fields.get("kv_quant", self.kv_quant))
        return twin

    def forward(self, tokens: torch.Tensor, positions: torch.Tensor,
                cache: Cache, decode: bool = False,
                adapter_ids: Optional[torch.Tensor] = None,
                block_tables: Optional[torch.Tensor] = None,
                attend_rows: Optional[int] = None
                ) -> torch.Tensor:
        _unported(adapter_ids=adapter_ids)
        if self.kv_page_size:
            if not decode:
                raise NotImplementedError(
                    "paged KV serves the EXTEND path only: prefill runs "
                    "on contiguous B=1 mini caches (the engine splices "
                    "them into pool pages)")
            if block_tables is None:
                raise ValueError(
                    "paged extend needs block_tables ([B, n_pages] int32 "
                    "— the engine passes its pool's tables)")
        else:
            block_tables = None
        x = self.embed(tokens)
        for i in range(self.n_layers):
            x = getattr(self, f"block_{i}")(
                x, positions, cache[f"block_{i}"], decode, block_tables,
                attend_rows)
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


def init_pool_cache(model: DecodeTransformerLM, batch: int, n_pages: int,
                    page_size: int, kv_quant: bool = False) -> Cache:
    """Fresh all-zero paged cache: per layer a physical pool
    ``[n_pages + 1, page_size, Hkv, Dh]`` (the last page is the scratch
    page clamped garbage writes land in) plus ``cache_lens [batch]``.
    With *kv_quant* the pools are int8 and f32 per-row scale pools
    ``k_scale`` / ``v_scale`` ``[n_pages + 1, page_size, Hkv]`` ride
    alongside.  Block tables live with the allocator
    (``kv_pool.PagePool``), not in the cache."""
    head_dim = model.d_model // model.n_heads
    kv = (n_pages + 1, page_size, model.n_kv_heads, head_dim)
    dev = model.device
    pool_dtype = torch.int8 if kv_quant else model.dtype
    out = {}
    for i in range(model.n_layers):
        buf = {
            "cached_k": torch.zeros(kv, dtype=pool_dtype, device=dev),
            "cached_v": torch.zeros(kv, dtype=pool_dtype, device=dev),
            "cache_lens": torch.zeros(batch, dtype=torch.int32, device=dev),
        }
        if kv_quant:
            buf["k_scale"] = torch.zeros(kv[:3], dtype=torch.float32,
                                         device=dev)
            buf["v_scale"] = torch.zeros(kv[:3], dtype=torch.float32,
                                         device=dev)
        out[f"block_{i}"] = buf
    return out


@torch.no_grad()
def extend_step(model: DecodeTransformerLM, cache: Cache,
                tokens: torch.Tensor, positions: torch.Tensor,
                adapter_ids: Optional[torch.Tensor] = None,
                block_tables: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Cache]:
    """One banded extend (any T >= 1): returns ``(logits, cache)``.
    The cache is updated in place and returned, so the JAX idiom
    ``logits, cache = extend_step(...)`` reads the same.  A paged model
    takes its pool's *block_tables* [B, n_pages]."""
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


# -- counter-based draws ----------------------------------------------------
#
# Every random number of the port is a pure function of (key, draw index,
# slot, vocab index): integer hashing in int64 torch ops, with no
# generator state.  So a step draws the same numbers whether it runs
# alone or inside a replayed window, a seeded slot's numbers do not
# depend on its neighbours, and the draw needs no host-to-device copy.
# The JAX package draws with ``fold_in`` on its PRNG keys; the streams
# differ from JAX's, and the port is held to its own invariants.

_MASK32 = 0xFFFFFFFF
# tags that keep the streams apart: a request's own seed chain and the
# vocabulary index hash never meet the engine stream's values
_SEED_TAG = 0x5EED5EED
_VOCAB_TAG = 0x85EBCA6B


def _mix32(x):
    """A 32-bit finaliser (xorshift-multiply, twice) of an int or an
    int64 tensor holding values in [0, 2**32).  Both multipliers are
    below 2**31, so no product reaches 2**63: the int64 arithmetic never
    overflows, on the CPU or on the card."""
    x = x ^ (x >> 16)
    x = (x * 0x21F0AAAD) & _MASK32
    x = x ^ (x >> 15)
    x = (x * 0x735A2D97) & _MASK32
    return x ^ (x >> 15)


def fold_in(key, data):
    """A new 32-bit key from *key* and *data* (ints or int64 tensors,
    broadcast): the counterpart of ``jax.random.fold_in``."""
    return _mix32(key ^ _mix32((data & _MASK32) ^ 0x9E3779B9))


def prng_key(seed: int) -> int:
    """The key of an integer seed (all of its bits count)."""
    seed = int(seed)
    return fold_in(fold_in(0x243F6A88, seed & _MASK32),
                   (seed >> 32) & _MASK32)


def seed_key(seed: int, stream: int = 0) -> int:
    """The key of a request's own chain: its seed, then its stream (the
    copy index of an n > 1 request), so seed s stream 1 never meets
    seed s + 1 stream 0."""
    return fold_in(fold_in(prng_key(seed), _SEED_TAG), stream)


def row_keys(keys, draws, slots):
    """One key a row: ``fold_in(fold_in(key, draw), slot)``."""
    return fold_in(fold_in(keys, draws), slots)


def gumbel_rows(keys: torch.Tensor, vocab: int) -> torch.Tensor:
    """[S, vocab] f32 Gumbel noise, row s drawn from ``keys[s]`` (int64
    [S]).  The uniform is exact integer arithmetic, the same bits on
    every device: 24 hashed bits centred in (0, 1)."""
    v = torch.arange(vocab, dtype=torch.int64, device=keys.device)
    bits = _mix32(keys[:, None] ^ _mix32(v ^ _VOCAB_TAG)[None, :])
    u = ((bits >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u))


def _greedy_pick(logits, key, draw, top_k, temperature):
    """Deterministic next-token rule (draws nothing); int32 ids, as the
    JAX package's."""
    del key, draw, top_k, temperature
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _sample_pick(logits, key, draw, top_k, temperature):
    """Temperature-scaled, optionally top-k truncated sampling: the
    argmax of the logits plus Gumbel noise, row b drawn from
    ``row_keys(key, draw, b)``.  *key* and *draw* are int64 tensors on
    the logits' device, so a captured step reads the draw index from
    its buffer."""
    scaled = logits / max(float(temperature), 1e-6)
    if top_k is not None:
        kth = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
        scaled = scaled.masked_fill(scaled < kth, float("-inf"))
    rows = torch.arange(logits.shape[0], device=logits.device)
    noise = gumbel_rows(row_keys(key, draw, rows), logits.shape[-1])
    return torch.argmax(scaled + noise, dim=-1).to(torch.int32)


def scan_boundary_update(fin, frs, nxt, i, eos_vec, stop_mat, emitted0,
                         budget):
    """One decode step's finish detection on the device: given the
    step's tokens ``nxt`` [S] and the first-boundary state (``fin`` [S]
    step index, -1 = none yet; ``frs`` [S] reason code), record which
    slots just hit a boundary.  Reason codes follow the engine's
    ``finish_reason``: 1 = eos, 2 = stop token, 3 = length (budget).
    ``eos_vec`` [S] is each slot's effective eos id (-1 disables),
    ``stop_mat`` [S, K] its padded stop ids (pad -1), ``emitted0`` [S]
    the tokens emitted before the window and ``budget`` the cap.  The
    earliest flagged token wins, and on one token eos beats stop beats
    length, as in the host walk.  Returns the new ``(fin, frs)``."""
    eos_hit = nxt == eos_vec
    stop_hit = (stop_mat == nxt[:, None]).any(dim=1)
    len_hit = (emitted0 + i + 1) >= budget
    zero = torch.zeros_like(frs)
    reason = torch.where(
        eos_hit, zero + 1,
        torch.where(stop_hit, zero + 2, torch.where(len_hit, zero + 3,
                                                    zero)))
    first = (fin < 0) & (reason > 0)
    return torch.where(first, i, fin), torch.where(first, reason, frs)


# -- the decode step as a CUDA graph ----------------------------------------

# warm-up runs of a step before its capture: they set up cuBLAS on the
# capture stream, which a capture may not do
_WARMUP = 2

# held across every capture: a CUDA call from another thread while a
# graph is being captured fails the capture, so code on other threads
# that must make one (the server's /debug/profile starting or stopping
# the profiler) takes this lock around it
CAPTURE_LOCK = threading.Lock()


def capture_step(step, state, stream: "torch.cuda.Stream"):
    """Capture one call of *step*, which reads and writes only buffers
    that outlive the graph, as a CUDA graph on *stream*.  It is first
    run on that stream, which sets up the libraries there; those runs
    advance the decode state, so the buffers in *state* are put back
    after them.  The K/V rows they wrote lie at or past each slot's
    depth, where the replayed steps write before anything reads.  A
    failure raises: nothing falls back to running eagerly."""
    saved = [t.clone() for t in state]
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(_WARMUP):
            step()
    torch.cuda.current_stream().wait_stream(stream)
    for t, s in zip(state, saved):
        t.copy_(s)
    graph = torch.cuda.CUDAGraph()
    with CAPTURE_LOCK:
        # a dead reference cycle freed inside the capture (an engine or
        # a server dropped earlier, still holding graphs and buffers)
        # would make CUDA calls there and invalidate it: the collector,
        # process-wide, is held off until the capture ends
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, stream=stream):
                step()
        finally:
            if collecting:
                gc.enable()
    return graph


def cache_lens(cache: Cache):
    """Every layer's ``cache_lens`` (what a decode step advances)."""
    return [layer["cache_lens"] for layer in cache.values()]


class _DecodeSteps:
    """The decode steps of one generation over static buffers: the
    tokens and positions in, the draw index (which is also the output
    column) and the output ids.  With *graph* (CUDA only) the step is
    captured once at construction and replayed; otherwise it runs
    eagerly (the CPU path, and the check the card holds the graph
    against).  *cache* is updated in place and must outlive this."""

    def __init__(self, model: DecodeTransformerLM, cache: Cache, pick,
                 top_k, temperature, key: int, n_steps: int,
                 graph: bool):
        dev = model.device
        B = cache["block_0"]["cache_lens"].shape[0]
        self.model, self.cache, self.pick = model, cache, pick
        self.top_k, self.temperature = top_k, temperature
        self.tok = torch.zeros(B, dtype=torch.int32, device=dev)
        self.pos = torch.zeros(B, dtype=torch.int32, device=dev)
        self.draw = torch.zeros(1, dtype=torch.int64, device=dev)
        self.key = torch.full((1,), prng_key(key), dtype=torch.int64,
                              device=dev)
        self.out = torch.zeros(B, n_steps, dtype=torch.int32, device=dev)
        self.graph = None
        self.capture_ms = None
        if graph:
            _sync(dev)
            t0 = time.perf_counter()
            self.graph = capture_step(
                self._step, [self.tok, self.pos, self.draw]
                + cache_lens(cache), torch.cuda.Stream(dev))
            _sync(dev)
            self.capture_ms = (time.perf_counter() - t0) * 1e3

    @torch.no_grad()
    def _step(self) -> None:
        logits, _ = extend_step(self.model, self.cache, self.tok[:, None],
                                self.pos[:, None])
        nxt = self.pick(logits[:, -1, :], self.key, self.draw, self.top_k,
                        self.temperature)
        self.out.index_copy_(1, self.draw, nxt[:, None])
        self.tok.copy_(nxt)
        self.pos.add_(1)
        self.draw.add_(1)

    @torch.no_grad()
    def run(self, first_logits: torch.Tensor, pos0: torch.Tensor,
            n_steps: int) -> torch.Tensor:
        """[B, n_steps]: the first token picked from *first_logits*
        (draw 0), then ``n_steps - 1`` steps from depth *pos0*."""
        if not 1 <= n_steps <= self.out.shape[1]:
            raise ValueError(f"n_steps {n_steps} outside [1, "
                             f"{self.out.shape[1]}]")
        self.draw.zero_()
        first = self.pick(first_logits, self.key, self.draw, self.top_k,
                          self.temperature)
        self.out.index_copy_(1, self.draw, first[:, None])
        self.tok.copy_(first)
        self.pos.copy_(pos0)
        self.draw.fill_(1)
        for _ in range(n_steps - 1):
            if self.graph is None:
                self._step()
            else:
                self.graph.replay()
                _decode_loop.graph_replays += 1
        return self.out[:, :n_steps].clone()


@torch.no_grad()
def _decode_loop(model: DecodeTransformerLM, cache: Cache,
                 prefill_logits_last: torch.Tensor, n_steps: int,
                 pos0: torch.Tensor, top_k, pick, temperature,
                 key, eager: bool = False) -> torch.Tensor:
    """``n_steps`` tokens: the first from the prefill logits, then one
    extend per token, ``n_steps - 1`` in all.  Returns [B, n_steps].
    On CUDA the step is captured as a CUDA graph and replayed (counted
    in ``_decode_loop.graph_replays``); *eager* runs it op by op
    instead, which the CPU always does."""
    graph = model.device.type == "cuda" and not eager
    steps = _DecodeSteps(model, cache, pick, top_k, temperature,
                         0 if key is None else key, n_steps, graph)
    return steps.run(prefill_logits_last, pos0, n_steps)


_decode_loop.graph_replays = 0


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
    key: int,
    temperature: float = 1.0,
    top_k: Optional[int] = None,
) -> torch.Tensor:
    """Temperature / top-k sampling over the same loop as
    :func:`greedy_generate`; returns ``generated [B, n_steps]``.  Token
    t of row b is drawn from ``row_keys(prng_key(key), t, b)``, so the
    ids are a function of the integer *key* alone.  ``temperature -> 0``
    and ``top_k=1`` recover greedy."""
    validate_top_k(model, top_k)
    prompt = torch.as_tensor(prompt, device=model.device)
    B, T_p = _check_request(model, prompt, n_steps)
    logits, cache = _prefill(model, prompt, _positions(B, T_p, model.device))
    pos0 = torch.full((B,), T_p, dtype=torch.int32, device=model.device)
    return _decode_loop(model, cache, logits[:, -1, :], n_steps, pos0,
                        top_k, _sample_pick, temperature, key)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def decode_throughput(
    model: DecodeTransformerLM, prompt, n_steps: int, rounds: int = 3,
) -> Dict[str, float]:
    """Tokens/sec of the decode loop, best of *rounds* after one warm
    run; the prefill runs outside that timed region, and its own best
    of *rounds* (after one warm run) is reported as ``prefill_ms``.
    Each decode round starts from the prefilled cache, copied in place
    into the one cache the steps run on.  On CUDA the step is captured
    once before the rounds (``capture_ms``, not in the decode time) and
    the rounds time the first pick and the replays."""
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
    run_cache = {name: {key: t.clone() for key, t in layer.items()}
                 for name, layer in cache.items()}
    steps = _DecodeSteps(model, run_cache, _greedy_pick, None, 1.0, 0,
                         n_steps, graph=model.device.type == "cuda")

    best = None
    for r in range(rounds + 1):
        for name, layer in cache.items():
            for key, t in layer.items():
                run_cache[name][key].copy_(t)
        _sync(model.device)
        t0 = time.perf_counter()
        steps.run(last, pos0, n_steps)
        _sync(model.device)
        dt = time.perf_counter() - t0
        if r and (best is None or dt < best):
            best = dt
    return {
        "tokens_per_sec": B * n_steps / best,
        "tokens_per_sec_per_seq": n_steps / best,
        "prefill_ms": prefill_best * 1e3,
        "capture_ms": steps.capture_ms,
        "batch": float(B),
        "steps": float(n_steps),
    }
