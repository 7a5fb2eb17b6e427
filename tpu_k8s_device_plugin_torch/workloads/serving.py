"""Slot-based continuous batching on the decoder's KV cache.

The JAX package's ``workloads/serving.py`` in PyTorch: a fixed
``n_slots``-wide decode batch whose per-slot depths live in each
layer's ``cache_lens [S]``, so request churn changes data, never
shapes.

* **slots**: the engine owns a ``[S, T_max, Hkv, Dh]`` cache per layer,
  or with ``kv_paging`` a page pool ``[P + 1, page, Hkv, Dh]`` per layer
  addressed through per-slot block tables (``kv_pool.PagePool`` makes
  every allocation decision on the host).  A request holds one slot
  from admit to completion; free slots keep decoding garbage that
  nothing reads (masking, not branching).
* **admit**: the prompt prefills a B=1 cache in fixed-size chunks
  through the banded extend, then the filled rows are copied into the
  slot and its ``cache_lens`` entry set to the prompt length.
  Automatic prefix caching reuses rows of resident or registered
  prompts on the chunk grid.  ``admit_step_packed`` runs the next
  chunks of K admissions as rows of one extend (the ragged packed
  prefill the iteration scheduler drives).  Every chunked admission
  extend, serial or packed, runs its projections over ``pack_width``
  rows and its attention row by row, so a row's arithmetic never
  depends on how many rows are real (see ``_ChunkBatch``); on CUDA the
  extend at each K is captured once as a CUDA graph.  Every
  host-to-device copy of admission goes through pinned staging without
  waiting for the stream, so admission work enqueued behind an open
  decode window never waits for it: the first token's read
  (``_finish_admit_resolve``) is its one synchronisation.
* **decode**: one step for all S slots at their own depths, the
  request's sampling knobs as per-slot data.  On CUDA the step is
  captured once per static variant as a CUDA graph (the counterpart of
  the reference's one compiled ``lax.scan`` step) and replayed
  ``n_steps`` times a window; ``step`` replays it once.  The step's
  inputs, its outputs and the state it advances live in static device
  buffers that belong to the engine and are written only in place, so
  the captured addresses stay valid across admissions.  On the CPU the
  same step runs op by op.
* **harvest**: one synchronisation a window; the host walks the
  window's tokens for eos, stop ids and budgets, as the reference does.
* **paged pool**: prefixes are shared by page reference and copied on
  write; a pool under pressure reclaims parked donor pages, then asks a
  preemption callback; a preempted slot's pages go to the host and come
  back on ``resume``; retired conversations park their pages as
  sessions.  The block tables, like the grammar table, are static
  buffers of the captured step, written in place between windows.
* **grammars**: token-level DFAs (``grammar.TokenDfa``) in one combined
  table; a constrained slot's DFA state is one more row of the step's
  buffers, and ``jump_round`` commits DFA-forced chains in one extend.

Sampling draws from the port's counter-based hash
(``inference.gumbel_rows``): the engine stream keys a row by (engine
key, global draw index, slot), a seeded request by (its seed and
stream, its own draw index), so a window and the same steps one by one
draw the same numbers, and a seeded request ignores its neighbours.

* **speculative decoding** (``draft=model`` or ``draft="ngram"``):
  ``spec_round`` proposes ``gamma`` tokens for every active slot (the
  draft model from its own ``[S, max_len]`` cache, or prompt lookup over
  the slot's history), verifies them in ONE ``[S, gamma + 1]`` extend
  and commits each slot's accepted prefix plus the target's next token:
  the ids of greedy ``step`` decoding.  It runs op by op (no CUDA
  graph), and is greedy only.
* **LoRA adapters** (a model with ``n_adapters``): each slot's adapter
  id (-1 = the base model) is one more row of the step's buffers, and
  of the admission extend's, written in place; prefixes are bound to
  the adapter they were prefilled with.

* **tensor parallelism** (``mesh=``, a ``DeviceMesh`` with a ``model``
  axis, one process a rank): the model and the draft are split over
  that axis (``inference.shard_decoder``: this rank's heads and FFN
  columns, the collectives after the row pieces and the LM head), and
  the caches and pools hold this rank's KV heads.  Every rank runs the
  same engine calls in the same order (the logits are gathered, so
  their picks agree); ``tp_driver`` replays rank 0's calls on the other
  ranks where rank 0 alone decides them (a scheduler, a server).  The
  steps are captured as CUDA graphs when the axis runs NCCL and run op
  by op when it runs gloo (``stats()["tp_steps"]``).  What leaves the
  engine (``preempt``, ``demote_session``) holds the whole KV in global
  head order, gathered over the axis; ``resume`` and ``resume_session``
  take such a state on every rank and keep their heads of it, so a
  state moves between split and whole engines.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from .inference import (
    Cache,
    DecodeTransformerLM,
    cache_lens,
    capturable,
    capture_step,
    dequantize_kv_rows,
    extend_step,
    gumbel_rows,
    init_cache,
    init_pool_cache,
    prng_key,
    quantize_kv_rows,
    row_keys,
    scan_boundary_update,
    seed_key,
    validate_top_k,
)
from .kv_pool import PagePool, PagePoolExhausted
from .speculative import _draft_propose
from .transformer import resolve_device

# Upper bound for the auto-selected prefill chunk; the resolved chunk is
# always a divisor of max_len, so padded admission never overflows the
# cache (see _resolve_chunk).
DEFAULT_CHUNK = 128

# Default admission grid with prefix caching (prefix_chunk="auto"):
# automatic prefix matches floor to whole chunks, so the grid bounds how
# much of a repeated prompt is reusable.
PREFIX_CHUNK = 32

# Width step of the fused window's per-slot stop-id matrix [S, K]: K is
# part of the captured step's key, so it grows in multiples of 4.
_STOP_PAD = 4

# Rows of every chunked admission extend (the most admissions one packed
# extend advances): the iteration scheduler's DEFAULT_MAX_PACK.
PACK_WIDTH = 4

# Budget for the fused boundary check when the engine has no
# max_new_tokens: beyond any emitted count reachable within max_len.
_NO_BUDGET = 1 << 30

# rows of the window's int64 block (see _Window), then its four scalars
_IROWS = ("tok", "pos", "slot_draws", "emitted", "topks", "min_toks",
          "seed_keys", "seed_on", "eos", "fin", "frs", "slots", "gstate",
          "adapters")
_SCALARS = ("draws", "step", "key", "budget")
# rows of its f32 block
_FROWS = ("temps", "topps", "minps", "pres", "freqs", "reps")


def _on_mesh(model: DecodeTransformerLM, mesh, what: str = ""
             ) -> DecodeTransformerLM:
    """*model* split over *mesh*'s model axis: as it is when it was built
    so, else ``inference.shard_decoder`` of it.  ``ValueError`` naming
    the model axis when its heads do not divide it."""
    from .inference import check_tp, shard_decoder, tp_axis

    check_tp(model, tp_axis(mesh)[1], what)
    if model.tp_mesh is mesh:
        return model
    return shard_decoder(model, mesh)


def _resolve_chunk(max_len: int,
                   cap: int = DEFAULT_CHUNK) -> Optional[int]:
    """The admission chunk for ``chunk="auto"``: the largest divisor of
    *max_len* that is <= min(cap, max_len // 2).  A divisor guarantees
    ceil(t_p / c) * c <= max_len, so a prompt that passes the budget
    check is never rejected by chunk padding.  None (one extend of the
    whole prompt) for a max_len with no divisor >= 8."""
    c = min(cap, max(1, max_len // 2))
    while c > 1 and max_len % c:
        c -= 1
    return c if c >= 8 else None


def _splice_slot(cache: Cache, mini: Cache, slot: int) -> None:
    """Copy the B=1 *mini* cache into row *slot* of the engine cache, in
    place (the engine cache's addresses never move)."""
    for layer, buf in cache.items():
        m = mini[layer]
        buf["cached_k"][slot].copy_(m["cached_k"][0])
        buf["cached_v"][slot].copy_(m["cached_v"][0])
        buf["cache_lens"][slot].copy_(m["cache_lens"][0])


def _set_len(cache: Cache, slot: int, value: int) -> None:
    for buf in cache.values():
        buf["cache_lens"][slot].fill_(value)


def _slot_to_mini(cache: Cache, slot: int) -> Cache:
    """Row *slot* of the engine cache as a new B=1 mini cache (the
    inverse of _splice_slot); the engine cache is not touched."""
    return {layer: {key: t[slot:slot + 1].clone() for key, t in buf.items()}
            for layer, buf in cache.items()}


def _clone_cache(cache: Cache) -> Cache:
    return {layer: {key: t.clone() for key, t in buf.items()}
            for layer, buf in cache.items()}


def _row_pairs(cache: Cache, minis: List[Cache]) -> list:
    """(row i of every *cache* tensor, the same tensor of mini i) pairs,
    grouped by dtype: one ``_foreach_copy_`` a group moves them all in a
    few launches, where a copy a tensor made the host launch 3 x layers
    x K copies, which took longer than the bytes (about 11x their bound
    at Llama-3-8B on an H100)."""
    groups: dict = {}
    for layer, buf in cache.items():
        for key, t in buf.items():
            dst, src = groups.setdefault(t.dtype, ([], []))
            for i, m in enumerate(minis):
                dst.append(t[i])
                src.append(m[layer][key][0])
    return list(groups.values())


def _pack_minis(minis: List[Cache], out: Cache) -> None:
    """Stack K B=1 admission caches into rows [0, K) of *out*, in place
    (the ragged packed prefill's batch)."""
    for rows, mini_rows in _row_pairs(out, minis):
        torch._foreach_copy_(rows, mini_rows)


def _unpack_minis(cache: Cache, minis: List[Cache]) -> None:
    """Copy rows [0, K) of *cache* back into the K minis, in place (the
    inverse of :func:`_pack_minis`)."""
    for rows, mini_rows in _row_pairs(cache, minis):
        torch._foreach_copy_(mini_rows, rows)


class _Staging:
    """Pinned host staging for the engine's small host-to-device copies
    (admission's tokens, positions, knob, bias, mask and count rows; the
    block tables and stop ids of a window).  A copy from pageable memory
    waits for the stream, and so for an open decode window; a copy from
    pinned memory does not.  Each pinned block is held until an event
    recorded after its copy says the copy is done, so nothing rewrites
    it while the copy waits behind the window.  On the CPU an array is
    taken as it is."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.device = device
        self._held: list = []

    def _pinned(self, arr) -> torch.Tensor:
        src = torch.from_numpy(np.ascontiguousarray(arr))
        self._held = [(t, e) for t, e in self._held if not e.query()]
        pinned = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        pinned.copy_(src)
        return pinned

    def _hold(self, pinned: torch.Tensor) -> None:
        event = torch.cuda.Event()
        event.record()
        self._held.append((pinned, event))

    def put(self, arr) -> torch.Tensor:
        """*arr* (a numpy array) as a new tensor on the device."""
        if not self.cuda:
            return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)
        pinned = self._pinned(arr)
        out = pinned.to(self.device, non_blocking=True)
        self._hold(pinned)
        return out

    def copy_into(self, dst: torch.Tensor, arr) -> None:
        """Copy *arr* into the device tensor *dst*, in place."""
        if not self.cuda:
            dst.copy_(torch.from_numpy(np.ascontiguousarray(arr)))
            return
        pinned = self._pinned(arr)
        dst.copy_(pinned, non_blocking=True)
        self._hold(pinned)


# -- paged-pool device helpers (kv_pool.PagePool makes the decisions;
# these move the bytes).  Every one writes the pool in place: a captured
# decode step reads the pool by address, so a helper that rebound a
# layer's tensors would leave the graph decoding from a stale pool.


def _device(cache: Cache) -> torch.device:
    return next(iter(cache.values()))["cached_k"].device


def _owned(put, targets, scratch: int):
    """(logical indices, physical pages) of the *targets* entries that
    are not the scratch page, as long tensors on the device (*put* is
    the engine's ``_Staging.put``)."""
    targets = np.asarray(targets, np.int64)
    idx = np.flatnonzero(targets != scratch)
    return put(idx), put(targets[idx])


def _paged_splice(cache: Cache, mini: Cache, targets, scratch: int,
                  slot: int, new_len: int, put) -> None:
    """Scatter a contiguous B=1 *mini* cache into pool pages: logical
    page i of the mini lands in physical page ``targets[i]``; entries
    the slot does not own (shared prefix pages, the unmapped tail) are
    the scratch page and are skipped, so a shared page is never
    written.  Quantized pools quantize on the way in.  Also sets
    ``cache_lens[slot]``."""
    idx, pages = _owned(put, targets, scratch)
    for layer, buf in cache.items():
        pool_k = buf["cached_k"]
        m = mini[layer]
        shape = (len(targets),) + tuple(pool_k.shape[1:])
        mk = m["cached_k"][0].reshape(shape).index_select(0, idx)
        mv = m["cached_v"][0].reshape(shape).index_select(0, idx)
        if "k_scale" in buf:
            kq, ks = quantize_kv_rows(mk)
            vq, vs = quantize_kv_rows(mv)
            pool_k.index_copy_(0, pages, kq)
            buf["cached_v"].index_copy_(0, pages, vq)
            buf["k_scale"].index_copy_(0, pages, ks)
            buf["v_scale"].index_copy_(0, pages, vs)
        else:
            pool_k.index_copy_(0, pages, mk.to(pool_k.dtype))
            buf["cached_v"].index_copy_(0, pages, mv.to(pool_k.dtype))
        buf["cache_lens"][slot].fill_(new_len)


def _paged_gather_mini(cache: Cache, table_row, dtype, put) -> Cache:
    """One slot's pool pages gathered into a new contiguous B=1 mini
    cache (the paged counterpart of ``_slot_to_mini``: what seeds a
    suffix extend).  The pool is only read.  Quantized pools dequantize
    on the way out.  ``cache_lens`` is a zero the caller sets."""
    row = put(np.asarray(table_row, np.int64))
    out = {}
    for layer, buf in cache.items():
        k, v = buf["cached_k"][row], buf["cached_v"][row]
        if "k_scale" in buf:
            k = dequantize_kv_rows(k, buf["k_scale"][row], dtype)
            v = dequantize_kv_rows(v, buf["v_scale"][row], dtype)
        n_kv, hd = k.shape[-2], k.shape[-1]
        out[layer] = {
            "cached_k": k.reshape(1, -1, n_kv, hd),
            "cached_v": v.reshape(1, -1, n_kv, hd),
            "cache_lens": torch.zeros(1, dtype=torch.int32, device=k.device),
        }
    return out


def _paged_gather_raw(cache: Cache, table_row, put, group=None
                      ) -> Dict[str, dict]:
    """One slot's pool pages in storage form (``[n_tables, page, ...]``,
    int8 and scales when quantized), copied to the host: the snapshot a
    preemption keeps, with the KV heads of every rank of the model axis
    *group* when one is given.  numpy arrays, except bf16 pools, which
    stay torch tensors (numpy has no bfloat16)."""
    row = put(np.asarray(table_row, np.int64))
    out = {}
    for layer, buf in cache.items():
        keys = (("k", "cached_k"), ("v", "cached_v"))
        if "k_scale" in buf:
            keys += (("ks", "k_scale"), ("vs", "v_scale"))
        out[layer] = {name: _to_host(_whole_heads(buf[key][row], group))
                      for name, key in keys}
    return out


def _whole_heads(t: torch.Tensor, group) -> torch.Tensor:
    """A pool slice ``[..., page, Hkv(, Dh)]`` with every rank's KV heads,
    in global order: gathered over the model axis *group* (dim 2), as it
    is without one."""
    if group is None:
        return t
    from . import collectives

    return collectives.all_gather(t, group, dim=2)


def _to_host(t: torch.Tensor):
    t = t.to("cpu")
    return t if t.dtype == torch.bfloat16 else t.numpy()


def _paged_restore_raw(cache: Cache, raw, targets, scratch: int,
                       slot: int, new_len: int, put, heads=(1, 0)) -> None:
    """Scatter a preemption snapshot back into freshly allocated pages
    (*targets*, the scratch page beyond the restored length, which is
    skipped): the inverse of ``_paged_gather_raw``, storage-exact.  A
    pool that holds rank *r* of *m*'s KV heads (*heads* ``(m, r)``)
    takes its heads of the whole snapshot."""
    keys = (("k", "cached_k"), ("v", "cached_v"), ("ks", "k_scale"),
            ("vs", "v_scale"))
    idx, pages = _owned(put, targets, scratch)
    for layer, buf in cache.items():
        for name, key in keys:
            if key not in buf:
                continue
            src = torch.as_tensor(raw[layer][name])
            if heads[0] > 1:
                src = src.chunk(heads[0], dim=2)[heads[1]]
            src = src.to(pages.device)
            if src.dtype != buf[key].dtype:
                raise ValueError(
                    f"checkpoint {layer}/{name} is {src.dtype}, the pool "
                    f"is {buf[key].dtype}")
            buf[key].index_copy_(0, pages, src.index_select(0, idx))
        buf["cache_lens"][slot].fill_(new_len)


def _copy_page(cache: Cache, src: int, dst: int) -> None:
    """Physical page copy in every layer (K, V and scales): the
    copy-on-write data movement behind ``PagePool.cow``."""
    for buf in cache.values():
        for key, t in buf.items():
            if key != "cache_lens":
                t[dst].copy_(t[src])


def _rollback_active(cache: Cache, lens, active) -> None:
    """Set ``cache_lens`` to the [S] vector *lens* where *active*, in
    place, keeping the device value elsewhere (the rollback a jump round
    ends with).  Inactive slots keep their own device lens: lowering a
    released slot's would park later clamped writes on top of its
    prompt rows, the donor rows ``release`` promises stay valid."""
    new = torch.as_tensor(np.asarray(lens, np.int32), device=_device(cache))
    act = torch.as_tensor(np.asarray(active, bool), device=_device(cache))
    for buf in cache.values():
        buf["cache_lens"].copy_(torch.where(act, new, buf["cache_lens"]))


def _lcp(a: np.ndarray, b: np.ndarray) -> int:
    """Longest common prefix of two int token arrays."""
    L = min(len(a), len(b))
    if L == 0:
        return 0
    neq = a[:L] != b[:L]
    idx = int(np.argmax(neq))
    return L if not neq[idx] else idx


def _ngram_propose(seq: np.ndarray, n: int, g: int) -> np.ndarray:
    """Prompt-lookup proposals (vLLM's [ngram] speculative mode): the *g*
    tokens that followed the LATEST earlier occurrence of the sequence's
    final *n*-gram; on a miss, the last token repeated.  Proposals are
    guesses, the verify decides."""
    L = len(seq)
    n = min(n, L - 1)
    out = np.full(g, seq[-1] if L else 0, np.int32)
    if n < 1:
        return out
    key = seq[L - n:]
    # every window against the key in one comparison, latest match
    windows = np.lib.stride_tricks.sliding_window_view(seq[:L - 1], n)
    hits = np.flatnonzero((windows == key).all(axis=1))
    if len(hits):
        i = int(hits[-1])
        cont = seq[i + n:i + n + g]
        out[:len(cont)] = cont
    return out


def _knobs_live_vec(temps, topks, topps, minps, pres, freqs,
                    reps) -> np.ndarray:
    """[S] bool: which slots' sampling knobs are armed."""
    return ((np.asarray(temps) != 0) | (np.asarray(topks) != 0)
            | (np.asarray(topps) < 1.0) | (np.asarray(minps) != 0)
            | (np.asarray(pres) != 0) | (np.asarray(freqs) != 0)
            | (np.asarray(reps) != 1.0))


def _knobs_live(temps, topks, topps, minps, pres, freqs, reps) -> bool:
    """True when any slot's knobs are armed: the predicate the draw
    accounting hangs on.  The greedy fast path, a window's sampled flag
    and its draw count must all agree, or ``step`` and ``run_scan``
    would leave different draw counters behind.  Penalties arm it too
    (a penalised temperature-0 request needs the full pick)."""
    return bool(_knobs_live_vec(temps, topks, topps, minps, pres,
                                freqs, reps).any())


def _bump_counts(counts: torch.Tensor, tokens: torch.Tensor) -> None:
    """counts[s, tokens[s]] += 1 for every row, in place (each row gets
    one add, so the order of the adds does not matter)."""
    counts.scatter_add_(1, tokens.long()[:, None],
                        torch.ones_like(counts[:, :1]))


def _apply_penalties(logits, pres, freqs, reps, counts, seen):
    """vLLM's penalties on the raw logits (before temperature).
    Repetition first, over tokens seen in the prompt or the output
    (positive logits divide by r, negative multiply; r = 1 is exactly
    off), then presence and frequency over the output histogram (0 is
    exactly off)."""
    r = reps[:, None]
    logits = torch.where(seen > 0, torch.where(logits > 0, logits / r,
                                               logits * r), logits)
    out_seen = (counts > 0).to(torch.float32)
    return logits - pres[:, None] * out_seen - freqs[:, None] * counts


def _pick_tokens(logits, temps, topks, topps, minps, pres, freqs, reps,
                 counts, seen, keys):
    """Per-slot sampling in one pass over [S, V] logits: temperature (0 =
    greedy), top-k (0 = all), top-p (1 = all), min-p (0 = all),
    presence/frequency penalties over *counts* and the repetition
    penalty over *seen*; every knob an [S] tensor, so mixed batches
    share one step.  Gumbel-max: the argmax of the filtered scaled
    logits plus noise drawn from ``keys[s]`` is a draw from their
    softmax, and zero noise where the temperature is 0 gives greedy.
    One descending sort serves both filters: top-k keeps the logits at
    or above the k-th largest (a per-row rank read from the sorted
    row, so k is data); top-p keeps the smallest prefix of the
    temperature-scaled top-k distribution whose mass reaches p (the
    argmax always survives); min-p then keeps tokens within log(min_p)
    of the surviving maximum.  Nothing here synchronises with the
    host."""
    S, V = logits.shape
    logits = _apply_penalties(logits.to(torch.float32), pres, freqs, reps,
                              counts, seen)
    safe_t = torch.where(temps > 0, temps, 1.0)
    scaled = logits / safe_t[:, None]
    k_eff = torch.where(topks > 0, topks, V).long()
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    kth = sorted_desc.gather(1, (k_eff - 1)[:, None])
    masked = torch.where(logits >= kth, scaled, float("-inf"))
    sorted_scaled = sorted_desc / safe_t[:, None]
    in_topk = (torch.arange(V, device=logits.device)[None, :]
               < k_eff[:, None])
    sorted_masked = torch.where(in_topk, sorted_scaled, float("-inf"))
    probs_sorted = torch.softmax(sorted_masked, dim=-1)
    before = torch.cumsum(probs_sorted, dim=-1) - probs_sorted
    keep = before < topps[:, None]
    n_keep = torch.clamp(keep.sum(dim=-1), min=1)
    pth = sorted_scaled.gather(1, (n_keep - 1)[:, None])
    masked = torch.where(scaled >= pth, masked, float("-inf"))
    mmax = masked.max(dim=-1, keepdim=True).values
    thresh = mmax + torch.log(torch.clamp(minps, min=1e-30))[:, None]
    masked = torch.where((minps[:, None] > 0) & (scaled < thresh),
                         float("-inf"), masked)
    noise = gumbel_rows(keys, V)
    noised = masked + torch.where(temps[:, None] > 0, noise, 0.0)
    return torch.argmax(noised, dim=-1)


def _top_logprobs(logits, chosen, k: int):
    """log-softmax stats of the emitted tokens: ([S] chosen logprob,
    [S, k] top-k logprobs, [S, k] top-k ids), on the raw logits."""
    lp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    top_lp, top_id = torch.topk(lp, k, dim=-1)
    chosen_lp = lp.gather(1, chosen.long()[:, None])[:, 0]
    return chosen_lp, top_lp, top_id


class _Window:
    """The static device buffers of the decode step: an int64 block of
    [S] rows (``_IROWS``) and four scalars, an f32 block of [S] knob rows
    (``_FROWS``), and the outputs of up to ``max_len`` steps.  The host
    fills the two blocks once a window, through one copy each; the
    step reads them, writes its outputs at row ``step`` and advances
    ``tok``, ``pos``, ``step``, ``fin`` and ``frs`` in place."""

    def __init__(self, n_slots: int, steps: int, lp_k: int, device):
        S, R = n_slots, len(_IROWS)
        self.ints = torch.zeros(R * S + len(_SCALARS), dtype=torch.int64,
                                device=device)
        self.floats = torch.zeros(len(_FROWS), S, dtype=torch.float32,
                                  device=device)
        pin = device.type == "cuda"
        self.ints_host = torch.zeros(self.ints.shape, dtype=torch.int64,
                                     pin_memory=pin)
        self.floats_host = torch.zeros(self.floats.shape,
                                       dtype=torch.float32, pin_memory=pin)
        rows = self.ints[:R * S].view(R, S)
        for j, name in enumerate(_IROWS):
            setattr(self, name, rows[j])
        for j, name in enumerate(_SCALARS):
            setattr(self, name, self.ints[R * S + j:R * S + j + 1])
        for j, name in enumerate(_FROWS):
            setattr(self, name, self.floats[j])
        self.out_tok = torch.zeros(steps, S, dtype=torch.int32,
                                   device=device)
        k = max(lp_k, 1)
        self.out_clp = torch.zeros(steps, S, dtype=torch.float32,
                                   device=device)
        self.out_tlp = torch.zeros(steps, S, k, dtype=torch.float32,
                                   device=device)
        self.out_tid = torch.zeros(steps, S, k, dtype=torch.int64,
                                   device=device)
        # stop-id matrices by width K (fused windows)
        self.stops: Dict[int, torch.Tensor] = {}
        # mark the end of the last copy out of the pinned blocks, and of
        # a window's outputs back to the host
        cuda = device.type == "cuda"
        self._copied = torch.cuda.Event() if cuda else None
        self._fetched = torch.cuda.Event() if cuda else None

    def load(self, ints: dict, floats: dict) -> None:
        """Write every row and scalar, then copy both blocks to the
        device (asynchronously from pinned memory on CUDA, so the host
        first waits for the previous copy out of them)."""
        S, R = self.floats.shape[1], len(_IROWS)
        if self._copied is not None:
            self._copied.synchronize()
        ih = self.ints_host.numpy()
        for j, name in enumerate(_IROWS):
            ih[j * S:(j + 1) * S] = ints[name]
        for j, name in enumerate(_SCALARS):
            ih[R * S + j] = ints[name]
        fh = self.floats_host.numpy()
        for j, name in enumerate(_FROWS):
            fh[j] = floats[name]
        self.ints.copy_(self.ints_host, non_blocking=True)
        self.floats.copy_(self.floats_host, non_blocking=True)
        if self._copied is not None:
            self._copied.record()

    def fetch(self, n_steps: int, lp: bool, fused: bool) -> list:
        """The window's outputs as host arrays, after one wait for the
        device: the tokens [n_steps, S], with *lp* the logprob stats,
        with *fused* ``fin`` and ``frs``."""
        outs = [self.out_tok[:n_steps]]
        if lp:
            outs += [self.out_clp[:n_steps], self.out_tlp[:n_steps],
                     self.out_tid[:n_steps]]
        if fused:
            outs += [self.fin, self.frs]
        pin = self._fetched is not None
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
                for t in outs]
        for h, t in zip(host, outs):
            h.copy_(t, non_blocking=True)
        if pin:
            self._fetched.record()
            self._fetched.synchronize()
        return [h.numpy() for h in host]

    def load_stops(self, mat: torch.Tensor) -> None:
        """Copy the stop-id matrix (on the device) into the buffer of its
        width."""
        buf = self.stops.get(mat.shape[1])
        if buf is None:
            buf = self.stops[mat.shape[1]] = torch.zeros(
                mat.shape, dtype=torch.int64, device=self.ints.device)
        buf.copy_(mat)


class _PrefillJob:
    """One admission prefill, advanced one extend at a time: the prompt
    cut into fixed-size chunks (the last one zero-padded; its padding
    lands beyond the true length, which the final ``cache_lens`` fix
    restores), or one extend of the whole prompt on an unchunked
    engine.  With *plp_k*, each chunk's prompt-logprob stats (row j
    scores the next prompt token) are appended to *plp_out*.  The serial
    and the packed paths build a chunk's operands and absorb its logits
    through the same methods; only the extend is batched.

    ``packable`` gates the packed path: a fixed chunk grid (an unchunked
    job is one extend of its own length), no prompt-logprob capture, and
    no expert FFN (expert capacity couples the rows of a batch).
    *adapter* is the request's LoRA adapter id (-1 = none)."""

    __slots__ = ("eng", "mini", "toks", "start", "n", "c", "total", "i",
                 "last", "counted", "plp_k", "plp_out", "packable",
                 "packed_used", "aid")

    def __init__(self, eng: "ServingEngine", mini: Cache,
                 toks_np: np.ndarray, start: int, plp_k: int = 0,
                 plp_out: Optional[list] = None, adapter: int = -1):
        n = int(toks_np.shape[1])
        self.eng = eng
        self.aid = adapter
        self.mini = mini
        self.start = start
        self.n = n
        self.plp_k = plp_k
        self.plp_out = plp_out
        self.last = None
        self.i = 0
        self.counted = False
        self.packed_used = False
        c = eng.chunk
        if c is None:
            self.c = n
            self.total = 1
            self.toks = toks_np
            self.packable = False
            return
        padded = ((n + c - 1) // c) * c
        if start + padded > eng.model.max_len:
            raise ValueError(
                f"padded prompt {start + padded} exceeds max_len "
                f"{eng.model.max_len} (shrink chunk or prompt)")
        self.toks = np.concatenate(
            [toks_np, np.zeros((1, padded - n), np.int32)], axis=1)
        self.c = c
        self.total = padded // c
        self.packable = plp_k == 0 and eng.model.n_experts == 0

    @property
    def remaining(self) -> int:
        return self.total - self.i

    def close(self) -> None:
        """Abandon the job (abort_admit)."""
        self.i = self.total

    def chunk_np(self) -> np.ndarray:
        """Host tokens [1, c] of the next chunk."""
        return self.toks[:, self.i * self.c:(self.i + 1) * self.c]

    def pos_np(self) -> np.ndarray:
        """Host positions [1, c] of the next chunk."""
        return (np.arange(self.c, dtype=np.int32)
                + self.start + self.i * self.c)[None, :]

    def pad_rows(self) -> int:
        """Zero-pad rows in the next chunk (the tail chunk's grid
        padding: the packed path's waste accounting)."""
        lo, hi = self.i * self.c, (self.i + 1) * self.c
        return max(0, hi - max(self.n, lo))

    def charge(self) -> None:
        """Count the prefill tokens once, at the first extend."""
        if not self.counted:
            self.counted = True
            self.eng._prefill_tokens += self.n

    def absorb_logits(self, logits: torch.Tensor) -> None:
        """Keep the last real prompt token's logits row ([V]) of the
        chunk just run (*logits* [c, V]), and its prompt-logprob stats
        when asked.  The row is a copy: a captured extend writes the
        next chunk's logits over the same buffer."""
        if self.plp_k:
            # row j of chunk i scores padded token i*c + j + 1; rows past
            # the prompt score zeros, which the assembly never reads
            i, c = self.i, self.c
            tgt = np.zeros(c, np.int64)
            avail = self.toks.shape[1] - (i * c + 1)
            if avail > 0:
                m = min(c, avail)
                tgt[:m] = self.toks[0, i * c + 1:i * c + 1 + m]
            self.plp_out.append(_top_logprobs(
                logits, self.eng._stage.put(tgt), self.plp_k))
        off = self.n - 1 - self.i * self.c
        if 0 <= off < self.c:
            self.last = logits[off].clone()
        self.i += 1

    def attach_mini(self) -> None:
        """When the job is done, pin ``cache_lens`` back to the true
        length (chunk padding inflated it)."""
        if self.remaining == 0 and self.eng.chunk is not None:
            _set_len(self.mini, 0, self.start + self.n)


class _ChunkBatch:
    """The chunk extend of admission over static buffers: a cache of
    ``pack_width`` rows W, the tokens and positions [W, chunk] (one int32
    block, so a round's inputs are one copy) and, for each count K of
    real rows, the logits [W, chunk, V].  Every chunked admission
    extend, serial (K = 1) or packed, runs its projections and FFN over
    all W rows and its attention row by row over the first K (the other
    rows attend to nothing), so a row's arithmetic never depends on K:
    GEMM libraries choose their blocking, and with it the order of each
    dot product's sums, by the shape (the CPU's f32 extends of B=1 and
    B=3 at a chunk of 4 differ in the last bits; on the H100, bf16 ones
    of B=1 and B=4 at a chunk of 32), while attention costs a row of
    work for each row that attends.  A run copies its K minis into rows
    [0, K), extends once a chunk and copies them back out; rows K..W-1
    compute on whatever they hold, and nothing reads them.  On CUDA the
    extend at each K is captured once as a CUDA graph and replayed;
    with the engine's ``_use_graphs`` off (the CPU, and the card's
    check) it runs op by op on the same buffers.  A model with adapters
    reads each row's adapter id from ``aids`` [W]."""

    def __init__(self, model: DecodeTransformerLM, width: int, chunk: int):
        self.model = model
        self.cache = init_cache(model, width)
        self.inputs = torch.zeros(2, width, chunk, dtype=torch.int32,
                                  device=model.device)
        self.aids = torch.full((width,), -1, dtype=torch.int64,
                               device=model.device)
        self.logits: Dict[int, torch.Tensor] = {}
        self.graphs: Dict[int, "torch.cuda.CUDAGraph"] = {}

    @torch.no_grad()
    def run(self, k: int) -> torch.Tensor:
        """The extend with *k* real rows, op by op; its logits."""
        aids = self.aids if self.model.n_adapters > 0 else None
        self.logits[k] = self.model(self.inputs[0], self.inputs[1],
                                    self.cache, decode=True, attend_rows=k,
                                    adapter_ids=aids)
        return self.logits[k]

    def capture(self, k: int, stream) -> None:
        self.graphs[k] = capture_step(lambda: self.run(k),
                                      cache_lens(self.cache), stream)


class AdmitState:
    """One in-flight admission (begin_admit -> admit_step* ->
    finish_admit): the slot reservation, the validated request knobs,
    the B=1 mini cache being prefilled and, after the finish dispatch,
    the first-token pick still on the device.  ``admit()`` drives one
    of these end to end."""

    __slots__ = (
        "slot", "prompt_np", "t_p", "stops", "temperature", "top_k",
        "top_p", "min_p", "presence_penalty", "frequency_penalty",
        "repetition_penalty", "seed", "seed_stream", "ignore_eos",
        "min_tokens", "lp_n", "plp_n", "logit_bias", "gstart", "canon",
        "auto_src", "gen", "result", "plp_dev", "chunks_total",
        "chunks_done", "pick", "pick_stats", "spliced", "inplace",
        "first_cached", "share_pages", "prefill_end", "aid",
    )

    def __init__(self):
        self.gen = None
        self.result = None
        self.auto_src = None
        self.chunks_total = 0
        self.chunks_done = 0
        self.pick = None
        self.pick_stats = None
        self.spliced = False
        # exact-repeat fast paths: inplace = the donor is the target slot
        # (admission is one cache_lens fix); first_cached = the donor's
        # greedy first token (no pick, no sync)
        self.inplace = False
        self.first_cached = None
        self.plp_dev = []
        # paged: pages this admission maps by reference (the prefix
        # share), their refcounts taken at begin and given back by abort
        # or taken over by the finish-time mapping; and the end of the
        # rows the prefill fills, up to which the slot owns pages
        self.share_pages = []
        self.prefill_end = 0

    @property
    def ready(self) -> bool:
        """All prefill chunks ran; finish_admit may run."""
        return self.gen is None and self.result is not None


class _ScanHandle:
    """One dispatched-but-unharvested window: its static flags and a
    snapshot of who was in it.  ``skip`` collects slots spliced,
    released, preempted or parked after the dispatch (they sat the
    window out)."""

    __slots__ = ("n_steps", "sampled", "lp_k", "grammared", "active",
                 "skip", "fused")

    def __init__(self, n_steps, sampled, lp_k, grammared, active, fused):
        self.n_steps = n_steps
        self.sampled = sampled
        self.lp_k = lp_k
        self.grammared = grammared
        self.active = active
        self.skip = set()
        self.fused = fused


class ServingEngine:
    """Continuous-batching scheduler over one decode step.

    >>> eng = ServingEngine(decoder_model, n_slots=8, eos_id=2)
    >>> s = eng.admit([5, 17, 99])       # returns a slot id
    >>> eng.step(); eng.step()           # decode all active slots
    >>> eng.finished(s), eng.output(s)

    The JAX package's arguments in its order, less ``params`` (the
    model holds its weights), then the device: the model's, which must
    be CUDA unless ``device="cpu"`` is passed.  ``rng`` is an integer
    seed.  ``draft`` is a draft ``DecodeTransformerLM`` (or the
    reference's ``(model, params)`` pair, whose second entry the port
    ignores: the model holds its weights) or ``"ngram"``; ``gamma``
    tokens are proposed a round, ``ngram_n`` is the prompt-lookup
    n-gram.  ``mesh`` splits the model (and the draft) over its
    ``model`` axis (``inference.shard_decoder``; a model built split,
    as ``bench_serving.build_model_and_params(mesh=)`` builds it, is
    taken as it is); it raises ``ValueError`` naming the model axis
    when the query or KV heads do not divide it.
    """

    def __init__(
        self,
        model: DecodeTransformerLM,
        n_slots: int,
        eos_id: Optional[int] = None,
        chunk: Union[int, None, str] = "auto",
        prefix_chunk: Union[int, None, str] = "auto",
        max_new_tokens: Optional[int] = None,
        mesh=None,
        rng: Optional[int] = None,
        auto_prefix: bool = True,
        auto_prefix_min: int = 8,
        logprobs_k: int = 0,
        draft=None,
        gamma: int = 4,
        ngram_n: int = 3,
        grammar=None,
        jump_len: int = 8,
        kv_paging: bool = False,
        kv_pages: Optional[int] = None,
        kv_page_size: int = 0,
        kv_dtype: Optional[str] = None,
        prefix_registry_max: int = 256,
        fused_decode: bool = False,
        device=None,
    ):
        device = resolve_device(device)
        if device.type != model.device.type or (
                device.index is not None and device != model.device):
            raise ValueError(f"the model lives on {model.device}, not on "
                             f"{device}")
        device = model.device
        if n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        if logprobs_k < 0:
            raise ValueError("logprobs_k must be >= 0")
        if logprobs_k > model.vocab:
            raise ValueError(f"logprobs_k {logprobs_k} exceeds the vocab "
                             f"{model.vocab}")
        if chunk == "auto":
            if prefix_chunk is None:
                chunk = _resolve_chunk(model.max_len)
            elif prefix_chunk == "auto":
                chunk = (_resolve_chunk(model.max_len, cap=PREFIX_CHUNK)
                         or _resolve_chunk(model.max_len))
            elif isinstance(prefix_chunk, str):
                raise ValueError(
                    f"prefix_chunk must be an int, None, or 'auto', "
                    f"got {prefix_chunk!r}")
            else:
                if prefix_chunk < 1:
                    raise ValueError("prefix_chunk must be >= 1")
                if model.max_len % prefix_chunk:
                    raise ValueError(
                        f"prefix_chunk {prefix_chunk} must divide "
                        f"max_len {model.max_len} (a divisor is what "
                        "guarantees chunk padding never overflows the "
                        "cache)")
                chunk = prefix_chunk
        elif isinstance(chunk, str):
            raise ValueError(f"chunk must be an int, None, or 'auto', "
                             f"got {chunk!r}")
        elif prefix_chunk != "auto":
            raise ValueError(
                "pass chunk OR prefix_chunk, not both: an explicit "
                "chunk already pins the admission/APC grid")
        if chunk is not None and chunk < 1:
            raise ValueError("chunk must be >= 1 when set")
        if prefix_registry_max < 1:
            raise ValueError("prefix_registry_max must be >= 1")
        if jump_len < 1:
            raise ValueError("jump_len must be >= 1")
        self.mesh = mesh
        if mesh is not None:
            model = _on_mesh(model, mesh)
        self.model = model
        self.device = device
        self.n_slots = n_slots
        self.eos_id = eos_id
        self.chunk = chunk
        self.max_new_tokens = max_new_tokens
        # the rows of every chunked admission extend (see _ChunkBatch)
        self.pack_width = PACK_WIDTH
        self._stage = _Staging(device)
        # -- paged KV pool (opt-in; the contiguous cache stays the
        # default).  Storage becomes a [P + 1, page, Hkv, Dh] pool per
        # layer and a host allocator with per-slot block tables; decode
        # gathers the pool back into the contiguous view inside the same
        # captured step, so tokens equal the contiguous engine's; int8
        # pool storage (kv_dtype) is the one lossy option
        self._paged = bool(kv_paging)
        self._pool: Optional[PagePool] = None
        self._pmodel = None
        self._btables = None
        self._kv_quant = False
        self._preempt_cb = None
        self._kv_preemptions = 0
        self._park_seq = [0] * n_slots
        self._park_counter = 0
        if kv_paging:
            if chunk is None:
                raise ValueError(
                    "kv_paging needs a chunked engine (pass chunk or "
                    "prefix_chunk; paged splices land whole pages on "
                    "the admission grid)")
            ps = int(kv_page_size) or chunk
            if ps < 1:
                raise ValueError("kv_page_size must be >= 1")
            if model.max_len % ps:
                raise ValueError(
                    f"kv_page_size {ps} must divide max_len "
                    f"{model.max_len}")
            if chunk % ps:
                raise ValueError(
                    f"kv_page_size {ps} must divide the admission "
                    f"chunk {chunk}: APC matches floor to whole "
                    "chunks, and whole-page sharing needs the chunk "
                    "grid to lie on the page grid")
            if kv_dtype not in (None, "int8"):
                raise ValueError(
                    f"kv_dtype must be None or 'int8', got {kv_dtype!r}")
            self._kv_quant = kv_dtype == "int8"
            n_tables = model.max_len // ps
            pages = (int(kv_pages) if kv_pages is not None
                     else n_slots * n_tables)
            self._pool = PagePool(pages, ps, n_slots, model.max_len)
            self._pmodel = model.clone(kv_page_size=ps,
                                       kv_quant=self._kv_quant)
            self.cache = init_pool_cache(model, n_slots, pages, ps,
                                         self._kv_quant)
            # the block tables: a static buffer of the captured step,
            # refreshed in place from the allocator when a window loads
            self._btables = torch.full((n_slots, n_tables), pages,
                                       dtype=torch.int64, device=device)
        else:
            self.cache = init_cache(model, n_slots)
        self.prefix_registry_max = prefix_registry_max
        self._prefix_touch: Dict[int, int] = {}  # handle -> use seq
        self._use_seq = 0
        self.lens = [0] * n_slots          # host mirror of cache_lens
        self.active = [False] * n_slots
        # slots held by an in-flight admission: invisible to
        # free_slots(), inactive for every decode path until spliced
        self._reserved = [False] * n_slots
        self._inflight_scan: Optional[_ScanHandle] = None
        self.last_token = np.zeros(n_slots, np.int32)
        self.outputs: List[List[int]] = [[] for _ in range(n_slots)]
        self._finished: Dict[int, List[int]] = {}
        self._finish_reason: Dict[int, str] = {}
        self._stops: List[frozenset] = [frozenset()] * n_slots
        self._ignore_eos = [False] * n_slots
        # per-request seeds: a seeded slot draws from its own chain,
        # indexed by a per-slot draw counter; the seed and stream are
        # kept for checkpoints, the chain's key for the step
        self._seeds = [0] * n_slots
        self._seed_streams = [0] * n_slots
        self._seed_keys = np.zeros(n_slots, np.int64)
        self._seed_on = np.zeros(n_slots, np.int64)
        self._slot_draws = [0] * n_slots
        # logprobs: top-logprobs_k stats for all slots when a request
        # asks; requests take n <= k and the host trims
        self.logprobs_k = logprobs_k
        self._lp_want = [0] * n_slots
        self._lp_records: List[list] = [[] for _ in range(n_slots)]
        # prompt_logprobs records, filled at admission from the prefill
        # chunks' own logits
        self._prompt_lp: List[list] = [[] for _ in range(n_slots)]
        # registry: handle -> (tokens, B=1 cache, last logits row)
        self._prefixes: Dict[int, tuple] = {}
        self._next_prefix = 0
        # automatic prefix caching on the chunk grid (off unchunked)
        self.auto_prefix = bool(auto_prefix) and chunk is not None
        self.auto_prefix_min = auto_prefix_min
        # per-slot resident prompt, the reference's record: (tokens,
        # adapter id (-1), canon, last logits row, greedy first token or
        # None[, session id]); canon is the prefix length whose rows lie
        # on the chunk grid (or, for a parked session, were written)
        self._slot_prompts: list = [None] * n_slots
        self._prefill_tokens = 0
        self._prefix_hits = 0
        self._prefix_reused_tokens = 0
        self._prefix_evictions = 0
        self._key = prng_key(0 if rng is None else rng)
        self._draws = 0
        self._steps = 0
        self._tokens = 0
        self._completed = 0
        self.temps = np.zeros(n_slots, np.float32)
        self.topks = np.zeros(n_slots, np.int32)
        self.topps = np.ones(n_slots, np.float32)
        self.minps = np.zeros(n_slots, np.float32)
        self.pres = np.zeros(n_slots, np.float32)
        self.freqs = np.zeros(n_slots, np.float32)
        self.reps = np.ones(n_slots, np.float32)
        self.min_toks = np.zeros(n_slots, np.int32)
        self.fused_decode = bool(fused_decode)
        self._fused_windows = 0
        self._fused_truncated = 0
        V = model.vocab
        f32 = dict(dtype=torch.float32, device=device)
        # output histogram (presence/frequency) and prompt+output
        # histogram (repetition), bumped per step while a penalised
        # request is live, reset per slot at each penalised admit
        self._counts = torch.zeros(n_slots, V, **f32)
        self._seen = torch.zeros(n_slots, V, **f32)
        self._zero_vocab_row = torch.zeros(1, V, **f32)
        # logit_bias rows (zero unless the slot's admit set one; a stale
        # row is zeroed at the slot's next unbiased admit)
        self._bias = torch.zeros(n_slots, V, **f32)
        self._bias_on = [False] * n_slots
        # min_tokens: -1e6 over eos and the stop ids while the slot is
        # below its floor
        self._min_mask = torch.zeros(n_slots, V, **f32)
        self._w = _Window(n_slots, model.max_len, logprobs_k, device)
        # the captured decode steps by static variant, their count of
        # replays and the ms all captures took; on the CPU the step runs
        # op by op
        self._use_graphs = capturable(model)
        self._graphs: Dict[tuple, "torch.cuda.CUDAGraph"] = {}
        self._capture_stream = None
        self.graph_replays = 0
        self.graph_captures = 0
        self.capture_ms = 0.0
        # the admission extend's static buffers (a chunked engine's, made
        # at the first chunk), its replays on CUDA and its captures' ms
        self._batch: Optional[_ChunkBatch] = None
        self.extend_replays = 0
        self.extend_capture_ms = 0.0
        # prompt tokens extended, counted at each chunk dispatch with the
        # grid's pad rows left out (``prefill_tokens`` counts a whole
        # admission at its first extend).  Beside stats(), which keeps the
        # reference's keys, as the replay counts are
        self.prefill_chunk_tokens = 0
        # packed-prefill accounting (stats' packed_prefill_* keys)
        self._packed_extends = 0
        self._packed_rows = 0
        self._packed_requests = 0
        self._packed_pad_tokens = 0
        # grammar-constrained decoding: a registry of token-level DFAs
        # in ONE combined [N, V] table with per-grammar state offsets;
        # the mask is derived in-step from the table's reject entries.
        # The device table is read by address by the grammared step:
        # registrations within capacity copy into it, a growth (or the
        # int16 -> int32 widening) allocates a new one and drops the
        # graphs that read the old
        self.jump_len = jump_len
        self._goffsets: List[int] = []
        self._growbounds: List[tuple] = []
        self._gstates_used = 0
        self._gtable_np: Optional[np.ndarray] = None
        self._gtable: Optional[torch.Tensor] = None
        self.gstate = np.full(n_slots, -1, np.int32)
        self._jump_rounds = 0
        self._jump_forced = 0
        if grammar is not None:
            self.register_grammar(grammar)
        # per-slot LoRA adapter ids (-1 = the base model), read by the
        # step only when the model has adapters
        self.adapters = np.full(n_slots, -1, np.int64)
        # speculative decoding: a greedy draft model (with its own
        # [S, max_len] cache) or prompt-lookup n-grams propose gamma
        # tokens a round, one [S, gamma + 1] extend verifies them
        self._draft_model = None
        self._draft_cache: Optional[Cache] = None
        self._ngram = False
        self.ngram_n = ngram_n
        self.gamma = gamma
        self._spec_rounds = 0
        self._spec_proposed = 0
        self._spec_accepted = 0
        if draft == "ngram":
            if gamma < 1:
                raise ValueError("gamma must be >= 1")
            if ngram_n < 1:
                raise ValueError("ngram_n must be >= 1")
            self._ngram = True
        elif draft is not None:
            draft_model = draft[0] if isinstance(draft, tuple) else draft
            if gamma < 1:
                raise ValueError("gamma must be >= 1")
            if draft_model.vocab != model.vocab:
                raise ValueError(
                    f"draft vocab {draft_model.vocab} != target vocab "
                    f"{model.vocab}")
            if draft_model.max_len < model.max_len:
                raise ValueError(
                    f"draft max_len {draft_model.max_len} < target "
                    f"max_len {model.max_len} (the draft cache must "
                    "cover every committable position)")
            if draft_model.device != device:
                raise ValueError(f"the draft lives on {draft_model.device},"
                                 f" the target on {device}")
            if mesh is not None:
                draft_model = _on_mesh(draft_model, mesh, "draft ")
            self._draft_model = draft_model
            self._draft_cache = init_cache(draft_model, n_slots)

    # -- grammars ------------------------------------------------------------

    def register_grammar(self, grammar) -> int:
        """Register a token-level DFA (``grammar.TokenDfa``); returns a
        grammar id for ``admit(grammar=gid)``.  All registered grammars
        share ONE combined ``[N, V]`` table (each grammar's states offset
        into it), packed to int16 while every state id fits.  Capacity
        doubles when a registration outgrows it: the device table is
        then a new tensor, and every captured step that reads the old
        one is dropped (recaptured at its next use, counted in
        ``graph_captures``); a registration within capacity is a copy
        into the same table."""
        if grammar.table.shape[1] != self.model.vocab:
            raise ValueError(
                f"grammar vocab {grammar.table.shape[1]} != model "
                f"vocab {self.model.vocab}")
        n_new = int(grammar.table.shape[0])
        off = self._gstates_used
        need = off + n_new
        cap = 0 if self._gtable_np is None else self._gtable_np.shape[0]
        grown = need > cap
        if grown:
            new_cap = max(64, 1 << (need - 1).bit_length())
            # padding rows are unreachable: every start state and
            # transition stays inside a registered grammar's rows
            dt = np.int16 if new_cap <= 32767 else np.int32
            table = np.full((new_cap, self.model.vocab), -1, dt)
            if self._gtable_np is not None:
                table[:off] = self._gtable_np[:off]
            self._gtable_np = table
        # local state ids shift by this grammar's offset; rejects stay -1
        local = np.asarray(grammar.table, np.int32)
        self._gtable_np[off:need] = np.where(
            local >= 0, local + np.int32(off),
            np.int32(-1)).astype(self._gtable_np.dtype)
        self._gstates_used = need
        self._goffsets.append(off + int(grammar.start))
        self._growbounds.append((off, need))
        if grown:
            self._gtable = torch.from_numpy(self._gtable_np).to(self.device)
            for flags in [f for f in self._graphs if f[7]]:
                del self._graphs[flags]
        else:
            self._gtable[off:need].copy_(
                torch.from_numpy(self._gtable_np[off:need]))
        return len(self._goffsets) - 1

    @property
    def n_grammars(self) -> int:
        """How many grammars are registered (admit gids are
        ``range(n_grammars)``)."""
        return len(self._goffsets)

    def grammar_rel(self, gstate: int) -> int:
        """A combined-table state id -> the grammar-local row index (-1
        stays -1): the engine-portable form a migrated checkpoint
        carries."""
        if gstate < 0:
            return -1
        for off, end in self._growbounds:
            if off <= gstate < end:
                return gstate - off
        raise ValueError(
            f"gstate {gstate} is in no registered grammar's rows")

    def grammar_abs(self, gid: int, rel: int) -> int:
        """Inverse of :meth:`grammar_rel` against THIS engine's table:
        grammar *gid*'s local state *rel* -> combined-table id."""
        if rel < 0:
            return -1
        off, end = self._growbounds[gid]
        if off + rel >= end:
            raise ValueError(
                f"local state {rel} outside grammar {gid}'s "
                f"{end - off} rows")
        return off + rel

    # -- paged-pool plumbing -----------------------------------------------

    @property
    def kv_paging(self) -> bool:
        return self._paged

    def _bt(self) -> torch.Tensor:
        """The block tables' device buffer, refreshed in place from the
        allocator when its mappings changed (the captured steps read it
        by address)."""
        pool = self._pool
        assert pool is not None
        if pool.dirty:
            self._btables.copy_(self._stage.put(pool.tables))
            pool.dirty = False
        return self._btables

    def set_preempt_cb(self, cb) -> None:
        """Install a preemption policy: ``cb(exclude_slot) -> bool``
        must free pool pages (typically by preempting a slot through
        :meth:`preempt`) and return whether it made progress.  The
        engine calls it only after reclaiming parked donor pages failed
        to satisfy an allocation."""
        self._preempt_cb = cb

    def _alloc_page(self) -> int:
        assert self._pool is not None
        while True:
            try:
                return self._pool.alloc()
            except PagePoolExhausted:
                if self._reclaim_parked():
                    continue
                if (self._preempt_cb is not None
                        and self._preempt_cb(-1)):
                    continue
                raise

    def _alloc_pages(self, n: int) -> List[int]:
        """*n* pages for a resume, reclaiming parked donor pages (but
        never preempting: the resuming request is itself the yielding
        party); all or none."""
        pool = self._pool
        assert pool is not None
        got: List[int] = []
        try:
            for _ in range(n):
                while True:
                    try:
                        got.append(pool.alloc())
                        break
                    except PagePoolExhausted:
                        if not self._reclaim_parked():
                            raise
        except PagePoolExhausted:
            for p in got:
                pool.give_back(p)
            raise
        return got

    def _reclaim_parked(self) -> bool:
        """Evict the least-recently-parked donor record whose pages only
        the record pins."""
        assert self._pool is not None
        best = None
        for s in range(self.n_slots):
            if (self.active[s] or self._reserved[s]
                    or self._slot_prompts[s] is None
                    or not self._pool.mapped(s)):
                continue
            if best is None or self._park_seq[s] < self._park_seq[best]:
                best = s
        if best is None:
            return False
        self._drop_donor(best)
        return True

    def _drop_donor(self, slot: int) -> None:
        assert self._pool is not None
        self._pool.clear_slot(slot)
        self._slot_prompts[slot] = None
        self._prefix_evictions += 1

    def _make_writable(self, slot: int, idx: int) -> None:
        """Guarantee (slot, idx) maps a page this slot may append into:
        map a fresh page, or copy a shared one on write."""
        pool = self._pool
        assert pool is not None
        e = pool.entry(slot, idx)
        if e == pool.scratch:
            pool.map(slot, idx, self._alloc_page())
        elif not pool.writable(slot, idx):
            new = self._alloc_page()
            _copy_page(self.cache, e, new)
            pool.cow(slot, idx, new)

    def _ensure_append_pages(self, n_new: int) -> None:
        """Page budget before a decode dispatch: every active slot gets
        writable pages covering its next *n_new* appends (fresh pages
        past the prefill, copy-on-write where a shared page is about to
        be written), so the block tables stay fixed for the window.
        Allocation failure escalates: reclaim, then the preemption
        callback, then ``PagePoolExhausted``."""
        if not self._paged:
            return
        assert self._pool is not None
        for s in range(self.n_slots):
            if not self.active[s]:
                continue
            start = self.lens[s]
            if start >= self.model.max_len:
                continue
            end = min(start + n_new, self.model.max_len)
            for idx in self._pool.pages_for(start, end):
                if not self.active[s]:
                    break  # the preemption policy evicted this slot
                self._make_writable(s, idx)

    def _table_targets(self, slot: int, lo: int, hi: int) -> np.ndarray:
        """[n_tables] physical pages of *slot*'s entries [lo, hi), the
        scratch page elsewhere."""
        pool = self._pool
        targets = np.full(pool.n_tables, pool.scratch, np.int64)
        targets[lo:hi] = pool.tables[slot, lo:hi]
        return targets

    def _restore_pages(self, raw, tokens: int, slot: int,
                       new_len: int) -> None:
        """Map fresh pages for the first *tokens* rows of *slot* and
        scatter the storage snapshot *raw* into them."""
        pool = self._pool
        got = self._alloc_pages(pool.pages_needed(tokens))
        for idx, p in enumerate(got):
            pool.map(slot, idx, p)
        _paged_restore_raw(self.cache, raw,
                           self._table_targets(slot, 0, len(got)),
                           pool.scratch, slot, new_len, self._stage.put,
                           (self.model.tp_size, self.model.tp_rank))

    def _free_slot_for_restore(self) -> int:
        free = self.free_slots()
        if not free:
            raise RuntimeError("no free slots")
        slot = free[0]
        if self._slot_prompts[slot] is not None:
            self._drop_donor(slot)
        self._pool.clear_slot(slot)
        return slot

    def preempt(self, slot: int) -> Dict[str, object]:
        """Preemption by page eviction: checkpoint an ACTIVE slot's KV
        pages to the host (storage-exact: int8 pools keep their raw
        bytes and scales), free the pages, and return the state
        :meth:`resume` re-admits from, with the reference's keys.  Host
        bookkeeping (outputs, knobs, draw chains, grammar state) rides
        the state; penalty histograms are rebuilt from token counts at
        resume.  Greedy, seeded and grammar streams continue
        bit-identically after the resume."""
        if not self._paged:
            raise RuntimeError("preemption needs kv_paging=True")
        assert self._pool is not None
        if not self.active[slot]:
            raise ValueError(f"slot {slot} is not active")
        raw = _paged_gather_raw(self.cache, self._pool.tables[slot],
                                self._stage.put, self.model.tp_group)
        rec = self._slot_prompts[slot]
        if rec is not None and isinstance(rec[3], torch.Tensor):
            rec = rec[:3] + (rec[3].to("cpu").numpy(),) + rec[4:]
        state: Dict[str, object] = {
            "kv": raw,
            "lens": int(self.lens[slot]),
            "outputs": list(self.outputs[slot]),
            "last_token": int(self.last_token[slot]),
            "record": rec,
            "stops": self._stops[slot],
            "ignore_eos": self._ignore_eos[slot],
            "temperature": float(self.temps[slot]),
            "top_k": int(self.topks[slot]),
            "top_p": float(self.topps[slot]),
            "min_p": float(self.minps[slot]),
            "presence_penalty": float(self.pres[slot]),
            "frequency_penalty": float(self.freqs[slot]),
            "repetition_penalty": float(self.reps[slot]),
            "adapter": int(self.adapters[slot]),
            "seed": int(self._seeds[slot]),
            "seed_stream": int(self._seed_streams[slot]),
            "seed_on": int(self._seed_on[slot]),
            "slot_draws": int(self._slot_draws[slot]),
            "lp_want": int(self._lp_want[slot]),
            "lp_records": list(self._lp_records[slot]),
            "prompt_lp": list(self._prompt_lp[slot]),
            "min_toks": int(self.min_toks[slot]),
            "gstate": int(self.gstate[slot]),
            "bias": (self._bias[slot].to("cpu").numpy()
                     if self._bias_on[slot] else None),
        }
        self.active[slot] = False
        self._pool.clear_slot(slot)
        self._slot_prompts[slot] = None
        self.lens[slot] = 0
        self._reset_slot_params(slot)
        self._kv_preemptions += 1
        if self._inflight_scan is not None:
            # a window dispatched before the preemption must not advance
            # host mirrors the resume will overwrite
            self._inflight_scan.skip.add(slot)
        return state

    def resume(self, state: Dict[str, object]) -> int:
        """Re-admit a :meth:`preempt` checkpoint (this engine's or the
        JAX package's, through the ``migrate`` codec) into a free slot:
        allocate pages, scatter the snapshot back, restore every host
        mirror.  Raises RuntimeError (no free slot) or PagePoolExhausted
        (still under pressure); the caller re-queues and retries."""
        if not self._paged:
            raise RuntimeError("preemption needs kv_paging=True")
        self._check_adapter(None if int(state["adapter"]) < 0
                            else int(state["adapter"]))
        slot = self._free_slot_for_restore()
        lens = int(state["lens"])
        self._restore_pages(state["kv"], lens, slot, lens)
        V = self.model.vocab
        rec = state["record"]
        if rec is not None:
            rec = tuple(rec)
            last = rec[3]
            if last is not None:
                last = torch.as_tensor(np.asarray(last, np.float32)).to(
                    self.device)
            rec = (np.asarray(rec[0], np.int32), int(rec[1]), int(rec[2]),
                   last) + rec[4:]
        self.lens[slot] = lens
        self.outputs[slot] = [int(t) for t in state["outputs"]]
        self.last_token[slot] = int(state["last_token"])
        self._slot_prompts[slot] = rec
        self._stops[slot] = frozenset(int(t) for t in state["stops"])
        self._ignore_eos[slot] = bool(state["ignore_eos"])
        self.temps[slot] = state["temperature"]
        self.topks[slot] = state["top_k"]
        self.topps[slot] = state["top_p"]
        self.minps[slot] = state["min_p"]
        self.pres[slot] = state["presence_penalty"]
        self.freqs[slot] = state["frequency_penalty"]
        self.reps[slot] = state["repetition_penalty"]
        self.adapters[slot] = int(state["adapter"])
        self._seeds[slot] = int(state["seed"])
        self._seed_streams[slot] = int(state["seed_stream"])
        self._seed_on[slot] = int(state["seed_on"])
        self._seed_keys[slot] = (seed_key(self._seeds[slot],
                                          self._seed_streams[slot])
                                 if self._seed_on[slot] else 0)
        self._slot_draws[slot] = int(state["slot_draws"])
        self._lp_want[slot] = int(state["lp_want"])
        self._lp_records[slot] = list(state["lp_records"])
        self._prompt_lp[slot] = list(state["prompt_lp"])
        self.min_toks[slot] = int(state["min_toks"])
        self.gstate[slot] = int(state["gstate"])
        self._finished.pop(slot, None)
        self._finish_reason.pop(slot, None)
        # penalty histograms rebuild exactly: every device increment was
        # +1.0 on f32 counts, so host bincounts reproduce them
        if state["presence_penalty"] or state["frequency_penalty"]:
            cnt = np.bincount(np.asarray(state["outputs"], np.int64),
                              minlength=V).astype(np.float32)
            self._counts[slot].copy_(torch.from_numpy(cnt))
        if state["repetition_penalty"] != 1.0:
            hist = [int(t) for t in state["outputs"]]
            if rec is not None:
                hist = np.asarray(rec[0], np.int64).tolist() + hist
            seen = np.bincount(np.asarray(hist, np.int64),
                               minlength=V).astype(np.float32)
            self._seen[slot].copy_(torch.from_numpy(seen))
        if state["bias"] is not None:
            self._bias[slot].copy_(torch.as_tensor(
                np.asarray(state["bias"], np.float32)))
            self._bias_on[slot] = True
        elif self._bias_on[slot]:
            self._bias[slot].zero_()
            self._bias_on[slot] = False
        if state["min_toks"]:
            mask_np = np.zeros(V, np.float32)
            if self.eos_id is not None:
                mask_np[self.eos_id] = -1e6
            for t in state["stops"]:
                mask_np[int(t)] = -1e6
            self._min_mask[slot].copy_(torch.from_numpy(mask_np))
        self.active[slot] = True
        if self._inflight_scan is not None:
            self._inflight_scan.skip.add(slot)
        return slot

    # -- session tiering (the device tier of a conversation's KV) ----------

    def park_session(self, slot: int, session_id: str, kept: int) -> int:
        """Park a retired request's slot as the device tier of its
        conversation: pages stay mapped, the resident-prompt record is
        rewritten to cover the whole conversation (prompt + the *kept*
        output tokens), and the slot turns RESERVED: free_slots() skips
        it and :meth:`_reclaim_parked` cannot take its pages.  Rows are
        reusable up to ``canon`` = rows actually written (a token's K/V
        is written when it is fed, one step after it is sampled).
        Returns canon."""
        if not self._paged:
            raise RuntimeError("session parking needs kv_paging=True")
        rec = self._slot_prompts[slot]
        if rec is None:
            raise ValueError(f"slot {slot} has no resident record")
        if not session_id:
            raise ValueError("empty session_id")
        prompt_np = np.asarray(rec[0], np.int32)
        outs = np.asarray(self.outputs[slot][:kept], np.int32)
        tokens = (np.concatenate([prompt_np, outs])
                  if outs.size else prompt_np)
        canon = min(int(self.lens[slot]), int(tokens.shape[0]))
        if self._draft_model is not None or self._ngram:
            # parked rows stay below the clamped verify band
            # [max_len - gamma - 1, max_len - 1] (see begin_admit)
            canon = min(canon, self.model.max_len - self.gamma - 1)
        canon = max(canon, 0)
        self.active[slot] = False
        self._finished.pop(slot, None)
        self._finish_reason.pop(slot, None)
        self.lens[slot] = 0
        self._slot_prompts[slot] = (tokens, int(rec[1]), canon, None, None,
                                    session_id)
        self._reserved[slot] = True
        self._reset_slot_params(slot)
        if self._inflight_scan is not None:
            self._inflight_scan.skip.add(slot)
        return canon

    def _parked_record(self, slot: int):
        rec = self._slot_prompts[slot]
        if not self._reserved[slot] or rec is None or len(rec) < 6:
            raise ValueError(f"slot {slot} holds no parked session")
        return rec

    def demote_session(self, slot: int) -> Dict[str, object]:
        """Checkpoint a session-parked slot to the host and free its
        pages and slot (the device -> host tier transition).
        Storage-exact like :meth:`preempt`; the state is what
        :meth:`resume_session`, or the ``migrate`` codec, re-parks
        from."""
        if not self._paged:
            raise RuntimeError("session tiering needs kv_paging=True")
        rec = self._parked_record(slot)
        state: Dict[str, object] = {
            "v": 1,
            "kind": "session",
            "session_id": rec[5],
            "tokens": np.asarray(rec[0], np.int32),
            "canon": int(rec[2]),
            "adapter": int(rec[1]),
            "kv": _paged_gather_raw(self.cache, self._pool.tables[slot],
                                    self._stage.put, self.model.tp_group),
        }
        self._pool.clear_slot(slot)
        self._slot_prompts[slot] = None
        self._reserved[slot] = False
        self.lens[slot] = 0
        if self._inflight_scan is not None:
            self._inflight_scan.skip.add(slot)
        return state

    def resume_session(self, state: Dict[str, object]) -> int:
        """Re-park a :meth:`demote_session` checkpoint into a free slot:
        pages re-allocate (reclaiming anonymous parked donors under
        pressure, never preempting), the raw KV scatters back, and the
        slot comes back RESERVED and inactive, the state
        :meth:`park_session` leaves.  Raises RuntimeError (no free
        slot), PagePoolExhausted, or ValueError (malformed state)."""
        if not self._paged:
            raise RuntimeError("session tiering needs kv_paging=True")
        sid = state.get("session_id")
        if not isinstance(sid, str) or not sid:
            raise ValueError("session state carries no session_id")
        if state.get("kind") != "session":
            raise ValueError(
                f"not a session checkpoint: kind={state.get('kind')!r}")
        tokens = np.asarray(state["tokens"], np.int32).reshape(-1)
        canon = int(state["canon"])
        if not 0 <= canon <= min(int(tokens.shape[0]), self.model.max_len):
            raise ValueError(f"bad session canon {canon}")
        self._check_adapter(None if int(state["adapter"]) < 0
                            else int(state["adapter"]))
        slot = self._free_slot_for_restore()
        self._restore_pages(state["kv"], canon, slot, canon)
        self.lens[slot] = 0
        self._slot_prompts[slot] = (tokens, int(state["adapter"]), canon,
                                    None, None, sid)
        self._reserved[slot] = True
        self._finished.pop(slot, None)
        self._finish_reason.pop(slot, None)
        self._reset_slot_params(slot)
        if self._inflight_scan is not None:
            self._inflight_scan.skip.add(slot)
        return slot

    def discard_session(self, slot: int) -> None:
        """Drop a parked session outright: pages freed, record gone,
        slot unreserved."""
        self._parked_record(slot)
        self._pool.clear_slot(slot)
        self._slot_prompts[slot] = None
        self._reserved[slot] = False
        self.lens[slot] = 0

    def session_slots(self) -> Dict[str, int]:
        """Map of session_id -> slot for every device-parked session."""
        out: Dict[str, int] = {}
        for s, rec in enumerate(self._slot_prompts):
            if rec is not None and len(rec) > 5 and self._reserved[s]:
                out[rec[5]] = s
        return out

    # -- admission ---------------------------------------------------------

    @property
    def scan_inflight(self) -> bool:
        """A dispatched-but-unharvested window is open."""
        return self._inflight_scan is not None

    def free_slots(self) -> List[int]:
        return [s for s in range(self.n_slots)
                if not self.active[s] and not self._reserved[s]]

    def _extend_prompt(self, mini: Cache, toks: np.ndarray, start: int,
                       adapter: int = -1):
        """Push *toks* [1, n] into *mini* from depth *start*; returns
        (mini, the last real token's logits row)."""
        job = _PrefillJob(self, mini, toks, start, adapter=adapter)
        self._advance_jobs([job], job.remaining)
        return job.mini, job.last

    @torch.no_grad()
    def _draft_prefill(self, prompt_np: np.ndarray) -> Cache:
        """Cold prefill of the draft with the whole prompt [1, n] on the
        engine's chunk grid (the target's rows cannot seed another
        model's cache), op by op; a B=1 draft cache holding n rows."""
        n = int(prompt_np.shape[1])
        mini = init_cache(self._draft_model, 1)
        c = self.chunk
        put = self._stage.put
        if c is None:
            extend_step(self._draft_model, mini, put(prompt_np.astype(
                np.int64)), put(np.arange(n, dtype=np.int32)[None, :]))
            return mini
        padded = ((n + c - 1) // c) * c
        toks = np.zeros((1, padded), np.int64)
        toks[0, :n] = prompt_np[0]
        for i in range(padded // c):
            extend_step(self._draft_model, mini,
                        put(toks[:, i * c:(i + 1) * c]),
                        put((np.arange(c, dtype=np.int32) + i * c)[None, :]))
        _set_len(mini, 0, n)
        return mini

    def _check_adapter(self, adapter) -> int:
        """The request's adapter id, -1 for none; raises for a model
        without adapters or an id outside [0, n_adapters)."""
        if adapter is None:
            return -1
        if self.model.n_adapters == 0:
            raise ValueError(
                "model was built without LoRA adapters (n_adapters=0)")
        if not 0 <= adapter < self.model.n_adapters:
            raise ValueError(
                f"adapter {adapter} outside [0, {self.model.n_adapters})")
        return int(adapter)

    def _auto_match(self, pnp: np.ndarray, t_p: int, aid: int = -1,
                    session: Optional[str] = None):
        """The best automatic prefix donor for the prompt: the registry
        entry or resident slot prompt sharing the longest common prefix,
        in whole chunks and capped at t_p - 1 (the last prompt token
        recomputes, for its logits row).  An exact repeat of a registered
        or resident prompt reuses its stored logits row too, with no
        extend at all ("reg_full" / "slot_full", m = t_p).  Session
        records (see :meth:`park_session`) are private to their
        conversation: other traffic never matches them, and the owning
        session's request matches its own record first.  Donors are
        bound to the adapter *aid* they were prefilled with (the adapter
        shapes the K/V).  Returns (kind, ref, m) or None."""
        if not self.auto_prefix:
            return None
        c = self.chunk
        best = None
        best_m = 0
        for h, (ptoks, _pc, _pl, paid) in self._prefixes.items():
            if paid != aid:
                continue
            lcp = _lcp(pnp, ptoks)
            if lcp == t_p == len(ptoks):
                return ("reg_full", h, t_p)
            m = (min(lcp, t_p - 1) // c) * c
            if m > best_m:
                best_m, best = m, ("reg", h, m)
        for s, rec in enumerate(self._slot_prompts):
            if rec is None:
                continue
            rec_sess = rec[5] if len(rec) > 5 else None
            if rec_sess is not None and rec_sess != session:
                continue  # another conversation's decode rows
            stoks, said, canon = rec[0], rec[1], rec[2]
            if said != aid:
                continue
            lcp = _lcp(pnp, stoks)
            if rec_sess is not None:
                # the conversation's own parked rows win outright
                m = (min(lcp, canon, t_p - 1) // c) * c
                if m >= max(1, self.auto_prefix_min):
                    return ("slot", s, m)
                continue
            if (lcp == t_p == len(stoks) and canon == t_p
                    and rec[3] is not None):
                return ("slot_full", s, t_p)
            m = (min(lcp, canon, t_p - 1) // c) * c
            if m > best_m:
                best_m, best = m, ("slot", s, m)
        if best_m < max(1, self.auto_prefix_min):
            return None
        return best

    def _touch_prefix(self, handle: int) -> None:
        """LRU stamp: a registry entry was used."""
        self._use_seq += 1
        self._prefix_touch[handle] = self._use_seq

    def register_prefix(self, tokens, adapter: Optional[int] = None) -> int:
        """Prefill a shared prompt prefix once and reuse it:
        ``admit(prompt, prefix=handle)`` skips recomputing its
        positions.  Returns an opaque handle.  The registry holds at
        most ``prefix_registry_max`` entries (each a full B=1 cache);
        past that the least recently used is evicted
        (``prefix_evictions``).  A prefix is bound to its *adapter* (the
        adapter shapes its K/V): admissions that use it must ask for the
        same one."""
        toks = np.asarray(tokens, np.int32).reshape(1, -1)
        if int(toks.shape[1]) < 1:
            raise ValueError("empty prefix")
        aid = self._check_adapter(adapter)
        while len(self._prefixes) >= self.prefix_registry_max:
            lru = min(self._prefixes,
                      key=lambda h: self._prefix_touch.get(h, 0))
            self._prefixes.pop(lru, None)
            self._prefix_touch.pop(lru, None)
            self._prefix_evictions += 1
        mini, last = self._extend_prompt(init_cache(self.model, 1), toks, 0,
                                         adapter=aid)
        handle = self._next_prefix
        self._next_prefix += 1
        self._prefixes[handle] = (toks[0].copy(), mini, last, aid)
        self._touch_prefix(handle)
        return handle

    def release_prefix(self, handle: int) -> None:
        """Drop a registered prefix (its full B=1 cache with it)."""
        self._prefixes.pop(handle, None)
        self._prefix_touch.pop(handle, None)

    def _slot_src(self, ref: int) -> Cache:
        """Donor slot rows as a new B=1 mini cache: a contiguous copy,
        or in paged mode a pool gather by the donor's block table."""
        if self._paged:
            return _paged_gather_mini(self.cache, self._pool.tables[ref],
                                      self.model.dtype, self._stage.put)
        return _slot_to_mini(self.cache, ref)

    def _paged_land(self, st: AdmitState, mini: Optional[Cache]) -> None:
        """Finish-side block-table build of a paged admission: clear the
        slot's stale mappings, install the begin-time prefix shares,
        allocate owned pages for the prefilled suffix, and splice the
        mini into THOSE pages only (a shared page is never written
        while shared).  A pure-share landing (an exact repeat) skips the
        splice: one cache_lens fix."""
        pool = self._pool
        slot = st.slot
        ps = pool.page_size
        # the references taken at begin keep the shared pages alive even
        # when the donor is this slot: clear drops the old mappings,
        # map_shared re-installs them
        pool.clear_slot(slot)
        pool.map_shared(slot, st.share_pages)
        shared_n = len(st.share_pages)
        st.share_pages = []  # now held by the table
        end_page = (st.prefill_end + ps - 1) // ps
        try:
            for idx in range(shared_n, end_page):
                pool.map(slot, idx, self._alloc_page())
        except PagePoolExhausted:
            # roll the landing back; the reservation stands and the
            # caller aborts or retries.  The previous occupant's donor
            # record lost its pages with the clear, so it goes too
            pool.clear_slot(slot)
            self._slot_prompts[slot] = None
            raise
        if mini is None:
            _set_len(self.cache, slot, st.t_p)
        else:
            _paged_splice(self.cache, mini,
                          self._table_targets(slot, shared_n, end_page),
                          pool.scratch, slot, st.t_p, self._stage.put)

    def admit(self, prompt, prefix: Optional[int] = None,
              temperature: float = 0.0,
              top_k: Optional[int] = None,
              top_p: float = 1.0,
              min_p: float = 0.0,
              presence_penalty: float = 0.0,
              frequency_penalty: float = 0.0,
              repetition_penalty: float = 1.0,
              seed: Optional[int] = None,
              seed_stream: int = 0,
              adapter: Optional[int] = None,
              stop: Optional[List[int]] = None,
              ignore_eos: bool = False,
              logprobs: Optional[int] = None,
              prompt_logprobs: Optional[int] = None,
              logit_bias: Optional[Dict[int, float]] = None,
              min_tokens: int = 0,
              grammar: Union[bool, int] = False,
              session: Optional[str] = None) -> int:
        """Prefill *prompt* into a free slot; returns the slot id.
        Raises RuntimeError when the engine is full.  With ``prefix`` (a
        :meth:`register_prefix` handle) the prompt must start with the
        registered tokens and only the suffix is prefilled; without one,
        automatic prefix caching prefills only the unmatched tail.  The
        sampling knobs, ``stop`` ids, ``logprobs`` and the rest are
        per-slot data.  Runs begin_admit -> admit_step* ->
        finish_admit in one call."""
        st = self.begin_admit(
            prompt, prefix=prefix, temperature=temperature,
            top_k=top_k, top_p=top_p, min_p=min_p,
            presence_penalty=presence_penalty,
            frequency_penalty=frequency_penalty,
            repetition_penalty=repetition_penalty,
            seed=seed, seed_stream=seed_stream, adapter=adapter,
            stop=stop, ignore_eos=ignore_eos, logprobs=logprobs,
            prompt_logprobs=prompt_logprobs, logit_bias=logit_bias,
            min_tokens=min_tokens, grammar=grammar, session=session)
        try:
            if st.gen is not None:
                # one run of every chunk: on CUDA one copy of the mini
                # into the captured extend's cache and back
                self._advance([st], st.gen.remaining)
            return self.finish_admit(st)
        except BaseException:
            if not st.spliced:
                self.abort_admit(st)
            raise

    def begin_admit(self, prompt, prefix: Optional[int] = None,
                    temperature: float = 0.0,
                    top_k: Optional[int] = None,
                    top_p: float = 1.0,
                    min_p: float = 0.0,
                    presence_penalty: float = 0.0,
                    frequency_penalty: float = 0.0,
                    repetition_penalty: float = 1.0,
                    seed: Optional[int] = None,
                    seed_stream: int = 0,
                    adapter: Optional[int] = None,
                    stop: Optional[List[int]] = None,
                    ignore_eos: bool = False,
                    logprobs: Optional[int] = None,
                    prompt_logprobs: Optional[int] = None,
                    logit_bias: Optional[Dict[int, float]] = None,
                    min_tokens: int = 0,
                    grammar: Union[bool, int] = False,
                    session: Optional[str] = None) -> AdmitState:
        """Validate a request, reserve a free slot and set up its
        chunked prefill without running it: advance the returned
        :class:`AdmitState` with :meth:`admit_step` and land it with
        :meth:`finish_admit` (or drop it with :meth:`abort_admit`).
        Every validation error raises here, before any engine state is
        touched."""
        prompt_np = np.asarray(prompt, np.int32).reshape(1, -1)
        t_p = int(prompt_np.shape[1])
        if t_p < 1:
            raise ValueError("empty prompt")
        if int(prompt_np.min()) < 0 or int(prompt_np.max()) >= \
                self.model.vocab:
            raise ValueError(
                f"prompt token outside [0, vocab={self.model.vocab})")
        if temperature < 0:
            raise ValueError("temperature must be >= 0")
        validate_top_k(self.model, top_k)
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p {top_p} outside (0, 1]")
        if not 0.0 <= min_p <= 1.0:
            raise ValueError(f"min_p {min_p} outside [0, 1]")
        for pname, pval in (("presence_penalty", presence_penalty),
                            ("frequency_penalty", frequency_penalty)):
            if not -2.0 <= pval <= 2.0:
                raise ValueError(
                    f"{pname} {pval} outside [-2, 2]")
        if not repetition_penalty > 0:
            raise ValueError(
                f"repetition_penalty {repetition_penalty} must be > 0")
        aid = self._check_adapter(adapter)
        stops = frozenset(int(t) for t in (stop or ()))
        for t in stops:
            if not 0 <= t < self.model.vocab:
                raise ValueError(
                    f"stop token {t} outside [0, vocab="
                    f"{self.model.vocab})")
        lp_n = int(logprobs or 0)
        plp_n = int(prompt_logprobs or 0)
        for nm, v in (("logprobs", lp_n), ("prompt_logprobs", plp_n)):
            if v < 0:
                raise ValueError(f"{nm} must be >= 0")
            if v > self.logprobs_k:
                raise ValueError(
                    f"{nm}={v} exceeds the engine's logprobs_k="
                    f"{self.logprobs_k} (set at construction: the "
                    "engine-wide k keeps the decode step's variants "
                    "few)")
        if plp_n and prefix is not None:
            raise ValueError(
                "prompt_logprobs needs the full prompt prefilled — "
                "incompatible with a prefix handle")
        budget = self.max_new_tokens or 1
        if t_p + budget > self.model.max_len:
            raise ValueError(
                f"prompt {t_p} + budget {budget} exceeds "
                f"max_len {self.model.max_len}")
        # t_p <= max_len - 1 keeps released slots' prompt rows valid
        # donors: a parked slot's masked decode writes clamp to row
        # max_len - 1, which this bound keeps out of the prompt rows
        if (self._draft_model is not None or self._ngram) \
                and self.auto_prefix:
            # with a proposer the bound is stronger: the verify extend
            # writes gamma + 1 rows for EVERY slot, so a parked slot's
            # clamped band is [max_len - gamma - 1, max_len - 1] and a
            # donor's prompt must sit below it (without donor matching
            # parked rows are never read back)
            spec_limit = self.model.max_len - self.gamma - 1
            if t_p > spec_limit:
                raise ValueError(
                    f"prompt {t_p} exceeds the speculative donor bound "
                    f"{spec_limit} (max_len - gamma - 1): parked-slot "
                    "prompt K/V must stay below the clamped verify "
                    "band; shorten the prompt, raise max_len, or "
                    "lower gamma")
        # grammar opt-in: True = grammar 0 (the constructor's), an int
        # selects a register_grammar() id; gstart -1 = unconstrained
        if grammar is False or grammar is None:
            gstart = -1
        else:
            if not self._goffsets:
                raise ValueError(
                    "engine has no grammar registered "
                    "(ServingEngine(..., grammar=TokenDfa) or "
                    "register_grammar())")
            gid = 0 if grammar is True else int(grammar)
            if not 0 <= gid < len(self._goffsets):
                raise ValueError(
                    f"unknown grammar id {gid} (registered: "
                    f"{len(self._goffsets)})")
            gstart = self._goffsets[gid]
        if min_tokens < 0:
            raise ValueError("min_tokens must be >= 0")
        if (min_tokens and self.max_new_tokens is not None
                and min_tokens > self.max_new_tokens):
            raise ValueError(
                f"min_tokens {min_tokens} exceeds the engine budget "
                f"{self.max_new_tokens}")
        if logit_bias is not None:
            if not isinstance(logit_bias, dict) or not logit_bias:
                raise ValueError(
                    "logit_bias must be a non-empty {token: bias} dict")
            for bk, bv in logit_bias.items():
                if isinstance(bk, bool) or not isinstance(
                        bk, (int, np.integer)):
                    raise ValueError(
                        "logit_bias keys must be token ids")
                if not 0 <= int(bk) < self.model.vocab:
                    raise ValueError(
                        f"logit_bias token {bk} outside "
                        f"[0, vocab={self.model.vocab})")
                if not np.isfinite(float(bv)):
                    raise ValueError(
                        "logit_bias values must be finite")
                if not -100.0 <= float(bv) <= 100.0:
                    # beyond that a bias could overpower the -1e6 mask
                    # of the min_tokens floor
                    raise ValueError(
                        f"logit_bias value {float(bv)} outside "
                        "[-100, 100]")
        free = self.free_slots()
        if not free:
            raise RuntimeError("no free slots")
        slot = free[0]

        auto_src = None
        L = 0
        if prefix is not None:
            if prefix not in self._prefixes:
                raise ValueError(f"unknown prefix handle {prefix}")
            ptoks, pcache, plast, paid = self._prefixes[prefix]
            L = len(ptoks)
            if t_p < L or not np.array_equal(prompt_np[0, :L], ptoks):
                raise ValueError(
                    "prompt does not start with the registered prefix")
            if paid != aid:
                raise ValueError(
                    f"prefix was registered with adapter {paid}, "
                    f"request uses {aid}: the adapter shapes the prefix "
                    "K/V, register one per adapter")
            start, n = L, t_p - L
        else:
            # prompt_logprobs needs every position's logits, so it
            # forces a full (cold) prefill: no automatic prefix reuse
            auto_src = (None if plp_n
                        else self._auto_match(prompt_np[0], t_p, aid,
                                              session or None))
            start = auto_src[2] if auto_src is not None else 0
            n = t_p - start
        if self.chunk is not None and n > 0:
            padded = ((n + self.chunk - 1) // self.chunk) * self.chunk
            if start + padded > self.model.max_len:
                raise ValueError(
                    f"padded prompt {start + padded} exceeds max_len "
                    f"{self.model.max_len} (shrink chunk or prompt)")
        if (auto_src is not None and auto_src[0] == "slot_full"
                and self._draft_model is None
                and not self.active[auto_src[1]]
                and not self._reserved[auto_src[1]]):
            # prefix-affinity placement: an exact repeat goes back into
            # its donor's free slot, where the copy is the identity
            slot = auto_src[1]

        st = AdmitState()
        st.slot = slot
        st.prompt_np = prompt_np
        st.t_p = t_p
        st.stops = stops
        st.temperature = temperature
        st.top_k = top_k
        st.top_p = top_p
        st.min_p = min_p
        st.presence_penalty = presence_penalty
        st.frequency_penalty = frequency_penalty
        st.repetition_penalty = repetition_penalty
        st.seed = seed
        st.seed_stream = seed_stream
        st.ignore_eos = ignore_eos
        st.min_tokens = min_tokens
        st.lp_n = lp_n
        st.plp_n = plp_n
        st.logit_bias = logit_bias
        st.gstart = gstart
        st.aid = aid
        st.auto_src = auto_src
        # an unaligned explicit prefix leaves the suffix rows off the
        # chunk grid: only the prefix part is reusable later
        if (self.chunk is not None and prefix is not None
                and L % self.chunk):
            st.canon = L
        else:
            st.canon = t_p
        if n <= 0:
            st.chunks_total = 0
        elif self.chunk is None:
            st.chunks_total = 1
        else:
            st.chunks_total = (n + self.chunk - 1) // self.chunk

        if self._paged:
            # page-budget gate: rows [shared, prefill_end) need owned
            # pages at finish.  Reclaim parked donor pages until the
            # budget fits, or raise HERE, with nothing mutated yet
            pool = self._pool
            ps, c = pool.page_size, self.chunk
            st.prefill_end = (start + ((n + c - 1) // c) * c
                              if n > 0 else t_p)
            if (auto_src is not None and auto_src[0] == "slot_full"
                    and self._draft_model is None):
                shared_est = (t_p + ps - 1) // ps  # in place or shared
            elif auto_src is not None and auto_src[0] == "slot":
                shared_est = auto_src[2] // ps
            else:
                shared_est = 0
            need = (st.prefill_end + ps - 1) // ps - shared_est
            if need > pool.n_pages:
                raise ValueError(
                    f"prompt needs {need} KV pages, pool holds "
                    f"{pool.n_pages}")
            while pool.free_pages() < need and self._reclaim_parked():
                pass
            if pool.free_pages() < need:
                raise PagePoolExhausted(
                    f"admission needs {need} KV pages, "
                    f"{pool.free_pages()} free")

        if prefix is not None:
            self._touch_prefix(prefix)
            if n > 0:
                # the extend writes in place: the registry entry must
                # survive for the next admit
                st.gen = _PrefillJob(self, _clone_cache(pcache),
                                     prompt_np[:, L:], start=L, adapter=aid)
            else:
                # exact-prefix prompt: the splice only reads the entry
                st.result = (pcache, plast)
        elif auto_src is not None:
            kind, ref, m = auto_src
            if kind in ("reg", "reg_full"):
                self._touch_prefix(ref)
            if kind == "reg_full":
                _, pc_full, pl_full, _ = self._prefixes[ref]
                st.result = (pc_full, pl_full)
            elif kind == "slot_full":
                rec_full = self._slot_prompts[ref]
                # with a draft the slot's draft rows are re-prefilled at
                # finish, so the target rows are copied as for any donor
                if ref == slot and self._draft_model is None:
                    st.inplace = True
                    st.result = (None, rec_full[3])
                elif self._paged and self._draft_model is None:
                    # a paged exact repeat into another slot maps the
                    # donor's pages by reference: the first append past
                    # the shared rows pays one page copy instead
                    st.share_pages = self._pool.share(
                        ref, (t_p + self._pool.page_size - 1)
                        // self._pool.page_size)
                    st.result = (None, rec_full[3])
                else:
                    src = self._slot_src(ref)
                    _set_len(src, 0, t_p)
                    st.result = (src, rec_full[3])
                st.first_cached = rec_full[4]
            else:
                if kind == "reg":
                    src = _clone_cache(self._prefixes[ref][1])
                else:
                    src = self._slot_src(ref)
                    if self._paged:
                        # the matched prefix pages map by reference;
                        # only the suffix lands in owned pages
                        st.share_pages = self._pool.share(
                            ref, m // self._pool.page_size)
                # rows beyond m are stale donor data masked by the
                # cache_lens reset; the suffix extend overwrites them
                _set_len(src, 0, m)
                st.gen = _PrefillJob(self, src, prompt_np[:, m:], start=m,
                                     adapter=aid)
        else:
            st.gen = _PrefillJob(self, init_cache(self.model, 1),
                                 prompt_np, start=0,
                                 plp_k=self.logprobs_k if plp_n else 0,
                                 plp_out=st.plp_dev, adapter=aid)
        # the reservation is the last begin-side mutation
        self._reserved[slot] = True
        return st

    def admit_step(self, st: AdmitState) -> bool:
        """Run the next prefill chunk of an in-flight admission; True
        while chunks remain.  Enqueues the extend and returns without
        waiting for the device, which is what lets the iteration
        scheduler slide prefill chunks between decode windows."""
        if st.gen is None:
            return False
        self._advance([st], 1)
        return st.gen is not None

    def admit_step_packed(self, states: List[AdmitState],
                          rounds: int = 1) -> None:
        """Advance EACH of *states* by *rounds* prefill chunks through
        batched extends: the ragged packed prefill.  The K B=1 admission
        caches stack once into the first K rows of the admission batch
        (``_ChunkBatch``), every round runs one extend with all K chunks
        at their own depths (per-row positions and ``cache_lens``, the
        decode cache's per-slot machinery), and the rows split back once
        at the end.  Each packed row's
        operands and bookkeeping come from the same :class:`_PrefillJob`
        methods the serial path uses, and the extend computes its rows
        independently, so a packed admission lands as the serial chunks
        would.  Callers guarantee every state is mid-prefill and
        packable, ``len(states) >= 2`` and *rounds* <= every state's
        remaining chunks.  On CUDA the extend at each K is captured once
        (see :meth:`warm_packed`)."""
        jobs = []
        for st in states:
            job = st.gen
            if job is None or not job.packable or not job.remaining:
                raise ValueError(
                    "admit_step_packed needs in-flight packable "
                    "admissions")
            jobs.append(job)
        k = len(jobs)
        if k < 2:
            raise ValueError("a pack needs >= 2 admissions")
        if k > self.pack_width:
            raise ValueError(
                f"a pack of {k} exceeds the engine's pack_width "
                f"{self.pack_width}")
        if rounds < 1 or any(j.remaining < rounds for j in jobs):
            raise ValueError(
                "rounds must be >= 1 and <= every job's remaining "
                "chunks")
        for job in jobs:
            if not job.packed_used:
                job.packed_used = True
                self._packed_requests += 1
        self._advance(states, rounds, packed=True)

    def warm_packed(self, sizes) -> None:
        """Capture the admission extend at each pack size in *sizes* (1 is
        the serial chunk) before traffic needs it, so the first packed
        convoy does not pay the capture; a size used before it is
        captured is captured at that use.  A size beyond ``pack_width``
        raises.  No engine state is touched.  Eager engines (the CPU, or
        ``_use_graphs`` off) and unchunked ones have nothing to
        capture."""
        sizes = sorted(set(int(k) for k in sizes))
        for k in sizes:
            if k > self.pack_width:
                raise ValueError(
                    f"pack size {k} exceeds the engine's pack_width "
                    f"{self.pack_width}")
        if self.chunk is not None and self._use_graphs:
            for k in sizes:
                if k >= 1:
                    self._chunk_batch(k)

    def _chunk_batch(self, k: int) -> _ChunkBatch:
        """The admission extend's static buffers, made at first use; on
        CUDA with graphs on, the extend with *k* real rows is captured at
        its first use (a failed capture raises)."""
        b = self._batch
        if b is None:
            b = _ChunkBatch(self.model, self.pack_width, self.chunk)
            self._batch = b
        if self._use_graphs and k not in b.graphs:
            if self._capture_stream is None:
                self._capture_stream = torch.cuda.Stream(self.device)
            torch.cuda.synchronize(self.device)
            t0 = time.perf_counter()
            b.capture(k, self._capture_stream)
            torch.cuda.synchronize(self.device)
            self.extend_capture_ms += (time.perf_counter() - t0) * 1e3
        return b

    def _advance(self, states: List[AdmitState], rounds: int,
                 packed: bool = False) -> None:
        """Run *rounds* chunks of each of *states* (see
        :meth:`_advance_jobs`) and carry the results into the states."""
        jobs = [st.gen for st in states]
        self._advance_jobs(jobs, rounds, packed)
        for st, job in zip(states, jobs):
            st.chunks_done += rounds
            st.result = (job.mini, job.last)
            if job.remaining == 0:
                st.gen = None

    @torch.no_grad()
    def _advance_jobs(self, jobs: List[_PrefillJob], rounds: int,
                      packed: bool = False) -> None:
        """*rounds* chunks of each of *jobs*, one extend a round with the
        jobs' chunks as the first rows of one batch (``_ChunkBatch``):
        the minis are copied into its cache once, each round copies the
        tokens and positions in and extends (a replay on CUDA), and the
        minis are copied back out once.  An unchunked engine's job is
        one extend of its own length on its mini.  Nothing here waits
        for the device.  *packed* counts the packed-prefill stats."""
        k = len(jobs)
        for job in jobs:
            job.charge()
        lora = self.model.n_adapters > 0
        if self.chunk is None:
            (job,) = jobs
            self.prefill_chunk_tokens += job.n
            aids = (self._stage.put(np.asarray([job.aid], np.int64))
                    if lora else None)
            logits = self.model(self._stage.put(job.chunk_np()),
                                self._stage.put(job.pos_np()), job.mini,
                                decode=True, adapter_ids=aids)
            job.absorb_logits(logits[0])
            job.attach_mini()
            return
        b = self._chunk_batch(k)
        minis = [job.mini for job in jobs]
        _pack_minis(minis, b.cache)
        if lora:
            aids = np.full(b.aids.shape[0], -1, np.int64)
            aids[:k] = [job.aid for job in jobs]
            self._stage.copy_into(b.aids, aids)
        inputs = np.zeros(tuple(b.inputs.shape), np.int32)
        for _ in range(rounds):
            pad = 0
            for i, job in enumerate(jobs):
                inputs[0, i] = job.chunk_np()[0]
                inputs[1, i] = job.pos_np()[0]
                pad += job.pad_rows()
            self.prefill_chunk_tokens += k * self.chunk - pad
            if packed:
                self._packed_pad_tokens += pad
                self._packed_extends += 1
                self._packed_rows += k
            self._stage.copy_into(b.inputs, inputs)
            if self._use_graphs:
                b.graphs[k].replay()
                self.extend_replays += 1
                logits = b.logits[k]
            else:
                logits = b.run(k)
            for i, job in enumerate(jobs):
                job.absorb_logits(logits[i])
        _unpack_minis(b.cache, minis)
        for job in jobs:
            job.attach_mini()

    def abort_admit(self, st: AdmitState) -> None:
        """Abandon an in-flight admission: the reserved slot returns to
        the free pool and the mini cache is dropped."""
        if st.spliced:
            raise RuntimeError(
                "admission already finished; release() the slot")
        if st.gen is not None:
            st.gen.close()
            st.gen = None
        st.result = None
        if st.share_pages:
            # give back the begin-time prefix-share references
            self._pool.unshare(st.share_pages)
            st.share_pages = []
        self._reserved[st.slot] = False

    def finish_admit(self, st: AdmitState) -> int:
        """Land a fully prefilled admission: copy the mini cache into
        the slot, arm the request's knobs and pick its first token.
        Returns the slot id."""
        self._finish_admit_dispatch(st)
        return self._finish_admit_resolve(st)

    def _finish_admit_dispatch(self, st: AdmitState) -> None:
        """The device half of finish_admit: the splice, the knobs and
        the first-token pick, all enqueued without a synchronisation
        (the pick stays on the device in ``st.pick``)."""
        if not st.ready:
            raise RuntimeError("admission prefill not finished "
                               "(admit_step until it returns False)")
        slot = st.slot
        mini, last = st.result
        self._finished.pop(slot, None)
        self._finish_reason.pop(slot, None)
        self._prompt_lp[slot] = []
        if st.auto_src is not None:
            self._prefix_hits += 1
            self._prefix_reused_tokens += st.auto_src[2]
        if st.inplace:
            _set_len(self.cache, slot, st.t_p)
        elif self._paged:
            self._paged_land(st, mini)
        else:
            _splice_slot(self.cache, mini, slot)
        if self._draft_model is not None:
            _splice_slot(self._draft_cache,
                         self._draft_prefill(st.prompt_np), slot)
        # the final-position logits row rides the record: an exact
        # repeat of this prompt admits with no extend; resolve fills in
        # the greedy first token when this admission qualifies
        self._slot_prompts[slot] = (st.prompt_np[0], st.aid, st.canon,
                                    last, None)
        self.lens[slot] = st.t_p
        self.active[slot] = True
        self.temps[slot] = st.temperature
        self.topks[slot] = st.top_k or 0
        self.topps[slot] = st.top_p
        self.minps[slot] = st.min_p
        self.pres[slot] = st.presence_penalty
        self.freqs[slot] = st.frequency_penalty
        self.reps[slot] = st.repetition_penalty
        self.adapters[slot] = st.aid
        self._stops[slot] = st.stops
        self._ignore_eos[slot] = bool(st.ignore_eos)
        V = self.model.vocab
        if st.logit_bias:
            bias_np = np.zeros(V, np.float32)
            for bk, bv in st.logit_bias.items():
                bias_np[int(bk)] = float(bv)
            self._stage.copy_into(self._bias[slot], bias_np)
            self._bias_on[slot] = True
            bias_row = self._bias[slot:slot + 1]
        else:
            if self._bias_on[slot]:
                self._bias[slot].zero_()
                self._bias_on[slot] = False
            bias_row = None
        self.min_toks[slot] = st.min_tokens
        min_row = None
        if st.min_tokens:
            mask_np = np.zeros(V, np.float32)
            if self.eos_id is not None:
                mask_np[self.eos_id] = -1e6
            for t in st.stops:
                mask_np[t] = -1e6
            self._stage.copy_into(self._min_mask[slot], mask_np)
            min_row = self._min_mask[slot:slot + 1]  # 0 emitted yet
        self.gstate[slot] = st.gstart
        self._seeds[slot] = 0 if st.seed is None else int(st.seed)
        self._seed_streams[slot] = int(st.seed_stream)
        self._seed_keys[slot] = (0 if st.seed is None
                                 else seed_key(st.seed, st.seed_stream))
        self._seed_on[slot] = 0 if st.seed is None else 1
        self._slot_draws[slot] = 0
        self._lp_want[slot] = st.lp_n
        self._lp_records[slot] = []
        # the repetition penalty of the first token scopes over the
        # prompt (host bincount); its output histogram is empty
        rep_on = st.repetition_penalty != 1.0
        if rep_on:
            seen_row = self._stage.put(np.bincount(
                st.prompt_np[0], minlength=V).astype(np.float32))[None, :]
        else:
            seen_row = self._zero_vocab_row
        if (st.first_cached is not None
                and self._clean_greedy_admit(st)):
            # clean-greedy exact repeat: the donor's first token is the
            # argmax of this same logits row; no pick, no draw
            st.pick = None
        else:
            st.first_cached = None
            first_lg = last[None, :]
            if bias_row is not None:
                first_lg = first_lg + bias_row
            if min_row is not None:
                first_lg = first_lg + min_row
            if st.gstart >= 0:
                # the mask derived from the host table's row
                first_lg = first_lg + self._stage.put(
                    (self._gtable_np[st.gstart] < 0).astype(np.float32)
                    * np.float32(-1e9))[None, :]
            st.pick = self._first_pick(st, slot, first_lg, seen_row)
            if st.presence_penalty or st.frequency_penalty:
                self._counts[slot].zero_()
                _bump_counts(self._counts[slot:slot + 1], st.pick)
            if rep_on:
                self._seen[slot].copy_(seen_row[0])
                _bump_counts(self._seen[slot:slot + 1], st.pick)
            if st.lp_n:
                st.pick_stats = _top_logprobs(first_lg, st.pick,
                                              self.logprobs_k)
        st.spliced = True
        self._reserved[slot] = False
        # a window dispatched before this splice must not advance the
        # new slot's host mirrors at harvest
        if self._inflight_scan is not None:
            self._inflight_scan.skip.add(slot)

    def _first_pick(self, st: AdmitState, slot: int, first_lg, seen_row):
        """The admission's first token, on the device: greedy argmax
        (no draw) unless a knob is armed; then one engine draw (a seeded
        request draws index 0 of its own chain)."""
        knobs = (np.asarray([st.temperature], np.float32),
                 np.asarray([st.top_k or 0], np.int64),
                 np.asarray([st.top_p], np.float32),
                 np.asarray([st.min_p], np.float32),
                 np.asarray([st.presence_penalty], np.float32),
                 np.asarray([st.frequency_penalty], np.float32),
                 np.asarray([st.repetition_penalty], np.float32))
        if not _knobs_live(*knobs):
            return torch.argmax(first_lg, dim=-1)
        if st.seed is None:
            key = row_keys(self._key, self._draws, slot)
        else:
            key = row_keys(int(self._seed_keys[slot]), 0, 0)
        self._draws += 1
        # this slot's own chain moved with the draw
        self._slot_draws[slot] = 1
        t = [self._stage.put(k) for k in knobs]
        keys = self._stage.put(np.asarray([key], np.int64))
        return _pick_tokens(first_lg, *t, self._zero_vocab_row, seen_row,
                            keys)

    def _finish_admit_resolve(self, st: AdmitState) -> int:
        """The host half of finish_admit: read the first token (the
        admission's one synchronisation) and finish the bookkeeping."""
        slot = st.slot
        if st.plp_n:
            # entry 0 has no conditional; entry j scores prompt[j] from
            # chunk (j - 1) // c, row (j - 1) % c
            c = self.chunk or st.t_p
            hosts = [tuple(x.cpu().numpy() for x in stats)
                     for stats in st.plp_dev]
            recs: list = [None]
            for j in range(1, st.t_p):
                clp, tlp, tid = hosts[(j - 1) // c]
                r = (j - 1) % c
                recs.append((float(clp[r]),
                             [(int(tid[r][q]), float(tlp[r][q]))
                              for q in range(st.plp_n)]))
            self._prompt_lp[slot] = recs
        if st.pick is None:
            first = int(st.first_cached)
        else:
            first = int(st.pick.cpu()[0])
        if st.lp_n:
            clp, tlp, tid = (x.cpu().numpy() for x in st.pick_stats)
            self._record_logprobs(slot, float(clp[0]), tlp[0], tid[0])
        if st.gstart >= 0:
            self.gstate[slot] = int(self._gtable_np[st.gstart, first])
        if self._clean_greedy_admit(st):
            # a zero-sync donor for the next exact repeat
            rec = self._slot_prompts[slot]
            self._slot_prompts[slot] = rec[:4] + (first,)
        self.last_token[slot] = first
        self.outputs[slot] = [first]
        self._tokens += 1
        self._maybe_finish(slot, first)
        return slot

    @staticmethod
    def _clean_greedy_admit(st: AdmitState) -> bool:
        """Pure-greedy, unmasked admission: the first token is exactly
        the argmax of the final prompt logits row, so it can ride the
        resident-prompt record and be reused by the next exact repeat.
        Any knob that bends the pick or needs its stats disqualifies."""
        return (st.temperature == 0.0 and not (st.top_k or 0)
                and st.top_p == 1.0 and st.min_p == 0.0
                and st.presence_penalty == 0.0
                and st.frequency_penalty == 0.0
                and st.repetition_penalty == 1.0
                and not st.logit_bias and not st.min_tokens
                and st.gstart < 0 and not st.lp_n)

    def _pen_live(self) -> bool:
        """Any presence/frequency-penalised request live?"""
        return bool(self.pres.any() or self.freqs.any())

    def _bias_live(self) -> bool:
        """Any active slot with a logit_bias row?"""
        return any(self._bias_on[s] for s in range(self.n_slots)
                   if self.active[s])

    def _min_live(self) -> bool:
        """Any active slot still below its min_tokens floor?"""
        return any(
            self.active[s]
            and len(self.outputs[s]) < int(self.min_toks[s])
            for s in range(self.n_slots))

    def _rep_live(self) -> bool:
        return bool((self.reps != 1.0).any())

    def _grammar_live(self) -> bool:
        """Any active slot under a grammar?"""
        return bool(self._goffsets) and any(
            self.active[s] and self.gstate[s] >= 0
            for s in range(self.n_slots))

    def _record_logprobs(self, slot: int, chosen_lp: float,
                         top_lp, top_id) -> None:
        """Append one emitted token's stats, trimmed to the request's
        n: (chosen logprob, [(token id, logprob) x n])."""
        n = self._lp_want[slot]
        self._lp_records[slot].append((
            chosen_lp,
            [(int(top_id[j]), float(top_lp[j])) for j in range(n)],
        ))

    def prompt_logprobs(self, slot: int):
        """Prompt-scoring records from admission: entry 0 is None (no
        conditional), entry j is ``(logprob of prompt[j] given
        prompt[:j], [(token id, logprob) x n])``.  Empty unless the
        request asked."""
        return list(self._prompt_lp[slot])

    def token_logprobs(self, slot: int):
        """Per-token logprob records for *slot*, parallel to
        :meth:`output`: ``(chosen_logprob, [(token_id, logprob), ...])``
        with the request's ``logprobs`` n entries each; empty when the
        request did not ask."""
        return list(self._lp_records[slot])

    # -- decoding ----------------------------------------------------------

    @torch.no_grad()
    def _decode_step(self, flags: tuple) -> None:
        """One decode step of every slot over the window's buffers: the
        extend, the pick (with the variant's knobs), the outputs at row
        ``step`` and the advance of the state.  What a CUDA graph
        captures and replays."""
        (sampled, lp_k, pen, rep, seeded, biased, minned, grammared,
         fused, K, paged) = flags
        w = self._w
        logits = self._extend(w.tok[:, None], w.pos[:, None], paged,
                              w.adapters)
        lg = logits[:, -1, :]
        if biased:
            lg = lg + self._bias
        if minned:
            # the floor's gate is per-step data, so a crossing inside a
            # window lifts the mask where step-by-step decoding would
            gate = ((w.emitted + w.step) < w.min_toks).to(lg.dtype)
            lg = lg + self._min_mask * gate[:, None]
        if grammared:
            # ONE [S, V] row gather serves both the allowed-token mask
            # (reject entries are -1) and the state advance below
            grow = self._gtable[w.gstate.clamp(min=0)]
            gon = (w.gstate >= 0).to(lg.dtype)[:, None]
            lg = lg + torch.where(grow < 0, -1e9, 0.0) * gon
        if sampled:
            keys = row_keys(w.key, w.draws + w.step, w.slots)
            if seeded:
                own = row_keys(w.seed_keys, w.slot_draws + w.step, 0)
                keys = torch.where(w.seed_on > 0, own, keys)
            nxt = _pick_tokens(lg, w.temps, w.topks, w.topps, w.minps,
                               w.pres, w.freqs, w.reps, self._counts,
                               self._seen, keys)
        else:
            nxt = torch.argmax(lg, dim=-1)
        w.out_tok.index_copy_(0, w.step, nxt.to(torch.int32)[None])
        if lp_k:
            # the stats see the bias (the distribution the pick used)
            clp, tlp, tid = _top_logprobs(lg, nxt, lp_k)
            w.out_clp.index_copy_(0, w.step, clp[None])
            w.out_tlp.index_copy_(0, w.step, tlp[None])
            w.out_tid.index_copy_(0, w.step, tid[None])
        # the histograms take this step's token after its pick
        if pen:
            _bump_counts(self._counts, nxt)
        if rep:
            _bump_counts(self._seen, nxt)
        if grammared:
            stepped = grow.gather(1, nxt.long()[:, None])[:, 0].long()
            w.gstate.copy_(torch.where(w.gstate >= 0, stepped, w.gstate))
        if fused:
            fin, frs = scan_boundary_update(
                w.fin, w.frs, nxt, w.step, w.eos, w.stops[K], w.emitted,
                w.budget)
            w.fin.copy_(fin)
            w.frs.copy_(frs)
        w.tok.copy_(nxt)
        w.pos.add_(1)
        w.step.add_(1)

    def _extend(self, tokens: torch.Tensor, positions: torch.Tensor,
                paged: bool, adapter_ids: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """One extend on the engine cache (the admission minis always
        run contiguous): the paged engine's twin model reads the pool
        through the block-table buffer.  *adapter_ids* [S] reach the
        model only when it has adapters."""
        if self.model.n_adapters == 0:
            adapter_ids = None
        if paged:
            return self._pmodel(tokens, positions, self.cache, decode=True,
                                block_tables=self._btables,
                                adapter_ids=adapter_ids)
        return self.model(tokens, positions, self.cache, decode=True,
                          adapter_ids=adapter_ids)

    def _graph(self, flags: tuple) -> "torch.cuda.CUDAGraph":
        """The captured step of *flags*, captured at its first use."""
        graph = self._graphs.get(flags)
        if graph is None:
            if self._capture_stream is None:
                self._capture_stream = torch.cuda.Stream(self.device)
            state = [self._w.ints, self._counts, self._seen]
            torch.cuda.synchronize(self.device)
            t0 = time.perf_counter()
            graph = capture_step(lambda: self._decode_step(flags),
                                 state + cache_lens(self.cache),
                                 self._capture_stream)
            torch.cuda.synchronize(self.device)
            self.capture_ms += (time.perf_counter() - t0) * 1e3
            self.graph_captures += 1
            self._graphs[flags] = graph
        return graph

    def step(self) -> Dict[int, int]:
        """One decode step for every active slot, each picking with its
        own knobs: a window of one step (on CUDA one replay of the same
        captured step that ``run_scan`` replays).  Returns {slot: token}
        for the slots active at the step."""
        if not any(self.active):
            return {}
        for s in range(self.n_slots):
            if self.active[s] and self.lens[s] >= self.model.max_len:
                self._finish(s)
        if not any(self.active):
            return {}
        self._ensure_append_pages(1)
        if not any(self.active):
            return {}  # the page-pressure policy preempted the rest
        out = self.scan_harvest(self._dispatch(1, fused=False))
        return {s: toks[0] for s, toks in out.items()}

    def run(self, max_steps: int) -> None:
        for _ in range(max_steps):
            if not any(self.active):
                return
            self.step()

    # -- structural jump-ahead (grammar-forced chains) ---------------------

    def _forced_chain(self, state: int, cap: int) -> List[int]:
        """Walk the DFA from *state* while exactly ONE token is legal;
        returns the forced tokens.  Stops at eos (an eos-only state
        retires through the normal pick) and at *cap*."""
        chain: List[int] = []
        for _ in range(cap):
            row = self._gtable_np[state]
            allowed = np.flatnonzero(row >= 0)
            if allowed.size != 1:
                break
            t = int(allowed[0])
            if t == self.eos_id:
                break
            chain.append(t)
            state = int(row[t])
        return chain

    def jump_ready(self) -> bool:
        """Would :meth:`jump_round` run right now?  True iff a grammar
        slot is active and no active slot armed sampling knobs or
        logprobs (forced commits skip picks, so they consume no draws
        and record no logprobs)."""
        if not self._grammar_live():
            return False
        if _knobs_live(self.temps, self.topks, self.topps, self.minps,
                       self.pres, self.freqs, self.reps):
            return False
        if self.logprobs_k and any(
                self._lp_want[s] for s in range(self.n_slots)
                if self.active[s]):
            return False
        return True

    def forced_pending(self) -> bool:
        """Any active constrained slot whose NEXT token is forced (a
        single non-eos legal continuation)?  The cheap trigger for
        :meth:`jump_round`."""
        if not self.jump_ready():
            return False
        for s in range(self.n_slots):
            if self.active[s] and self.gstate[s] >= 0:
                row = self._gtable_np[self.gstate[s]]
                allowed = np.flatnonzero(row >= 0)
                if allowed.size == 1 and int(allowed[0]) != self.eos_id:
                    return True
        return False

    @torch.no_grad()
    def jump_round(self) -> Optional[Dict[int, List[int]]]:
        """Structural jump-ahead for grammar-constrained decoding: the
        tokens the DFA FORCES (exactly one legal continuation) are
        committed in ONE ``[S, jump_len + 1]`` extend, run eagerly like
        an admission, plus a masked-argmax bonus token from each slot's
        post-chain position: 1..jump_len+1 tokens a slot for one host
        round trip, the ids of :meth:`step` decoding (a forced token IS
        the greedy pick: every alternative sits at -1e9).  Greedy only
        (see :meth:`jump_ready`).  Returns None when the fixed band
        cannot run safely (a slot lacks jump_len + 1 rows of headroom,
        or a parked donor's prompt rows would sit inside the clamped
        write band); the caller then steps.  Unconstrained active slots
        ride the same extend and commit their position-0 pick, exactly
        a step's commit."""
        if not self.jump_ready():
            raise ValueError(
                "jump_round needs grammar-live all-greedy traffic "
                "(jump_ready() is the predicate)")
        if self._inflight_scan is not None:
            raise RuntimeError(
                "a dispatched window is outstanding (scan_harvest it "
                "first)")
        if not any(self.active):
            return {}
        for s in range(self.n_slots):
            if self.active[s] and self.lens[s] >= self.model.max_len:
                self._finish(s)
        if not any(self.active):
            return {}
        S, T = self.n_slots, self.jump_len + 1
        headroom = min(self.model.max_len - self.lens[s]
                       for s in range(S) if self.active[s])
        if headroom < T:
            return None  # endgame: the clamped band would hit live rows
        for s in range(S):
            # parked donors: the masked extend's clamped writes land on
            # rows [max_len - T, max_len - 1], and every parked prompt's
            # canon rows must sit below them
            if (self.auto_prefix and not self.active[s]
                    and self._slot_prompts[s] is not None
                    and self._slot_prompts[s][2] > self.model.max_len - T):
                return None
        chains: Dict[int, List[int]] = {}
        post = np.full(S, -1, np.int64)
        for s in range(S):
            if not self.active[s]:
                continue
            chains[s] = []
            if self.gstate[s] >= 0:
                chains[s] = self._forced_chain(int(self.gstate[s]),
                                               self.jump_len)
                st = int(self.gstate[s])
                for t in chains[s]:
                    st = int(self._gtable_np[st, t])
                post[s] = st
        self._ensure_append_pages(T)
        if not any(self.active):
            return {}
        toks = np.zeros((S, T), np.int64)
        toks[:, 0] = self.last_token
        for s, c in chains.items():
            toks[s, 1:1 + len(c)] = c
        k = np.asarray([len(chains.get(s, ())) for s in range(S)], np.int64)
        dev = self.device
        positions = (torch.as_tensor(np.asarray(self.lens, np.int32),
                                     device=dev)[:, None]
                     + torch.arange(T, dtype=torch.int32, device=dev))
        if self._paged:
            self._bt()
        logits = self._extend(torch.from_numpy(toks).to(dev), positions,
                              self._paged,
                              torch.from_numpy(self.adapters).to(dev))
        # the bonus pick from each slot's post-chain position
        kd = torch.from_numpy(k).to(dev)
        lg = logits[torch.arange(S, device=dev), kd]
        if self._bias_live():
            lg = lg + self._bias
        if self._min_live():
            emitted = np.asarray([len(self.outputs[s]) for s in range(S)])
            gate = ((emitted + k) < self.min_toks).astype(np.float32)
            lg = lg + self._min_mask * torch.from_numpy(gate).to(dev)[:, None]
        gon = torch.from_numpy((post >= 0).astype(np.float32)).to(dev)
        grow = self._gtable[torch.from_numpy(np.maximum(post, 0)).to(dev)]
        lg = lg + torch.where(grow < 0, -1e9, 0.0) * gon[:, None]
        bonus = torch.argmax(lg, dim=-1).cpu().numpy()
        self._steps += 1
        self._jump_rounds += 1

        out: Dict[int, List[int]] = {}
        new_lens = np.zeros(S, np.int32)
        dispatched = np.asarray(self.active, bool)
        for s in range(S):
            if not dispatched[s]:
                self.lens[s] += T  # host mirror only
                continue
            committed = chains[s] + [int(bonus[s])]
            toks_out = []
            n_c = len(committed)
            for j, tok in enumerate(committed):
                self.last_token[s] = tok
                self.outputs[s].append(tok)
                self._tokens += 1
                toks_out.append(tok)
                if self.gstate[s] >= 0:
                    self.gstate[s] = int(self._gtable_np[self.gstate[s],
                                                         tok])
                self._maybe_finish(s, tok)
                if not self.active[s]:
                    n_c = j + 1  # later tokens discarded
                    break
            self.lens[s] += n_c
            # forced-token accounting from the committed prefix
            self._jump_forced += min(n_c, len(chains[s]))
            new_lens[s] = self.lens[s]
            if self.active[s] and self.lens[s] >= self.model.max_len:
                self._finish(s)
            out[s] = toks_out
        _rollback_active(self.cache, new_lens, dispatched)
        return out

    def run_scan(self, n_steps: int) -> Dict[int, List[int]]:
        """*n_steps* decode steps as one window with no host round trip
        in between: on CUDA ``n_steps`` replays of the captured step.
        Token for token identical to ``n_steps`` x :meth:`step` when no
        admissions interleave; eos/budget retirement applies after the
        window (retired slots' extra tokens are computed and dropped).
        Every active slot needs *n_steps* rows of cache headroom.
        Returns {slot: [tokens]} for slots active at entry."""
        if n_steps < 1:
            raise ValueError("n_steps must be >= 1")
        if not any(self.active):
            return {}
        return self.scan_harvest(self.scan_dispatch(n_steps))

    def scan_dispatch(self, n_steps: int) -> _ScanHandle:
        """Enqueue *n_steps* decode steps and return without waiting
        for the device; :meth:`scan_harvest` reads them.  In between the
        host may run admission work (it lands after the window on the
        same stream), but no other decode path."""
        return self._dispatch(n_steps, self.fused_decode)

    def _dispatch(self, n_steps: int, fused: bool) -> _ScanHandle:
        if n_steps < 1:
            raise ValueError("n_steps must be >= 1")
        if self._inflight_scan is not None:
            raise RuntimeError(
                "a dispatched window is already outstanding "
                "(scan_harvest it first)")
        if not any(self.active):
            raise RuntimeError("no active slots to scan")
        for s in range(self.n_slots):
            if self.active[s] and \
                    self.lens[s] + n_steps > self.model.max_len:
                raise ValueError(
                    f"slot {s} has {self.model.max_len - self.lens[s]} "
                    f"cache rows left, need {n_steps}")
        # the block tables stay fixed for the window: its pages are
        # allocated (or copied on write) on the host before it runs
        self._ensure_append_pages(n_steps)
        if not any(self.active):
            raise RuntimeError(
                "page-pressure policy preempted every active slot")
        sampled = _knobs_live(self.temps, self.topks, self.topps,
                              self.minps, self.pres, self.freqs,
                              self.reps)
        pen = self._pen_live()
        rep = self._rep_live()
        seeded = bool(self._seed_on.any())
        # logprob stats ride the window only when someone listens
        lp_k = self.logprobs_k if any(
            self._lp_want[s] for s in range(self.n_slots)
            if self.active[s]) else 0
        K = 0
        if fused:
            stop_mat = self._stop_matrix()
            K = stop_mat.shape[1]
            self._w.load_stops(self._stage.put(stop_mat))
        grammared = self._grammar_live()
        flags = (sampled, lp_k, pen, rep, seeded, self._bias_live(),
                 self._min_live(), grammared, fused, K, self._paged)
        self._load_window()
        if self._use_graphs:
            graph = self._graph(flags)
            for _ in range(n_steps):
                graph.replay()
            self.graph_replays += n_steps
        else:
            for _ in range(n_steps):
                self._decode_step(flags)
        handle = _ScanHandle(n_steps, sampled, lp_k, grammared,
                             list(self.active), fused)
        self._inflight_scan = handle
        return handle

    def _stop_matrix(self) -> np.ndarray:
        """The per-slot stop ids [S, K] (pad -1), K the widest set
        rounded up to a multiple of ``_STOP_PAD``."""
        widest = max(len(self._stops[s]) for s in range(self.n_slots))
        K = max(_STOP_PAD, -(-widest // _STOP_PAD) * _STOP_PAD)
        mat = np.full((self.n_slots, K), -1, np.int64)
        for s in range(self.n_slots):
            for j, t in enumerate(sorted(self._stops[s])):
                mat[s, j] = t
        return mat

    def _load_window(self) -> None:
        """Host state into the window's buffers: the step's inputs, the
        knobs, the draw counters and the boundary state."""
        S = self.n_slots
        eos = -1 if self.eos_id is None else int(self.eos_id)
        ints = {
            "tok": self.last_token, "pos": self.lens,
            "slot_draws": self._slot_draws,
            "emitted": [len(self.outputs[s]) for s in range(S)],
            "topks": self.topks, "min_toks": self.min_toks,
            "seed_keys": self._seed_keys, "seed_on": self._seed_on,
            "eos": [-1 if self._ignore_eos[s] else eos for s in range(S)],
            "fin": -1, "frs": 0, "slots": np.arange(S),
            "draws": self._draws, "step": 0, "key": self._key,
            "budget": (self.max_new_tokens
                       if self.max_new_tokens is not None
                       else _NO_BUDGET),
            "gstate": self.gstate, "adapters": self.adapters,
        }
        floats = {"temps": self.temps, "topps": self.topps,
                  "minps": self.minps, "pres": self.pres,
                  "freqs": self.freqs, "reps": self.reps}
        self._w.load(ints, floats)
        if self._paged:
            self._bt()

    def scan_abandon(self, handle: _ScanHandle) -> None:
        """Drop a dispatched window without its host bookkeeping; the
        caller releases every slot."""
        if self._inflight_scan is handle:
            self._inflight_scan = None

    def scan_harvest(self, handle: _ScanHandle) -> Dict[int, List[int]]:
        """Read a dispatched window's outputs (its one wait for the
        device) and run the host bookkeeping for every slot that was in
        it.  Slots spliced or released after the dispatch
        (``handle.skip``) keep the lens and draw counters set since."""
        self._inflight_scan = None
        w = self._w
        n_steps = handle.n_steps
        sampled, lp_k = handle.sampled, handle.lp_k
        skip = handle.skip
        live = [handle.active[s] and self.active[s] and s not in skip
                for s in range(self.n_slots)]
        host = w.fetch(n_steps, bool(lp_k), handle.fused)
        toks = host[0]  # [n_steps, S]
        if lp_k:
            clps, tlps, tids = host[1:4]
        self._steps += n_steps
        out: Dict[int, List[int]] = {
            s: [] for s in range(self.n_slots) if live[s]
        }
        if handle.fused:
            return self._harvest_fused(
                handle, live, toks, clps if lp_k else None,
                tlps if lp_k else None, tids if lp_k else None,
                host[-2], host[-1], out)
        if not sampled and not lp_k and not handle.grammared:
            # greedy fast path: no draws, no logprobs and no DFA walk, so
            # each column is cut at its first eos, stop id or budget
            # (eos > stop > length on one token, the earliest first)
            for s in range(self.n_slots):
                if s not in skip:
                    self.lens[s] += n_steps
            eos = None if self.eos_id is None else int(self.eos_id)
            for s in list(out):
                col = toks[:, s].tolist()
                fin = None
                if eos is not None and not self._ignore_eos[s]:
                    try:
                        fin = (col.index(eos), "eos")
                    except ValueError:
                        pass
                stops = self._stops[s]
                if stops:
                    for i, t in enumerate(
                            col if fin is None else col[:fin[0]]):
                        if t in stops:
                            fin = (i, "stop")
                            break
                if self.max_new_tokens is not None:
                    room = self.max_new_tokens - len(self.outputs[s])
                    if room <= n_steps and (
                            fin is None or room - 1 < fin[0]):
                        fin = (room - 1, "length")
                kept = col if fin is None else col[:fin[0] + 1]
                self.outputs[s].extend(kept)
                out[s] = kept
                self._tokens += len(kept)
                if kept:
                    self.last_token[s] = kept[-1]
                if fin is not None:
                    self._finish(s, fin[1])
            return out
        # the draw accounting of step(): a draw is consumed while some
        # armed slot is still live (retirement resets its knobs); the
        # armed set is taken once and only shrinks, as slots finish
        armed: set = set()
        if sampled:
            lv = _knobs_live_vec(self.temps, self.topks, self.topps,
                                 self.minps, self.pres, self.freqs,
                                 self.reps)
            armed = {s for s in range(self.n_slots)
                     if lv[s] and s not in skip}
        draws_used = 0
        for i in range(n_steps):
            if sampled and armed:
                draws_used += 1
            if lp_k:
                for s in range(self.n_slots):
                    if (handle.active[s] and s not in skip
                            and self.active[s] and self._lp_want[s]):
                        self._record_logprobs(s, float(clps[i, s]),
                                              tlps[i, s], tids[i, s])
            for s in range(self.n_slots):
                if s not in skip:
                    self.lens[s] += 1
                if s in skip or not (handle.active[s]
                                     and self.active[s]):
                    continue
                tok = int(toks[i, s])
                if handle.grammared and self.gstate[s] >= 0:
                    # the host mirror of the step's transitions, walked
                    # over the same emitted tokens
                    self.gstate[s] = int(self._gtable_np[self.gstate[s],
                                                         tok])
                self.last_token[s] = tok
                self.outputs[s].append(tok)
                self._tokens += 1
                out[s].append(tok)
                self._maybe_finish(s, tok)
                if not self.active[s]:
                    armed.discard(s)
        self._draws += draws_used
        self._slot_draws = [
            d if s in skip else d + draws_used
            for s, d in enumerate(self._slot_draws)]
        return out

    def _harvest_fused(self, handle: _ScanHandle, live, toks,
                       clps, tlps, tids, fin, frs,
                       out: Dict[int, List[int]]) -> Dict[int, List[int]]:
        """Columnar harvest of a fused window: the device found each
        slot's first eos/stop/budget boundary (``fin``, ``frs``), so the
        host slices kept prefixes.  Every effect (outputs, lens,
        logprobs, draws, finish order) is what the unfused harvest
        gives for the same window."""
        n_steps, skip = handle.n_steps, handle.skip
        sampled, lp_k = handle.sampled, handle.lp_k
        self._fused_windows += 1
        for s in range(self.n_slots):
            if s not in skip:
                self.lens[s] += n_steps
        live_idx = [s for s in range(self.n_slots) if live[s]]
        keep = {s: (int(fin[s]) + 1 if fin[s] >= 0 else n_steps)
                for s in live_idx}
        self._fused_truncated += sum(
            n_steps - keep[s] for s in live_idx)
        # one draw a step while an armed slot is live: the longest kept
        # prefix over the armed set
        draws_used = 0
        if sampled:
            lv = _knobs_live_vec(self.temps, self.topks, self.topps,
                                 self.minps, self.pres, self.freqs,
                                 self.reps)
            draws_used = max(
                (keep[s] for s in live_idx
                 if lv[s] and s not in skip), default=0)
        if handle.grammared:
            # batched DFA walk over the columns still emitting; a state
            # can go negative mid-walk, which drops the column as the
            # per-token ``gstate >= 0`` guard does
            gs = self.gstate
            for i in range(n_steps):
                cols = np.asarray([s for s in live_idx
                                   if keep[s] > i and gs[s] >= 0], np.int64)
                if cols.size == 0:
                    break
                gs[cols] = self._gtable_np[gs[cols], toks[i, cols]]
        if lp_k:
            for s in live_idx:
                n = self._lp_want[s]
                if not n:
                    continue
                k = keep[s]
                cl = clps[:k, s].tolist()
                tl = tlps[:k, s, :n].tolist()
                ti = tids[:k, s, :n].tolist()
                self._lp_records[s].extend(
                    (cl[i], list(zip(ti[i], tl[i])))
                    for i in range(k))
        for s in live_idx:
            kept = toks[:keep[s], s].tolist()
            self.outputs[s].extend(kept)
            out[s] = kept
            self._tokens += len(kept)
            if kept:
                self.last_token[s] = kept[-1]
        # the unfused harvest retires in slot order on its greedy path
        # and in (finish step, slot) order otherwise
        finishing = [s for s in live_idx if fin[s] >= 0]
        if sampled or lp_k or handle.grammared:
            finishing.sort(key=lambda s: (int(fin[s]), s))
        reasons = {1: "eos", 2: "stop", 3: "length"}
        for s in finishing:
            self._finish(s, reasons[int(frs[s])])
        if sampled:
            self._draws += draws_used
            self._slot_draws = [
                d if s in skip else d + draws_used
                for s, d in enumerate(self._slot_draws)]
        return out

    # -- completion --------------------------------------------------------

    def _maybe_finish(self, slot: int, token: int) -> None:
        if (self.eos_id is not None and token == self.eos_id
                and not self._ignore_eos[slot]):
            self._finish(slot, "eos")
        elif token in self._stops[slot]:
            self._finish(slot, "stop")
        elif (self.max_new_tokens is not None
              and len(self.outputs[slot]) >= self.max_new_tokens):
            self._finish(slot, "length")

    def _finish(self, slot: int, reason: str = "length") -> None:
        self._finished[slot] = self.outputs[slot]
        self._finish_reason[slot] = reason
        self.active[slot] = False
        self._completed += 1
        self._reset_slot_params(slot)

    def finished(self, slot: int) -> bool:
        return slot in self._finished

    def finish_reason(self, slot: int) -> Optional[str]:
        """Why the slot finished: "eos", "stop" or "length"; None while
        the request is in flight."""
        return self._finish_reason.get(slot)

    def output(self, slot: int) -> List[int]:
        """Generated tokens for *slot* (finished or in flight)."""
        return list(self.outputs[slot])

    def stats(self) -> Dict[str, int]:
        """Engine counters, with the reference's keys (the pool's, the
        preemptions and the parked sessions too on a paged engine)."""
        out = {
            "n_slots": self.n_slots,
            "active_slots": sum(self.active),
            "free_slots": self.n_slots - sum(self.active),
            "reserved_slots": sum(self._reserved),
            "finished_requests": self._completed,
            "registered_prefixes": len(self._prefixes),
            "tokens_emitted": self._tokens,
            "decode_steps": self._steps,
            "prefill_tokens": self._prefill_tokens,
            "prefix_cache_hits": self._prefix_hits,
            "prefix_reused_tokens": self._prefix_reused_tokens,
            "spec_rounds": self._spec_rounds,
            "spec_proposed": self._spec_proposed,
            "spec_accepted": self._spec_accepted,
            "jump_rounds": self._jump_rounds,
            "jump_forced_tokens": self._jump_forced,
            "prefix_evictions": self._prefix_evictions,
            "packed_prefill_extends": self._packed_extends,
            "packed_prefill_rows": self._packed_rows,
            "packed_prefill_requests": self._packed_requests,
            "packed_prefill_pad_tokens": self._packed_pad_tokens,
            "fused_windows": self._fused_windows,
            "fused_truncated_tokens": self._fused_truncated,
        }
        if self._paged:
            out.update(self._pool.stats())
            out["kv_preemptions"] = self._kv_preemptions
            out["kv_sessions_parked"] = len(self.session_slots())
        if self.mesh is not None:
            out["tp_size"] = self.model.tp_size
            # captured over NCCL, op by op over gloo (or on the CPU)
            out["tp_steps"] = "captured" if self._use_graphs else "eager"
        return out

    def release(self, slot: int) -> None:
        """Free a slot (abandons any in-flight generation).  Its prompt
        record survives: the rows [0, canon) stay valid donors for
        automatic prefix matches until the slot is admitted into again,
        since a parked slot's masked decode writes clamp to row
        max_len - 1 (max_len - gamma - 1 under a speculative proposer,
        whose verify writes gamma + 1 rows), below which every prompt
        lies."""
        if self._inflight_scan is not None:
            self._inflight_scan.skip.add(slot)
        self.active[slot] = False
        self._finished.pop(slot, None)
        self._finish_reason.pop(slot, None)
        self.lens[slot] = 0
        self._reset_slot_params(slot)

    def _reset_slot_params(self, slot: int) -> None:
        """Clear a freed slot's knobs: the greedy fast path looks at the
        whole knob vectors."""
        self.temps[slot] = 0.0
        self.topks[slot] = 0
        self.topps[slot] = 1.0
        self.minps[slot] = 0.0
        self.pres[slot] = 0.0
        self.freqs[slot] = 0.0
        self.reps[slot] = 1.0
        self.adapters[slot] = -1
        self._stops[slot] = frozenset()
        self._ignore_eos[slot] = False
        self._seed_on[slot] = 0
        self._lp_want[slot] = 0  # records stay readable after finish
        # parked-donor LRU stamp: under pool pressure the oldest parked
        # record's pages are reclaimed first
        self._park_counter += 1
        self._park_seq[slot] = self._park_counter

    # -- speculative decoding ----------------------------------------------

    @torch.no_grad()
    def spec_round(self) -> Dict[int, List[int]]:
        """One speculative round for every active slot: the proposer
        gives ``gamma`` tokens a slot (the draft model's greedy steps on
        its own cache, or prompt lookup over the slot's history), the
        target verifies them in ONE ``[S, gamma + 1]`` extend, and each
        slot commits its accepted prefix plus the target's own next
        token: 1..gamma+1 tokens a slot for one host round trip, the ids
        of greedy :meth:`step` decoding.  Op by op, on CUDA too.

        Greedy only, as its first-mismatch rule is: raises if an active
        slot armed sampling knobs, logprobs or a grammar.  Near the end
        of the cache (a slot with fewer than gamma + 1 rows left) it
        steps instead.  Returns {slot: [tokens]}."""
        if self._draft_model is None and not self._ngram:
            raise RuntimeError(
                "engine was built without a speculative proposer "
                "(ServingEngine(..., draft=model) or draft=\"ngram\")")
        if _knobs_live(self.temps, self.topks, self.topps, self.minps,
                       self.pres, self.freqs, self.reps):
            raise ValueError(
                "speculative decoding is greedy-only: a slot armed "
                "sampling/penalty knobs")
        if self.logprobs_k and any(
                self._lp_want[s] for s in range(self.n_slots)
                if self.active[s]):
            raise ValueError(
                "speculative decoding does not produce per-token "
                "logprobs (the accepted tokens skip their own decode "
                "step)")
        if self._grammar_live():
            raise ValueError(
                "speculative decoding does not compose with grammar "
                "constraints (verify positions depend on sequential "
                "DFA states); decode grammar requests with "
                "step/run_scan")
        if self._inflight_scan is not None:
            raise RuntimeError(
                "a dispatched window is outstanding (scan_harvest it "
                "first)")
        if not any(self.active):
            return {}
        for s in range(self.n_slots):
            if self.active[s] and self.lens[s] >= self.model.max_len:
                self._finish(s)
        if not any(self.active):
            return {}
        S, g = self.n_slots, self.gamma
        headroom = min(self.model.max_len - self.lens[s]
                       for s in range(S) if self.active[s])
        if headroom < g + 1:
            # a verify position at max_len would clamp onto the slot's
            # last valid row: the endgame steps (the draft cache goes
            # stale for those tokens, which costs accept rate only)
            return {s: [t] for s, t in self.step().items()}
        self._ensure_append_pages(g + 1)
        if not any(self.active):
            return {}
        dev = self.device
        first = torch.from_numpy(self.last_token.astype(np.int64)).to(dev)
        pos0 = torch.from_numpy(np.asarray(self.lens, np.int32)).to(dev)
        if self._ngram:
            # host-side proposals from the resident prompt and outputs
            pnp = np.zeros((S, g), np.int64)
            for s in range(S):
                if not self.active[s]:
                    continue
                rec = self._slot_prompts[s]
                hist = np.concatenate([
                    rec[0] if rec is not None else np.zeros(0, np.int32),
                    np.asarray(self.outputs[s], np.int32)])
                pnp[s] = _ngram_propose(hist, self.ngram_n, g)
            props = torch.from_numpy(pnp).to(dev)
        else:
            props, _ = _draft_propose(self._draft_model, g,
                                      self._draft_cache, first, pos0)
            props = props.long()
        verify = torch.cat([first[:, None], props], dim=1)
        positions = pos0[:, None] + torch.arange(g + 1, dtype=torch.int32,
                                                 device=dev)
        if self._paged:
            self._bt()
        logits = self._extend(verify, positions, self._paged,
                              torch.from_numpy(self.adapters).to(dev))
        if self._bias_live():
            # the verify rule is the biased argmax plain decoding uses
            logits = logits + self._bias[:, None, :]
        if self._min_live():
            # verify position j emits output token emitted + j: the
            # floor lifts per position where plain decoding lifts it
            emitted = np.asarray([len(self.outputs[s]) for s in range(S)])
            gate = ((emitted[:, None] + np.arange(g + 1)[None, :])
                    < self.min_toks[:, None]).astype(np.float32)
            logits = logits + self._min_mask[:, None, :] * \
                torch.from_numpy(gate).to(dev)[:, :, None]
        tgt = torch.argmax(logits, dim=-1)                   # [S, g + 1]
        # one read of proposals and choices together
        both = torch.cat([props, tgt], dim=1).cpu().numpy()
        props_h, tgt_h = both[:, :g], both[:, g:]
        self._steps += 1
        self._spec_rounds += 1

        out: Dict[int, List[int]] = {}
        new_lens = np.zeros(S, np.int32)
        dispatched = np.asarray(self.active, bool)  # active at verify
        for s in range(S):
            if not dispatched[s]:
                # host mirror only: a parked slot's device lens stays
                # high, so its clamped writes stay past its donor rows
                self.lens[s] += g + 1
                continue
            acc = 0
            while acc < g and props_h[s, acc] == tgt_h[s, acc]:
                acc += 1
            self._spec_proposed += g
            self._spec_accepted += acc
            # committed: the accepted proposals and the target's own
            # token, tgt_h[s, :acc + 1], capped at the cache end
            k = min(acc + 1, self.model.max_len - self.lens[s])
            toks = []
            for j in range(k):
                tok = int(tgt_h[s, j])
                self.last_token[s] = tok
                self.outputs[s].append(tok)
                self._tokens += 1
                toks.append(tok)
                self._maybe_finish(s, tok)
                if not self.active[s]:
                    k = j + 1  # later verify tokens are dropped
                    break
            self.lens[s] += k
            new_lens[s] = self.lens[s]
            if self.active[s] and self.lens[s] >= self.model.max_len:
                self._finish(s)
            out[s] = toks
        # both caches roll back to the committed length: the target
        # keeps its accepted verify rows, the draft holds [first,
        # props[:-1]] and the extra append, so rows below lens are valid
        # in both (slots that finished in the loop get their exact lens)
        _rollback_active(self.cache, new_lens, dispatched)
        if self._draft_cache is not None:
            _rollback_active(self._draft_cache, new_lens, dispatched)
        return out

    def run_spec(self, max_rounds: int) -> None:
        """Speculative rounds until every slot retires (the counterpart
        of :meth:`run`)."""
        for _ in range(max_rounds):
            if not any(self.active):
                return
            self.spec_round()

    @property
    def accept_rate(self) -> float:
        """Share of the proposals the target kept (a measure of the
        proposer, not a correctness knob)."""
        return (self._spec_accepted / self._spec_proposed
                if self._spec_proposed else 0.0)

    def spec_ready(self) -> bool:
        """Would :meth:`spec_round` run right now?  True iff a proposer
        is loaded and no active slot armed sampling knobs, logprobs or a
        grammar: the schedulers' predicate for spec rounds (greedy
        traffic) over windows (mixed traffic)."""
        if self._draft_model is None and not self._ngram:
            return False
        if _knobs_live(self.temps, self.topks, self.topps, self.minps,
                       self.pres, self.freqs, self.reps):
            return False
        if self.logprobs_k and any(
                self._lp_want[s] for s in range(self.n_slots)
                if self.active[s]):
            return False
        if self._grammar_live():
            return False
        return True
