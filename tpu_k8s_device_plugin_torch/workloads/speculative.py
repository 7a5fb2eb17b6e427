"""Speculative decoding: a small draft model proposes, the target verifies
in one banded extend; the output is exactly the target's greedy output.

The JAX package's ``workloads/speculative.py`` in PyTorch.  A round: the
draft proposes ``gamma`` tokens greedily from its own cache, the target
scores the last committed token and the proposals in ONE extend of
``gamma + 1`` positions, the longest prefix of proposals equal to the
target's own argmaxes is accepted and the target's token after it is
committed too (the correction at the first mismatch, or a bonus token
when every proposal was accepted).  Each committed token is the
target's argmax given the same prefix, so the ids equal
``greedy_generate``'s.  Rollback is one write of ``cache_lens``: the
rejected rows stay in the cache past the committed length and the next
append overwrites them.

Runs op by op (no CUDA graph), one host read of the verify's argmaxes
per round; the models hold their weights, so there is no ``params``
argument.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .inference import Cache, DecodeTransformerLM, extend_step, init_cache


def _rollback(cache: Cache, new_len) -> Cache:
    """Set every layer's ``cache_lens`` to *new_len* (an int or a [B]
    tensor), in place: K/V rows past it become dead rows the next append
    overwrites.  Returns the cache."""
    for buf in cache.values():
        lens = buf["cache_lens"]
        if isinstance(new_len, torch.Tensor):
            lens.copy_(new_len.to(lens.dtype))
        else:
            lens.fill_(int(new_len))
    return cache


@torch.no_grad()
def _draft_propose(model: DecodeTransformerLM, gamma: int, cache: Cache,
                   first: torch.Tensor, pos0: torch.Tensor
                   ) -> Tuple[torch.Tensor, Cache]:
    """*gamma* greedy draft tokens [B, gamma] from the draft cache, from
    the last committed tokens *first* [B] at positions *pos0* [B].  The
    gamma steps append the rows of ``[first, props[0..gamma-2]]``; one
    more extend, its logits unused, appends ``props[gamma-1]``, so the
    draft cache covers every token that can be committed (all accepted
    needs that row next round).  Returns (proposals, cache)."""
    tok = first.to(torch.int64)
    pos = pos0.to(torch.int32)
    props = []
    for _ in range(gamma):
        logits, cache = extend_step(model, cache, tok[:, None], pos[:, None])
        tok = torch.argmax(logits[:, -1, :], dim=-1)
        props.append(tok)
        pos = pos + 1
    extend_step(model, cache, tok[:, None], pos[:, None])
    return torch.stack(props, dim=1).to(torch.int32), cache


@torch.no_grad()
def speculative_generate(target: DecodeTransformerLM,
                         draft: DecodeTransformerLM, prompt, n_steps: int,
                         gamma: int = 4) -> Tuple[torch.Tensor, float]:
    """Greedy speculative decoding of one sequence (*prompt* [T_p] or
    [1, T_p]).  Returns ``(generated [n_steps] int32, accept_rate)``:
    the ids are ``greedy_generate(target, ...)``'s, and the accept rate
    is the share of draft proposals the target kept (a measure of the
    draft, not a correctness knob).  Both models run on the target's
    device; the prompt prefills through the extend path, as in the JAX
    package."""
    if gamma < 1:
        raise ValueError("gamma must be >= 1")
    dev = target.device
    prompt = torch.as_tensor(np.asarray(prompt, np.int64),
                             device=dev).reshape(1, -1)
    t_p = int(prompt.shape[1])
    if t_p + n_steps > target.max_len:
        raise ValueError(
            f"prompt {t_p} + steps {n_steps} exceeds target max_len "
            f"{target.max_len}")
    if t_p + n_steps + gamma > draft.max_len:
        raise ValueError(
            f"draft max_len {draft.max_len} too small for prompt {t_p} "
            f"+ steps {n_steps} + gamma {gamma}")

    pos_p = torch.arange(t_p, dtype=torch.int32, device=dev)[None, :]
    t_logits, t_cache = extend_step(target, init_cache(target, 1), prompt,
                                    pos_p)
    _, d_cache = extend_step(draft, init_cache(draft, 1), prompt, pos_p)

    out = [int(torch.argmax(t_logits[0, -1]))]
    produced = 1
    length = t_p  # committed rows in both caches
    proposed_total = accepted_total = 0
    # committed state: both caches hold `length` rows; out[-1] is the
    # last committed token, appended to neither yet
    while produced < n_steps:
        # length == t_p + produced - 1 and t_p + n_steps <= max_len give
        # max_len - length - 1 >= n_steps - produced >= g: the g + 1
        # verify rows fit the target cache
        g = min(gamma, n_steps - produced)
        first = torch.tensor([out[-1]], dtype=torch.int64, device=dev)
        pos0 = torch.tensor([length], dtype=torch.int32, device=dev)
        props, d_cache = _draft_propose(draft, g, d_cache, first, pos0)
        # logits[t] is the target's next-token distribution after
        # out[-1], props[0..t-1]
        verify = torch.cat([first[:, None], props.to(torch.int64)], dim=1)
        verify_pos = (torch.arange(g + 1, dtype=torch.int32, device=dev)
                      + length)[None, :]
        v_logits, t_cache = extend_step(target, t_cache, verify, verify_pos)
        choices = torch.argmax(v_logits[0], dim=-1).cpu().numpy()
        props_h = props[0].cpu().numpy()
        n_acc = 0
        while n_acc < g and choices[n_acc] == props_h[n_acc]:
            n_acc += 1
        new_toks = [int(x) for x in props_h[:n_acc]] + [int(choices[n_acc])]
        new_toks = new_toks[:n_steps - produced]
        out.extend(new_toks)
        produced += len(new_toks)
        proposed_total += g
        accepted_total += n_acc
        # both caches hold length + g + 1 rows, of which 1 + n_acc
        # (first and the accepted proposals) are committed
        length += 1 + n_acc
        _rollback(t_cache, length)
        _rollback(d_cache, length)

    rate = accepted_total / proposed_total if proposed_total else 0.0
    return torch.tensor(out, dtype=torch.int32), rate
