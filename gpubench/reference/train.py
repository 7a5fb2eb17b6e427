"""The training step of the configuration files, in plain f32 torch.

The decoder of ``reference/model.py`` (the same layers, written for
autograd: every block recomputed in the backward pass, attention in
blocks of query rows), mean next-token cross entropy, and Adam written
out: ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g^2``,
``p -= lr * (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)``.  The
weights are made again from the seed, the batches drawn again by the
benchmark's feed; nothing comes from the program.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from .. import weights
from ..feed import Feed
from .model import Quant, causal_attention, fp8_e4m3, rms_norm, rope, tf32_off

__all__ = ["steps", "fp8_e4m3"]


class _RoundST(torch.autograd.Function):
    """*quant* in the forward pass, the gradient passed straight
    through: a product of rounded operands."""

    @staticmethod
    def forward(ctx, x, quant):
        return quant(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _mm(x: torch.Tensor, w: torch.Tensor, quant: Quant) -> torch.Tensor:
    if quant is not None:
        x, w = _RoundST.apply(x, quant), _RoundST.apply(w, quant)
    return x @ w.t()


def _block(x, w, an, mn, cfg, quant):
    d = int(cfg["hidden_size"])
    h = int(cfg["num_attention_heads"])
    hkv = int(cfg["num_key_value_heads"])
    dh = int(cfg.get("head_dim") or d // h)
    eps = float(cfg["rms_norm_eps"])
    theta = float(cfg["rope_theta"])
    t = x.shape[0]
    qkv = _mm(rms_norm(x, an, eps), w["qkv"], quant)
    q = qkv[:, :h * dh].reshape(t, h, dh)
    k = qkv[:, h * dh:(h + hkv) * dh].reshape(t, hkv, dh)
    v = qkv[:, (h + hkv) * dh:].reshape(t, hkv, dh)
    att = causal_attention(rope(q, theta), rope(k, theta), v)
    x = x + _mm(att.reshape(t, h * dh), w["out_proj"], quant)
    y = rms_norm(x, mn, eps)
    gate = torch.nn.functional.silu(_mm(y, w["mlp_gate"], quant))
    return x + _mm(gate * _mm(y, w["mlp_up"], quant), w["mlp_down"], quant)


def _loss(cfg: Dict, leaf, tokens: torch.Tensor, labels: torch.Tensor,
          quant: Quant) -> torch.Tensor:
    eps = float(cfg["rms_norm_eps"])
    total = 0.0
    for b in range(tokens.shape[0]):
        x = leaf("embed.weight")[tokens[b]]
        for i in range(int(cfg["num_hidden_layers"])):
            w = {n: leaf(f"block_{i}.{n}.weight")
                 for n in ("qkv", "out_proj", "mlp_gate", "mlp_up",
                           "mlp_down")}
            x = checkpoint(_block, x, w, leaf(f"block_{i}.attn_norm.scale"),
                           leaf(f"block_{i}.mlp_norm.scale"), cfg, quant,
                           use_reentrant=False)
        logits = _mm(rms_norm(x, leaf("final_norm.scale"), eps),
                     leaf("lm_head.weight"), quant)
        total = total + torch.nn.functional.cross_entropy(
            logits, labels[b], reduction="sum")
    return total / labels.numel()


def steps(cfg: Dict, train: Dict, seed: int, device, n: int = 3,
          quant: Optional[Quant] = None) -> Dict:
    """*n* steps from the seed's weights on the feed's first *n*
    batches: ``losses``, ``g1`` (each leaf's first gradient norm) and
    ``dp`` (each leaf's change norm after the *n* steps)."""
    tf32_off()
    flat, norms = weights.make(cfg, seed, device, torch.float32)
    flat.requires_grad_(True)
    norms.requires_grad_(True)
    bufs = (flat, norms)
    a = train["adam"]
    lr, (b1, b2), eps = float(a["lr"]), a["betas"], float(a["eps"])
    m = [torch.zeros_like(p) for p in bufs]
    v = [torch.zeros_like(p) for p in bufs]
    feed = Feed(int(cfg["vocab_size"]), int(train["batch"]),
                int(train["seq"]), seed, device)
    losses: List[float] = []
    g1: Dict[str, float] = {}
    # the change is the sum of the steps' updates, kept apart from the
    # parameters so no rounding of p_n - p_0 enters it
    moved = [torch.zeros_like(p) for p in bufs]
    for t in range(1, n + 1):
        tokens, labels = feed.next()
        for p in bufs:
            p.grad = None
        table = weights.leaves(cfg, flat, norms)
        loss = _loss(cfg, table.__getitem__, tokens, labels, quant)
        del table
        loss.backward()
        losses.append(float(loss.detach()))
        with torch.no_grad():
            if t == 1:
                gt = weights.leaves(cfg, flat.grad, norms.grad)
                g1 = {k: float(x.norm()) for k, x in gt.items()}
            for i, p in enumerate(bufs):
                m[i].mul_(b1).add_(p.grad, alpha=1 - b1)
                v[i].mul_(b2).addcmul_(p.grad, p.grad, value=1 - b2)
                step = (m[i] / (1 - b1 ** t)) / (
                    (v[i] / (1 - b2 ** t)).sqrt() + eps) * lr
                p.sub_(step)
                moved[i].sub_(step)
    with torch.no_grad():
        dp = {k: float(x.norm())
              for k, x in weights.leaves(cfg, *moved).items()}
    del flat, norms, bufs, m, v, moved
    return dict(losses=losses, g1=g1, dp=dp)
