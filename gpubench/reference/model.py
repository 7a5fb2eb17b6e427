"""The decoder of the configuration files, in plain f32 torch.

Pre-norm blocks: RMSNorm (the configuration's eps), attention with
rotary embeddings (the two halves of each head rotate together, as in
the transformers library's Mistral and Llama code, at the
configuration's ``rope_theta``), grouped or full heads, causal softmax
in f32, output projection; RMSNorm, SwiGLU (``down(silu(gate) * up)``);
a final RMSNorm and the LM head.  Every matmul is f32 with TF32 off.

The forward runs layer by layer over a list of sequences, one layer's
weights at a time, and attention in blocks of query rows, so that it
fits beside whatever else is on the device.  ``quant`` rounds each
matmul's operands before the product: the lower-precision control of
``gpubench.check``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

Leaf = Callable[[str], torch.Tensor]
Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]

# query rows a block of the attention scores holds
_Q_BLOCK = 1024


def tf32_off() -> None:
    """f32 matmuls in f32: no TF32 anywhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x [T, H, Dh] at positions 0..T-1."""
    t, _, dh = x.shape
    half = dh // 2
    inv = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                        device=x.device) / dh))
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] \
        * inv[None, :]
    cos = torch.cos(ang)[:, None, :]
    sin = torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                     ) -> torch.Tensor:
    """q [T, H, Dh], k/v [T, Hkv, Dh]: softmax(q k^T / sqrt(Dh)) v under
    the causal mask, in blocks of query rows; [T, H, Dh]."""
    t, h, dh = q.shape
    g = h // k.shape[1]
    k = k.repeat_interleave(g, dim=1).transpose(0, 1)   # [H, T, Dh]
    v = v.repeat_interleave(g, dim=1).transpose(0, 1)
    qh = q.transpose(0, 1)                              # [H, T, Dh]
    out = torch.empty_like(qh)
    scale = dh ** -0.5
    for r0 in range(0, t, _Q_BLOCK):
        r1 = min(t, r0 + _Q_BLOCK)
        s = torch.matmul(qh[:, r0:r1], k[:, :r1].transpose(1, 2)) * scale
        rows = torch.arange(r0, r1, device=q.device)[:, None]
        cols = torch.arange(r1, device=q.device)[None, :]
        s = s.masked_fill(cols > rows, float("-inf"))
        out[:, r0:r1] = torch.matmul(torch.softmax(s, dim=-1), v[:, :r1])
    return out.transpose(0, 1)


def _mm(x: torch.Tensor, w: torch.Tensor, quant: Quant) -> torch.Tensor:
    """x @ w^T for w [out, in], operands rounded by *quant* if given."""
    if quant is not None:
        x, w = quant(x), quant(w)
    return x @ w.t()


def forward_logits(cfg: Dict, leaf: Leaf, seqs: List[torch.Tensor],
                   want: List[torch.Tensor], quant: Quant = None
                   ) -> List[torch.Tensor]:
    """The f32 logits of each sequence of *seqs* (1-D id tensors on the
    leaves' device) at its positions *want* (1-D index tensors): a list
    of [len(want[i]), vocab]."""
    d = int(cfg["hidden_size"])
    h = int(cfg["num_attention_heads"])
    hkv = int(cfg["num_key_value_heads"])
    dh = int(cfg.get("head_dim") or d // h)
    eps = float(cfg["rms_norm_eps"])
    theta = float(cfg["rope_theta"])
    emb = leaf("embed.weight")
    xs = [emb[s].float() for s in seqs]
    del emb
    for i in range(int(cfg["num_hidden_layers"])):
        w = {n: leaf(f"block_{i}.{n}.weight").float()
             for n in ("qkv", "out_proj", "mlp_gate", "mlp_up", "mlp_down")}
        an = leaf(f"block_{i}.attn_norm.scale").float()
        mn = leaf(f"block_{i}.mlp_norm.scale").float()
        for j, x in enumerate(xs):
            t = x.shape[0]
            qkv = _mm(rms_norm(x, an, eps), w["qkv"], quant)
            q = qkv[:, :h * dh].view(t, h, dh)
            k = qkv[:, h * dh:(h + hkv) * dh].view(t, hkv, dh)
            v = qkv[:, (h + hkv) * dh:].view(t, hkv, dh)
            att = causal_attention(rope(q, theta), rope(k, theta), v)
            x = x + _mm(att.reshape(t, h * dh), w["out_proj"], quant)
            y = rms_norm(x, mn, eps)
            gate = torch.nn.functional.silu(_mm(y, w["mlp_gate"], quant))
            x = x + _mm(gate * _mm(y, w["mlp_up"], quant), w["mlp_down"],
                        quant)
            xs[j] = x
        del w
    fn = leaf("final_norm.scale").float()
    head = leaf("lm_head.weight").float()
    return [_mm(rms_norm(x[p], fn, eps), head, quant)
            for x, p in zip(xs, want)]


def fp8_e4m3(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale for the tensor (its
    largest magnitude to the format's largest, 448), back in f32."""
    amax = x.abs().max().clamp(min=1e-12)
    s = 448.0 / amax
    return (x * s).to(torch.float8_e4m3fn).to(torch.float32) / s
