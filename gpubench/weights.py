"""Seeded weights, made on the device in a few large calls.

The benchmark makes the weights and hands the same tensors to both
sides: the program's parameters become views of the buffers made here
(``bind_``), and the plain reference makes the same buffers again from
the same seed (``make``) after the program's state is freed.  The
layout follows the configuration file alone:

* one buffer in the served (or trained) dtype holds every matrix, in
  the order of :func:`layout`, drawn N(0, 1) by one generator seeded
  with the run's seed, in pieces of at most ``_PIECE`` elements, then
  scaled leaf by leaf to sd 1 for the embedding and 1 / sqrt(fan_in)
  for every projection;
* one f32 buffer holds the RMSNorm scales, 1 + 0.1 N(0, 1), so that a
  scale left out or applied twice shows.

Matrices are stored ``[out, in]``; the fused attention projection is
the rows of the query heads, then the key heads, then the value heads.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

# elements a single draw fills at most: well inside what one kernel
# launch of torch's normal sampler indexes
_PIECE = 1 << 30
_NORM_SALT = 0x5EED


def dims(cfg: Dict) -> Dict[str, int]:
    """The widths the layout needs, from a configuration file."""
    h = int(cfg["num_attention_heads"])
    d = int(cfg["hidden_size"])
    return dict(d=d, f=int(cfg["intermediate_size"]), h=h,
                hkv=int(cfg["num_key_value_heads"]),
                dh=int(cfg.get("head_dim") or d // h),
                layers=int(cfg["num_hidden_layers"]),
                vocab=int(cfg["vocab_size"]))


def layout(cfg: Dict) -> List[Tuple[str, Tuple[int, int], float]]:
    """``(name, [out, in], sd)`` of every matrix, in buffer order."""
    m = dims(cfg)
    d, f, dh = m["d"], m["f"], m["dh"]
    qkv = (m["h"] + 2 * m["hkv"]) * dh
    out = [("embed.weight", (m["vocab"], d), 1.0)]
    for i in range(m["layers"]):
        for name, shape in (("qkv", (qkv, d)), ("out_proj", (d, m["h"] * dh)),
                            ("mlp_gate", (f, d)), ("mlp_up", (f, d)),
                            ("mlp_down", (d, f))):
            out.append((f"block_{i}.{name}.weight", shape,
                        1.0 / math.sqrt(shape[1])))
    out.append(("lm_head.weight", (m["vocab"], d), 1.0 / math.sqrt(d)))
    return out


def norm_names(cfg: Dict) -> List[str]:
    """The RMSNorm scales, in the f32 buffer's row order."""
    n = dims(cfg)["layers"]
    return ([f"block_{i}.{k}_norm.scale" for i in range(n)
             for k in ("attn", "mlp")] + ["final_norm.scale"])


def n_params(cfg: Dict) -> int:
    """Every weight of the configuration (matrices and norm scales)."""
    return (sum(a * b for _, (a, b), _ in layout(cfg))
            + len(norm_names(cfg)) * dims(cfg)["d"])


def make(cfg: Dict, seed: int, device, dtype: torch.dtype
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(flat, norms)`` for *cfg* from *seed* on *device*: the matrices
    in *dtype* and the norm scales in f32, as described above."""
    lay = layout(cfg)
    total = sum(a * b for _, (a, b), _ in lay)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.empty(total, dtype=dtype, device=device)
    for p0 in range(0, total, _PIECE):
        n = min(_PIECE, total - p0)
        flat[p0:p0 + n] = torch.randn(n, generator=gen, dtype=dtype,
                                      device=device)
    off = 0
    for _, (a, b), sd in lay:
        if sd != 1.0:
            flat[off:off + a * b].mul_(sd)
        off += a * b
    gen.manual_seed(int(seed) ^ _NORM_SALT)
    names = norm_names(cfg)
    norms = torch.randn((len(names), dims(cfg)["d"]), generator=gen,
                        dtype=torch.float32, device=device)
    norms.mul_(0.1).add_(1.0)
    return flat, norms


def leaves(cfg: Dict, flat: torch.Tensor, norms: torch.Tensor
           ) -> Dict[str, torch.Tensor]:
    """Every weight by name, as views of the two buffers."""
    out = {}
    off = 0
    for name, (a, b), _ in layout(cfg):
        out[name] = flat[off:off + a * b].view(a, b)
        off += a * b
    for i, name in enumerate(norm_names(cfg)):
        out[name] = norms[i]
    return out


@torch.no_grad()
def bind_(model: torch.nn.Module, cfg: Dict, flat: torch.Tensor,
          norms: torch.Tensor) -> None:
    """Give *model* the benchmark's weights: each matrix parameter
    becomes a view of *flat*, each norm scale a copy of its row of
    *norms* (the program keeps those in f32 whatever it serves in).
    The parameters are replaced, not written, so a model built on the
    ``meta`` device never holds a second copy of the weights.  Raises
    unless the model's parameters are exactly the layout's, by name,
    shape and dtype."""
    want = leaves(cfg, flat, norms)
    have = dict(model.named_parameters())
    if set(have) != set(want):
        raise ValueError(
            f"the model's parameters differ from the configuration's: "
            f"missing {sorted(set(want) - set(have))[:4]}, extra "
            f"{sorted(set(have) - set(want))[:4]}")
    for name, p in have.items():
        w = want[name]
        if p.shape != w.shape:
            raise ValueError(f"{name}: the model has {tuple(p.shape)}, "
                             f"the configuration {tuple(w.shape)}")
        if name.endswith("_norm.scale"):
            w = w.to(p.dtype, copy=True)
        elif p.dtype != w.dtype:
            raise ValueError(f"{name}: the model stores {p.dtype}, the "
                             f"benchmark made {w.dtype}")
        owner, _, leaf = name.rpartition(".")
        model.get_submodule(owner)._parameters[leaf] = torch.nn.Parameter(
            w, requires_grad=p.requires_grad)
    left = [n for n, t in list(model.named_parameters())
            + list(model.named_buffers()) if t.device != flat.device]
    if left:
        raise ValueError(f"not on {flat.device}: {left[:4]}")
