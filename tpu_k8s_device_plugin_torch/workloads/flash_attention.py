"""Flash attention forward: a hand-written Hopper kernel and its plain
PyTorch version.

:func:`flash_attention` is the public function, on [B, T, H, D] like the
JAX package's.  It dispatches on the tensors' device: CPU tensors take
:func:`flash_attention_plain`; CUDA tensors launch the kernel in
``csrc/flash_attn_fwd.cu`` through :func:`flash_attention_cuda`, or
raise.  K/V may be grouped (``Hkv`` dividing ``H``): query head ``h``
reads KV head ``h // (H // Hkv)``, which is what ``repeat_kv`` followed
by full-head attention computes, without the copy.
"""

from __future__ import annotations

import ctypes

import torch

from .. import build

_KERNEL_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_fn = None


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"expected q [B, Tq, H, D] and k, v [B, Tk, Hkv, D]; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Tq, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError("q and k/v differ in batch or head_dim")
    if k.shape[2] < 1 or H % k.shape[2]:
        raise ValueError(
            f"KV heads {k.shape[2]} must divide query heads {H}")
    if causal and Tq != k.shape[1]:
        raise ValueError("causal flash requires Tq == Tk")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor,
                          causal: bool = False) -> torch.Tensor:
    """The kernel's function in plain PyTorch: f32 scores, a max-shifted
    exponent rounded to the input dtype before the P·V product (as the
    kernels do), normalised by the f32 row sum; rows with no visible
    key give 0."""
    _check_shapes(q, k, v, causal)
    B, Tq, H, D = q.shape
    Tk, n_kv = k.shape[1], k.shape[2]
    g = H // n_kv
    qg = q.to(torch.float32).reshape(B, Tq, n_kv, g, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(torch.float32))
    s = s * (1.0 / D ** 0.5)
    if causal:
        keep = torch.ones(Tq, Tk, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    denom = torch.where(denom == 0, torch.ones_like(denom), denom)
    o = torch.einsum(
        "bhgqk,bkhd->bhgqd", p.to(q.dtype).to(torch.float32),
        v.to(torch.float32)) / denom
    return o.permute(0, 3, 1, 2, 4).reshape(B, Tq, H, D).to(q.dtype)


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = build.load("flash_attn_fwd").flash_attn_fwd
        fn.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
            + [ctypes.c_longlong] * 12
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _strides(x: torch.Tensor):
    """(batch, time, head) element strides; a size-1 dim's stride is
    never used, so it is passed as 0."""
    return [0 if x.shape[i] == 1 else x.stride(i) for i in range(3)]


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor,
                         causal: bool = False) -> torch.Tensor:
    """Launch the Hopper kernel on CUDA tensors; raises on what it does
    not take.  ``flash_attention_cuda.launches`` counts launches."""
    _check_shapes(q, k, v, causal)
    for x in (q, k, v):
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError("flash_attention_cuda needs CUDA tensors on "
                             "one device")
        if x.dtype != q.dtype or x.dtype not in _KERNEL_DTYPES:
            raise TypeError(
                f"flash kernel takes bf16 or f32 q/k/v of one dtype, got "
                f"{q.dtype}, {k.dtype}, {v.dtype}")
        if x.stride(3) != 1:
            raise ValueError("flash kernel needs unit stride on head_dim")
        if x.dtype == torch.bfloat16 and (
                x.data_ptr() % 16 or any(s % 8 for s in _strides(x))):
            raise ValueError(
                "bf16 flash kernel reads 16-byte rows: pointers must be "
                "16-byte aligned and strides multiples of 8 elements")
    B, Tq, H, D = q.shape
    if D % 16 or not 16 <= D <= 128:
        raise ValueError(f"flash kernel supports head_dim 16..128 in "
                         f"steps of 16, got {D}")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    fn = _kernel_fn()
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _KERNEL_DTYPES[q.dtype], B, Tq, k.shape[1], H, k.shape[2], D,
            *_strides(q), *_strides(k), *_strides(v), *_strides(out),
            1.0 / D ** 0.5, int(causal),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd launch failed: error {err}")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """Fused attention on [B, T, H, D] (K/V may carry fewer, grouped
    heads).  CPU tensors take the plain version; CUDA tensors the
    kernel."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal)
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, causal)
    raise ValueError(f"flash_attention: no path for device {q.device}")


def flash_causal_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor,
                           positions: torch.Tensor) -> torch.Tensor:
    """Causal adapter in the attention-function shape ``(q, k, v,
    positions)``: positions must be the natural order 0..T-1, since the
    causal mask follows the storage order.  Grouped K/V go to the kernel
    as they are."""
    del positions
    return flash_attention(q, k, v, causal=True)
