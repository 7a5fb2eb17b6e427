"""Fused stride-1 SAME conv (odd window) + 3x3/s2 VALID max-pool over
NHWC: a hand-written Hopper kernel and its plain PyTorch version.

:func:`conv_pool` is the public function, an autograd function taking
``x [B, H, W, C]`` and an HWIO ``kernel [w, w, C, F]`` (cast to x's
dtype), as in the JAX package.  It equals ``max_pool(conv(x, kernel),
3, 2)`` where the conv accumulates in f32 and is rounded to x's dtype
before the pool, with the pre-pool activation never written out.  Its
backward scatters the pooled gradient through the pool index with K2
(``workloads/pool.py``) into the conv-output gradient, then takes the
conv's own input and weight gradients from PyTorch (the JAX package
leaves that conv VJP to XLA).

CPU tensors take :func:`conv_pool_plain`; CUDA tensors launch K3 from
``csrc/conv_pool_fwd.cu`` through :func:`conv_pool_cuda`, or raise.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from .. import build
from .pool import _out_dim, max_pool_fwd_plain, pool_bwd

POOL_WINDOW = 3  # pool window (VALID)
POOL_STRIDE = 2

_KERNEL_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_BLOCK_FEATURES = 64  # the kernel's blocks are multiples of this wide
_fn = None


def _check_shapes(x: torch.Tensor, kernel: torch.Tensor) -> None:
    if x.dim() != 4:
        raise ValueError(f"expected NHWC x [B, H, W, C], got "
                         f"{tuple(x.shape)}")
    c = x.shape[-1]
    window = kernel.shape[0] if kernel.dim() == 4 else 0
    if kernel.dim() != 4 or tuple(kernel.shape[:3]) != (window, window, c) \
            or window % 2 != 1:
        raise ValueError(
            f"kernel {tuple(kernel.shape)} must be odd-square x C={c}")
    if x.shape[1] < POOL_WINDOW or x.shape[2] < POOL_WINDOW:
        raise ValueError(f"input {tuple(x.shape)} is smaller than the "
                         "pool window")


def _conv(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Stride-1 SAME conv over NHWC with an HWIO kernel, in x's dtype."""
    out = F.conv2d(x.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1),
                   padding=kernel.shape[0] // 2)
    return out.permute(0, 2, 3, 1)


def conv_pool_plain(x: torch.Tensor, kernel: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3's function in plain PyTorch: ``(y, idx)``.  The conv runs in
    f32 on the operands rounded to x's dtype (f32 accumulation, as the
    kernel's), is rounded to x's dtype, and is pooled with K1's rule."""
    _check_shapes(x, kernel)
    conv = _conv(x.float(), kernel.to(x.dtype).float())
    return max_pool_fwd_plain(conv.to(x.dtype).contiguous(), POOL_WINDOW,
                              POOL_STRIDE)


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = build.load("conv_pool_fwd").conv_pool_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def conv_pool_cuda(x: torch.Tensor, kernel: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K3 on CUDA tensors; raises on what it does not take.
    ``conv_pool_cuda.launches`` counts launches."""
    _check_shapes(x, kernel)
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"the conv+pool kernel takes bf16 or f32, got "
                        f"{x.dtype}")
    for t in (x, kernel):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError("conv_pool_cuda needs CUDA tensors on one "
                             "device")
    if not x.is_contiguous():
        raise ValueError("the conv+pool kernel needs a contiguous NHWC x")
    B, H, W, C = x.shape
    window, feat = kernel.shape[0], kernel.shape[3]
    if feat % _BLOCK_FEATURES:
        raise ValueError(f"the conv+pool kernel needs F % "
                         f"{_BLOCK_FEATURES} == 0, got F={feat}")
    if x.dtype == torch.bfloat16 and (C % 8 or x.data_ptr() % 16):
        raise ValueError("the bf16 conv+pool kernel reads 16 bytes of "
                         "channels: C % 8 == 0 and a 16-byte aligned x")
    # tap-packed [F, window^2 * C]: tap-major (di, dj), channel-minor
    kp = kernel.to(x.dtype).permute(3, 0, 1, 2).reshape(feat, -1)
    kp = kp.contiguous()
    oh = _out_dim(H, POOL_WINDOW, POOL_STRIDE)
    ow = _out_dim(W, POOL_WINDOW, POOL_STRIDE)
    y = torch.empty((B, oh, ow, feat), dtype=x.dtype, device=x.device)
    idx = torch.empty((B, oh, ow, feat), dtype=torch.int8, device=x.device)
    if y.numel() == 0:
        return y, idx
    with torch.cuda.device(x.device):
        err = _kernel_fn()(
            x.data_ptr(), kp.data_ptr(), y.data_ptr(), idx.data_ptr(),
            _KERNEL_DTYPES[x.dtype], B, H, W, C, feat, window,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err == -2:
        raise ValueError(f"input {tuple(x.shape)} is too wide for the "
                         "conv+pool kernel's shared-memory tile")
    if err != 0:
        raise RuntimeError(f"conv_pool_fwd launch failed: error {err}")
    conv_pool_cuda.launches += 1
    return y, idx


conv_pool_cuda.launches = 0


def _conv_pool_fwd(x: torch.Tensor, kernel: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    if x.device.type == "cpu":
        return conv_pool_plain(x, kernel)
    if x.device.type == "cuda":
        return conv_pool_cuda(x, kernel)
    raise ValueError(f"conv_pool: no path for device {x.device}")


class _ConvPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel):
        x = x.contiguous()
        y, idx = _conv_pool_fwd(x, kernel)
        ctx.save_for_backward(x, kernel, idx)
        return y

    @staticmethod
    def backward(ctx, dp):
        x, kernel, idx = ctx.saved_tensors
        B, H, W, _ = x.shape
        window, feat = kernel.shape[0], kernel.shape[3]
        dconv = pool_bwd(idx, dp.contiguous(), (B, H, W, feat),
                         POOL_WINDOW, POOL_STRIDE).permute(0, 3, 1, 2)
        weight = kernel.to(x.dtype).permute(3, 2, 0, 1)  # OIHW
        xc = x.permute(0, 3, 1, 2)
        dx = dk = None
        if ctx.needs_input_grad[0]:
            dx = torch.nn.grad.conv2d_input(
                xc.shape, weight, dconv, padding=window // 2)
            dx = dx.permute(0, 2, 3, 1)
        if ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv2d_weight(
                xc, weight.shape, dconv, padding=window // 2)
            dk = dw.permute(2, 3, 1, 0).to(kernel.dtype)
        return dx, dk


def conv_pool(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Fused stride-1 SAME conv (odd window, HWIO kernel) + 3x3/s2 VALID
    max-pool over NHWC; the gradient's tie-break is the pool's first
    offset in row-major order."""
    return _ConvPool.apply(x, kernel)
