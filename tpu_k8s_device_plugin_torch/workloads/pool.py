"""VALID max-pool over NHWC with an int8 argmax index and a scatter
backward: hand-written Hopper kernels and their plain PyTorch versions.

:func:`max_pool` is the public function, an autograd function on
``[B, H, W, C]``.  Its forward computes the window max and, per output
element, the index ``0..window²-1`` of the *first* window offset in
row-major order whose value equals the max (the tie-break of XLA's
``select_and_scatter``).  An all ``-inf`` window gives ``-inf`` with
index 0; a window whose max is NaN gives NaN with index 0.  The backward
scatters the pooled gradient through that index into an input-shaped
gradient, summing overlapping windows in ascending offset order in the
gradient's dtype, and never re-reads the input.

The index is ``[B, OH, OW, C]`` int8, the output's own layout.  CPU
tensors take :func:`max_pool_fwd_plain` / :func:`max_pool_bwd_plain`;
CUDA tensors launch K1 and K2 from ``csrc/maxpool.cu`` through
:func:`max_pool_fwd_cuda` / :func:`max_pool_bwd_cuda`, or raise.  The
kernels stream bands of whole rows through shared memory, copied with
``cp.async.bulk`` ("bulk") where every copied row is a multiple of 16
bytes, the channels fill 16-byte vectors and two bands fit, else with
plain loads ("cooperative"); the launch code chooses from the shape, and
each wrapper counts its launches per mode in ``modes``.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from .. import build

_KERNEL_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
MODES = ("bulk", "cooperative")
_fns = {}


def _out_dim(size: int, window: int, stride: int) -> int:
    return (size - window) // stride + 1


def _offsets(window: int):
    return [(di, dj) for di in range(window) for dj in range(window)]


def _check_pool(shape: Sequence[int], window: int, stride: int) -> None:
    if len(shape) != 4:
        raise ValueError(f"expected NHWC [B, H, W, C], got {tuple(shape)}")
    if window < 1 or stride < 1 or window * window > 127:
        raise ValueError(f"unsupported window {window} / stride {stride}")
    if shape[1] < window or shape[2] < window:
        raise ValueError(
            f"input {tuple(shape)} is smaller than the {window}x{window} "
            "window")


def _window(x: torch.Tensor, di: int, dj: int, oh: int, ow: int,
            stride: int) -> torch.Tensor:
    """The ``[B, oh, ow, C]`` view of offset (di, dj) of every window."""
    return x[:, di:di + stride * (oh - 1) + 1:stride,
             dj:dj + stride * (ow - 1) + 1:stride]


def max_pool_fwd_plain(x: torch.Tensor, window: int = 3, stride: int = 2
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's function in plain PyTorch: ``(y, idx)``, the window max in
    x's dtype (NaN propagates, as ``torch.maximum`` does) and the int8
    index of the first offset equal to it (0 where none is, so for NaN)."""
    _check_pool(x.shape, window, stride)
    oh = _out_dim(x.shape[1], window, stride)
    ow = _out_dim(x.shape[2], window, stride)
    cands = [_window(x, di, dj, oh, ow, stride)
             for di, dj in _offsets(window)]
    y = cands[0]
    for c in cands[1:]:
        y = torch.maximum(y, c)
    y = y.contiguous()
    idx = torch.zeros(y.shape, dtype=torch.int8, device=x.device)
    found = torch.zeros(y.shape, dtype=torch.bool, device=x.device)
    for k, c in enumerate(cands):
        hit = (c == y) & ~found
        idx.masked_fill_(hit, k)
        found |= hit
    return y, idx


def max_pool_bwd_plain(idx: torch.Tensor, dp: torch.Tensor,
                       xshape: Sequence[int], window: int = 3,
                       stride: int = 2) -> torch.Tensor:
    """K2's function in plain PyTorch: ``dy`` of shape *xshape* in dp's
    dtype; each offset's share is added in ascending offset order, so a
    bf16 sum rounds after every add, as the kernels do."""
    _check_pool(xshape, window, stride)
    oh, ow = idx.shape[1], idx.shape[2]
    dy = torch.zeros(tuple(xshape), dtype=dp.dtype, device=dp.device)
    zero = torch.zeros((), dtype=dp.dtype, device=dp.device)
    for k, (di, dj) in enumerate(_offsets(window)):
        _window(dy, di, dj, oh, ow, stride).add_(
            torch.where(idx == k, dp, zero))
    return dy


def _kernel_fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build.load("maxpool"), name)
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 8
                       + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check_cuda(*tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError("the pool kernels need CUDA tensors on one "
                             "device")
        if not t.is_contiguous():
            raise ValueError("the pool kernels need contiguous NHWC tensors")


def _check_dtype(t: torch.Tensor) -> None:
    if t.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"the pool kernels take bf16 or f32, got {t.dtype}")


def _vec(c: int, data: torch.Tensor, *tensors: torch.Tensor) -> int:
    """Channels per thread: 16 bytes of *data*'s type where C and every
    pointer allow it, else 1."""
    v = 16 // data.element_size()
    if c % v or any(t.data_ptr() % 16 for t in tensors):
        return 1
    return v


def _launch(name: str, wrapper, *args, stream) -> None:
    """Launch *name* and count it, by the load mode the launch code chose;
    ``wrapper.plan`` keeps the launch's pooled rows a band, channels a
    slice, shared memory bytes a block and blocks."""
    plan = (ctypes.c_int * 5)()
    err = _kernel_fn(name)(*args, plan, stream)
    if err == -2:
        raise RuntimeError(f"{name}: a band of one pooled row does not fit "
                           "in shared memory")
    if err != 0:
        raise RuntimeError(f"{name} launch failed: error {err}")
    wrapper.launches += 1
    wrapper.modes["bulk" if plan[4] else "cooperative"] += 1
    wrapper.plan = dict(zip(("rows", "channels", "smem", "blocks"), plan))


def max_pool_fwd_cuda(x: torch.Tensor, window: int = 3, stride: int = 2
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K1; raises on what it does not take.
    ``max_pool_fwd_cuda.launches`` counts launches, ``.modes`` them by
    load mode, and ``.plan`` holds the last launch's bands and grid."""
    _check_pool(x.shape, window, stride)
    _check_dtype(x)
    _check_cuda(x)
    B, H, W, C = x.shape
    oh, ow = _out_dim(H, window, stride), _out_dim(W, window, stride)
    y = torch.empty((B, oh, ow, C), dtype=x.dtype, device=x.device)
    idx = torch.empty((B, oh, ow, C), dtype=torch.int8, device=x.device)
    if y.numel() == 0:
        return y, idx
    with torch.cuda.device(x.device):
        _launch("maxpool_fwd", max_pool_fwd_cuda,
                x.data_ptr(), y.data_ptr(), idx.data_ptr(),
                _KERNEL_DTYPES[x.dtype], B, H, W, C, window, stride,
                _vec(C, x, x, y, idx),
                stream=torch.cuda.current_stream(x.device).cuda_stream)
    return y, idx


max_pool_fwd_cuda.launches = 0
max_pool_fwd_cuda.modes = dict.fromkeys(MODES, 0)
max_pool_fwd_cuda.plan = None


def max_pool_bwd_cuda(idx: torch.Tensor, dp: torch.Tensor,
                      xshape: Sequence[int], window: int = 3,
                      stride: int = 2) -> torch.Tensor:
    """Launch K2; raises on what it does not take.
    ``max_pool_bwd_cuda.launches`` counts launches, ``.modes`` them by
    load mode, and ``.plan`` holds the last launch's bands and grid."""
    _check_pool(xshape, window, stride)
    _check_dtype(dp)
    _check_cuda(idx, dp)
    B, H, W, C = xshape
    oh, ow = _out_dim(H, window, stride), _out_dim(W, window, stride)
    if idx.dtype != torch.int8 or tuple(idx.shape) != (B, oh, ow, C) or \
            dp.shape != idx.shape:
        raise ValueError(
            f"expected int8 idx and dp of shape {(B, oh, ow, C)}, got "
            f"{idx.dtype} {tuple(idx.shape)} and {tuple(dp.shape)}")
    dy = torch.empty(tuple(xshape), dtype=dp.dtype, device=dp.device)
    if dy.numel() == 0:
        return dy
    with torch.cuda.device(dp.device):
        _launch("maxpool_bwd", max_pool_bwd_cuda,
                idx.data_ptr(), dp.data_ptr(), dy.data_ptr(),
                _KERNEL_DTYPES[dp.dtype], B, H, W, C, window, stride,
                _vec(C, dp, idx, dp, dy),
                stream=torch.cuda.current_stream(dp.device).cuda_stream)
    return dy


max_pool_bwd_cuda.launches = 0
max_pool_bwd_cuda.modes = dict.fromkeys(MODES, 0)
max_pool_bwd_cuda.plan = None


def pool_fwd(x: torch.Tensor, window: int, stride: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(y, idx)``: the plain version for CPU tensors, K1 for CUDA."""
    if x.device.type == "cpu":
        return max_pool_fwd_plain(x, window, stride)
    if x.device.type == "cuda":
        return max_pool_fwd_cuda(x, window, stride)
    raise ValueError(f"max_pool: no path for device {x.device}")


def pool_bwd(idx: torch.Tensor, dp: torch.Tensor, xshape: Sequence[int],
             window: int, stride: int) -> torch.Tensor:
    """``dy``: the plain version for CPU tensors, K2 for CUDA."""
    if dp.device.type == "cpu":
        return max_pool_bwd_plain(idx, dp, xshape, window, stride)
    if dp.device.type == "cuda":
        return max_pool_bwd_cuda(idx, dp, xshape, window, stride)
    raise ValueError(f"max_pool: no path for device {dp.device}")


class _MaxPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, window, stride):
        y, idx = pool_fwd(x.contiguous(), window, stride)
        ctx.save_for_backward(idx)
        ctx.pool = (tuple(x.shape), window, stride)
        return y

    @staticmethod
    def backward(ctx, dp):
        (idx,) = ctx.saved_tensors
        xshape, window, stride = ctx.pool
        return pool_bwd(idx, dp.contiguous(), xshape, window, stride), \
            None, None


def max_pool(x: torch.Tensor, window: int = 3,
             stride: int = 2) -> torch.Tensor:
    """VALID ``window`` x ``window`` max-pool with stride ``stride`` over
    NHWC, with the index-scatter backward (see the module docstring)."""
    return _MaxPool.apply(x, window, stride)
