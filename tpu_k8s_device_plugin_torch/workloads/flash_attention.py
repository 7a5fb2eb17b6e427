"""Flash attention, forward and backward: hand-written Hopper kernels and
their plain PyTorch versions.

:func:`flash_attention` is the public function, on [B, T, H, D] like the
JAX package's.  It dispatches on the tensors' device: CPU tensors take
the plain versions; CUDA tensors launch the kernels, or raise.  K/V may
be grouped (``Hkv`` dividing ``H``): query head ``h`` reads KV head
``h // (H // Hkv)``, which is what ``repeat_kv`` followed by full-head
attention computes, without the copy.

Without a gradient to compute (under ``torch.no_grad``, or no input
needing one) the call is the JAX primal path: K4 (``csrc/
flash_attn_fwd.cu``, :func:`flash_attention_cuda`) and nothing saved.
Otherwise it runs through :class:`_FlashAttention`, the JAX custom VJP:
the forward launches K4 with its per-row logsumexp residual ``lse``, and
the backward computes ``delta = sum_d dO * O`` in f32 from the stored
output (plain torch, as the JAX package computes it outside any kernel),
then K5 for dQ (:func:`flash_attention_dq_cuda`) and K6 for dK and dV
(:func:`flash_attention_dkv_cuda`), both in ``csrc/flash_attn_bwd.cu``.
CPU tensors go through the same Function with the plain versions.  The
residuals ``lse`` and ``delta`` are [B, H, Tq] f32 (the TPU's 128-lane
broadcast is not kept).  dK and dV come out at the grouped shape, summed
over each KV head's query heads.

K5 and K6 write their gradients in the input dtype, or in f32 on request
(``out_dtype``): the same f32 sums, stored unrounded.  The block forms
that ring attention composes, :func:`flash_block_forward` (K4 with its
lse, as [B, T, H]) and :func:`flash_block_grads` (K5 and K6 writing f32
from the global lse and delta), are at the end of the module.

The kernels read q, k, v and dO through their (batch, time, head)
strides, so the fused-projection views the model passes need no copy;
the backward copies dO only when its strides are ones the kernels do not
take (a head dim that is not contiguous, or bf16 rows not 16-byte
aligned).
"""

from __future__ import annotations

import ctypes

import torch

from .. import build

_KERNEL_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_fns = {}


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


def _scale(D: int) -> float:
    return 1.0 / D ** 0.5


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """Scaled f32 scores [B, Hkv, group, Tq, Tk], -inf where causally
    hidden."""
    B, Tq, H, D = q.shape
    Tk, n_kv = k.shape[1], k.shape[2]
    qg = q.to(torch.float32).reshape(B, Tq, n_kv, H // n_kv, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(torch.float32))
    s = s * _scale(D)
    if causal:
        keep = torch.ones(Tq, Tk, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    return s


def flash_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = False):
    """K4's function in plain PyTorch: f32 scores, a max-shifted exponent
    rounded to the input dtype before the P·V product (as the kernels
    do), normalised by the f32 row sum; rows with no visible key give 0.
    Returns ``(o [B, Tq, H, D] in q's dtype, lse [B, H, Tq] f32)``, lse
    being ``m + log(l)``, or -inf for a row with no visible key."""
    _check_shapes(q, k, v, causal)
    B, Tq, H, D = q.shape
    s = _scores(q, k, causal)
    m = (s.amax(dim=-1, keepdim=True) if s.shape[-1]  # no keys: Tk == 0
         else s.new_full((*s.shape[:-1], 1), float("-inf")))
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    denom = torch.where(l == 0, torch.ones_like(l), l)
    o = torch.einsum(
        "bhgqk,bkhd->bhgqd", p.to(q.dtype).to(torch.float32),
        v.to(torch.float32)) / denom
    lse = torch.where(l == 0, torch.full_like(l, float("-inf")),
                      m + torch.log(denom))
    return (o.permute(0, 3, 1, 2, 4).reshape(B, Tq, H, D).to(q.dtype),
            lse.reshape(B, H, Tq))


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor,
                          causal: bool = False) -> torch.Tensor:
    """The forward's output alone (:func:`flash_attention_fwd_plain`)."""
    return flash_attention_fwd_plain(q, k, v, causal)[0]


def attention_delta(do: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """``delta = sum_d dO * O`` per row, [B, H, Tq] f32, from the output
    as stored (in its own dtype), as the JAX backward computes it."""
    d = (do.to(torch.float32) * o.to(torch.float32)).sum(dim=-1)
    return d.transpose(1, 2).contiguous()


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, do: torch.Tensor,
                              lse: torch.Tensor, delta: torch.Tensor,
                              causal: bool = False):
    """K5's and K6's function in plain PyTorch, given the (global) lse
    and delta [B, H, Tq]: returns ``(dq, dk, dv)`` in f32, dK/dV at the
    grouped shape summed over each KV head's query heads.  The kernels'
    rounding points: P = exp(S * scale - lse); dP = dO V^T in f32;
    dS = P (dP - delta); P rounded to the input dtype before P^T dO, dS
    before dS K and dS^T Q; dK and dQ carry the scale."""
    _check_shapes(q, k, v, causal)
    B, Tq, H, D = q.shape
    n_kv = k.shape[2]
    g = H // n_kv
    f32 = torch.float32
    rounded = lambda x: x.to(q.dtype).to(f32)  # noqa: E731
    s = _scores(q, k, causal)
    p = torch.exp(s - lse.to(f32).reshape(B, n_kv, g, Tq, 1))
    dog = do.to(f32).reshape(B, Tq, n_kv, g, D)
    qg = q.to(f32).reshape(B, Tq, n_kv, g, D)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, v.to(f32))
    ds = p * (dp - delta.to(f32).reshape(B, n_kv, g, Tq, 1))
    dv = torch.einsum("bhgqk,bqhgd->bkhd", rounded(p), dog)
    ds = rounded(ds)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg) * _scale(D)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.to(f32)) * _scale(D)
    return dq.reshape(B, Tq, H, D), dk, dv


# --- the kernels --------------------------------------------------------

_LL = ctypes.c_longlong
_SIGNATURES = {  # C function: (source, argtypes)
    "flash_attn_fwd": (
        "flash_attn_fwd",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [_LL] * 12
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]),
    "flash_attn_bwd_dq": (
        "flash_attn_bwd",
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
        + [ctypes.POINTER(_LL), ctypes.c_float, ctypes.c_int,
           ctypes.c_void_p]),
    "flash_attn_bwd_dkv": (
        "flash_attn_bwd",
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
        + [ctypes.POINTER(_LL), ctypes.c_float, ctypes.c_int,
           ctypes.c_void_p]),
}


def _kernel_fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        source, argtypes = _SIGNATURES[name]
        fn = getattr(build.load(source), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _strides(x: torch.Tensor):
    """(batch, time, head) element strides; a size-1 dim's stride is
    never used, so it is passed as 0."""
    return [0 if x.shape[i] == 1 else x.stride(i) for i in range(3)]


def _kernel_takes(x: torch.Tensor) -> bool:
    """Whether the kernels read *x* through its strides: unit stride on
    the head dim and, for bf16, 16-byte rows."""
    return x.stride(3) == 1 and not (
        x.dtype == torch.bfloat16
        and (x.data_ptr() % 16 or any(s % 8 for s in _strides(x))))


def _check_cuda(name: str, *xs: torch.Tensor) -> None:
    """Refuse what the kernels do not take: tensors off CUDA or on two
    devices, dtypes other than one of bf16/f32, strides the kernels
    cannot read, head dims other than 16..128 in steps of 16."""
    ref = xs[0]
    for x in xs:
        if x.device.type != "cuda" or x.device != ref.device:
            raise ValueError(f"{name} needs CUDA tensors on one device")
        if x.dtype != ref.dtype or x.dtype not in _KERNEL_DTYPES:
            raise TypeError(
                f"{name} takes bf16 or f32 inputs of one dtype, got "
                f"{[str(y.dtype) for y in xs]}")
        if x.stride(3) != 1:
            raise ValueError(f"{name} needs unit stride on head_dim")
        if not _kernel_takes(x):
            raise ValueError(
                f"{name} (bf16) reads 16-byte rows: pointers must be "
                "16-byte aligned and strides multiples of 8 elements")
    D = ref.shape[3]
    if D % 16 or not 16 <= D <= 128:
        raise ValueError(f"{name} supports head_dim 16..128 in steps of "
                         f"16, got {D}")


def _check_rows(name: str, q: torch.Tensor, *rows: torch.Tensor) -> None:
    B, Tq, H, _ = q.shape
    for r in rows:
        if (r.shape != (B, H, Tq) or r.dtype != torch.float32
                or not r.is_contiguous() or r.device != q.device):
            raise ValueError(
                f"{name}: lse and delta must be contiguous f32 "
                f"[B, H, Tq] = {[B, H, Tq]} on q's device, got "
                f"{tuple(r.shape)} {r.dtype}")


def _launch(name: str, *args) -> None:
    err = _kernel_fn(name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: error {err}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor, causal: bool = False,
                         return_lse: bool = False):
    """Launch K4 on CUDA tensors; raises on what it does not take.
    Returns the output, or ``(output, lse [B, H, Tq] f32)`` with
    *return_lse*.  ``flash_attention_cuda.launches`` counts launches."""
    _check_shapes(q, k, v, causal)
    _check_cuda("flash kernel", q, k, v)
    B, Tq, H, D = q.shape
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    with torch.cuda.device(q.device):
        _launch(
            "flash_attn_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), lse.data_ptr() if return_lse else None,
            _KERNEL_DTYPES[q.dtype], B, Tq, k.shape[1], H, k.shape[2], D,
            *_strides(q), *_strides(k), *_strides(v), *_strides(out),
            _scale(D), int(causal), _stream(q))
    flash_attention_cuda.launches += 1
    return (out, lse) if return_lse else out


flash_attention_cuda.launches = 0


def _stride_array(*xs: torch.Tensor):
    vals = [s for x in xs for s in _strides(x)]
    return (_LL * len(vals))(*vals)


# launches of K5 and K6 by mode: bf16 in and out, bf16 in and f32 out (the
# block form's partials), f32 in and out
BWD_MODES = ("bf16", "f32out", "f32")


def _out_dtype(name: str, x: torch.Tensor, out_dtype) -> torch.dtype:
    """The gradients' dtype: *x*'s by default; bf16 inputs may ask for
    f32 (the f32 output mode), f32 inputs give f32."""
    out = x.dtype if out_dtype is None else out_dtype
    if out not in (x.dtype, torch.float32):
        raise TypeError(f"{name} writes {x.dtype} or f32 for {x.dtype} "
                        f"inputs, not {out}")
    return out


def _count_bwd(wrapper, x: torch.Tensor, out: torch.dtype) -> None:
    wrapper.launches += 1
    wrapper.modes["f32" if x.dtype == torch.float32 else
                  "f32out" if out == torch.float32 else "bf16"] += 1


def flash_attention_dq_cuda(q, k, v, do, lse, delta, causal=False,
                            out_dtype=None):
    """Launch K5 on CUDA tensors: dQ [B, Tq, H, D] in *out_dtype*, which
    is q's dtype by default; bf16 inputs may ask for f32 (the same sums,
    stored unrounded).  ``flash_attention_dq_cuda.launches`` counts
    launches, ``.modes`` them by mode (``BWD_MODES``)."""
    _check_shapes(q, k, v, causal)
    _check_cuda("flash dq kernel", q, k, v, do)
    _check_rows("flash dq kernel", q, lse, delta)
    if do.shape != q.shape:
        raise ValueError(f"dO {tuple(do.shape)} must be q's shape")
    out = _out_dtype("flash dq kernel", q, out_dtype)
    B, Tq, H, D = q.shape
    dq = torch.empty(q.shape, dtype=out, device=q.device)
    if dq.numel() == 0 or k.shape[1] == 0:
        return dq.zero_()
    with torch.cuda.device(q.device):
        _launch(
            "flash_attn_bwd_dq", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            _KERNEL_DTYPES[q.dtype], _KERNEL_DTYPES[out], B, Tq, k.shape[1],
            H, k.shape[2], D, _stride_array(q, k, v, do, dq), _scale(D),
            int(causal), _stream(q))
    _count_bwd(flash_attention_dq_cuda, q, out)
    return dq


flash_attention_dq_cuda.launches = 0
flash_attention_dq_cuda.modes = dict.fromkeys(BWD_MODES, 0)


def flash_attention_dkv_cuda(q, k, v, do, lse, delta, causal=False,
                             out_dtype=None):
    """Launch K6 on CUDA tensors: ``(dk, dv)`` at the grouped shape
    [B, Tk, Hkv, D] in *out_dtype* (k's dtype by default; f32 for bf16
    inputs on request).  ``flash_attention_dkv_cuda.launches`` counts
    launches, ``.modes`` them by mode."""
    _check_shapes(q, k, v, causal)
    _check_cuda("flash dkv kernel", q, k, v, do)
    _check_rows("flash dkv kernel", q, lse, delta)
    if do.shape != q.shape:
        raise ValueError(f"dO {tuple(do.shape)} must be q's shape")
    out = _out_dtype("flash dkv kernel", k, out_dtype)
    B, Tq, H, D = q.shape
    dk = torch.empty(k.shape, dtype=out, device=k.device)
    dv = torch.empty(v.shape, dtype=out, device=v.device)
    if dk.numel() == 0 or Tq == 0:
        return dk.zero_(), dv.zero_()
    with torch.cuda.device(q.device):
        _launch(
            "flash_attn_bwd_dkv", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), _KERNEL_DTYPES[q.dtype], _KERNEL_DTYPES[out], B,
            Tq, k.shape[1], H, k.shape[2], D,
            _stride_array(q, k, v, do, dk, dv), _scale(D), int(causal),
            _stream(q))
    _count_bwd(flash_attention_dkv_cuda, k, out)
    return dk, dv


flash_attention_dkv_cuda.launches = 0
flash_attention_dkv_cuda.modes = dict.fromkeys(BWD_MODES, 0)


def _path(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: no path for device {x.device}")
    return x.device.type


class _FlashAttention(torch.autograd.Function):
    """The training form: K4 with its lse forward; delta, K5 and K6
    backward (the plain versions for CPU tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        if _path(q) == "cuda":
            o, lse = flash_attention_cuda(q, k, v, causal, return_lse=True)
        else:
            o, lse = flash_attention_fwd_plain(q, k, v, causal)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        delta = attention_delta(do, o)
        if _path(q) == "cuda":
            if not _kernel_takes(do):
                do = do.contiguous()
            dq = flash_attention_dq_cuda(q, k, v, do, lse, delta, ctx.causal)
            dk, dv = flash_attention_dkv_cuda(q, k, v, do, lse, delta,
                                              ctx.causal)
        else:
            dq, dk, dv = flash_attention_bwd_plain(q, k, v, do, lse, delta,
                                                   ctx.causal)
            dq, dk, dv = dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """Fused attention on [B, T, H, D] (K/V may carry fewer, grouped
    heads), differentiable.  CPU tensors take the plain versions; CUDA
    tensors the kernels."""
    if torch.is_grad_enabled() and (
            q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal)
    if _path(q) == "cpu":
        return flash_attention_plain(q, k, v, causal)
    return flash_attention_cuda(q, k, v, causal)


def flash_causal_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor,
                           positions: torch.Tensor) -> torch.Tensor:
    """Causal adapter in the attention-function shape ``(q, k, v,
    positions)``: positions must be the natural order 0..T-1, since the
    causal mask follows the storage order.  Grouped K/V go to the kernel
    as they are."""
    del positions
    return flash_attention(q, k, v, causal=True)


# --- block forms, for ring attention -------------------------------------
#
# The JAX package's block-level entry points onto its kernels
# (``flash_block_forward``, ``flash_block_grads``), on [B, T, H, D] with
# the per-row statistics as [B, T, H] f32.  They are not differentiable
# themselves: ring attention wraps the whole rotation in one
# ``torch.autograd.Function``.  CPU tensors take the plain versions; CUDA
# tensors launch K4, K5 and K6, or raise.  The reference's ``block_q`` and
# ``block_k`` are not taken: the Hopper kernels' tiles are fixed when they
# are compiled, and no tile size changes the function.


def flash_block_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False):
    """One attention block pair, [B, Tq, H, D] x [B, Tk, H, D] (Tq != Tk
    allowed when not causal): returns ``(o, lse)``, *o* in q's dtype
    normalised over *this* K/V block only, *lse* the per-row logsumexp
    [B, Tq, H] f32 (-inf, with *o* 0, for a row with no visible key).
    Partials merge exactly: ``o = sum_s exp(lse_s - lse_tot) o_s``."""
    if _path(q) == "cuda":
        o, lse = flash_attention_cuda(q, k, v, causal, return_lse=True)
    else:
        o, lse = flash_attention_fwd_plain(q, k, v, causal)
    return o, lse.transpose(1, 2)


def flash_block_grads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      do: torch.Tensor, lse: torch.Tensor,
                      delta: torch.Tensor, causal: bool = False):
    """One block pair's gradient terms given the *global* softmax
    statistics (``lse`` and ``delta = sum_d dO * O``, [B, Tq, H] f32):
    ``(dq, dk, dv)`` in **f32** on the inputs' shapes, whatever their
    dtype.  Summing dq over K/V blocks and dk/dv over query blocks gives
    the dense gradient; the partials are summed unrounded and rounded
    once by the caller.  On CUDA, K5 and K6 in their f32 output mode."""
    lse_t, delta_t = (r.to(torch.float32).transpose(1, 2).contiguous()
                      for r in (lse, delta))
    if _path(q) == "cpu":
        return flash_attention_bwd_plain(q, k, v, do, lse_t, delta_t, causal)
    if not _kernel_takes(do):
        do = do.contiguous()
    f32 = torch.float32
    dq = flash_attention_dq_cuda(q, k, v, do, lse_t, delta_t, causal,
                                 out_dtype=f32)
    dk, dv = flash_attention_dkv_cuda(q, k, v, do, lse_t, delta_t, causal,
                                      out_dtype=f32)
    return dq, dk, dv
