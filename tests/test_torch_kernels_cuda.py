"""The port's CUDA kernels on the card, against their plain versions:
K4 (flash attention, with and without its lse residual), K5 and K6 (the
flash backward, with bf16 or f32 outputs), the block forms and a ring of
one rank over them, K1 and K2 (max-pool forward and backward) and K3
(fused conv+pool).

These need a CUDA device and the CUDA toolkit (the kernels build from
``tpu_k8s_device_plugin_torch/csrc`` at first use); elsewhere they skip.
On the GPU machine:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q
"""

import math

import pytest
import torch

from tpu_k8s_device_plugin_torch.workloads import convpool as cp
from tpu_k8s_device_plugin_torch.workloads import flash_attention as fa
from tpu_k8s_device_plugin_torch.workloads import pool as mp

pytestmark = pytest.mark.cuda

# bf16 3e-2 and f32 2e-5: the JAX package's flash contract
TOL = {torch.bfloat16: 3e-2, torch.float32: 2e-5}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


# outputs and gradients are also held by blocks of 64 rows of one (batch,
# head): along a causal sequence their values fall as 1/sqrt(row), so a flat
# atol lets a wrong late tile pass; each entry within the
# tolerance x (its block's rms + |ref|), and each block's
# ||err|| / ||ref|| within BLOCK_REL (rounding to bf16 alone reads
# about 2e-3)
BLOCK_ROWS = 64
BLOCK_REL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}


def _assert_blocks_close(got, want, tol, rel_bar):
    B, T, H, D = want.shape
    pad = (-T) % BLOCK_ROWS
    w = torch.nn.functional.pad(want.float(), (0, 0, 0, 0, 0, pad))
    g = torch.nn.functional.pad(got.float(), (0, 0, 0, 0, 0, pad))
    w = w.view(B, -1, BLOCK_ROWS, H, D)
    diff = g.view(B, -1, BLOCK_ROWS, H, D) - w
    n = torch.full((w.shape[1], 1), float(BLOCK_ROWS * D), device=w.device)
    n[-1] = (T - BLOCK_ROWS * (w.shape[1] - 1)) * D
    sq, err_sq = w.square().sum((2, 4)), diff.square().sum((2, 4))
    rms = (sq / n).sqrt()[:, :, None, :, None]
    assert (diff.abs() <= tol * (rms + w.abs())).all()
    rel = torch.where(sq > 0, (err_sq / sq).sqrt(),
                      torch.where(err_sq > 0, float("inf"), 0.0))
    assert float(rel.max()) <= rel_bar, float(rel.max())


def _qkv(gen, q_shape, tk, hkv, dtype):
    B, _, _, D = q_shape
    return (torch.randn(q_shape, generator=gen, device="cuda", dtype=dtype),
            torch.randn((B, tk, hkv, D), generator=gen, device="cuda",
                        dtype=dtype),
            torch.randn((B, tk, hkv, D), generator=gen, device="cuda",
                        dtype=dtype))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize(
    "q_shape,tk,hkv,causal",
    [
        ((2, 128, 4, 128), 128, 1, True),     # GQA 4:1, whole tiles
        ((1, 100, 2, 64), 100, 2, True),      # ragged T
        ((2, 64, 4, 16), 200, 2, False),      # Tq != Tk, full attention
        ((1, 1, 2, 32), 1, 2, True),          # one row
        ((3, 70, 6, 48), 70, 3, True),        # odd B, H, T; D = 48
        # the bf16 kernel streams K/V tiles of 128 keys through a ring of
        # three stages: at T 1024 it wraps, and the diagonal tile is masked
        ((1, 1024, 8, 128), 1024, 2, True),   # GQA 4:1
        ((1, 1024, 2, 128), 1024, 2, True),   # group 1
        ((1, 200, 4, 96), 200, 2, True),      # D = 96, padded to 128
        ((2, 320, 8, 64), 320, 2, True),      # D = 64
        ((2, 130, 4, 64), 40, 2, False),      # Tk < 64, full attention
        ((2, 100, 8, 64), 300, 2, False),     # Tq, Tk ragged, full
    ],
)
def test_kernel_matches_plain(gen, q_shape, tk, hkv, causal, dtype):
    q, k, v = _qkv(gen, q_shape, tk, hkv, dtype)
    before = fa.flash_attention_cuda.launches
    got = fa.flash_attention_cuda(q, k, v, causal)
    torch.cuda.synchronize()
    assert fa.flash_attention_cuda.launches == before + 1
    want = fa.flash_attention_plain(q, k, v, causal)
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    _assert_blocks_close(got, want, tol, BLOCK_REL[dtype])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("return_lse", [False, True], ids=["o", "o-lse"])
def test_kernel_with_no_keys_gives_zeros(gen, dtype, return_lse):
    """Tk == 0 (full attention over nothing): every row is empty, so the
    output is 0 and the lse -inf, as the plain version gives."""
    q, k, v = _qkv(gen, (2, 70, 4, 64), 0, 2, dtype)
    got = fa.flash_attention_cuda(q, k, v, False, return_lse=return_lse)
    torch.cuda.synchronize()
    want = fa.flash_attention_fwd_plain(q, k, v, False)
    if return_lse:
        assert torch.equal(got[1], want[1]) and torch.isneginf(got[1]).all()
        got = got[0]
    assert torch.equal(got, want[0]) and not got.any()


def test_forward_kernel_is_deterministic(gen):
    """K4 owns its rows and sums in a fixed order: two launches on the
    same inputs give the same bits, output and lse."""
    q, k, v = _qkv(gen, (1, 1024, 8, 128), 1024, 2, torch.bfloat16)
    runs = [fa.flash_attention_cuda(q, k, v, True, return_lse=True)
            for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_kernel_reads_strided_views(gen):
    """q/k/v as views of one fused projection, as the decoder passes
    them: no copies, same result."""
    B, T, H, hkv, D = 2, 96, 4, 2, 64
    qkv = torch.randn(B, T, (H + 2 * hkv) * D, generator=gen, device="cuda",
                      dtype=torch.bfloat16)
    q = qkv[..., :H * D].view(B, T, H, D)
    k = qkv[..., H * D:(H + hkv) * D].view(B, T, hkv, D)
    v = qkv[..., (H + hkv) * D:].view(B, T, hkv, D)
    got = fa.flash_attention(q, k, v, causal=True)
    want = fa.flash_attention_plain(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal=True)
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2,
                               rtol=3e-2)


def test_kernel_refuses_what_it_does_not_take(gen):
    q, k, v = _qkv(gen, (1, 32, 2, 24), 32, 2, torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_cuda(q, k, v)
    q, k, v = _qkv(gen, (1, 32, 2, 32), 32, 2, torch.float16)
    with pytest.raises(TypeError):
        fa.flash_attention_cuda(q, k, v)
    q, k, v = _qkv(gen, (1, 32, 2, 32), 40, 2, torch.bfloat16)
    with pytest.raises(ValueError, match="Tq == Tk"):
        fa.flash_attention_cuda(q, k, v, causal=True)


def test_decoder_prefill_runs_the_kernel(gen, monkeypatch):
    """A bf16 Llama-shaped decoder on the card: with the threshold at 8
    the prefill launches the kernel once per layer, and its logits agree
    with the einsum prefill."""
    from tpu_k8s_device_plugin_torch.workloads import (
        bench_serving, inference, llama)

    model = llama.decoder(llama.TINY_LLAMA, max_len=64, device="cuda")
    bench_serving.random_init_(model, seed=0)
    prompt = torch.randint(0, model.vocab, (2, 32), device="cuda",
                           generator=gen)
    pos = torch.arange(32, dtype=torch.int32, device="cuda").expand(2, 32)
    want, _ = inference._prefill(model, prompt, pos)
    monkeypatch.setattr(inference, "_FLASH_PREFILL_MIN_T", 8)
    before = fa.flash_attention_cuda.launches
    got, _ = inference._prefill(model, prompt, pos)
    assert fa.flash_attention_cuda.launches - before == model.n_layers
    torch.testing.assert_close(got, want, atol=0.1, rtol=0.05)


# --- K4's lse, K5 and K6 (csrc/flash_attn_bwd.cu) ---------------------

# the JAX package's flash gradient contract: 5e-2 in bf16, 5e-4 in f32
GRAD_TOL = {torch.bfloat16: 5e-2, torch.float32: 5e-4}
BWD_CASES = [  # q shape, Tk, KV heads, causal
    ((1, 200, 4, 128), 200, 1, True),     # ragged T, GQA 4:1, D = 128
    ((2, 40, 2, 64), 40, 2, True),        # T < 64, MHA
    ((1, 256, 8, 32), 256, 2, False),     # whole tiles, full attention
    ((2, 100, 4, 48), 150, 4, False),     # Tq != Tk, MHA, D = 48
    ((1, 130, 6, 16), 130, 3, True),      # GQA 2:1, D = 16
    # the bf16 kernels stream tiles through a ring of three stages: at
    # T 1024 it wraps many times and every causal diagonal case occurs
    ((1, 1024, 8, 128), 1024, 2, True),   # GQA 4:1
    ((1, 320, 8, 64), 320, 1, True),      # group 8
    ((1, 320, 2, 128), 320, 2, True),     # group 1
    ((1, 200, 4, 96), 200, 2, True),      # D = 96, padded to 128
    ((2, 130, 4, 64), 40, 2, False),      # Tk < 64, full attention
]
def _bwd_inputs(gen, q_shape, tk, hkv, dtype, causal):
    q, k, v = _qkv(gen, q_shape, tk, hkv, dtype)
    do = torch.randn(q_shape, generator=gen, device="cuda", dtype=dtype)
    o, lse = fa.flash_attention_fwd_plain(q, k, v, causal)
    return q, k, v, do, lse, fa.attention_delta(do, o)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("q_shape,tk,hkv,causal", BWD_CASES)
def test_kernel_lse_matches_plain(gen, q_shape, tk, hkv, causal, dtype):
    q, k, v = _qkv(gen, q_shape, tk, hkv, dtype)
    before = fa.flash_attention_cuda.launches
    o, lse = fa.flash_attention_cuda(q, k, v, causal, return_lse=True)
    torch.cuda.synchronize()
    assert fa.flash_attention_cuda.launches == before + 1
    want_o, want_lse = fa.flash_attention_fwd_plain(q, k, v, causal)
    tol = TOL[dtype]
    torch.testing.assert_close(o.float(), want_o.float(), atol=tol, rtol=tol)
    _assert_blocks_close(o, want_o, tol, BLOCK_REL[dtype])
    # lse is f32 in both: only the order of the f32 sums differs
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("q_shape,tk,hkv,causal", BWD_CASES)
def test_backward_kernels_match_plain(gen, q_shape, tk, hkv, causal, dtype):
    q, k, v, do, lse, delta = _bwd_inputs(gen, q_shape, tk, hkv, dtype,
                                          causal)
    before = (fa.flash_attention_dq_cuda.launches,
              fa.flash_attention_dkv_cuda.launches)
    dq = fa.flash_attention_dq_cuda(q, k, v, do, lse, delta, causal)
    dk, dv = fa.flash_attention_dkv_cuda(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    assert (fa.flash_attention_dq_cuda.launches,
            fa.flash_attention_dkv_cuda.launches) == (before[0] + 1,
                                                      before[1] + 1)
    want = fa.flash_attention_bwd_plain(q, k, v, do, lse, delta, causal)
    tol = GRAD_TOL[dtype]
    for got, ref in zip((dq, dk, dv), want):
        assert got.dtype == dtype and got.shape == ref.shape
        torch.testing.assert_close(got.float(), ref, atol=tol, rtol=tol)
        _assert_blocks_close(got, ref, tol, BLOCK_REL[dtype])


def test_backward_kernels_are_deterministic(gen):
    """K6 sums the group's query heads in a fixed order without atomics,
    and K5 owns its rows: two launches on the same inputs give the same
    bits."""
    q, k, v, do, lse, delta = _bwd_inputs(gen, (1, 1024, 8, 128), 1024, 2,
                                          torch.bfloat16, True)
    runs = [(fa.flash_attention_dq_cuda(q, k, v, do, lse, delta, True),
             *fa.flash_attention_dkv_cuda(q, k, v, do, lse, delta, True))
            for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_backward_kernels_read_strided_views(gen):
    """q/k/v as views of one fused projection and a dO with padded rows:
    the kernels read them through their strides."""
    B, T, H, hkv, D = 2, 96, 4, 2, 64
    qkv = torch.randn(B, T, (H + 2 * hkv) * D, generator=gen, device="cuda",
                      dtype=torch.bfloat16)
    q = qkv[..., :H * D].view(B, T, H, D)
    k = qkv[..., H * D:(H + hkv) * D].view(B, T, hkv, D)
    v = qkv[..., (H + hkv) * D:].view(B, T, hkv, D)
    do = torch.randn(B, T, H, D + 8, generator=gen, device="cuda",
                     dtype=torch.bfloat16)[..., :D]
    o, lse = fa.flash_attention_fwd_plain(q, k, v, True)
    delta = fa.attention_delta(do, o)
    got = (fa.flash_attention_dq_cuda(q, k, v, do, lse, delta, True),
           *fa.flash_attention_dkv_cuda(q, k, v, do, lse, delta, True))
    want = fa.flash_attention_bwd_plain(
        *(x.contiguous() for x in (q, k, v, do)), lse, delta, True)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w, atol=5e-2, rtol=5e-2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_training_form_gradients_match_plain(gen, dtype):
    """flash_attention with gradients on: K4 with lse, then K5 and K6,
    against autograd through the plain forward on the same inputs."""
    q, k, v = (x.requires_grad_() for x in
               _qkv(gen, (2, 150, 8, 64), 150, 2, dtype))
    do = torch.randn(q.shape, generator=gen, device="cuda", dtype=dtype)
    got = torch.autograd.grad(fa.flash_attention(q, k, v, True), (q, k, v),
                              do)
    want = torch.autograd.grad(fa.flash_attention_plain(q, k, v, True),
                               (q, k, v), do)
    tol = GRAD_TOL[dtype]
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=tol)


def test_backward_kernels_refuse(gen):
    q, k, v, do, lse, delta = _bwd_inputs(gen, (1, 32, 2, 32), 32, 2,
                                          torch.bfloat16, True)
    with pytest.raises(ValueError, match="lse and delta"):
        fa.flash_attention_dq_cuda(q, k, v, do, lse.transpose(1, 2),
                                   delta, True)
    with pytest.raises(TypeError):
        fa.flash_attention_dkv_cuda(q, k, v, do.float(), lse, delta, True)
    with pytest.raises(TypeError, match="writes"):
        fa.flash_attention_dq_cuda(q, k, v, do, lse, delta, True,
                                   out_dtype=torch.float16)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_dkv_cuda(q[..., :24], k[..., :24], v[..., :24],
                                    do[..., :24], lse, delta, True)


# the f32 output mode of the bf16 K5 and K6 (ring attention's partials):
# causal and not, Tq != Tk, grouped heads, a padded head dim
F32OUT_CASES = [BWD_CASES[i] for i in (0, 3, 5, 8, 9)]


def _modes():
    return (dict(fa.flash_attention_dq_cuda.modes),
            dict(fa.flash_attention_dkv_cuda.modes))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("q_shape,tk,hkv,causal", F32OUT_CASES)
def test_backward_kernels_f32_output_mode(gen, q_shape, tk, hkv, causal,
                                          dtype):
    """``out_dtype=f32``: the same sums stored unrounded, within the
    plain version's bars; for bf16 inputs, the bf16 mode's result is the
    f32 mode's rounded to bf16, bit for bit."""
    q, k, v, do, lse, delta = _bwd_inputs(gen, q_shape, tk, hkv, dtype,
                                          causal)
    before = _modes()
    f32 = torch.float32
    dq = fa.flash_attention_dq_cuda(q, k, v, do, lse, delta, causal,
                                    out_dtype=f32)
    dk, dv = fa.flash_attention_dkv_cuda(q, k, v, do, lse, delta, causal,
                                         out_dtype=f32)
    torch.cuda.synchronize()
    mode = "f32out" if dtype == torch.bfloat16 else "f32"
    after = _modes()
    assert [a[mode] - b[mode] for a, b in zip(after, before)] == [1, 1]
    want = fa.flash_attention_bwd_plain(q, k, v, do, lse, delta, causal)
    tol = GRAD_TOL[dtype]
    for got, ref in zip((dq, dk, dv), want):
        assert got.dtype == f32 and got.shape == ref.shape
        torch.testing.assert_close(got, ref, atol=tol, rtol=tol)
        _assert_blocks_close(got, ref, tol, BLOCK_REL[dtype])
    if dtype == torch.bfloat16:
        rounded = (fa.flash_attention_dq_cuda(q, k, v, do, lse, delta,
                                              causal),
                   *fa.flash_attention_dkv_cuda(q, k, v, do, lse, delta,
                                                causal))
        for r, g in zip(rounded, (dq, dk, dv)):
            assert r.dtype == torch.bfloat16
            assert torch.equal(r, g.to(torch.bfloat16))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("tq,tk,causal", [
    (128, 128, True),    # a diagonal block
    (100, 100, True),    # ragged
    (128, 64, False),    # the zig-zag ring's Tq = 2 Tk tile
    (64, 200, False),    # Tq < Tk
    (64, 0, False),      # no key: lse -inf, o 0
])
def test_block_forms_match_plain(gen, tq, tk, causal, dtype):
    """``flash_block_forward`` (K4 with its lse, [B, T, H]) and
    ``flash_block_grads`` (K5 and K6 in their f32 mode, given the global
    lse and delta as [B, T, H]) against the plain versions."""
    q, k, v = _qkv(gen, (2, tq, 4, 64), tk, 4, dtype)
    do = torch.randn(q.shape, generator=gen, device="cuda", dtype=dtype)
    launches = fa.flash_attention_cuda.launches
    o, lse = fa.flash_block_forward(q, k, v, causal)
    torch.cuda.synchronize()
    assert fa.flash_attention_cuda.launches == launches + 1
    want_o, want_lse = fa.flash_attention_fwd_plain(q, k, v, causal)
    assert lse.shape == (2, tq, 4) and lse.dtype == torch.float32
    torch.testing.assert_close(o.float(), want_o.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    torch.testing.assert_close(lse, want_lse.transpose(1, 2), atol=1e-4,
                               rtol=1e-5)
    if tk == 0:
        assert torch.isneginf(lse).all() and not o.any()
        return
    delta = fa.attention_delta(do, want_o)
    before = _modes()
    got = fa.flash_block_grads(q, k, v, do, want_lse.transpose(1, 2),
                               delta.transpose(1, 2), causal)
    torch.cuda.synchronize()
    mode = "f32out" if dtype == torch.bfloat16 else "f32"
    assert [a[mode] - b[mode] for a, b in zip(_modes(), before)] == [1, 1]
    want = fa.flash_attention_bwd_plain(q, k, v, do, want_lse, delta,
                                        causal)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        torch.testing.assert_close(g, w, atol=GRAD_TOL[dtype],
                                   rtol=GRAD_TOL[dtype])


@pytest.mark.parametrize("layout,impl", [("contiguous", "einsum"),
                                         ("contiguous", "flash"),
                                         ("zigzag", "flash")])
def test_ring_of_one_rank_on_the_card(gen, layout, impl):
    """Ring attention on a gloo group of this process alone, CUDA
    tensors: the flash impl launches K4 and K5/K6 in their f32 mode (one
    block each), and output and gradients agree with the single-device
    flash attention."""
    import torch_gloo_ranks
    from tpu_k8s_device_plugin_torch.workloads import ring_attention as ra

    q, k, v = (x.requires_grad_() for x in
               _qkv(gen, (1, 256, 4, 64), 256, 4, torch.bfloat16))
    do = torch.randn(q.shape, generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    launches = fa.flash_attention_cuda.launches
    before = _modes()
    with torch_gloo_ranks.solo_group():
        fn, sharding = ra.make_ring_attention(causal=True, layout=layout,
                                              impl=impl)
        order = (lambda x: ra.zigzag_permute(x, 1)) if layout == "zigzag" \
            else (lambda x: x)
        out = fn(*(sharding.scatter(order(x)) for x in (q, k, v)))
        got = torch.autograd.grad(out, (q, k, v), order(do))
    torch.cuda.synchronize()
    flash = impl == "flash"
    # zig-zag at one rank: the diagonal step's three tiles
    blocks = 3 if layout == "zigzag" else 1
    assert fa.flash_attention_cuda.launches - launches == \
        (blocks if flash else 0)
    assert [a["f32out"] - b["f32out"] for a, b in zip(_modes(), before)] \
        == ([blocks] * 2 if flash else [0, 0])
    want_o = fa.flash_attention_plain(q, k, v, True)
    want = torch.autograd.grad(want_o, (q, k, v), do)
    tol = TOL[torch.bfloat16]
    _assert_blocks_close(out.detach(), order(want_o).detach(), tol,
                         BLOCK_REL[torch.bfloat16])
    for g, w in zip(got, want):
        _assert_blocks_close(g, w, GRAD_TOL[torch.bfloat16],
                             BLOCK_REL[torch.bfloat16])


def test_lm_mesh_step_of_one_rank_on_nccl(gen):
    """``make_lm_train_step`` on a (1, 1, 1, 1) mesh over NCCL at world
    size 1, the reference tests' tiny config: its collectives (the loss's
    sums over the token axes) are real NCCL calls on the card, and the
    loss is finite and falls."""
    import torch_gloo_ranks
    from tpu_k8s_device_plugin_torch.workloads import transformer as tr

    with torch_gloo_ranks.solo_group("nccl"):
        mesh = tr.make_lm_mesh(seq=1, model=1, expert=1)
        step, state, place = tr.make_lm_train_step(
            mesh, vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            seq_len=32, batch=4)
        batch = place(*state["batch"])
        losses = [float(step(*batch)) for _ in range(3)]
    assert all(map(math.isfinite, losses)) and losses[-1] < losses[0]
    assert next(state["model"].parameters()).is_cuda


def test_lm_train_step_runs_k4_k5_k6_per_layer(gen):
    """One bf16 training step of a Llama-shaped LM on the card: K4 (with
    lse), K5 and K6 once per layer each; its loss agrees with the einsum
    model's on the same weights."""
    from tpu_k8s_device_plugin_torch.workloads import (
        bench_serving, llama, transformer)

    cfg = llama.TINY_LLAMA
    model = llama.train_model(cfg, attn_fn=fa.flash_causal_attention,
                              device="cuda")
    bench_serving.random_init_(model, seed=0)
    ref = llama.train_model(cfg, device="cuda")
    ref.load_state_dict(model.state_dict())
    tokens, labels, pos = transformer.synthetic_lm_batch(gen, 2, 64,
                                                         cfg.vocab)
    want = transformer.lm_loss(ref, tokens, labels, pos)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    counters = (fa.flash_attention_cuda, fa.flash_attention_dq_cuda,
                fa.flash_attention_dkv_cuda)
    before = [c.launches for c in counters]
    loss = transformer.lm_train_step(model, opt, tokens, labels, pos)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == \
        [cfg.n_layers] * 3
    assert torch.isfinite(loss)
    torch.testing.assert_close(loss, want.detach(), atol=0, rtol=1e-2)


# --- K1, K2 (csrc/maxpool.cu) and K3 (csrc/conv_pool_fwd.cu) -----------

DTYPES = [torch.bfloat16, torch.float32]
# the AlexNet stage shapes (the pools' inputs are the convs' outputs)
POOL_SHAPES = [(2, 56, 56, 64), (2, 27, 27, 192), (2, 13, 13, 256),
               (3, 27, 27, 64)]  # ragged batch
CONV_SHAPES = [((2, 56, 56, 48), 3, 64), ((2, 27, 27, 64), 5, 192),
               ((2, 13, 13, 256), 3, 256), ((3, 13, 13, 256), 3, 256),
               ((2, 27, 27, 64), 3, 128),   # one block of 128 features
               ((3, 15, 15, 8), 5, 64),     # odd size, C = 8: K = 200
               ((1, 20, 9, 16), 3, 320)]    # H != W, five blocks of 64


def _pool_pair(x, window=3, stride=2):
    """K1 and K2 against their plain versions, bit for bit; the
    gradient is 2 * y, as for sum(y ** 2)."""
    before = (mp.max_pool_fwd_cuda.launches, mp.max_pool_bwd_cuda.launches)
    y, idx = mp.max_pool_fwd_cuda(x, window, stride)
    dy = mp.max_pool_bwd_cuda(idx, 2 * y, x.shape, window, stride)
    torch.cuda.synchronize()
    assert (mp.max_pool_fwd_cuda.launches,
            mp.max_pool_bwd_cuda.launches) == (before[0] + 1, before[1] + 1)
    py, pidx = mp.max_pool_fwd_plain(x, window, stride)
    pdy = mp.max_pool_bwd_plain(pidx, 2 * py, x.shape, window, stride)
    assert torch.equal(y, py) and torch.equal(idx, pidx)
    assert torch.equal(dy, pdy)
    return y, idx


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", POOL_SHAPES)
def test_pool_kernels_bit_exact(gen, shape, dtype):
    _pool_pair(torch.randn(shape, generator=gen, device="cuda", dtype=dtype))


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("shape,window,stride", [
    ((3, 10, 10, 16), 2, 2), ((1, 9, 9, 8), 3, 3), ((2, 8, 12, 4), 3, 1),
    ((2, 9, 9, 6), 3, 2),  # C % 8 != 0: one channel per thread
    # pairs the kernels are not built for read window and stride at run
    # time: overlapping, disjoint and gapped (stride > window) windows, in
    # the bulk and the cooperative mode
    *[(shape, w, s) for shape in ((2, 17, 17, 64), (2, 15, 13, 6))
      for w, s in ((1, 1), (2, 3), (4, 2), (3, 4), (5, 1), (5, 3), (11, 2))]])
def test_pool_kernels_other_windows(gen, shape, window, stride, dtype):
    # quantised values: ties everywhere, and overlapping gradients whose
    # bf16 sums round
    x = 1 + torch.randint(0, 3, shape, generator=gen, device="cuda") / 128
    _pool_pair(x.to(dtype), window, stride)


def test_pool_kernel_edge_values(gen):
    x = torch.full((1, 7, 7, 8), float("-inf"), device="cuda")
    y, idx = _pool_pair(x)
    assert torch.isneginf(y).all() and not idx.any()
    x = torch.randn((1, 7, 7, 8), generator=gen, device="cuda")
    x[0, 3, 4, 1] = float("nan")
    y, idx = mp.max_pool_fwd_cuda(x)
    py, pidx = mp.max_pool_fwd_plain(x)
    assert torch.equal(torch.isnan(y), torch.isnan(py))
    assert torch.equal(y.nan_to_num(), py.nan_to_num())
    assert torch.equal(idx, pidx)
    assert torch.isnan(y[0, 1, 1:3, 1]).all() and not idx[0, 1, 1:3, 1].any()


# the bands of whole rows (csrc/maxpool.cu): ragged last bands, one band,
# more items than blocks, the tails past the last window, both load modes,
# rows too wide for two bands and channel slices

def _modes_of(fn):
    """The load-mode counts of K1 and K2 after fn(), less those before."""
    counters = (mp.max_pool_fwd_cuda, mp.max_pool_bwd_cuda)
    before = [dict(c.modes) for c in counters]
    fn()
    return tuple(next(m for m in mp.MODES if c.modes[m] > b[m])
                 for c, b in zip(counters, before))


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", [
    (3, 7, 7, 16),      # OH 3: a single band
    (37, 27, 27, 64),   # K1 bands of 4, 4, 4, 1 rows, K2 of 7 and 6
    (5, 13, 13, 256),   # K1 two bands of 3, K2 one of 6
    (263, 27, 27, 64),  # 1052 items over a persistent grid, unevenly
    (2, 14, 9, 32),     # H != W, the last band short
], ids=["one-band", "ragged-bands", "two-bands", "ragged-grid", "h-ne-w"])
def test_pool_kernels_band_edges(gen, shape, dtype):
    _pool_pair(torch.randn(shape, generator=gen, device="cuda",
                           dtype=dtype))


@pytest.mark.parametrize("shape,dtype,window,stride,want,split", [
    # two stages of K1's band do not fit: one stage, cooperative
    ((2, 56, 56, 384), torch.bfloat16, 3, 2, ("cooperative", "bulk"),
     (False, False)),
    ((2, 224, 224, 128), torch.float32, 2, 2, ("cooperative", "bulk"),
     (False, False)),
    # one pooled row of every channel does not fit: channel slices
    ((2, 7, 4096, 16), torch.float32, 3, 2,
     ("cooperative", "cooperative"), (True, True)),
    ((2, 5, 4096, 64), torch.bfloat16, 3, 2,
     ("cooperative", "cooperative"), (True, True)),
], ids=["bf16-384ch", "f32-224px", "f32-split", "bf16-split"])
def test_pool_kernels_wide_rows(gen, shape, dtype, window, stride, want,
                                split):
    """Rows too wide for two bands in shared memory take one stage of
    plain loads, and rows too wide for one band split the channels into
    slices; both are exact."""
    x = torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
    assert _modes_of(lambda: _pool_pair(x, window, stride)) == want
    for fn, cut in zip((mp.max_pool_fwd_cuda, mp.max_pool_bwd_cuda), split):
        assert (fn.plan["channels"] < shape[3]) == cut


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
def test_pool_backward_writes_zero_tails(gen, dtype):
    """Stage 1's windows cover rows and columns 0..54 of 56: the kernel
    writes row and column 55 as zeros, over whatever dy's memory held."""
    x = torch.randn((2, 56, 56, 64), generator=gen, device="cuda",
                    dtype=dtype)
    y, idx = mp.max_pool_fwd_cuda(x)
    torch.cuda.empty_cache()
    junk = torch.full((2, 56, 56, 64), float("nan"), device="cuda",
                      dtype=dtype)
    del junk  # the allocator hands this memory to dy
    dy = mp.max_pool_bwd_cuda(idx, torch.ones_like(y), x.shape)
    torch.cuda.synchronize()
    assert not dy[:, 55].any() and not dy[:, :, 55].any()
    assert torch.equal(dy, mp.max_pool_bwd_plain(idx, torch.ones_like(y),
                                                 x.shape))


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
def test_pool_kernels_ties_and_rounding_sums(gen, dtype):
    """Three input levels make ties everywhere (the first offset wins);
    gradients of many magnitudes make the overlapping sums round, in
    ascending offset order, at every add in bf16."""
    shape = (4, 27, 27, 192)
    x = torch.randint(0, 3, shape, generator=gen, device="cuda").to(dtype)
    y, idx = mp.max_pool_fwd_cuda(x)
    scale = 2.0 ** torch.randint(-8, 9, y.shape, generator=gen,
                                 device="cuda")
    dp = (torch.randn(y.shape, generator=gen, device="cuda")
          * scale).to(dtype)
    dy = mp.max_pool_bwd_cuda(idx, dp, shape)
    torch.cuda.synchronize()
    py, pidx = mp.max_pool_fwd_plain(x)
    assert torch.equal(y, py) and torch.equal(idx, pidx)
    assert torch.equal(dy, mp.max_pool_bwd_plain(pidx, dp, shape))
    assert (idx == 0).float().mean() > 0.2  # ties took offset 0


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
def test_pool_kernels_nan_and_neg_inf(gen, dtype):
    """On a bulk-mode shape (bf16 there runs the packed compares): a NaN
    wins its windows with index 0; an all -inf window gives -inf with
    index 0; -inf beside numbers loses."""
    x = torch.randn((2, 13, 13, 64), generator=gen, device="cuda",
                    dtype=dtype)
    x[0, 4, 5, 7] = float("nan")
    x[0, 9, 2, 60] = float("nan")
    x[1, :5, :5] = float("-inf")
    x[1, 8, :, 3] = float("-inf")
    before = mp.max_pool_fwd_cuda.modes["bulk"]
    y, idx = mp.max_pool_fwd_cuda(x)
    torch.cuda.synchronize()
    assert mp.max_pool_fwd_cuda.modes["bulk"] == before + 1
    py, pidx = mp.max_pool_fwd_plain(x)
    nan = torch.isnan(py)
    assert nan.any() and torch.equal(torch.isnan(y), nan)
    assert torch.equal(y.nan_to_num(), py.nan_to_num())
    assert torch.equal(idx, pidx) and not idx[nan].any()
    assert torch.isneginf(y[1, :2, :2]).all() and not idx[1, :2, :2].any()
    dp = torch.randn(y.shape, generator=gen, device="cuda", dtype=dtype)
    dy = mp.max_pool_bwd_cuda(idx, dp, x.shape)
    assert torch.equal(dy, mp.max_pool_bwd_plain(pidx, dp, x.shape))


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("shape,window,stride,want", [
    ((2, 56, 56, 64), 3, 2, ("bulk", "bulk")),
    ((2, 27, 27, 192), 3, 2, ("bulk", "bulk")),
    ((2, 13, 13, 256), 3, 2, ("bulk", "bulk")),
    ((2, 9, 9, 6), 3, 2, ("cooperative", "cooperative")),  # C % 4 != 0
    ((1, 9, 9, 8), 3, 3, ("bulk", "cooperative")),  # index rows of 24 B
])
def test_pool_kernels_load_modes(gen, shape, window, stride, want, dtype):
    """The launch code picks the load mode from the shape: the AlexNet
    stages copy their bands in bulk, shapes whose rows are not multiples
    of 16 bytes load them cooperatively; both are exact."""
    x = 1 + torch.randint(0, 3, shape, generator=gen, device="cuda") / 128
    assert _modes_of(lambda: _pool_pair(x.to(dtype), window, stride)) == want


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
def test_pool_backward_takes_the_conv_pool_index(gen, dtype):
    """K2 is also the first half of K3's backward: fed K3's index it is
    exact against the plain version on the same index."""
    x, k = _conv_inputs(gen, (2, 27, 27, 64), 5, 192, dtype)
    y, idx = cp.conv_pool_cuda(x, k)
    dp = torch.randn(y.shape, generator=gen, device="cuda", dtype=dtype)
    shape = (2, 27, 27, 192)
    dy = mp.max_pool_bwd_cuda(idx, dp, shape)
    torch.cuda.synchronize()
    assert torch.equal(dy, mp.max_pool_bwd_plain(idx, dp, shape))


def _conv_inputs(gen, shape, window, feat, dtype, integer=False):
    if integer:  # small integers: every sum is exact in f32
        x = torch.randint(-1, 2, shape, generator=gen, device="cuda")
        k = torch.randint(-1, 2, (window, window, shape[-1], feat),
                          generator=gen, device="cuda")
        return x.to(dtype), k.to(dtype)
    x = torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
    k = torch.randn((window, window, shape[-1], feat), generator=gen,
                    device="cuda") * (window * window * shape[-1]) ** -0.5
    return x, k.to(dtype)


def _decided(x, k):
    """Where the plain version's best pool candidate beats the second by
    more than another accumulation order can move them: two bf16 units
    in the last place (2^-6 of the magnitude) in bf16, 1e-4 of it in
    f32."""
    conv = cp._conv(x.float(), k.float()).to(x.dtype).float()
    win = conv.unfold(1, 3, 2).unfold(2, 3, 2).flatten(-2)
    top = win.topk(2, dim=-1).values
    mag = top.abs().amax(-1)
    rel = 2 ** -6 if x.dtype == torch.bfloat16 else 1e-4
    return top[..., 0] - top[..., 1] > rel * mag


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("shape,window,feat", CONV_SHAPES)
def test_conv_pool_kernel_matches_plain(gen, shape, window, feat, dtype):
    x, k = _conv_inputs(gen, shape, window, feat, dtype)
    before = cp.conv_pool_cuda.launches
    y, idx = cp.conv_pool_cuda(x, k)
    torch.cuda.synchronize()
    assert cp.conv_pool_cuda.launches == before + 1
    py, pidx = cp.conv_pool_plain(x, k)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(y.float(), py.float(), atol=tol, rtol=tol)
    decided = _decided(x, k)
    assert decided.float().mean() > 0.8
    assert torch.equal(idx[decided], pidx[decided])


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("shape,window,feat",
                         CONV_SHAPES[:3] + CONV_SHAPES[4:])
def test_conv_pool_kernel_exact_on_integers(gen, shape, window, feat, dtype):
    """Integer inputs make every conv sum exact, so the kernel must give
    the plain version's values and index bit for bit, ties included."""
    x, k = _conv_inputs(gen, shape, window, feat, dtype, integer=True)
    y, idx = cp.conv_pool_cuda(x, k)
    py, pidx = cp.conv_pool_plain(x, k)
    assert torch.equal(y, py) and torch.equal(idx, pidx)


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
def test_conv_pool_kernel_nan_wins_with_index_0(gen, dtype):
    """K1's rule after the conv: a pool window that holds a NaN gives NaN
    with index 0; -inf inputs to the pool behave as numbers."""
    x, k = _conv_inputs(gen, (2, 15, 15, 8), 3, 64, dtype)
    x[0, 7, 8, 3] = float("nan")
    x[1, 2:11, 2:11, :] = float("-inf")
    k = k.abs()  # -inf * |k| stays -inf: no NaN in the second image
    y, idx = cp.conv_pool_cuda(x, k)
    torch.cuda.synchronize()
    py, pidx = cp.conv_pool_plain(x, k)
    assert torch.isnan(py[0]).any() and not torch.isnan(py[1]).any()
    assert torch.isneginf(py[1]).any()
    assert torch.equal(torch.isnan(y), torch.isnan(py))
    assert not idx[torch.isnan(py)].any()
    assert torch.equal(torch.isinf(y), torch.isinf(py))
    assert torch.equal(idx[torch.isinf(py)], pidx[torch.isinf(py)])


def test_pool_and_conv_pool_kernels_refuse(gen):
    x = torch.randn((2, 9, 9, 8), generator=gen, device="cuda")
    with pytest.raises(TypeError):
        mp.max_pool_fwd_cuda(x.half())
    with pytest.raises(ValueError, match="contiguous"):
        mp.max_pool_fwd_cuda(x.transpose(1, 2))
    with pytest.raises(ValueError, match="smaller"):
        mp.max_pool_fwd_cuda(x[:, :2])
    y, idx = mp.max_pool_fwd_cuda(x)
    with pytest.raises(ValueError, match="int8"):
        mp.max_pool_bwd_cuda(idx.int(), y, x.shape)
    k = torch.randn((3, 3, 8, 64), generator=gen, device="cuda")
    with pytest.raises(TypeError):
        cp.conv_pool_cuda(x.half(), k.half())
    with pytest.raises(ValueError, match="F % 64"):
        cp.conv_pool_cuda(x, k[..., :32])
    with pytest.raises(ValueError, match="C % 8"):
        cp.conv_pool_cuda(x[..., :4].contiguous().bfloat16(),
                          k[:, :, :4].bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        cp.conv_pool_cuda(x.transpose(1, 2), k)
    with pytest.raises(ValueError, match="odd-square"):
        cp.conv_pool_cuda(x, k[:2, :2])


@pytest.mark.parametrize("pool,expect", [
    ("pallas", (3, 3, 0)), ("fused", (0, 3, 3)), ("xla", (0, 0, 0))])
def test_alexnet_step_launches_the_kernels(gen, pool, expect):
    """One bf16 training step at 64 px: K1 per pool and K2 per pool
    backward under "pallas"; K3 per stage and K2 per stage backward
    under "fused"; none under "xla"."""
    from tpu_k8s_device_plugin_torch.workloads import alexnet

    model, opt = alexnet.create_train_state(
        image_size=64, num_classes=10, s2d=True, pool=pool, device="cuda")
    images, labels = alexnet.synthetic_batch(gen, 4, image_size=64,
                                             num_classes=10, s2d=True)
    counters = (mp.max_pool_fwd_cuda, mp.max_pool_bwd_cuda,
                cp.conv_pool_cuda)
    before = [c.launches for c in counters]
    loss = alexnet.train_step(model, opt, images, labels)
    torch.cuda.synchronize()
    assert tuple(c.launches - b for c, b in zip(counters, before)) == expect
    assert torch.isfinite(loss)
