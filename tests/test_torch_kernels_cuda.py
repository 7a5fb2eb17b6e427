"""The port's CUDA kernels on the card, against their plain versions.

These need a CUDA device and the CUDA toolkit (the kernels build from
``tpu_k8s_device_plugin_torch/csrc`` at first use); elsewhere they skip.
On the GPU machine:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q
"""

import pytest
import torch

from tpu_k8s_device_plugin_torch.workloads import flash_attention as fa

pytestmark = pytest.mark.cuda

# bf16 3e-2 and f32 2e-5: the JAX package's flash contract
TOL = {torch.bfloat16: 3e-2, torch.float32: 2e-5}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


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
