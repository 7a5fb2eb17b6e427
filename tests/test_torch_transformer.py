"""The port's LM training path against the JAX package's, on the CPU.

Two models: the gelu ``TransformerLM`` of tests/test_transformer.py
(``TINY``, multi-head) and ``llama.train_model(TINY_LLAMA)`` (SwiGLU,
GQA 8:2, theta 5e5).  Both are initialised by JAX, converted with
``convert.params_from_jax`` (the gradient trees too: they carry the
same names) and run in f32.  Attention is the einsum oracle or the flash
adapter; the JAX flash kernels run in interpret mode.  Tokens come from
numpy with a seed.  Logits agree to 1e-4, each gradient to 1e-4 of its
largest entry, and three Adam steps to 1e-5 in the losses and 1e-4 in
the parameters (the two frameworks sum in different orders)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpu_k8s_device_plugin.workloads import llama as jllama
from tpu_k8s_device_plugin.workloads import transformer as jtr
from tpu_k8s_device_plugin.workloads.flash_attention import (
    flash_causal_attention as jflash,
)
from tpu_k8s_device_plugin_torch.convert import params_from_jax
from tpu_k8s_device_plugin_torch.workloads import flash_attention as tfa
from tpu_k8s_device_plugin_torch.workloads import inference as tinf
from tpu_k8s_device_plugin_torch.workloads import llama as tllama
from tpu_k8s_device_plugin_torch.workloads import transformer as ttr

TINY = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64)
ATTN = {"local": (jtr.local_causal_attention, ttr.local_causal_attention),
        "flash": (jflash, tfa.flash_causal_attention)}
_DT = {"f32": (jnp.float32, torch.float32),
       "bf16": (jnp.bfloat16, torch.bfloat16)}


def _models(config, attn="local", dtype="f32"):
    """(JAX model, port model) for *config*, without parameters."""
    (jattn, tattn), (jd, td) = ATTN[attn], _DT[dtype]
    if config == "tiny":
        return (jtr.TransformerLM(attn_fn=jattn, dtype=jd, **TINY),
                ttr.TransformerLM(attn_fn=tattn, dtype=td, device="cpu",
                                  **TINY))
    cfg = jllama.TINY_LLAMA
    return (jllama.train_model(cfg, dtype=jd, attn_fn=jattn),
            tllama.train_model(tllama.TINY_LLAMA, dtype=td, attn_fn=tattn,
                               device="cpu"))


def _batch(vocab, batch=2, seq_len=32, seed=0):
    tokens = np.random.default_rng(seed).integers(
        0, vocab, (batch, seq_len)).astype(np.int32)
    labels = np.concatenate(
        [tokens[:, 1:], np.full((batch, 1), -1, np.int32)], axis=1)
    positions = np.broadcast_to(np.arange(seq_len, dtype=np.int32),
                                (batch, seq_len))
    return tokens, labels, positions


def _pair(config, attn="local", dtype="f32", seed=1):
    """JAX model and params, the port model with them loaded, a batch."""
    jm, tm = _models(config, attn, dtype)
    batch = _batch(tm.vocab, seed=seed)
    params = jm.init(jax.random.PRNGKey(seed), *map(jnp.asarray,
                                                    (batch[0], batch[2])))
    params = params["params"]
    tm.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                              params)))
    return jm, params, tm, batch


def _torch(batch):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in batch)


@pytest.mark.parametrize("attn", ["local", "flash"])
@pytest.mark.parametrize("config", ["tiny", "llama"])
def test_logits_match_jax(config, attn):
    jm, params, tm, (tokens, _, positions) = _pair(config, attn)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(tokens),
                               jnp.asarray(positions)))
    got = tm(*_torch((tokens, positions)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-4,
                               rtol=0)
    # positions=None means 0..T-1, as in the JAX model
    torch.testing.assert_close(tm(torch.from_numpy(tokens)), got)


@pytest.mark.parametrize("attn", ["local", "flash"])
@pytest.mark.parametrize("config", ["tiny", "llama"])
def test_loss_and_every_gradient_match_jax(config, attn):
    jm, params, tm, batch = _pair(config, attn)
    jloss, jgrads = jax.value_and_grad(
        functools.partial(jtr.lm_loss, jm))(params, *map(jnp.asarray,
                                                          batch))
    loss = ttr.lm_loss(tm, *_torch(batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    got = dict(tm.named_parameters())
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name].grad
        assert g is not None and g.dtype == torch.float32, name
        scale = float(w.abs().max())
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-4 * scale, err_msg=name)


@pytest.mark.parametrize("config,eps", [("tiny", 1e-8), ("tiny", 1e-3),
                                        ("llama", 1e-3)])
def test_three_adam_steps_match_optax(config, eps):
    """``torch.optim.Adam`` against ``optax.adam`` through three training
    steps, each framework from its own state.  At eps 1e-3 every update is
    well conditioned, and where eps goes (after the bias correction, in
    both) weighs the most.  TINY_LLAMA at the default eps is held step by
    step in the next test: free running, its gaps compound."""
    jm, params, tm, batch = _pair(config)
    tx = optax.adam(1e-2, eps=eps)
    opt_state = tx.init(params)
    step = jax.jit(functools.partial(jtr.lm_train_step, jm, tx))
    opt = torch.optim.Adam(tm.parameters(), lr=1e-2, betas=(0.9, 0.999),
                           eps=eps)
    tbatch = _torch(batch)
    jbatch = tuple(map(jnp.asarray, batch))
    for _ in range(3):
        params, opt_state, jloss = step(params, opt_state, *jbatch)
        loss = ttr.lm_train_step(tm, opt, *tbatch)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-4, err_msg=name)


# Adam's update lr * m / (sqrt(v) + eps) turns a gradient gap dg into a
# parameter gap of up to lr * dg / (sqrt(v) + eps).  The two frameworks'
# gradients differ by up to about 1e-8 at small entries (f32 sums in
# another order), so below an RMS gradient sqrt(v) of 1e-6 that gap can
# pass 1e-4 at lr 1e-2; above it, it stays under 1e-4.
ADAM_NOISE_FLOOR = 1e-6


def _tree(x):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, x))


@pytest.mark.parametrize("config", ["tiny", "llama"])
def test_each_adam_step_matches_optax_at_default_eps(config):
    """``torch.optim.Adam`` against ``optax.adam(1e-2)`` at the default
    eps (1e-8), one step at a time: before each of three steps the port
    takes the reference's parameters and moments, so a gap cannot carry
    into the next step's gradients.  The losses agree to 1e-5, the
    moments to 1e-4 of their leaf's largest entry, and every parameter to
    1e-4, except where the reference's bias-corrected RMS gradient
    sqrt(v) is below ``ADAM_NOISE_FLOOR`` (and not exactly 0: a gradient
    that is 0 in both frameworks leaves the entry as it was); those
    entries are at most one part in a thousand."""
    jm, params, tm, batch = _pair(config)
    tx = optax.adam(1e-2)
    opt_state = tx.init(params)
    step = jax.jit(functools.partial(jtr.lm_train_step, jm, tx))
    opt = torch.optim.Adam(tm.parameters(), lr=1e-2, betas=(0.9, 0.999),
                           eps=1e-8)
    named = dict(tm.named_parameters())
    tbatch, jbatch = _torch(batch), tuple(map(jnp.asarray, batch))
    noisy = total = 0
    for t in range(1, 4):
        params, opt_state, jloss = step(params, opt_state, *jbatch)
        loss = ttr.lm_train_step(tm, opt, *tbatch)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5,
                                   err_msg=f"step {t}")
        want, mu, nu = map(_tree, (params, opt_state[0].mu,
                                   opt_state[0].nu))
        for name, p in named.items():
            state, msg = opt.state[p], f"{name}, step {t}"
            for key, ref in (("exp_avg", mu[name]), ("exp_avg_sq", nu[name])):
                np.testing.assert_allclose(
                    state[key].numpy(), ref.numpy(), rtol=0,
                    atol=1e-4 * float(ref.abs().max()), err_msg=msg)
            rms = (nu[name] / (1 - 0.999 ** t)).sqrt()
            kept = (rms >= ADAM_NOISE_FLOOR) | (rms == 0)
            noisy += int((~kept).sum())
            total += kept.numel()
            np.testing.assert_allclose(
                p.detach()[kept].numpy(), want[name][kept].numpy(), rtol=0,
                atol=1e-4, err_msg=msg)
            with torch.no_grad():  # the next step starts from the reference
                p.copy_(want[name])
                state["exp_avg"].copy_(mu[name])
                state["exp_avg_sq"].copy_(nu[name])
    assert noisy <= 1e-3 * total, (noisy, total)


def test_flash_lm_matches_einsum_lm_bf16():
    """Mirror of tests/test_flash_attention.py's LM check (the same tiny
    gelu model): the flash LM and the einsum LM give the same bf16
    logits on the same weights."""
    _, _, flash, (tokens, _, positions) = _pair("tiny", "flash", "bf16")
    _, einsum = _models("tiny", "local", "bf16")
    einsum.load_state_dict(flash.state_dict())
    args = _torch((tokens, positions))
    np.testing.assert_allclose(flash(*args).detach().numpy(),
                               einsum(*args).detach().numpy(), atol=3e-2,
                               rtol=3e-2)


def test_training_reduces_loss():
    """Mirror of tests/test_transformer.py's single-device check: five
    Adam steps on one batch lower the loss."""
    _, _, tm, batch = _pair("tiny")
    opt = torch.optim.Adam(tm.parameters(), lr=1e-2)
    losses = [float(ttr.lm_train_step(tm, opt, *_torch(batch)))
              for _ in range(5)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_parameters_are_f32_and_train_in_bf16_compute():
    _, tm = _models("llama", dtype="bf16")
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in tm.parameters())
    names = {n for n, _ in tm.named_parameters()}
    assert {"embed.weight", "final_norm.scale", "lm_head.weight",
            "block_1.mlp_gate.weight", "block_0.attn_norm.scale"} <= names


def test_synthetic_lm_batch():
    gen = torch.Generator().manual_seed(0)
    tokens, labels, positions = ttr.synthetic_lm_batch(gen, 3, 16, 50)
    assert tokens.shape == labels.shape == positions.shape == (3, 16)
    assert ((tokens >= 0) & (tokens < 50)).all()
    assert torch.equal(labels[:, :-1], tokens[:, 1:])
    assert (labels[:, -1] == -1).all()
    assert positions.dtype == torch.int32
    assert torch.equal(positions[1], torch.arange(16, dtype=torch.int32))


def test_loss_ignores_negative_labels():
    _, params, tm, (tokens, labels, positions) = _pair("tiny")
    jm = _models("tiny")[0]
    labels = labels.copy()
    labels[0, :5] = -3
    want = jtr.lm_loss(jm, params, *map(jnp.asarray,
                                        (tokens, labels, positions)))
    got = ttr.lm_loss(tm, *_torch((tokens, labels, positions)))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    none = ttr.lm_loss(tm, *_torch((tokens, np.full_like(labels, -1),
                                    positions)))
    assert none.item() == 0.0


@pytest.mark.parametrize("build", [
    lambda: ttr.TransformerLM(n_experts=4, device="cpu", **TINY),
    lambda: ttr.Block(32, 4, 64, n_experts=2, device="cpu"),
    lambda: tinf.DecodeTransformerLM(n_experts=4, device="cpu", **TINY),
], ids=["TransformerLM", "Block", "DecodeTransformerLM"])
def test_moe_refused_naming_its_roadmap_item(build):
    """MoE FFNs (ROADMAP item 3) are ported now: every model builds an
    expert FFN named ``moe`` in place of its dense MLP, and runs
    (tests/test_torch_moe.py holds them against the JAX package)."""
    model = build()
    names = [n for n, _ in model.named_parameters()]
    assert any(n.endswith("moe.router") for n in names)
    assert not any("mlp_up" in n for n in names)
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0, 0.05)
    if isinstance(model, ttr.Block):
        x = torch.randn(1, 4, 32)
        pos = torch.arange(4, dtype=torch.int32)[None, :]
        assert model(x, pos).shape == x.shape
    elif isinstance(model, ttr.TransformerLM):
        tokens = torch.zeros(1, 6, dtype=torch.long)
        labels = torch.ones(1, 6, dtype=torch.long)
        loss = ttr.lm_loss(model, tokens, labels)
        assert torch.isfinite(loss) and model.aux_loss().item() > 0
    else:
        ids, _ = tinf.greedy_generate(model, [[1, 2, 3]], 3)
        assert tuple(ids.shape) == (1, 3)
