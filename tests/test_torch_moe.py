"""The port's MoE FFN against the JAX package's ``workloads/moe.py``, on
the CPU, in f32.

Mirrors tests/test_moe.py's routing-plan and module cases (and its
single-token gather branch): the same router logits give the same
dispatch and combine plan, the module agrees with the reference's
per-token oracle at 1e-5 when nothing drops, priority makes the drops
layout-invariant, and a tied top-k goes to the lower expert as
``jax.lax.top_k`` sends it.  Then the MoE LM: parameters initialised by
JAX and converted with ``convert.params_from_jax``, the loss (cross
entropy plus the aux terms) and every gradient within 5e-4 of the
reference's, and the MoE decoder's greedy ids equal to the JAX
decoder's, through the plain loop and the serving engine."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_k8s_device_plugin.workloads import inference as jinf
from tpu_k8s_device_plugin.workloads import moe as jmoe
from tpu_k8s_device_plugin.workloads import serving as jserving
from tpu_k8s_device_plugin.workloads import transformer as jtr
from tpu_k8s_device_plugin_torch.convert import params_from_jax
from tpu_k8s_device_plugin_torch.workloads import inference as tinf
from tpu_k8s_device_plugin_torch.workloads import moe as tmoe
from tpu_k8s_device_plugin_torch.workloads import serving as tserving
from tpu_k8s_device_plugin_torch.workloads import transformer as ttr

TINY = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64)


def _np(x):
    return np.asarray(x)


def _logits(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _ffn_pair(E, D, F, k, capacity=None, x_shape=None, seed=2):
    """The JAX MoEFFN with its initialised params and the port's with
    them loaded."""
    x = jnp.zeros(x_shape or (1, 4, D), jnp.float32)
    jffn = jmoe.MoEFFN(n_experts=E, d_model=D, d_ff=F, k=k,
                       capacity=capacity, dtype=jnp.float32)
    params = jffn.init(jax.random.PRNGKey(seed), x)["params"]
    tffn = tmoe.MoEFFN(E, D, F, k=k, capacity=capacity, dtype=torch.float32,
                       device="cpu")
    tffn.load_state_dict(params_from_jax(jax.tree_util.tree_map(
        np.asarray, params)))
    return jffn, params, tffn


@pytest.mark.parametrize("priority", [False, True])
@pytest.mark.parametrize("B,T,E,k,C", [(2, 16, 4, 2, 6), (1, 12, 8, 2, 2),
                                       (3, 8, 4, 1, 3)])
def test_dispatch_plan_equals_reference(B, T, E, k, C, priority):
    """The dispatch and combine tensors and the aux loss, from the same
    logits: the plan bit for bit, the gates and the loss to f32
    rounding."""
    logits = _logits((B, T, E), seed=B * 100 + T)
    prio = None
    if priority:
        prio = np.stack([np.random.default_rng(b).permutation(T)
                         for b in range(B)]).astype(np.int32)
    jd, jc, ja = jmoe.top_k_routing(
        jnp.asarray(logits), k, C,
        priority=None if prio is None else jnp.asarray(prio))
    td, tc, ta = tmoe.top_k_routing(
        torch.from_numpy(logits), k, C,
        priority=None if prio is None else torch.from_numpy(prio))
    np.testing.assert_array_equal(td.numpy(), _np(jd))
    np.testing.assert_allclose(tc.numpy(), _np(jc), atol=1e-7, rtol=1e-6)
    np.testing.assert_allclose(ta.item(), float(ja), rtol=1e-6)
    d = td.numpy()
    assert (d.sum(axis=1) <= 1.0).all()          # a slot holds one token
    assert (d.sum(axis=(2, 3)) <= k).all()       # a token holds <= k
    assert (d.sum(axis=3) <= 1.0).all()          # one slot an expert


def test_capacity_overflow_drops_tokens():
    """Every token prefers expert 0; capacity 2 keeps exactly the first
    two."""
    logits = torch.zeros(1, 8, 4)
    logits[..., 0] = 10.0
    dispatch, _, _ = tmoe.top_k_routing(logits, 1, 2)
    assert float(dispatch[..., 0, :].sum()) == 2.0
    assert dispatch[0, :2, 0].sum() == 2.0 and dispatch[0, 2:].sum() == 0.0


def test_aux_loss_is_one_at_perfect_balance():
    B, T, E = 2, 8, 4
    bias = torch.eye(E)[torch.arange(T) % E] * 1e-4
    _, _, aux = tmoe.top_k_routing(bias.expand(B, T, E), 1, T)
    assert abs(aux.item() - 1.0) < 1e-3


def test_capacity_formula():
    for args in ((64, 8, 2, 1.0), (4, 64, 1, 1.0), (8192, 8, 2, 1.25),
                 (33, 5, 3, 0.7)):
        assert tmoe.moe_capacity(*args) == jmoe.moe_capacity(*args)
    assert tmoe.moe_capacity(8192, 8, 2, 1.25) == 2560


def test_top_k_tie_goes_to_the_lower_expert():
    """Three experts tie for the top two places: jax.lax.top_k picks the
    two lowest indices, and so does the port, in the same order."""
    logits = np.array([[[0.5, 2.0, 2.0, -1.0, 2.0]]], np.float32)
    _, _, jidx = jmoe._top_k_gates(jnp.asarray(logits), 2)
    _, gates, tidx = tmoe._top_k_gates(torch.from_numpy(logits), 2)
    np.testing.assert_array_equal(tidx.numpy(), _np(jidx))
    assert tidx.tolist() == [[[1, 2]]]
    np.testing.assert_allclose(gates.numpy(), [[[0.5, 0.5]]])
    jd, _, _ = jmoe.top_k_routing(jnp.asarray(logits), 2, 1)
    td, _, _ = tmoe.top_k_routing(torch.from_numpy(logits), 2, 1)
    np.testing.assert_array_equal(td.numpy(), _np(jd))


@pytest.mark.parametrize("k", [1, 2])
def test_matches_reference_oracle_when_nothing_drops(k):
    """Capacity T drops nothing: the module, the port's oracle and the
    reference's oracle agree at 1e-5."""
    B, T, D, F, E = 2, 16, 8, 32, 4
    x = np.random.default_rng(1).standard_normal((B, T, D)).astype(
        np.float32)
    jffn, params, tffn = _ffn_pair(E, D, F, k, capacity=T)
    want = _np(jmoe.moe_ffn_oracle(params, jnp.asarray(x), k=k))
    with torch.no_grad():
        got = tffn(torch.from_numpy(x))
        oracle = tmoe.moe_ffn_oracle(tffn.state_dict(), torch.from_numpy(x),
                                     k=k)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(oracle.numpy(), want, atol=1e-5, rtol=1e-5)
    module = _np(jffn.apply({"params": params}, jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), module, atol=1e-5, rtol=1e-5)


def test_routing_is_layout_invariant_under_overflow():
    """Permuting tokens and positions together permutes the output, even
    with tight capacity, and equals the reference on both layouts."""
    B, T, D = 2, 16, 8
    rng = np.random.RandomState(0)
    x = rng.randn(B, T, D).astype(np.float32)
    positions = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T))
    jffn, params, tffn = _ffn_pair(4, D, 16, 2, capacity=3)
    perm = rng.permutation(T)
    with torch.no_grad():
        natural = tffn(torch.from_numpy(x),
                       torch.from_numpy(np.ascontiguousarray(positions)))
        permuted = tffn(torch.from_numpy(np.ascontiguousarray(x[:, perm])),
                        torch.from_numpy(np.ascontiguousarray(
                            positions[:, perm])))
    np.testing.assert_allclose(natural.numpy()[:, perm], permuted.numpy(),
                               atol=1e-5, rtol=1e-5)
    want = _np(jffn.apply({"params": params}, jnp.asarray(x),
                          jnp.asarray(positions)))
    np.testing.assert_allclose(natural.numpy(), want, atol=1e-5, rtol=1e-5)


def test_keeps_aux_loss_like_the_reference_sows_it():
    B, T, D = 2, 8, 8
    x = np.random.default_rng(4).standard_normal((B, T, D)).astype(
        np.float32)
    jffn, params, tffn = _ffn_pair(4, D, 16, 2)
    _, mut = jffn.apply({"params": params}, jnp.asarray(x),
                        mutable="losses")
    (leaf,) = jax.tree_util.tree_leaves(mut)
    tffn(torch.from_numpy(x))
    assert tffn.aux.item() > 0
    np.testing.assert_allclose(tffn.aux.item(), float(leaf), rtol=1e-6)


@pytest.mark.parametrize("quantized", [False, True])
def test_single_token_gather_branch_matches_dense(quantized):
    """T == 1 with B*k <= E takes the gather branch; it equals the dense
    dispatch of the same token (run at T = 2, dropless) and the
    reference's gather branch, in both stack layouts."""
    B, D, F, E = 4, 16, 32, 8
    x1 = np.random.default_rng(21).standard_normal((B, 1, D)).astype(
        np.float32)
    jffn, params, tffn = _ffn_pair(E, D, F, 2, x_shape=(B, 1, D))
    if quantized:
        from tpu_k8s_device_plugin.workloads.inference import (
            quantize_lm_params as jquant)

        params = jquant({"moe": params})["moe"]
        jffn = jffn.clone(quantized=True)
        tffn = tmoe.MoEFFN(E, D, F, k=2, dtype=torch.float32, quantized=True,
                           device="cpu")
        tffn.load_state_dict(params_from_jax(jax.tree_util.tree_map(
            np.asarray, params)))
    x2 = np.concatenate([x1, x1], axis=1)
    pos2 = np.ascontiguousarray(
        np.broadcast_to(np.arange(2, dtype=np.int32), (B, 2)))
    with torch.no_grad():
        got = tffn(torch.from_numpy(x1))
        dense = tffn(torch.from_numpy(x2), torch.from_numpy(pos2))
    np.testing.assert_allclose(got.numpy()[:, 0], dense.numpy()[:, 0],
                               atol=1e-5, rtol=1e-5)
    want = _np(jffn.apply({"params": params}, jnp.asarray(x1)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def _lm_pair(seed=1, cf=1.25, seq=16):
    jm = jtr.TransformerLM(n_experts=4, moe_capacity_factor=cf,
                           dtype=jnp.float32, **TINY)
    tm = ttr.TransformerLM(n_experts=4, moe_capacity_factor=cf,
                           dtype=torch.float32, device="cpu", **TINY)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, TINY["vocab"], (2, seq)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:],
                             np.full((2, 1), -1, np.int32)], axis=1)
    positions = np.broadcast_to(np.arange(seq, dtype=np.int32), (2, seq))
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(tokens),
                     jnp.asarray(positions))["params"]
    tm.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                              params)))
    return jm, params, tm, (tokens, labels, positions)


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_lm_loss_and_gradients_match_reference(cf):
    """The MoE LM's loss (cross entropy plus both layers' aux terms) and
    every gradient, router and expert stacks included, within 5e-4 of
    the reference's; capacity factor 0.5 makes tokens drop."""
    jm, params, tm, batch = _lm_pair(cf=cf)
    jloss, jgrads = jax.value_and_grad(functools.partial(jtr.lm_loss, jm))(
        params, *map(jnp.asarray, batch))
    loss = ttr.lm_loss(tm, *(torch.from_numpy(np.ascontiguousarray(b))
                             for b in batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    aux = tm.aux_loss().item()
    assert aux > 0
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    got = dict(tm.named_parameters())
    assert set(got) == set(want)
    assert "block_0.moe.experts_up" in got and "block_1.moe.router" in got
    for name, w in want.items():
        g = got[name].grad
        assert g is not None, name
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=5e-4 * max(float(w.abs().max()),
                                                   1e-6), err_msg=name)


def _decoder_pair(n_slots=0, max_len=64):
    _, params, _, _ = _lm_pair(cf=2.0)
    jdec = jinf.make_decoder(**TINY, max_len=max_len, n_experts=4,
                             moe_capacity_factor=2.0, dtype=jnp.float32)
    tdec = tinf.make_decoder(**TINY, max_len=max_len, n_experts=4,
                             moe_capacity_factor=2.0, dtype=torch.float32,
                             device="cpu")
    tdec.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                params)))
    return jdec, params, tdec


@pytest.mark.parametrize("batch", [1, 4])
def test_moe_decoder_greedy_ids_match_reference(batch):
    """Batch 1 and 2 decode through the gather branch (B*k <= E), batch
    4 through the dense one; the ids equal the JAX decoder's."""
    jdec, params, tdec = _decoder_pair()
    prompt = np.random.default_rng(7).integers(
        0, TINY["vocab"], (batch, 9)).astype(np.int32)
    want, wlog = jinf.greedy_generate(jdec, params, jnp.asarray(prompt), 10)
    got, glog = tinf.greedy_generate(tdec, prompt, 10)
    np.testing.assert_array_equal(got.numpy(), _np(want))
    np.testing.assert_allclose(glog.numpy(), _np(wlog), atol=1e-4, rtol=0)


def test_moe_engine_ids_match_reference():
    """Four MoE requests through both engines (the 4-slot decode takes
    the dense branch, the chunked admission extends pin capacity to T)
    give the same ids."""
    jdec, params, tdec = _decoder_pair()
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, TINY["vocab"], n).tolist()
               for n in (5, 11, 17, 8)]
    jeng = jserving.ServingEngine(jdec, params, n_slots=4,
                                  max_new_tokens=8, prefix_chunk=8)
    teng = tserving.ServingEngine(tdec, n_slots=4, max_new_tokens=8,
                                  prefix_chunk=8, device="cpu")
    for eng in (jeng, teng):
        for p in prompts:
            eng.admit(p)
        eng.run(16)
    for s in range(4):
        assert teng.output(s) == jeng.output(s)
