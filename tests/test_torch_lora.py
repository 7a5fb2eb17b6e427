"""The port's multi-LoRA decoder and engine against the JAX package's, on
the CPU, in f32.

Mirrors tests/test_lora.py: a fresh adapter (B = 0) is exactly the base
model; an adapter with random B matches the base model with the merged
weights W + A B at 2e-4; requests with mixed adapters in one engine get
the ids of their solo runs; a registered prefix is bound to its
adapter; bad adapter ids are refused; adapters compose with int8 and
int4 bases.  The adapter stacks come from the reference's
``attach_lora`` (random B as its tests draw them) through
``convert.params_from_jax``, and every id is also held against the JAX
engine's; the port's own ``attach_lora`` gives the reference's layout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_k8s_device_plugin.workloads import inference as jinf
from tpu_k8s_device_plugin.workloads import serving as jserving
from tpu_k8s_device_plugin_torch.convert import params_from_jax
from tpu_k8s_device_plugin_torch.workloads import inference as tinf
from tpu_k8s_device_plugin_torch.workloads import serving as tserving

CFG = dict(vocab=96, d_model=64, n_heads=4, n_layers=2, d_ff=128)
N_ADAPT = 3
RANK = 4


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _random_b(lp, rng):
    """Every lora_B random (a trained adapter), as tests/test_lora.py."""
    out = jax.tree_util.tree_map(lambda x: x, lp)
    for bname, block in out.items():
        if not bname.startswith("block_"):
            continue
        for name in list(block):
            if name.endswith("_lora_B"):
                rng, k = jax.random.split(rng)
                block[name] = jax.random.normal(
                    k, block[name].shape, jnp.float32) * 0.05
    return out


@pytest.fixture(scope="module")
def setup():
    base = jinf.make_decoder(**CFG, max_len=64, dtype=jnp.float32)
    jlora = jinf.make_decoder(**CFG, max_len=64, dtype=jnp.float32,
                              n_adapters=N_ADAPT, lora_rank=RANK)
    tokens = jnp.zeros((1, 8), jnp.int32)
    pos = jnp.broadcast_to(jnp.arange(8, dtype=jnp.int32), (1, 8))
    base_params = _host(base.init(jax.random.PRNGKey(0), tokens, pos)[
        "params"])
    lp = _host(_random_b(jinf.attach_lora(base_params, jlora,
                                          jax.random.PRNGKey(1)),
                         jax.random.PRNGKey(2)))
    return base, jlora, base_params, lp


def _port(quantized=False, n_adapters=N_ADAPT, state=None):
    model = tinf.make_decoder(**CFG, max_len=64, dtype=torch.float32,
                              quantized=quantized, n_adapters=n_adapters,
                              lora_rank=RANK, device="cpu")
    if state is not None:
        model.load_state_dict(params_from_jax(state))
    return model


def _solo(model, prompt, n, **admit_kw):
    eng = tserving.ServingEngine(model, n_slots=1, max_new_tokens=n,
                                 device="cpu")
    s = eng.admit(prompt, **admit_kw)
    eng.run(n + 2)
    return eng.output(s)


def _jsolo(model, params, prompt, n, **admit_kw):
    eng = jserving.ServingEngine(model, params, n_slots=1,
                                 max_new_tokens=n)
    s = eng.admit(prompt, **admit_kw)
    eng.run(n + 2)
    return eng.output(s)


def test_fresh_adapter_is_exact_noop(setup):
    base, jlora, base_params, _ = setup
    fresh = _host(jinf.attach_lora(base_params, jlora,
                                   jax.random.PRNGKey(1)))
    prompt = [5, 17, 3, 70]
    want, _ = jinf.greedy_generate(base, base_params,
                                   jnp.asarray([prompt], jnp.int32), 6)
    assert _solo(_port(state=fresh), prompt, 6, adapter=1) == \
        np.asarray(want)[0].tolist()
    # the port's own attach_lora: the reference's keys and shapes, and
    # a no-op too
    tbase = _port(n_adapters=0, state=base_params)
    ours = tinf.attach_lora(tbase.state_dict(), _port(), seed=3)
    theirs = params_from_jax(fresh)
    assert {k: tuple(v.shape) for k, v in ours.items()} == \
        {k: tuple(v.shape) for k, v in theirs.items()}
    model = _port()
    model.load_state_dict(ours)
    assert _solo(model, prompt, 6, adapter=2) == \
        np.asarray(want)[0].tolist()


def _merged(base_params, lp, adapter):
    """The base tree with one adapter folded in: W + A_k B_k."""
    out = jax.tree_util.tree_map(lambda x: x, base_params)
    for bname, block in out.items():
        if not bname.startswith("block_"):
            continue
        for name in list(block):
            if isinstance(block[name], dict) and "kernel" in block[name]:
                a = lp[bname].get(f"{name}_lora_A")
                if a is None:
                    continue
                b = lp[bname][f"{name}_lora_B"]
                block[name] = {"kernel": block[name]["kernel"]
                               + a[adapter] @ b[adapter]}
    return out


def test_trained_adapter_matches_merged_weights(setup):
    _, _, base_params, lp = setup
    model = _port(state=lp)
    prompt = torch.tensor([[5, 17, 3, 70, 2]])
    pos = torch.arange(5, dtype=torch.int32)[None, :]
    for adapter in range(N_ADAPT):
        merged = _port(n_adapters=0, state=_merged(base_params, lp,
                                                   adapter))
        want = merged(prompt, pos, tinf.init_cache(merged, 1))
        got = model(prompt, pos, tinf.init_cache(model, 1), decode=True,
                    adapter_ids=torch.tensor([adapter]))
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4,
                                   atol=2e-4)


def test_mixed_adapters_match_solo_runs(setup):
    """Two adapters and the base in one 4-slot engine: each request's
    ids are its solo run's and the JAX engine's."""
    _, jlora, _, lp = setup
    model = _port(state=lp)
    prompts = {0: [5, 17, 3], 1: [9, 9, 8, 7], None: [2, 71]}
    eng = tserving.ServingEngine(model, n_slots=4, max_new_tokens=6,
                                 device="cpu")
    jeng = jserving.ServingEngine(jlora, lp, n_slots=4, max_new_tokens=6)
    slots = {a: eng.admit(p, adapter=a) for a, p in prompts.items()}
    jslots = {a: jeng.admit(p, adapter=a) for a, p in prompts.items()}
    eng.run(8)
    jeng.run(8)
    for a, p in prompts.items():
        assert eng.output(slots[a]) == _solo(model, p, 6, adapter=a), a
        assert eng.output(slots[a]) == jeng.output(jslots[a]), a
    # the adapters do change the ids
    assert len({tuple(eng.output(s)) for s in slots.values()}) > 1


def test_prefix_bound_to_adapter(setup):
    _, jlora, _, lp = setup
    model = _port(state=lp)
    system = [7, 7, 12]
    eng = tserving.ServingEngine(model, n_slots=2, max_new_tokens=5,
                                 device="cpu")
    h = eng.register_prefix(system, adapter=0)
    with pytest.raises(ValueError, match="adapter"):
        eng.admit(system + [1], prefix=h, adapter=1)
    with pytest.raises(ValueError, match="adapter"):
        eng.admit(system + [1], prefix=h)  # base against an adapter-0 prefix
    s = eng.admit(system + [1], prefix=h, adapter=0)
    eng.run(7)
    assert eng.output(s) == _solo(model, system + [1], 5, adapter=0)
    assert eng.output(s) == _jsolo(jlora, lp, system + [1], 5, adapter=0)


def test_auto_prefix_donors_are_adapter_bound(setup):
    """A resident prompt prefilled under one adapter is no donor for the
    same prompt under another: the second admission prefills cold and
    decodes its own adapter's ids, while the same prompt under the
    first adapter again is a hit."""
    _, _, _, lp = setup
    model = _port(state=lp)
    prompt = list(range(3, 3 + 20))
    eng = tserving.ServingEngine(model, n_slots=2, max_new_tokens=4,
                                 prefix_chunk=8, device="cpu")
    a = eng.admit(prompt, adapter=0)
    b = eng.admit(prompt, adapter=1)
    assert eng.stats()["prefix_cache_hits"] == 0
    eng.run(6)
    assert eng.output(a) == _solo(model, prompt, 4, adapter=0)
    assert eng.output(b) == _solo(model, prompt, 4, adapter=1)
    # the same prompt under adapter 0 again finds its donor
    c = eng.admit(prompt, adapter=0)
    assert eng.stats()["prefix_cache_hits"] == 1
    eng.run(6)
    assert eng.output(c) == eng.output(a)


def test_adapter_validation(setup):
    _, _, base_params, lp = setup
    eng = tserving.ServingEngine(_port(state=lp), n_slots=1, device="cpu")
    with pytest.raises(ValueError, match="adapter"):
        eng.admit([1, 2], adapter=N_ADAPT)
    with pytest.raises(ValueError, match="adapter"):
        eng.admit([1, 2], adapter=-2)
    base_eng = tserving.ServingEngine(_port(n_adapters=0,
                                            state=base_params),
                                      n_slots=1, device="cpu")
    with pytest.raises(ValueError, match="n_adapters"):
        base_eng.admit([1, 2], adapter=0)
    with pytest.raises(ValueError, match="n_adapters"):
        base_eng.register_prefix([1, 2], adapter=0)


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_lora_composes_with_quantized_bases(setup, kind):
    """Adapters over an int8 or int4 base: zero-B adapters decode the
    plain quantized ids; random-B ones the JAX engine's ids; the B
    stacks carry the full output width (an int4 kernel is packed)."""
    _, _, base_params, _ = setup
    flag, jquant = ((True, jinf.quantize_lm_params) if kind == "int8"
                    else ("int4", jinf.quantize_lm_params_int4))
    jq = jinf.make_decoder(**CFG, max_len=64, dtype=jnp.float32,
                           quantized=flag, n_adapters=N_ADAPT,
                           lora_rank=RANK)
    qbase = _host(jquant(base_params))
    fresh = _host(jinf.attach_lora(qbase, jq, jax.random.PRNGKey(1)))
    f = base_params["block_0"]["mlp_up"]["kernel"].shape[1]
    ours = tinf.attach_lora(params_from_jax(qbase), _port(quantized=flag))
    assert tuple(ours["block_0.mlp_up_lora_B"].shape) == (N_ADAPT, RANK, f)
    prompt = [5, 17, 3]
    plain = _solo(_port(quantized=flag, n_adapters=0, state=qbase),
                  prompt, 4)
    assert _solo(_port(quantized=flag, state=fresh), prompt, 4,
                 adapter=1) == plain
    trained = _host(_random_b(fresh, jax.random.PRNGKey(5)))
    got = _solo(_port(quantized=flag, state=trained), prompt, 4, adapter=2)
    assert got == _jsolo(jq, trained, prompt, 4, adapter=2)
