"""The port's sharded LM (``workloads/transformer.py``: ``make_lm_mesh``,
``lm_tree_shardings``, ``make_lm_train_step``; the expert axis of
``workloads/moe.py``) on a gloo group of 8 processes, against the JAX
package on its 8 virtual CPU devices: the counterparts of the mesh
cases of ``tests/test_transformer.py``, ``tests/test_moe.py``,
``tests/test_llama.py`` and ``tests/test_checkpoint.py``.

The reference's side runs here: its initial parameters (the tree its
``make_lm_train_step`` makes from ``PRNGKey(0)``), converted with
``convert.params_from_jax``, go to the ranks with its batch as numpy;
each rank loads its pieces of them.  The bars are the reference
tests': a sharded loss within 2e-2 of the local oracle's, a ring within
2e-5 of the local step's.  Beyond them, one step of the (data 1, expert
1, seq 2, model 2) mesh with GQA 4:2 gives the reference's sharded
step's parameter updates within UPDATE_REL, both in f32 compute: in
bf16 the two frameworks round the activations apart, and Adam's first
update, about ``lr * sign(g)``, turns those roundings into sign flips of
near-zero gradient entries (0.1-0.4 in relative norm even between the
port's own sharded and single-device steps).

Also the generalised ``parallel.Sharding`` (a spec entry split over two
axes jointly, ``fit_spec``'s replication where a split cannot hold).
"""

import functools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_parallel import GlooPool
from tpu_k8s_device_plugin.workloads import inference as jinf
from tpu_k8s_device_plugin.workloads import llama as jllama
from tpu_k8s_device_plugin.workloads import transformer as jtr
from tpu_k8s_device_plugin_torch.convert import params_from_jax

WORLD = 8
TINY = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64)
LLAMA = dict(vocab=jllama.TINY_LLAMA.vocab, d_model=jllama.TINY_LLAMA.d_model,
             n_heads=jllama.TINY_LLAMA.n_heads,
             n_kv_heads=jllama.TINY_LLAMA.n_kv_heads,
             n_layers=jllama.TINY_LLAMA.n_layers, d_ff=jllama.TINY_LLAMA.d_ff,
             ffn="swiglu", rope_theta=jllama.TINY_LLAMA.rope_theta)
GQA = dict(vocab=64, d_model=64, n_heads=8, n_layers=1, d_ff=128,
           n_kv_heads=2, ffn="swiglu", rope_theta=500000.0)
LOSS_RTOL, RING_RTOL = 2e-2, 2e-5
# f32 compute: the updates' relative norm |port - ref| / |ref - init|
UPDATE_REL = 1e-3


@pytest.fixture(scope="module")
def pool():
    p = GlooPool(WORLD)
    yield p
    p.close()


def _np(tree):
    return {k: v.numpy() for k, v in params_from_jax(
        jax.tree_util.tree_map(np.asarray, tree)).items()}


@functools.lru_cache(maxsize=None)
def reference_init(batch, seq_len, **cfg):
    """What the reference's ``make_lm_train_step`` starts from: its
    parameters (converted, numpy), its batch (numpy) and the local
    oracle's loss on them."""
    rng = jax.random.PRNGKey(0)
    model = jtr.TransformerLM(attn_fn=jtr.local_causal_attention, **cfg)
    batch_ = jtr.synthetic_lm_batch(rng, batch, seq_len, cfg["vocab"])
    params = model.init(rng, *batch_[::2])["params"]
    want = float(jtr.lm_loss(model, params, *batch_))
    return (_np(params), tuple(np.asarray(b) for b in batch_), want,
            params)


def run(pool, shape, kw, steps=1):
    cfg = {k: v for k, v in kw.items()
           if k not in ("seq_axis", "attn_layout", "batch", "seq_len")}
    params, batch, want, _ = reference_init(kw["batch"], kw["seq_len"],
                                            **cfg)
    return pool.run("lm_steps", shape, kw, params, batch, steps), want


class TestShardedLM:
    @pytest.mark.parametrize("layout", ["contiguous", "zigzag"])
    def test_sharded_loss_matches_local_oracle(self, pool, layout):
        got, want = run(pool, (1, 2, 2), dict(
            TINY, seq_len=32, batch=4, attn_layout=layout))
        for losses, *_ in got:
            assert np.isclose(losses[0], want, rtol=LOSS_RTOL), (losses,
                                                                 want)
        assert len({r[0][0] for r in got}) == 1  # the same on every rank

    def test_sharded_training_reduces_loss_and_keeps_layout(self, pool):
        got, _ = run(pool, (1, 2, 2), dict(TINY, seq_len=32, batch=4),
                     steps=5)
        for losses, _, shapes, specs in got:
            assert all(np.isfinite(losses)) and losses[-1] < losses[0]
            # the column-parallel qkv keeps its pieces across steps
            assert specs["block_0.qkv.weight"] == ("model", None)
            assert shapes["block_0.qkv.weight"] == (3 * 32 // 2, 32)

    def test_pure_data_parallel_fallback(self, pool):
        """seq_axis=None: data and tensor parallelism, no ring."""
        got, want = run(pool, (1, 1, 2), dict(TINY, seq_len=32, batch=4,
                                              seq_axis=None))
        for losses, *_ in got:
            assert np.isfinite(losses[0])
            assert np.isclose(losses[0], want, rtol=LOSS_RTOL)


class TestExpertParallelLM:
    def test_ep_training_shards_experts_and_reduces_loss(self, pool):
        got, _ = run(pool, (2, 1, 2), dict(
            TINY, seq_len=32, batch=4, seq_axis=None, n_experts=4), steps=5)
        for losses, _, shapes, specs in got:
            assert all(np.isfinite(losses)) and losses[-1] < losses[0]
            # the stacks are genuinely expert x model split: [E/e, D, F/m]
            assert specs["block_0.moe.experts_up"] == ("expert", None,
                                                       "model")
            assert shapes["block_0.moe.experts_up"] == (2, 32, 32)
            assert shapes["block_0.moe.experts_down"] == (2, 32, 32)

    def test_moe_on_legacy_mesh_without_expert_axis(self, pool):
        """A mesh with no ``expert`` axis replicates the expert stacks."""
        got, _ = run(pool, ("legacy", 2, 2, 2), dict(
            TINY, seq_len=32, batch=4, seq_axis=None, n_experts=4))
        for losses, _, shapes, specs in got:
            assert specs["block_0.moe.experts_up"] == (None, None, "model")
            assert shapes["block_0.moe.experts_up"] == (4, 32, 32)
            assert np.isfinite(losses[0])

    def test_ep_sp_tp_combined_matches_local_oracle(self, pool):
        """data 1 x expert 2 x seq 2 x model 2: routing on the whole
        sequence under the zig-zag layout, the all-to-alls, the row
        parallel down projection; the loss against the local oracle."""
        got, want = run(pool, (2, 2, 2), dict(TINY, seq_len=32, batch=4,
                                              n_experts=4))
        for losses, _, shapes, _ in got:
            assert np.isclose(losses[0], want, rtol=LOSS_RTOL), (losses,
                                                                 want)
            assert shapes["block_0.moe.experts_up"] == (2, 32, 32)


def test_make_lm_mesh_errors():
    from tpu_k8s_device_plugin_torch.workloads import transformer as ttr

    with pytest.raises(ValueError, match="not divisible by"):
        ttr.make_lm_mesh(range(6), seq=2, model=2, device="cpu")
    with pytest.raises(RuntimeError, match="torch.distributed"):
        ttr.make_lm_mesh(seq=1, model=1, device="cpu")


def test_tp_shardings_cover_llama_params(pool):
    """Every leaf of the Llama tree and of its int8 form gets the
    reference's spec, in the port's layout: a Dense ``weight [out, in]``
    takes the reference kernel's spec reversed, every other leaf (int8
    kernels keep ``[in, out]``) the reference's own."""
    model = jllama.train_model(jllama.TINY_LLAMA, dtype=jnp.float32)
    rng = jax.random.PRNGKey(0)
    tokens = jax.random.randint(rng, (2, 16), 0, jllama.TINY_LLAMA.vocab)
    params = model.init(rng, tokens)["params"]
    qparams = jinf.quantize_lm_params(params)
    specs, qspecs = pool.run("lm_specs", _np(params), _np(qparams))[0]
    assert specs["block_0.mlp_gate.weight"] == ("model", None)
    assert qspecs["block_0.mlp_gate.scale"] == ("model",)
    assert qspecs["block_0.mlp_gate.kernel_int8"] == (None, "model")
    mesh = jtr.make_lm_mesh(seq=1, model=2, expert=1)
    for tree, got in ((params, specs), (qparams, qspecs)):
        ref = jax.tree_util.tree_leaves_with_path(
            jtr.lm_tree_shardings(mesh, tree))
        assert len(ref) == len(got)
        for path, sh in ref:
            keys = [str(p.key) for p in path]
            spec = tuple(sh.spec) + (None,) * (
                np.ndim(_leaf(tree, keys)) - len(sh.spec))
            if keys[-1] == "kernel":
                keys[-1], spec = "weight", spec[::-1]
            elif keys[-1] == "embedding":
                keys[-1] = "weight"
            name = ".".join(keys)
            assert tuple(got[name]) + (None,) * (
                len(spec) - len(got[name])) == spec, name


def _leaf(tree, keys):
    for k in keys:
        tree = tree[k]
    return tree


def test_gqa_ring_attention_matches_local_oracle(pool):
    """GQA K/V rotate the ring grouped, heads split on ``model`` (8 query
    and 2 KV heads over 2): the ring's loss on (seq 4, model 2), both
    layouts, against the port's own local step on the same mesh."""
    base = dict(GQA, batch=2, seq_len=32)
    local, _ = run(pool, (1, 4, 2), dict(base, seq_axis=None))
    for layout in ("contiguous", "zigzag"):
        ring, _ = run(pool, (1, 4, 2), dict(base, attn_layout=layout))
        np.testing.assert_allclose(ring[0][0][0], local[0][0][0],
                                   rtol=RING_RTOL, err_msg=layout)


def test_gqa_updates_match_reference_sharded_step(pool, monkeypatch):
    """One step on (data 1, expert 1, seq 2, model 2) with GQA 4:2 (heads
    split, so the fused qkv regroups by all-to-all), zig-zag, in f32
    compute on both sides: every gathered parameter's update against the
    reference's sharded step's, and the loss."""
    cfg = dict(vocab=64, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2,
               d_ff=64, ffn="swiglu")
    monkeypatch.setattr(jtr, "TransformerLM", functools.partial(
        jtr.TransformerLM, dtype=jnp.float32))
    mesh = jtr.make_lm_mesh(jax.devices()[:4], seq=2, model=2)
    step, state, place = jtr.make_lm_train_step(mesh, seq_len=32, batch=4,
                                                **cfg)
    init = jax.device_get(state["params"])
    batch = tuple(np.asarray(b) for b in state["batch"])
    params, _, loss = step(state["params"], state["opt_state"],
                           *place(*state["batch"]))
    before, after = _np(init), _np(jax.device_get(params))
    got = pool.run("lm_steps", (1, 2, 2), dict(cfg, seq_len=32, batch=4),
                   before, batch, 1, "float32", range(4), tuple(before))
    losses, updated, shapes, _ = got[0]
    assert all(r is None for r in got[4:])
    np.testing.assert_allclose(losses[0], float(loss), rtol=1e-5)
    assert shapes["block_0.qkv.weight"] == ((4 + 2 * 2) * 8 // 2, 32)
    for name, want in after.items():
        rel = np.linalg.norm(updated[name] - want) / np.linalg.norm(
            want - before[name])
        assert rel <= UPDATE_REL, (name, rel)


@pytest.fixture
def ckpt_dir(tmp_path):
    base = tmp_path / "ckpt"
    yield str(base)
    shutil.rmtree(base, ignore_errors=True)


def _check_restored(results, whole, model_parallel):
    gate, out = (whole[f"block_0.{n}.weight"] for n in ("mlp_gate",
                                                         "out_proj"))
    rows, cols = gate.shape[0] // model_parallel, out.shape[1] // \
        model_parallel
    for pieces, m, loss in results:
        assert np.isfinite(loss)
        np.testing.assert_array_equal(pieces["block_0.mlp_gate.weight"],
                                      gate[m * rows:(m + 1) * rows])
        np.testing.assert_array_equal(pieces["block_0.out_proj.weight"],
                                      out[:, m * cols:(m + 1) * cols])
        np.testing.assert_array_equal(pieces["embed.weight"],
                                      whole["embed.weight"])
    assert sorted({r[1] for r in results}) == list(range(model_parallel))


def _llama_checkpoint_case():
    kw = dict(LLAMA, seq_axis=None, batch=4, seq_len=16)
    cfg = {k: v for k, v in kw.items()
           if k not in ("seq_axis", "batch", "seq_len")}
    params, batch, _, _ = reference_init(4, 16, **cfg)
    return kw, params, batch


def test_sharded_restore_onto_mesh(pool, ckpt_dir):
    """The whole LM tree saved, restored with ``lm_tree_shardings`` onto a
    model=2 mesh: each rank holds its pieces, values exact."""
    kw, params, batch = _llama_checkpoint_case()
    results = pool.run("lm_restore", params, ckpt_dir, False, 2, kw, batch)
    _check_restored(results, params, 2)


def test_restore_onto_different_mesh_shape(pool, ckpt_dir):
    """Saved as the pieces of a model=2 mesh, restored onto model=4:
    values exact, and the restored tree trains a step there."""
    kw, params, batch = _llama_checkpoint_case()
    results = pool.run("lm_restore", params, ckpt_dir, True, 4, kw, batch)
    _check_restored(results, params, 4)


def test_sharding_joint_axes_and_fit(pool):
    results = pool.run("sharding_cases")
    x = np.arange(48.0).reshape(8, 6)
    for local, (d, e, s), whole, fits in results:
        assert whole
        block = d * 2 + e
        np.testing.assert_array_equal(
            local, x[block * 2:(block + 1) * 2, s * 3:(s + 1) * 3])
        assert fits == [(("data", "expert"), "seq"), (None, "seq"),
                        (None, "model"), (None, None)]
