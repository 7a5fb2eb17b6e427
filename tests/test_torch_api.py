"""The port's entry points take the JAX package's arguments, in its order
and with its defaults; a reference field the port does not implement yet
raises ``NotImplementedError`` naming its ROADMAP item, not
``TypeError``; generation returns the reference's int32 ids; and the
AlexNet workload imports nothing of the LM side.

All on the CPU; the JAX side runs with ``JAX_PLATFORMS=cpu``."""

import inspect
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_k8s_device_plugin.workloads import bench_serving as jbench
from tpu_k8s_device_plugin.workloads import server as jserver
from tpu_k8s_device_plugin.workloads import inference as jinf
from tpu_k8s_device_plugin.workloads import llama as jllama
from tpu_k8s_device_plugin.workloads.transformer import TransformerLM
from tpu_k8s_device_plugin_torch.convert import params_from_jax
from tpu_k8s_device_plugin_torch.workloads import bench_serving as tbench
from tpu_k8s_device_plugin_torch.workloads import inference as tinf
from tpu_k8s_device_plugin_torch.workloads import llama as tllama
from tpu_k8s_device_plugin_torch.workloads import server as tserver

GELU = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64)

# the reference fields that the flax dataclass adds itself
_FLAX_FIELDS = ("parent", "name")


def _params(fn):
    return [n for n in inspect.signature(fn).parameters
            if n not in ("self",) + _FLAX_FIELDS]


# (port callable, reference callable, parameters the port adds after the
# reference's)
SIGNATURES = {
    "llama.decoder": (tllama.decoder, jllama.decoder, ["device"]),
    "bench_serving.run": (tbench.run, jbench.run, ["seed", "device"]),
    "EngineServer": (tserver.EngineServer, jserver.EngineServer, []),
    "make_decoder": (tinf.make_decoder, jinf.make_decoder,
                     ["kv_quant", "device"]),
    "DecodeTransformerLM": (tinf.DecodeTransformerLM,
                            jinf.DecodeTransformerLM, ["device"]),
}


@pytest.mark.parametrize("name", sorted(SIGNATURES))
def test_leading_parameters_match_reference(name):
    """A caller that passes the reference's arguments by position binds
    them to the same parameters in the port."""
    port, ref, added = SIGNATURES[name]
    ours, theirs = _params(port), _params(ref)
    assert ours == theirs + added


def test_engine_server_defaults_match_reference():
    ours = inspect.signature(tserver.EngineServer).parameters
    theirs = inspect.signature(jserver.EngineServer).parameters
    assert {n: p.default for n, p in ours.items()} == \
        {n: p.default for n, p in theirs.items()}


def _option_strings(main_fn, monkeypatch):
    """Every option string of *main_fn*'s argparse parser, read off the
    parser it builds (parse_args is stopped before anything runs)."""
    import argparse

    seen = {}

    def grab(self, *a, **k):
        seen["opts"] = sorted(s for act in self._actions
                              for s in act.option_strings)
        raise SystemExit(0)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(SystemExit):
        main_fn([])
    return seen["opts"]


def test_server_cli_options_match_reference(monkeypatch):
    """``server.main`` takes the reference's options, plus ``--device``."""
    ours = _option_strings(tserver.main, monkeypatch)
    theirs = _option_strings(jserver.main, monkeypatch)
    assert ours == sorted(theirs + ["--device"])


@pytest.mark.parametrize("flags,item", [
    (["--tp", "2"], "item 6"), (["--checkpoint", "/nonexistent"], "item 7"),
    (["--quantized"], "item 1b"), (["--int4"], "item 1b"),
    (["--draft-config", "tiny-draft"], "item 1b"),
    (["--spec-ngram", "3"], "item 1b")])
def test_server_cli_unported_options_raise(flags, item):
    """Each option of a feature the port does not have raises naming its
    ROADMAP item before a model is built."""
    with pytest.raises(NotImplementedError, match=item):
        tserver.main(["--config", "tiny", "--device", "cpu", *flags])


def test_server_cli_refuses_cpu_fallback(monkeypatch):
    """Without ``--device``, the CLI wants CUDA and raises without it
    rather than serving on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tserver.main(["--config", "tiny", "--port", "0"])
    assert tserver.enable_compile_cache("/nonexistent") is False


@pytest.mark.parametrize("field", ["moe_k", "moe_capacity_factor",
                                   "lora_rank", "lora_scale", "kv_quant"])
@pytest.mark.parametrize("name", ["make_decoder", "DecodeTransformerLM"])
def test_reference_fields_take_reference_defaults(name, field):
    port, ref, _ = SIGNATURES[name]
    ours = inspect.signature(port).parameters
    if field not in inspect.signature(ref).parameters:
        # the reference's make_decoder stops at lora_scale; its
        # DecodeTransformerLM carries kv_quant
        ref = jinf.DecodeTransformerLM
    theirs = inspect.signature(ref).parameters
    assert ours[field].default == theirs[field].default


@pytest.mark.parametrize("build", ["make_decoder", "DecodeTransformerLM"])
def test_reference_fields_build_with_their_features_off(build):
    """moe_k and moe_capacity_factor take effect with experts, lora_rank
    and lora_scale with adapters: alone they are accepted, as the
    reference accepts them."""
    fn = SIGNATURES[build][0]
    model = fn(**GELU, moe_k=1, moe_capacity_factor=2.0, lora_rank=4,
               lora_scale=0.5, kv_quant=False, device="cpu")
    assert model.n_layers == GELU["n_layers"]


@pytest.mark.parametrize("kw,item", [
    (dict(n_experts=4, moe_k=1), "item 3"),
    (dict(n_experts=4, moe_capacity_factor=2.0), "item 3"),
    (dict(n_adapters=2, lora_rank=4), "item 1b"),
    (dict(n_adapters=2, lora_scale=0.5), "item 1b"),
    (dict(kv_quant=True), "item 4"),
])
@pytest.mark.parametrize("build", ["make_decoder", "DecodeTransformerLM"])
def test_reference_fields_raise_not_implemented(build, kw, item):
    """The fields of unported features raise naming their ROADMAP item;
    ``kv_quant`` (item 4, the paged engine) is ported now: alone it is
    accepted and recorded, as the reference's decoder takes it."""
    fn = SIGNATURES[build][0]
    if "kv_quant" in kw:
        assert fn(**GELU, device="cpu", **kw).kv_quant is True
        return
    with pytest.raises(NotImplementedError, match=item):
        fn(**GELU, device="cpu", **kw)


def test_quantized_by_position_raises():
    """The reference's positional calls name ``quantized`` in third
    (decoder) and second (run) place; the port raises for it there
    instead of taking it as a dtype or a batch."""
    with pytest.raises(NotImplementedError, match="quantized"):
        tllama.decoder(tllama.TINY_LLAMA, 32, True, torch.float32, "cpu")
    with pytest.raises(NotImplementedError, match="--quantized"):
        tbench.run("tiny", True, 1, 2, 4, 16, device="cpu")
    stats = tbench.run("tiny", False, 1, 2, 4, 16, device="cpu")
    assert stats["device"] == "cpu" and stats["tokens_per_sec"] > 0


@pytest.fixture(scope="module")
def pair():
    tokens = jnp.zeros((2, 8), jnp.int32)
    params = TransformerLM(**GELU).init(jax.random.PRNGKey(3),
                                        tokens)["params"]
    jdec = jinf.make_decoder(**GELU, max_len=32, dtype=jnp.float32)
    tdec = tinf.make_decoder(**GELU, max_len=32, dtype=torch.float32,
                             device="cpu")
    tdec.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return jdec, params, tdec


def test_greedy_ids_have_reference_dtype(pair):
    jdec, params, tdec = pair
    prompt = np.random.default_rng(3).integers(
        0, GELU["vocab"], (2, 6)).astype(np.int32)
    want, _ = jinf.greedy_generate(jdec, params, jnp.asarray(prompt), 8)
    got, _ = tinf.greedy_generate(tdec, prompt, 8)
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_sampled_ids_are_int32(pair):
    _, _, tdec = pair
    prompt = np.zeros((2, 4), np.int32)
    got = tinf.sample_generate(tdec, prompt, 4, 0, temperature=2.0,
                               top_k=8)
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, 4)


def test_alexnet_imports_nothing_of_the_lm():
    """In a fresh interpreter, importing the AlexNet workload loads
    neither the serving benchmark nor the decoder."""
    code = ("import sys\n"
            "import tpu_k8s_device_plugin_torch.workloads.alexnet\n"
            "mods = [m for m in sys.modules\n"
            "        if m.startswith('tpu_k8s_device_plugin_torch')]\n"
            "print(' '.join(sorted(mods)))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True,
                         cwd=Path(__file__).resolve().parents[1]
                         ).stdout.split()
    assert "tpu_k8s_device_plugin_torch.workloads.alexnet" in out
    for name in ("bench_serving", "inference", "llama", "flash_attention"):
        assert f"tpu_k8s_device_plugin_torch.workloads.{name}" not in out
