"""The port stands alone: no module of ``tpu_k8s_device_plugin_torch``,
and not ``chip_smoke.py``, imports JAX, flax, optax or the JAX package;
and its entry points refuse to fall back to the CPU by themselves."""

import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "tpu_k8s_device_plugin")


def _port_files():
    files = sorted((ROOT / "tpu_k8s_device_plugin_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_port_files_exist():
    names = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    assert "chip_smoke.py" in names
    assert "tpu_k8s_device_plugin_torch/workloads/inference.py" in names
    assert "tpu_k8s_device_plugin_torch/workloads/serving.py" in names
    assert all(p.exists() for p in _port_files())


@pytest.mark.parametrize(
    "path", _port_files(), ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_reference_imports(path):
    bad = [name for name in _imports(path)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_make_decoder_refuses_cpu_fallback(monkeypatch):
    from tpu_k8s_device_plugin_torch.workloads import inference

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        inference.make_decoder(vocab=64)
    assert inference.make_decoder(vocab=64, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("entry", ["TransformerLM", "Block", "train_model"])
def test_training_entry_points_refuse_cpu_fallback(monkeypatch, entry):
    from tpu_k8s_device_plugin_torch.workloads import llama, transformer

    build = {
        "TransformerLM": lambda **kw: transformer.TransformerLM(
            vocab=64, d_model=32, **kw),
        "Block": lambda **kw: transformer.Block(32, 4, 64, **kw),
        "train_model": lambda **kw: llama.train_model(llama.TINY_LLAMA,
                                                      **kw),
    }[entry]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build()
    model = build(device="cpu")
    assert {p.device.type for p in model.parameters()} == {"cpu"}


def test_serving_engine_refuses_cpu_fallback(monkeypatch):
    """Without CUDA, an engine over a CPU model runs only where the
    caller asks for the CPU; a device that is not the model's raises."""
    from tpu_k8s_device_plugin_torch.workloads import inference, serving

    model = inference.make_decoder(vocab=64, d_model=32, max_len=16,
                                   device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serving.ServingEngine(model, n_slots=1)
    with pytest.raises(ValueError, match="lives on"):
        serving.ServingEngine(model, n_slots=1, device="meta")
    eng = serving.ServingEngine(model, n_slots=1, device="cpu")
    assert eng.cache["block_0"]["cached_k"].device.type == "cpu"
    assert not eng._use_graphs
