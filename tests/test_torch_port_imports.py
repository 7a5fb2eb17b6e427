"""The port stands alone: no module of ``tpu_k8s_device_plugin_torch``,
and not ``chip_smoke.py``, imports JAX, flax, optax or the JAX package,
nor names a module of the JAX package in a string (a ``-m`` spawn line,
an ``import_module`` argument); and its entry points refuse to fall
back to the CPU by themselves."""

import ast
import re
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax",
             "tpu_k8s_device_plugin")


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


# a dotted name in the JAX package: "tpu_k8s_device_plugin." not
# followed by "_torch" (the port's own package)
REFERENCE_MODULE = re.compile(r"\btpu_k8s_device_plugin\.(?!_torch)")


def _reference_strings(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and REFERENCE_MODULE.search(node.value):
            yield node.lineno, node.value


def test_port_files_exist():
    names = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    assert "chip_smoke.py" in names
    assert "tpu_k8s_device_plugin_torch/workloads/inference.py" in names
    assert "tpu_k8s_device_plugin_torch/workloads/serving.py" in names
    assert "tpu_k8s_device_plugin_torch/workloads/moe.py" in names
    assert "tpu_k8s_device_plugin_torch/workloads/speculative.py" in names
    assert "tpu_k8s_device_plugin_torch/workloads/checkpoint.py" in names
    assert "tpu_k8s_device_plugin_torch/types/constants.py" in names
    assert "tpu_k8s_device_plugin_torch/dryrun.py" in names
    assert "tpu_k8s_device_plugin_torch/workloads/tp_driver.py" in names
    for module in ("parallel", "ring_attention", "collectives", "pipeline"):
        assert f"tpu_k8s_device_plugin_torch/workloads/{module}.py" in names
    for agent in AGENT_MODULES:
        assert agent in names, agent
    assert all(p.exists() for p in _port_files())


# the node agents of the device-plugin slice, one file per reference
# module they port
AGENT_MODULES = [
    f"tpu_k8s_device_plugin_torch/{m}.py" for m in (
        "types/api", "proto/deviceplugin_pb2", "proto/deviceplugin_pb2_grpc",
        "proto/tpuhealth_pb2", "proto/tpuhealth_pb2_grpc",
        "proto/slice_pb2", "proto/slice_pb2_grpc",
        "hostinfo/gpuprobe", "gpu/sysfs", "gpu/nvml", "gpu/topology",
        "gpu/discovery", "gpu/device_impl", "gpu/vfio",
        "gpu/device_impl_vfio", "slice/state", "slice/metrics",
        "slice/server", "slice/client", "allocator/allocator",
        "allocator/besteffort", "allocator/device", "plugin/plugin",
        "manager/manager", "health/server", "health/client",
        "health/metrics", "labeller/generators", "labeller/controller",
        "labeller/k8s_client", "cmd/device_plugin", "cmd/node_labeller",
        "cmd/metrics_exporter", "observability")]
AGENT_DIRS = ("gpu", "allocator", "plugin", "manager", "health", "hostinfo",
              "labeller", "cmd", "slice")


def _agent_files():
    pkg = ROOT / "tpu_k8s_device_plugin_torch"
    return sorted(p for d in AGENT_DIRS for p in (pkg / d).rglob("*.py"))


@pytest.mark.parametrize(
    "path", _agent_files(), ids=lambda p: p.relative_to(ROOT).as_posix())
def test_agents_never_import_torch(path):
    """The node agents run on every node: a CUDA context there would take
    device memory from workloads, so no agent module imports torch."""
    bad = [name for name in _imports(path) if name.split(".")[0] == "torch"]
    assert not bad, f"{path.name} imports {bad}"


def test_importing_every_agent_leaves_torch_unloaded():
    """Not even through the port's shared modules (obs, resilience)."""
    import subprocess
    import sys

    modules = [m[len("tpu_k8s_device_plugin_torch/"):-3].replace("/", ".")
               for m in AGENT_MODULES]
    code = ("import sys\n"
            + "".join(f"import tpu_k8s_device_plugin_torch.{m}\n"
                      for m in modules)
            + "print(sorted(m for m in sys.modules if m == 'torch' "
              "or m.startswith('torch.') or m == 'jax'))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize(
    "path", _port_files(), ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_reference_imports(path):
    bad = [name for name in _imports(path)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize(
    "path", _port_files(), ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_reference_module_in_strings(path):
    bad = list(_reference_strings(path))
    assert not bad, f"{path.name} names reference modules: {bad}"


def test_reference_module_strings_are_caught(tmp_path):
    """The string rule sees what the import rule cannot: a spawn line
    naming the reference's server, in any string constant."""
    probe = tmp_path / "probe.py"
    probe.write_text(
        'CMD = ["python", "-m", "tpu_k8s_device_plugin.workloads.server"]\n'
        'OK = "tpu_k8s_device_plugin_torch.workloads.server"\n'
        'def f():\n'
        '    """Spawns tpu_k8s_device_plugin.workloads.router."""\n')
    assert [line for line, _ in _reference_strings(probe)] == [1, 4]
    assert list(_imports(probe)) == []


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


def test_multi_device_entry_points_refuse_cpu_fallback(monkeypatch):
    """The mesh is CUDA's unless the caller asks for the CPU; the flash
    block forms take the plain versions only for CPU tensors."""
    from tpu_k8s_device_plugin_torch.workloads import bench_main, parallel
    from tpu_k8s_device_plugin_torch.workloads import flash_attention as fa

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        parallel.make_mesh(ranks=[0])
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_main.run_sharded(2, 1, 0)
    q = torch.zeros(1, 8, 2, 16)
    o, lse = fa.flash_block_forward(q, q, q)
    assert o.device.type == "cpu" and lse.shape == (1, 8, 2)
    meta = q.to("meta")
    with pytest.raises(ValueError, match="no path"):
        fa.flash_block_forward(meta, meta, meta)


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


def test_http_tier_imports_nothing_of_jax():
    """In a fresh interpreter, the HTTP and fleet tiers of the port (the
    server, the session tier, the load client, ``obs``, ``resilience``,
    the router, replay, the fleet reconciler, the trace generator and
    the slice-membership reader), the model's expert FFN and
    speculative decoding, checkpointing and its constants, and the
    elastic AlexNet loop load neither JAX, orbax nor the JAX
    package."""
    import subprocess
    import sys

    code = ("import sys\n"
            "import tpu_k8s_device_plugin_torch.workloads.server\n"
            "import tpu_k8s_device_plugin_torch.workloads.kv_tier\n"
            "import tpu_k8s_device_plugin_torch.workloads.loadclient\n"
            "import tpu_k8s_device_plugin_torch.workloads.qos\n"
            "import tpu_k8s_device_plugin_torch.obs\n"
            "import tpu_k8s_device_plugin_torch.resilience\n"
            "import tpu_k8s_device_plugin_torch.workloads.router\n"
            "import tpu_k8s_device_plugin_torch.workloads.replay\n"
            "import tpu_k8s_device_plugin_torch.workloads.fleet\n"
            "import tpu_k8s_device_plugin_torch.workloads.trafficgen\n"
            "import tpu_k8s_device_plugin_torch.slice\n"
            "import tpu_k8s_device_plugin_torch.workloads.moe\n"
            "import tpu_k8s_device_plugin_torch.workloads.speculative\n"
            "import tpu_k8s_device_plugin_torch.workloads.checkpoint\n"
            "import tpu_k8s_device_plugin_torch.workloads.bench_main\n"
            "import tpu_k8s_device_plugin_torch.workloads.parallel\n"
            "import tpu_k8s_device_plugin_torch.workloads.ring_attention\n"
            "import tpu_k8s_device_plugin_torch.types.constants\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in\n"
            "       ('jax', 'jaxlib', 'flax', 'optax', 'orbax',\n"
            "        'tpu_k8s_device_plugin')]\n"
            "print(' '.join(sorted(bad)) or 'clean')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True, cwd=ROOT
                         ).stdout.strip()
    assert out == "clean"


def test_http_tier_files_exist():
    for rel in ("workloads/server.py", "workloads/kv_tier.py",
                "workloads/qos.py", "workloads/loadclient.py",
                "resilience/policy.py", "obs/trace.py", "obs/span.py",
                "obs/recorder.py", "obs/stitch.py", "obs/slo.py",
                "obs/tsdb.py", "obs/alerts.py", "obs/profiler.py",
                "obs/incident.py", "workloads/trafficgen.py",
                "workloads/router.py", "workloads/replay.py",
                "workloads/fleet.py", "slice/state.py"):
        assert (ROOT / "tpu_k8s_device_plugin_torch" / rel).is_file(), rel
