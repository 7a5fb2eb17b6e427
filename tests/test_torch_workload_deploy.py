"""The port's workloads deployment: the GPU pod examples, the GPU
native-serve example, the workloads image, and the GPU chart's
PodMonitor.  Every file parses (the chart's templates through a small
renderer of the Go-template subset they use), every container that runs
on a GPU asks for ``nvidia.com/gpu``, every command line parses under the
port's own CLI, every env name is the pod's downward API or a port
constant, the Dockerfile copies what exists, the PodMonitor scrapes
ports the DaemonSet declares on the flags the port's CLIs take, and every
metric family the shipped dashboard queries is one the port registers,
so a rename in the code cannot leave them stale."""

import argparse
import ast
import json
import os
import re
import shlex
from pathlib import Path

import pytest
import yaml

from tpu_k8s_device_plugin_torch.cmd import device_plugin, metrics_exporter
from tpu_k8s_device_plugin_torch.types import constants
from tpu_k8s_device_plugin_torch.workloads import (
    bench_main,
    bench_serving,
    router,
    server,
)

ROOT = Path(__file__).resolve().parent.parent
GPU = f"{constants.RESOURCE_NAMESPACE}/{constants.DEVICE_TYPE_GPU}"
EXAMPLES = sorted(
    str(p.relative_to(ROOT))
    for d in ("example/pod-gpu", "example/native-serve-gpu")
    for p in (ROOT / d).glob("*.yaml"))
CLIS = {
    "tpu_k8s_device_plugin_torch.workloads.bench_main": bench_main.main,
    "tpu_k8s_device_plugin_torch.workloads.bench_serving":
        bench_serving.main,
    "tpu_k8s_device_plugin_torch.workloads.server": server.main,
    "tpu_k8s_device_plugin_torch.workloads.router": router.main,
}
# the pod's own identity from the downward API, which the replicas
# advertise to the router
DOWNWARD = {"POD_IP", "POD_NAME"}


def _docs(rel):
    with open(ROOT / rel) as f:
        return [d for d in yaml.safe_load_all(f) if d]


def _pod_specs(rel):
    for doc in _docs(rel):
        if doc["kind"] == "Pod":
            yield doc["spec"]
        elif doc["kind"] == "Deployment":
            yield doc["spec"]["template"]["spec"]


def _containers():
    return [(rel, c) for rel in EXAMPLES for spec in _pod_specs(rel)
            for c in spec["containers"]]


def _argv(c):
    """The container's command line as argv, with ``$(VAR)`` references
    to its env filled with a placeholder."""
    cmd = list(c["command"]) + list(c.get("args", []))
    if cmd[:2] == ["/bin/sh", "-c"]:
        cmd = shlex.split(re.sub(r"\$\((\w+)\)", r"\1", cmd[2]))
    return cmd


def _module_args(argv):
    """(module, its argv) of a ``python -m`` or ``torchrun ... -m`` line."""
    i = argv.index("-m")
    assert argv[0] in ("python", "torchrun"), argv
    return argv[i + 1], argv[i + 2:]


class _Parsed(Exception):
    pass


def _parse_only(monkeypatch):
    """Make every ArgumentParser stop right after a successful parse
    (an unknown or malformed flag still exits 2)."""
    real = argparse.ArgumentParser.parse_args

    def parse(self, args=None, namespace=None):
        raise _Parsed(real(self, args, namespace))

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse)


def test_examples_exist():
    names = {Path(p).name for p in EXAMPLES}
    assert {"alexnet-torch-gpu.yaml", "alexnet-torch-gpu-4.yaml",
            "alexnet-torch-cpu.yaml", "llama-serve-native.yaml",
            "deployment.yaml", "router.yaml", "service.yaml"} <= names
    assert (ROOT / "example" / "native-serve-gpu" / "README.md").exists()


@pytest.mark.parametrize("rel", EXAMPLES)
def test_examples_parse_with_kinds(rel):
    kinds = [d["kind"] for d in _docs(rel)]
    assert kinds and set(kinds) <= {"Pod", "Deployment", "Service"}


@pytest.mark.parametrize("rel,name", [(r, c["name"])
                                      for r, c in _containers()])
def test_container_runs_a_port_cli_that_parses(monkeypatch, rel, name):
    [c] = [c for r, c in _containers() if r == rel and c["name"] == name]
    module, args = _module_args(_argv(c))
    _parse_only(monkeypatch)
    with pytest.raises(_Parsed) as parsed:
        CLIS[module](args)
    ns = parsed.value.args[0]
    limits = c.get("resources", {}).get("limits", {})
    if module.endswith(".router") or getattr(ns, "device", None) == "cpu":
        # the router needs no GPU, and the CPU control pod asks for none
        assert GPU not in limits
    else:
        assert getattr(ns, "device", None) is None  # CUDA: no fallback
        want = 4 if getattr(ns, "sharded", False) else 1
        assert limits[GPU] == want
        if want > 1:
            assert _argv(c)[:3] == ["torchrun", "--nproc-per-node",
                                    str(want)]


def _constants():
    return {v for k, v in vars(constants).items()
            if k.startswith("ENV_") and isinstance(v, str)}


@pytest.mark.parametrize("rel", EXAMPLES)
def test_env_names_are_downward_api_or_port_constants(rel):
    for spec in _pod_specs(rel):
        for c in spec["containers"]:
            env = {e["name"]: e for e in c.get("env", [])}
            for name, e in env.items():
                if "valueFrom" in e:
                    assert name in DOWNWARD and "fieldRef" in e["valueFrom"]
                else:
                    assert name in _constants(), name
            line = " ".join(c["command"] + c.get("args", []))
            assert set(re.findall(r"\$\((\w+)\)", line)) <= set(env)


def test_replicas_register_with_the_router_service():
    docs = _docs("example/native-serve-gpu/router.yaml")
    [svc] = [d for d in docs if d["kind"] == "Service"]
    [port] = svc["spec"]["ports"]
    rep = [d for d in docs if d["kind"] == "Deployment"
           and d["metadata"]["name"].endswith("-replica")][0]
    [c] = rep["spec"]["template"]["spec"]["containers"]
    argv = _argv(c)
    assert (f"--register-with=http://{svc['metadata']['name']}:"
            f"{port['port']}") in argv
    rt = [d for d in docs if d["kind"] == "Deployment"
          and d["metadata"]["name"] == svc["metadata"]["name"]][0]
    assert svc["spec"]["selector"] == \
        rt["spec"]["template"]["metadata"]["labels"]
    [rc] = rt["spec"]["template"]["spec"]["containers"]
    assert f"--port={port['targetPort']}" in _argv(rc)


def test_dockerfile_copies_what_exists_and_carries_nvcc():
    text = (ROOT / "gpu-workloads.Dockerfile").read_text()
    copies = re.findall(r"^COPY\s+(\S+)\s+\S+", text, re.M)
    assert copies
    for src in copies:
        assert (ROOT / src).exists(), src
    [base] = re.findall(r"^FROM\s+(\S+)", text, re.M)
    assert base.startswith("nvidia/cuda:") and "devel" in base
    assert "torch" in text
    assert "rm -rf tpu_k8s_device_plugin_torch/_build" in text
    for module in re.findall(r"tpu_k8s_device_plugin_torch\.[\w.]+", text):
        assert module in CLIS


# -- the chart ---------------------------------------------------------------

_ACTION = re.compile(r"{{(-?)\s*(.*?)\s*(-?)}}", re.S)


def _lookup(path, values, dot):
    if path == ".":
        return dot
    if path == ".Release.Name":
        return "rel"
    assert path.startswith(".Values."), path
    v = values
    for part in path[len(".Values."):].split("."):
        v = v[part]
    return v


def _term(t, values, dot):
    m = re.fullmatch(r"gt \(int (\S+)\) (\d+)", t)
    if m:
        return int(_lookup(m.group(1), values, dot)) > int(m.group(2))
    m = re.fullmatch(r"toYaml (\S+)", t)
    if m:
        return yaml.safe_dump(_lookup(m.group(1), values, dot),
                              default_flow_style=False).rstrip()
    return _lookup(t, values, dot)


def _eval(expr, values, dot):
    stages = [s.strip() for s in expr.split("|")]
    v = _term(stages[0], values, dot)
    for stage in stages[1:]:
        name, *args = stage.split()
        if name == "quote":
            v = json.dumps(str(v))
        elif name == "nindent":
            pad = " " * int(args[0])
            v = "\n" + "\n".join(pad + line for line in str(v).split("\n"))
        else:
            raise AssertionError(f"unsupported template function {name}")
    return v


def render(text, values):
    """The Go-template subset the GPU chart uses: comments, trim markers,
    ``if`` / ``with`` / ``end``, value paths, ``gt (int X) N``,
    ``toYaml``, ``quote`` and ``nindent``."""
    text = re.sub(r"{{-?\s*/\*.*?\*/\s*-?}}", "", text, flags=re.S)
    parts, pos = [], 0
    for m in _ACTION.finditer(text):
        parts += [text[pos:m.start()], m]
        pos = m.end()
    parts.append(text[pos:])
    for i, p in enumerate(parts):
        if isinstance(p, str):
            continue
        if p.group(1):
            parts[i - 1] = parts[i - 1].rstrip()
        if p.group(3):
            parts[i + 1] = parts[i + 1].lstrip()

    def walk(i, dot, out):
        while i < len(parts):
            p = parts[i]
            if isinstance(p, str):
                out.append(p)
                i += 1
                continue
            word = p.group(2).split(" ", 1)
            if word[0] == "end":
                return i + 1
            if word[0] in ("if", "with"):
                v = _eval(word[1], values, dot)
                body = []
                i = walk(i + 1, v if word[0] == "with" else dot, body)
                if v:
                    out.extend(body)
                continue
            out.append(str(_eval(p.group(2), values, dot)))
            i += 1
        return i

    out = []
    walk(0, None, out)
    return "".join(out)


def _chart(template, **metrics):
    values = yaml.safe_load((ROOT / "helm/gpu/values.yaml").read_text())
    values["metrics"].update(metrics)
    text = (ROOT / "helm/gpu/templates" / template).read_text()
    return [d for d in yaml.safe_load_all(render(text, values)) if d], values


@pytest.mark.parametrize("template", ["daemonset.yaml", "podmonitor.yaml",
                                      "rbac.yaml"])
def test_chart_templates_render_and_parse(template):
    docs, _ = _chart(template, debugPort=9401,
                     podMonitor={"enabled": True, "labels": {"release": "p"},
                                 "interval": "30s"})
    assert docs and all(d["kind"] for d in docs)


def test_podmonitor_is_off_by_default():
    docs, values = _chart("podmonitor.yaml")
    assert values["metrics"]["podMonitor"]["enabled"] is False
    assert docs == []


def _ports(ds):
    out = {}
    for c in ds["spec"]["template"]["spec"]["containers"]:
        for port in c.get("ports", []):
            out[port["name"]] = (c, port["containerPort"])
    return out


@pytest.mark.parametrize("debug_port", [0, 9401])
def test_podmonitor_scrapes_declared_ports_on_the_clis_flags(debug_port):
    on = {"enabled": True, "labels": {}, "interval": "30s"}
    [ds], values = _chart("daemonset.yaml", debugPort=debug_port,
                          podMonitor=on)
    [pm], _ = _chart("podmonitor.yaml", debugPort=debug_port, podMonitor=on)
    assert pm["kind"] == "PodMonitor"
    assert pm["spec"]["selector"]["matchLabels"] == \
        ds["spec"]["template"]["metadata"]["labels"]
    names = [e["port"] for e in pm["spec"]["podMetricsEndpoints"]]
    assert names == (["dp-metrics"] if debug_port else []) + ["exp-metrics"]
    ports = _ports(ds)
    flags = {"dp-metrics": ("--debug-port", device_plugin.build_parser),
             "exp-metrics": ("--metrics-port",
                             metrics_exporter.build_parser)}
    for name in names:
        c, number = ports[name]
        flag, build = flags[name]
        assert f"{flag}={number}" in c["args"]
        ns = build().parse_args(c["args"])
        assert getattr(ns, flag[2:].replace("-", "_")) == number
    assert ports["exp-metrics"][1] == values["exporter"]["metricsPort"] \
        == constants.METRICS_HTTP_PORT
    if debug_port:
        # the debug endpoint binds where the scrape can reach it
        assert "--debug-host=0.0.0.0" in ports["dp-metrics"][0]["args"]
    else:
        assert "dp-metrics" not in ports


# -- the dashboard -------------------------------------------------------------

def _registered():
    """Every metric family name the port's modules spell out."""
    names = set()
    for path in (ROOT / "tpu_k8s_device_plugin_torch").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Constant) and isinstance(
                    node.value, str) and re.fullmatch(r"tpu_[a-z0-9_]+",
                                                      node.value):
                names.add(node.value)
    return names


def test_dashboard_queries_only_families_the_port_registers():
    """The families that named TPU chips name GPUs in the port
    (``tpu_exporter_unhealthy_chips`` is ``..._gpus``); every other one
    keeps its name."""
    board = json.loads((ROOT / "docs/dashboards/tpu-observability.json")
                       .read_text())
    exprs = []

    def walk(o):
        if isinstance(o, dict):
            for k, v in o.items():
                (exprs.append(v) if k == "expr" else walk(v))
        elif isinstance(o, list):
            for v in o:
                walk(v)

    walk(board)
    queried = {re.sub(r"_(bucket|count|sum)$", "", n)
               for e in exprs for n in re.findall(r"\btpu_[a-z0-9_]+", e)}
    assert len(queried) > 40
    registered = _registered()
    missing = sorted(n for n in queried
                     if n.replace("_chips", "_gpus") not in registered)
    assert not missing, missing
