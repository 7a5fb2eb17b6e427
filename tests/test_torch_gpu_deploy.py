"""The GPU agents' deployment files: the DaemonSet, the Helm chart, the
agents' Dockerfile and the multi-host example parse, and every env name,
path, flag and resource they use is the port's own (its constants and
CLI flags), so a rename in the code cannot leave them stale."""

import os
import re

import pytest
import yaml

from tpu_k8s_device_plugin_torch.cmd import device_plugin, metrics_exporter
from tpu_k8s_device_plugin_torch.cmd import node_labeller
from tpu_k8s_device_plugin_torch.types import constants

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_all(*parts):
    with open(os.path.join(REPO, *parts)) as f:
        return [d for d in yaml.safe_load_all(f) if d]


def daemonset():
    [ds] = [d for d in load_all("k8s-ds-gpu-dp.yaml")
            if d["kind"] == "DaemonSet"]
    return ds["spec"]["template"]["spec"]


def containers():
    return {c["name"]: c for c in daemonset()["containers"]}


PARSERS = {
    "tpu_k8s_device_plugin_torch.cmd.device_plugin":
        device_plugin.build_parser,
    "tpu_k8s_device_plugin_torch.cmd.metrics_exporter":
        metrics_exporter.build_parser,
    "tpu_k8s_device_plugin_torch.cmd.node_labeller":
        node_labeller.build_parser,
}


def test_every_container_runs_a_port_cli_with_its_flags():
    cs = containers()
    assert set(cs) == {"gpu-dp-cntr", "gpu-metrics-exporter",
                       "gpu-node-labeller"}
    for c in cs.values():
        assert c["command"][:2] == ["python", "-m"]
        parser = PARSERS[c["command"][2]]()
        parser.parse_args(c.get("args", []))  # exits on an unknown flag


def test_mounts_are_the_constants_paths():
    spec = daemonset()
    assert spec["hostNetwork"] is True
    host = {v["name"]: v["hostPath"]["path"] for v in spec["volumes"]}
    dp = containers()["gpu-dp-cntr"]
    mounts = {m["name"]: m["mountPath"] for m in dp["volumeMounts"]}
    assert mounts["dp"].rstrip("/") == host["dp"] == \
        constants.DEVICE_PLUGIN_PATH.rstrip("/")
    assert mounts["slice-state"] == host["slice-state"] == \
        os.path.dirname(constants.SLICE_STATE_FILE)
    # Allocate hands the kubelet host paths: /dev is mounted at /dev
    assert mounts["dev"] == host["dev"] == "/dev"
    socket = [a for a in dp["args"] if a.startswith("--exporter-socket=")]
    assert socket == [f"--exporter-socket={constants.METRICS_EXPORTER_SOCKET}"]
    assert os.path.dirname(constants.METRICS_EXPORTER_SOCKET) == \
        mounts["exporter"] == host["exporter"]
    lbl = containers()["gpu-node-labeller"]
    assert f"--slice-state-file={constants.SLICE_STATE_FILE}" in lbl["args"]


def test_commented_slice_env_names_are_the_constants():
    text = open(os.path.join(REPO, "k8s-ds-gpu-dp.yaml")).read()
    named = set(re.findall(r"#\s+- name: (TPU_DP_\w+)", text))
    assert named == {constants.ENV_SLICE_RENDEZVOUS,
                     constants.ENV_SLICE_WORKERS,
                     constants.ENV_SLICE_RESHAPE_GRACE}
    assert f":{constants.SLICE_RENDEZVOUS_PORT}" in text


def test_helm_chart():
    [chart] = load_all("helm", "gpu", "Chart.yaml")
    assert chart["apiVersion"] == "v2" and chart["name"]
    [values] = load_all("helm", "gpu", "values.yaml")
    assert values["dp"]["resourceNamingStrategy"] in (
        constants.RESOURCE_NAMING_STRATEGY_SINGLE,
        constants.RESOURCE_NAMING_STRATEGY_MIXED)
    assert values["dp"]["driverType"] in ("", constants.CONTAINER,
                                          constants.VF_PASSTHROUGH,
                                          constants.PF_PASSTHROUGH)
    assert values["slice"]["stateDir"] == os.path.dirname(
        constants.SLICE_STATE_FILE)
    assert values["exporter"]["socketDir"] == os.path.dirname(
        constants.METRICS_EXPORTER_SOCKET)
    assert values["exporter"]["metricsPort"] == constants.METRICS_HTTP_PORT
    template = open(os.path.join(REPO, "helm", "gpu", "templates",
                                 "daemonset.yaml")).read()
    for name in (constants.ENV_SLICE_RENDEZVOUS, constants.ENV_SLICE_WORKERS,
                 constants.ENV_SLICE_RESHAPE_GRACE):
        assert f"- name: {name}" in template
    for module in PARSERS:
        assert module in template
    flags = set(re.findall(r'"(--[a-z-]+)=', template))
    known = set()
    for build in PARSERS.values():
        for action in build()._actions:
            known.update(action.option_strings)
    assert flags and flags <= known


def test_dockerfile_builds_the_agents_without_cuda():
    text = open(os.path.join(REPO, "gpu-agents.Dockerfile")).read()
    assert "COPY tpu_k8s_device_plugin_torch/" in text
    assert "g++" in text and "gpuprobe" in text
    assert "torch==" not in text and "cuda" not in text.lower().replace(
        "no cuda toolkit", "")


def test_example_job_runs_torchrun_from_the_slice_env_alone():
    docs = load_all("example", "multihost-gpu", "job.yaml")
    [job] = [d for d in docs if d["kind"] == "Job"]
    spec = job["spec"]["template"]["spec"]
    assert spec["hostNetwork"] is True
    [c] = spec["containers"]
    assert c["resources"]["limits"][
        f"{constants.RESOURCE_NAMESPACE}/{constants.DEVICE_TYPE_GPU}"] == 8
    assert "env" not in c  # everything comes from Allocate
    cmd = " ".join(c["args"])
    used = set(re.findall(r"\$(\w+)", cmd))
    assert used == {constants.ENV_PET_NNODES, constants.ENV_PET_NODE_RANK,
                    constants.ENV_MASTER_ADDR, constants.ENV_MASTER_PORT}
    slice_env = {k for v in constants.REFERENCE_SLICE_ENV.values()
                 for k in v}
    assert used <= slice_env
    affinity = spec["affinity"]["podAffinity"][
        "requiredDuringSchedulingIgnoredDuringExecution"][0]
    assert affinity["topologyKey"] == f"{constants.LABEL_PREFIX}.slice-id"
    [cm] = [d for d in docs if d["kind"] == "ConfigMap"]
    script = cm["data"]["allreduce.py"]
    compile(script, "allreduce.py", "exec")
    assert constants.ENV_TPU_SLICE_GENERATION in script


@pytest.mark.parametrize("path", ["k8s-ds-gpu-dp.yaml",
                                  "example/multihost-gpu/job.yaml"])
def test_manifests_parse_with_kinds(path):
    kinds = [d["kind"] for d in load_all(*path.split("/"))]
    assert kinds and all(k for k in kinds)
