"""The port's protocol stubs held against the reference's: every message
of both protos, filled from a seed, serializes to the same bytes; full
names and method paths are equal; and the port's servicers answer the
reference's stubs (and the other way round) over a unix socket."""

import concurrent.futures
import random

import grpc
import pytest
from google.protobuf import descriptor as _descriptor

from tpu_k8s_device_plugin.proto import (
    deviceplugin_pb2 as ref_pb,
    deviceplugin_pb2_grpc as ref_grpc,
    tpuhealth_pb2 as ref_hpb,
    tpuhealth_pb2_grpc as ref_hgrpc,
)
from tpu_k8s_device_plugin_torch.proto import (
    deviceplugin_pb2 as pb,
    deviceplugin_pb2_grpc as pb_grpc,
    tpuhealth_pb2 as hpb,
    tpuhealth_pb2_grpc as hgrpc,
)

FD = _descriptor.FieldDescriptor


def _fill(msg, rng, depth=0):
    """Set every field of *msg* from *rng* (repeated fields get 1-3
    entries, maps 1-3 keys, nested messages recurse)."""
    for f in msg.DESCRIPTOR.fields:
        if f.message_type is not None and f.message_type.GetOptions().map_entry:
            for _ in range(rng.randint(1, 3)):
                getattr(msg, f.name)[f"k{rng.randint(0, 999)}"] = \
                    f"v{rng.randint(0, 999)}"
            continue
        repeated = f.is_repeated
        n = rng.randint(1, 3) if repeated else 1
        for _ in range(n):
            if f.type == FD.TYPE_MESSAGE:
                if depth > 3:
                    break
                sub = getattr(msg, f.name).add() if repeated \
                    else getattr(msg, f.name)
                _fill(sub, rng, depth + 1)
                continue
            if f.type == FD.TYPE_STRING:
                value = f"s{rng.randint(0, 10 ** 6)}"
            elif f.type == FD.TYPE_BOOL:
                value = bool(rng.randint(0, 1))
            elif f.type == FD.TYPE_ENUM:
                value = rng.choice(f.enum_type.values).number
            else:
                value = rng.randint(-2 ** 31, 2 ** 31 - 1) \
                    if f.type in (FD.TYPE_INT32, FD.TYPE_INT64) \
                    else rng.randint(0, 2 ** 31)
            if repeated:
                getattr(msg, f.name).append(value)
            else:
                setattr(msg, f.name, value)
    return msg


def _messages(module):
    return sorted(module.DESCRIPTOR.message_types_by_name)


@pytest.mark.parametrize("port, ref", [(pb, ref_pb), (hpb, ref_hpb)],
                         ids=["deviceplugin", "tpuhealth"])
def test_every_message_serializes_to_the_reference_bytes(port, ref):
    assert _messages(port) == _messages(ref)
    rng = random.Random(0)
    for name in _messages(port):
        for _ in range(5):
            seed = rng.randint(0, 10 ** 9)
            mine = _fill(getattr(port, name)(), random.Random(seed))
            theirs = _fill(getattr(ref, name)(), random.Random(seed))
            data = mine.SerializeToString(deterministic=True)
            assert data == theirs.SerializeToString(deterministic=True), name
            assert getattr(ref, name).FromString(data) == theirs


@pytest.mark.parametrize("port, ref", [(pb, ref_pb), (hpb, ref_hpb)],
                         ids=["deviceplugin", "tpuhealth"])
def test_full_names_and_methods_match(port, ref):
    mine, theirs = port.DESCRIPTOR, ref.DESCRIPTOR
    assert mine.package == theirs.package
    assert mine.serialized_pb == theirs.serialized_pb
    for name, msg in mine.message_types_by_name.items():
        assert msg.full_name == theirs.message_types_by_name[name].full_name
    services = {n: sorted(m.full_name for m in s.methods)
                for n, s in mine.services_by_name.items()}
    assert services == {n: sorted(m.full_name for m in s.methods)
                        for n, s in theirs.services_by_name.items()}


def test_method_paths_match_kubelet_abi():
    fd = pb.DESCRIPTOR
    assert fd.package == "v1beta1"
    assert sorted(m.name for m in fd.services_by_name["DevicePlugin"]
                  .methods) == ["Allocate", "GetDevicePluginOptions",
                                "GetPreferredAllocation", "ListAndWatch",
                                "PreStartContainer"]
    assert "Registration" in fd.services_by_name
    assert hpb.DESCRIPTOR.package == "tpuhealth"
    assert "TpuHealthService" in hpb.DESCRIPTOR.services_by_name


class _Recorder:
    """A channel stand-in recording the method paths stubs bind."""

    def __init__(self):
        self.paths = []

    def unary_unary(self, path, **_):
        self.paths.append(path)

    unary_stream = unary_unary


@pytest.mark.parametrize("stub", ["RegistrationStub", "DevicePluginStub"])
def test_stub_method_paths_equal_the_reference(stub):
    mine, theirs = _Recorder(), _Recorder()
    getattr(pb_grpc, stub)(mine)
    getattr(ref_grpc, stub)(theirs)
    assert mine.paths == theirs.paths
    assert "/v1beta1.DevicePlugin/Allocate" in mine.paths \
        or mine.paths == ["/v1beta1.Registration/Register"]


def test_health_stub_method_paths_equal_the_reference():
    mine, theirs = _Recorder(), _Recorder()
    hgrpc.TpuHealthServiceStub(mine)
    ref_hgrpc.TpuHealthServiceStub(theirs)
    assert mine.paths == theirs.paths == [
        "/tpuhealth.TpuHealthService/GetTpuState",
        "/tpuhealth.TpuHealthService/List"]


def test_device_message_roundtrip():
    d = pb.Device(ID="0000:13:00.0", health="Healthy",
                  topology=pb.TopologyInfo(nodes=[pb.NUMANode(ID=1)]))
    d2 = pb.Device.FromString(d.SerializeToString())
    assert d2.ID == "0000:13:00.0" and d2.topology.nodes[0].ID == 1


def test_allocate_response_roundtrip():
    resp = pb.AllocateResponse(container_responses=[
        pb.ContainerAllocateResponse(
            envs={"NVIDIA_VISIBLE_DEVICES": "GPU-1,GPU-2"},
            devices=[pb.DeviceSpec(container_path="/dev/nvidia0",
                                   host_path="/dev/nvidia0",
                                   permissions="rw")])])
    r2 = ref_pb.AllocateResponse.FromString(resp.SerializeToString())
    assert r2.container_responses[0].envs["NVIDIA_VISIBLE_DEVICES"] == \
        "GPU-1,GPU-2"
    assert r2.container_responses[0].devices[0].host_path == "/dev/nvidia0"


def test_health_state_roundtrip():
    s = hpb.TpuState(id="0000:13:00.0", accel_index=0, health="Unhealthy",
                     device="/dev/nvidia0")
    s2 = ref_hpb.TpuState.FromString(s.SerializeToString())
    assert s2.accel_index == 0 and s2.health == "Unhealthy"
    assert hpb.TpuHealth.Name(hpb.UNHEALTHY) == "UNHEALTHY"


class _EchoPlugin(pb_grpc.DevicePluginServicer):
    def GetDevicePluginOptions(self, request, context):
        return pb.DevicePluginOptions(get_preferred_allocation_available=True)

    def ListAndWatch(self, request, context):
        yield pb.ListAndWatchResponse(
            devices=[pb.Device(ID="gpu0", health="Healthy")])

    def Allocate(self, request, context):
        out = pb.AllocateResponse()
        for creq in request.container_requests:
            cres = out.container_responses.add()
            for did in creq.devices_ids:
                cres.devices.add(container_path=f"/dev/{did}",
                                 host_path=f"/dev/{did}", permissions="rw")
        return out


@pytest.fixture
def uds_server(tmp_path):
    sock = str(tmp_path / "plugin.sock")
    server = grpc.server(concurrent.futures.ThreadPoolExecutor(max_workers=4))
    pb_grpc.add_DevicePluginServicer_to_server(_EchoPlugin(), server)
    server.add_insecure_port(f"unix://{sock}")
    server.start()
    yield sock
    server.stop(0)


@pytest.mark.parametrize("stubs", [pb_grpc, ref_grpc],
                         ids=["port-stub", "reference-stub"])
def test_grpc_unary_and_stream_over_unix_socket(uds_server, stubs):
    with grpc.insecure_channel(f"unix://{uds_server}") as ch:
        stub = stubs.DevicePluginStub(ch)
        assert stub.GetDevicePluginOptions(
            pb.Empty()).get_preferred_allocation_available
        first = next(iter(stub.ListAndWatch(pb.Empty())))
        assert first.devices[0].ID == "gpu0"
        resp = stub.Allocate(pb.AllocateRequest(container_requests=[
            pb.ContainerAllocateRequest(devices_ids=["nvidia0", "nvidia1"])]))
        assert [d.host_path for d in resp.container_responses[0].devices] \
            == ["/dev/nvidia0", "/dev/nvidia1"]
