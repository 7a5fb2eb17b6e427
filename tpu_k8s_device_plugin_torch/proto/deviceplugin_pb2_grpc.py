"""gRPC stubs and servicers for the kubelet deviceplugin v1beta1 API.

The port's copy of the JAX package's hand-written module, in the style
of grpc_tools output.  Method paths must match the kubelet exactly:
/v1beta1.Registration/Register and /v1beta1.DevicePlugin/<RPC>.
"""

import grpc

from . import deviceplugin_pb2 as api


class RegistrationStub:
    """Client to the kubelet's Registration service."""

    def __init__(self, channel: grpc.Channel):
        self.Register = channel.unary_unary(
            "/v1beta1.Registration/Register",
            request_serializer=api.RegisterRequest.SerializeToString,
            response_deserializer=api.Empty.FromString,
        )


class RegistrationServicer:
    """Server side of Registration (used by the fake kubelet test harness)."""

    def Register(self, request, context):
        context.set_code(grpc.StatusCode.UNIMPLEMENTED)
        raise NotImplementedError()


def add_RegistrationServicer_to_server(servicer, server):
    rpc_method_handlers = {
        "Register": grpc.unary_unary_rpc_method_handler(
            servicer.Register,
            request_deserializer=api.RegisterRequest.FromString,
            response_serializer=api.Empty.SerializeToString,
        ),
    }
    generic_handler = grpc.method_handlers_generic_handler(
        "v1beta1.Registration", rpc_method_handlers
    )
    server.add_generic_rpc_handlers((generic_handler,))


class DevicePluginStub:
    """Client to a device plugin (used by the fake kubelet test harness)."""

    def __init__(self, channel: grpc.Channel):
        self.GetDevicePluginOptions = channel.unary_unary(
            "/v1beta1.DevicePlugin/GetDevicePluginOptions",
            request_serializer=api.Empty.SerializeToString,
            response_deserializer=api.DevicePluginOptions.FromString,
        )
        self.ListAndWatch = channel.unary_stream(
            "/v1beta1.DevicePlugin/ListAndWatch",
            request_serializer=api.Empty.SerializeToString,
            response_deserializer=api.ListAndWatchResponse.FromString,
        )
        self.GetPreferredAllocation = channel.unary_unary(
            "/v1beta1.DevicePlugin/GetPreferredAllocation",
            request_serializer=api.PreferredAllocationRequest.SerializeToString,
            response_deserializer=api.PreferredAllocationResponse.FromString,
        )
        self.Allocate = channel.unary_unary(
            "/v1beta1.DevicePlugin/Allocate",
            request_serializer=api.AllocateRequest.SerializeToString,
            response_deserializer=api.AllocateResponse.FromString,
        )
        self.PreStartContainer = channel.unary_unary(
            "/v1beta1.DevicePlugin/PreStartContainer",
            request_serializer=api.PreStartContainerRequest.SerializeToString,
            response_deserializer=api.PreStartContainerResponse.FromString,
        )


class DevicePluginServicer:
    """Server side of DevicePlugin; the plugin adapter subclasses this."""

    def GetDevicePluginOptions(self, request, context):
        context.set_code(grpc.StatusCode.UNIMPLEMENTED)
        raise NotImplementedError()

    def ListAndWatch(self, request, context):
        context.set_code(grpc.StatusCode.UNIMPLEMENTED)
        raise NotImplementedError()

    def GetPreferredAllocation(self, request, context):
        context.set_code(grpc.StatusCode.UNIMPLEMENTED)
        raise NotImplementedError()

    def Allocate(self, request, context):
        context.set_code(grpc.StatusCode.UNIMPLEMENTED)
        raise NotImplementedError()

    def PreStartContainer(self, request, context):
        context.set_code(grpc.StatusCode.UNIMPLEMENTED)
        raise NotImplementedError()


def add_DevicePluginServicer_to_server(servicer, server):
    rpc_method_handlers = {
        "GetDevicePluginOptions": grpc.unary_unary_rpc_method_handler(
            servicer.GetDevicePluginOptions,
            request_deserializer=api.Empty.FromString,
            response_serializer=api.DevicePluginOptions.SerializeToString,
        ),
        "ListAndWatch": grpc.unary_stream_rpc_method_handler(
            servicer.ListAndWatch,
            request_deserializer=api.Empty.FromString,
            response_serializer=api.ListAndWatchResponse.SerializeToString,
        ),
        "GetPreferredAllocation": grpc.unary_unary_rpc_method_handler(
            servicer.GetPreferredAllocation,
            request_deserializer=api.PreferredAllocationRequest.FromString,
            response_serializer=api.PreferredAllocationResponse.SerializeToString,
        ),
        "Allocate": grpc.unary_unary_rpc_method_handler(
            servicer.Allocate,
            request_deserializer=api.AllocateRequest.FromString,
            response_serializer=api.AllocateResponse.SerializeToString,
        ),
        "PreStartContainer": grpc.unary_unary_rpc_method_handler(
            servicer.PreStartContainer,
            request_deserializer=api.PreStartContainerRequest.FromString,
            response_serializer=api.PreStartContainerResponse.SerializeToString,
        ),
    }
    generic_handler = grpc.method_handlers_generic_handler(
        "v1beta1.DevicePlugin", rpc_method_handlers
    )
    server.add_generic_rpc_handlers((generic_handler,))
