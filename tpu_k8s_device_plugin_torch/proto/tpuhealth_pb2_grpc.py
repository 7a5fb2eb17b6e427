"""gRPC stubs and servicers for the TpuHealthService.

The port's copy of the JAX package's hand-written module, in grpc_tools
style.  The service keeps its name, tpuhealth.TpuHealthService, so either
package's client reads either package's exporter.
"""

import grpc

from . import tpuhealth_pb2 as api


class TpuHealthServiceStub:
    def __init__(self, channel: grpc.Channel):
        self.GetTpuState = channel.unary_unary(
            "/tpuhealth.TpuHealthService/GetTpuState",
            request_serializer=api.GetTpuStateRequest.SerializeToString,
            response_deserializer=api.GetTpuStateResponse.FromString,
        )
        self.List = channel.unary_unary(
            "/tpuhealth.TpuHealthService/List",
            request_serializer=api.ListTpuStateRequest.SerializeToString,
            response_deserializer=api.ListTpuStateResponse.FromString,
        )


class TpuHealthServiceServicer:
    def GetTpuState(self, request, context):
        context.set_code(grpc.StatusCode.UNIMPLEMENTED)
        raise NotImplementedError()

    def List(self, request, context):
        context.set_code(grpc.StatusCode.UNIMPLEMENTED)
        raise NotImplementedError()


def add_TpuHealthServiceServicer_to_server(servicer, server):
    rpc_method_handlers = {
        "GetTpuState": grpc.unary_unary_rpc_method_handler(
            servicer.GetTpuState,
            request_deserializer=api.GetTpuStateRequest.FromString,
            response_serializer=api.GetTpuStateResponse.SerializeToString,
        ),
        "List": grpc.unary_unary_rpc_method_handler(
            servicer.List,
            request_deserializer=api.ListTpuStateRequest.FromString,
            response_serializer=api.ListTpuStateResponse.SerializeToString,
        ),
    }
    generic_handler = grpc.method_handlers_generic_handler(
        "tpuhealth.TpuHealthService", rpc_method_handlers
    )
    server.add_generic_rpc_handlers((generic_handler,))
