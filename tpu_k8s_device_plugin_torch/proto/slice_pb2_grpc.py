"""gRPC stubs and servicers for the SliceRendezvous service.

The port's copy of the JAX package's hand-written module, in grpc_tools
style.  The service keeps its name, tpuslice.SliceRendezvous, so either
package's client joins either package's coordinator.
"""

import grpc

from . import slice_pb2 as api


class SliceRendezvousStub:
    def __init__(self, channel: grpc.Channel):
        self.Join = channel.unary_unary(
            "/tpuslice.SliceRendezvous/Join",
            request_serializer=api.JoinRequest.SerializeToString,
            response_deserializer=api.JoinResponse.FromString,
        )
        self.Heartbeat = channel.unary_unary(
            "/tpuslice.SliceRendezvous/Heartbeat",
            request_serializer=api.HeartbeatRequest.SerializeToString,
            response_deserializer=api.HeartbeatResponse.FromString,
        )


class SliceRendezvousServicer:
    def Join(self, request, context):
        context.set_code(grpc.StatusCode.UNIMPLEMENTED)
        raise NotImplementedError()

    def Heartbeat(self, request, context):
        context.set_code(grpc.StatusCode.UNIMPLEMENTED)
        raise NotImplementedError()


def add_SliceRendezvousServicer_to_server(servicer, server):
    rpc_method_handlers = {
        "Join": grpc.unary_unary_rpc_method_handler(
            servicer.Join,
            request_deserializer=api.JoinRequest.FromString,
            response_serializer=api.JoinResponse.SerializeToString,
        ),
        "Heartbeat": grpc.unary_unary_rpc_method_handler(
            servicer.Heartbeat,
            request_deserializer=api.HeartbeatRequest.FromString,
            response_serializer=api.HeartbeatResponse.SerializeToString,
        ),
    }
    generic_handler = grpc.method_handlers_generic_handler(
        "tpuslice.SliceRendezvous", rpc_method_handlers
    )
    server.add_generic_rpc_handlers((generic_handler,))
