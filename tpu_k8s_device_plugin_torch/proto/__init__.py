"""Protocol stubs: the kubelet's deviceplugin v1beta1 API and the health
service between the plugin and its exporter.

The port's own copies of the JAX package's ``proto/`` modules.  The
``*_pb2`` modules are protoc output from the ``.proto`` files beside
them, byte for byte the reference's, so the wire is the same; the
``*_pb2_grpc`` modules are hand-written in grpc_tools style.
"""

from . import deviceplugin_pb2
from . import deviceplugin_pb2_grpc
from . import tpuhealth_pb2
from . import tpuhealth_pb2_grpc

__all__ = [
    "deviceplugin_pb2",
    "deviceplugin_pb2_grpc",
    "tpuhealth_pb2",
    "tpuhealth_pb2_grpc",
]
