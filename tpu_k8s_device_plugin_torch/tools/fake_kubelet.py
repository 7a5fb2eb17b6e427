"""In-process fake kubelet over the port's ``proto``.

It serves the kubelet Registration service on kubelet.sock in a
device-plugin dir, records registrations, and drives a registered plugin
exactly as the kubelet would (ListAndWatch stream, Allocate,
GetPreferredAllocation).  The chaos soak runs one per slice member.
"""

from __future__ import annotations

import concurrent.futures
import os
import queue
import threading
from typing import List, Optional

import grpc

from ..proto import deviceplugin_pb2 as pluginapi
from ..proto import deviceplugin_pb2_grpc as pluginapi_grpc


class _RegistrationServicer(pluginapi_grpc.RegistrationServicer):
    def __init__(self, kubelet: "FakeKubelet"):
        self._kubelet = kubelet

    def Register(self, request, context):
        self._kubelet.registrations.append(request)
        self._kubelet.register_event.set()
        return pluginapi.Empty()


class FakeKubelet:
    """Owns a device-plugin dir with a kubelet.sock Registration server."""

    def __init__(self, device_plugin_dir: str):
        self.dir = device_plugin_dir
        os.makedirs(self.dir, exist_ok=True)
        self.socket_path = os.path.join(self.dir, "kubelet.sock")
        self.registrations: List[pluginapi.RegisterRequest] = []
        self.register_event = threading.Event()
        self._server: Optional[grpc.Server] = None

    def start(self) -> "FakeKubelet":
        if os.path.exists(self.socket_path):
            os.remove(self.socket_path)
        self._server = grpc.server(
            concurrent.futures.ThreadPoolExecutor(max_workers=4)
        )
        pluginapi_grpc.add_RegistrationServicer_to_server(
            _RegistrationServicer(self), self._server
        )
        self._server.add_insecure_port(f"unix://{self.socket_path}")
        self._server.start()
        return self

    def stop(self, remove_socket: bool = True) -> None:
        if self._server is not None:
            self._server.stop(grace=0).wait()
            self._server = None
        if remove_socket and os.path.exists(self.socket_path):
            os.remove(self.socket_path)

    def restart(self, wipe_dir: bool = False) -> None:
        """Simulate a kubelet restart (socket re-creation).  With
        ``wipe_dir`` the device-plugin dir is cleared first, matching the
        real kubelet's removeContents on startup."""
        self.stop()
        if wipe_dir:
            for name in os.listdir(self.dir):
                try:
                    os.remove(os.path.join(self.dir, name))
                except OSError:
                    pass
        self.start()

    def wait_for_registration(self, timeout: float = 5.0) -> bool:
        ok = self.register_event.wait(timeout)
        self.register_event.clear()
        return ok

    # -- driving a registered plugin the way kubelet does -------------------

    def plugin_channel(self, endpoint: str) -> grpc.Channel:
        # tpulint: disable=R1 -- fake KUBELET: this dial stands in for the kubelet's own, outside the system; the plugin it reaches is the side whose recovery the soak provokes, and a retry here would hide a plugin that stopped serving
        return grpc.insecure_channel(
            f"unix://{os.path.join(self.dir, endpoint)}"
        )

    def plugin_stub(self, endpoint: str) -> pluginapi_grpc.DevicePluginStub:
        return pluginapi_grpc.DevicePluginStub(self.plugin_channel(endpoint))


class ListAndWatchConsumer:
    """Background consumer of a plugin's ListAndWatch stream."""

    def __init__(self, stub: pluginapi_grpc.DevicePluginStub):
        self.frames: "queue.Queue[pluginapi.ListAndWatchResponse]" = queue.Queue()
        self._call = stub.ListAndWatch(pluginapi.Empty())
        self._thread = threading.Thread(target=self._consume, daemon=True)
        self._thread.start()

    def _consume(self):
        try:
            for frame in self._call:
                self.frames.put(frame)
        except grpc.RpcError:
            pass

    def next_frame(self, timeout: float = 5.0) -> pluginapi.ListAndWatchResponse:
        return self.frames.get(timeout=timeout)

    def cancel(self):
        self._call.cancel()
