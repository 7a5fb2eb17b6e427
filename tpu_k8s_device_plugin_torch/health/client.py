"""Client to the gpu-metrics-exporter health service.

The port's copy of the JAX package's ``health/client.py``: a short-lived
insecure gRPC connection over the exporter's unix socket per poll,
mapping device id -> Healthy/Unhealthy, under the shared retry policy
(one retry rides out an exporter restart), with the ``health.list``
fault hook.  An unreachable exporter returns {}: the plugin then falls
back to its own node check.  Hang containment lives one layer up, in
the device impl's breaker and watchdog.
"""

from __future__ import annotations

import logging
import os
from typing import Dict

import grpc

from .. import resilience
from ..proto import tpuhealth_pb2 as hpb, tpuhealth_pb2_grpc as hpb_grpc
from ..resilience import faults
from ..types import constants

log = logging.getLogger(__name__)

# One retry after a short pause: enough to ride out an exporter restart
# between List and retry, short enough that a down exporter degrades
# this pulse to the simple health check instead of stalling it.
_LIST_RETRY = resilience.RetryPolicy(
    max_attempts=2, initial_backoff_s=0.2, max_backoff_s=1.0)


def get_gpu_health(
    socket_path: str = constants.METRICS_EXPORTER_SOCKET,
    timeout_s: float = constants.EXPORTER_HEALTH_CHECK_TIMEOUT_S,
    retry: "resilience.RetryPolicy" = None,
    metrics: "resilience.ResilienceMetrics" = None,
    recorder=None,
) -> Dict[str, str]:
    """GPU id -> "Healthy"/"Unhealthy" from the exporter daemon."""
    if not os.path.exists(socket_path):
        return {}

    def _list():
        if faults.ACTIVE is not None:
            faults.ACTIVE.fire("health.list")
        with grpc.insecure_channel(f"unix://{socket_path}") as ch:
            stub = hpb_grpc.TpuHealthServiceStub(ch)
            return stub.List(hpb.ListTpuStateRequest(), timeout=timeout_s)

    try:
        resp = (retry or _LIST_RETRY).call(
            _list, op="health.list",
            retry_on=(grpc.RpcError, faults.InjectedFault),
            metrics=metrics, recorder=recorder, logger=log)
    except (grpc.RpcError, faults.InjectedFault) as e:
        log.warning("gpu-metrics-exporter unreachable at %s: %s",
                    socket_path, e)
        return {}
    out: Dict[str, str] = {}
    for state in resp.states:
        health = state.health.strip().lower()
        out[state.id] = (
            constants.HEALTHY
            if health == "healthy"
            else constants.UNHEALTHY
        )
    return out
