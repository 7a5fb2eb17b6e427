"""gpu-metrics-exporter entry point: the standalone health probe daemon.

    python -m tpu_k8s_device_plugin_torch.cmd.metrics_exporter \
        --socket PATH [--metrics-port PORT]

The port's counterpart of the JAX package's ``cmd/metrics_exporter.py``:
the health service on a unix socket and the Prometheus ``/metrics``
endpoint on a TCP port, probing the same roots.
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys
import threading

from .. import __version__
from ..gpu import nvml as nvml_mod
from ..health import GpuHealthServer, MetricsHTTPServer
from ..types import constants


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="gpu-metrics-exporter")
    p.add_argument(
        "--socket", default=constants.METRICS_EXPORTER_SOCKET,
        help="unix socket to serve the health service on",
    )
    p.add_argument(
        "--metrics-port", type=int, default=constants.METRICS_HTTP_PORT,
        help="TCP port for the Prometheus /metrics endpoint (0 disables)",
    )
    p.add_argument("--sysfs-root", default="/sys", help=argparse.SUPPRESS)
    p.add_argument("--dev-root", default="/dev", help=argparse.SUPPRESS)
    p.add_argument("--proc-root", default="/proc", help=argparse.SUPPRESS)
    p.add_argument("--nvml-json", default="", help=argparse.SUPPRESS)
    p.add_argument("--version", action="version", version=__version__)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    # chaos runs arm the probe hook through TPU_DP_FAULTS; unset env
    # leaves it a bare attribute check
    from ..resilience import faults
    faults.install_from_env()
    # pod shutdown sends SIGTERM: exit through the finally so the socket
    # is removed (skipped off the main thread, where signal.signal raises)
    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    nvml = nvml_mod.load(args.nvml_json)
    roots = dict(sysfs_root=args.sysfs_root, dev_root=args.dev_root,
                 proc_root=args.proc_root, nvml=nvml)
    server = GpuHealthServer(socket_path=args.socket, **roots).start()
    metrics = None
    try:
        # inside the try: a bind failure must tear the gRPC server down
        # and exit non-zero so the pod restarts
        if args.metrics_port:
            metrics = MetricsHTTPServer(port=args.metrics_port,
                                        **roots).start()
        server.wait()
    except KeyboardInterrupt:
        pass
    except OSError as e:
        logging.error("metrics listener failed: %s", e)
        return 1
    finally:
        if metrics is not None:
            metrics.stop()
        server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
