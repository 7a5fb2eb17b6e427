"""k8s-gpu-device-plugin entry point.

    python -m tpu_k8s_device_plugin_torch.cmd.device_plugin [flags]

The port's counterpart of the JAX package's ``cmd/device_plugin.py``:
flag parsing and validation, device-impl selection (an explicit driver
type, or the reference's chain: container, then vf-passthrough, then
pf-passthrough), multi-host slice wiring (``--slice-*``), then the
plugin manager's lifecycle.  ``--sysfs-root``, ``--dev-root``,
``--proc-root`` and ``--nvml-json`` point the agent at a fixture host.
"""

from __future__ import annotations

import argparse
import functools
import logging
import os
import signal
import socket
import sys

from .. import __version__
from ..gpu import nvml as nvml_mod
from ..gpu.device_impl import GpuContainerImpl
from ..gpu.device_impl_vfio import GpuPfImpl, GpuVfImpl
from ..health import get_gpu_health
from ..manager import PluginManager
from ..types import constants

log = logging.getLogger("k8s-gpu-device-plugin")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="k8s-gpu-device-plugin",
        description="Kubernetes device plugin for NVIDIA GPUs",
    )
    p.add_argument(
        "--pulse", type=int, default=0, metavar="SECONDS",
        help="time between health check polling; 0 disables (default 0)",
    )
    p.add_argument(
        "--driver_type", "--driver-type", dest="driver_type",
        choices=[constants.CONTAINER, constants.VF_PASSTHROUGH,
                 constants.PF_PASSTHROUGH],
        default=None,
        help="device driver mode; omit to autodetect "
             "(container, then vf-passthrough, then pf-passthrough)",
    )
    p.add_argument(
        "--resource_naming_strategy", "--resource-naming-strategy",
        dest="naming_strategy",
        choices=[constants.RESOURCE_NAMING_STRATEGY_SINGLE,
                 constants.RESOURCE_NAMING_STRATEGY_MIXED],
        default=constants.RESOURCE_NAMING_STRATEGY_SINGLE,
        help="single: everything under nvidia.com/gpu (whole GPUs, or MIG "
             "devices of one profile); mixed: nvidia.com/gpu for whole "
             "GPUs and nvidia.com/mig-<profile> for MIG devices "
             "(gpu_vf / gpu_pf under passthrough)",
    )
    p.add_argument(
        "--kubelet-dir", default=constants.DEVICE_PLUGIN_PATH,
        help="kubelet device-plugin directory",
    )
    p.add_argument("--sysfs-root", default="/sys", help=argparse.SUPPRESS)
    p.add_argument("--dev-root", default="/dev", help=argparse.SUPPRESS)
    p.add_argument("--proc-root", default="/proc", help=argparse.SUPPRESS)
    p.add_argument("--nvml-json", default="", help=argparse.SUPPRESS)
    p.add_argument(
        "--exporter-socket", default=constants.METRICS_EXPORTER_SOCKET,
        help="gpu-metrics-exporter unix socket for granular health",
    )
    p.add_argument(
        "--slice-rendezvous", "--slice_rendezvous", dest="slice_rendezvous",
        default=os.environ.get(constants.ENV_SLICE_RENDEZVOUS, ""),
        metavar="HOST:PORT",
        help="multi-host slice rendezvous address; every member of the "
             "slice passes the same value, and the plugin whose hostname "
             "is HOST also serves the coordinator.  Empty (the default) "
             "disables slice coordination.  Env override: "
             f"{constants.ENV_SLICE_RENDEZVOUS}",
    )
    p.add_argument(
        "--slice-workers", "--slice_workers", dest="slice_workers",
        type=int, metavar="N",
        default=os.environ.get(constants.ENV_SLICE_WORKERS, "0"),
        help="hosts in the slice; required with --slice-rendezvous.  "
             f"Env override: {constants.ENV_SLICE_WORKERS}",
    )
    p.add_argument(
        "--slice-reshape-grace", "--slice_reshape_grace",
        dest="slice_reshape_grace", type=float, metavar="SECONDS",
        default=float(
            os.environ.get(constants.ENV_SLICE_RESHAPE_GRACE, "0") or 0),
        help="degraded-mode reshape grace window in seconds.  0 (the "
             "default) keeps demote-all: an unhealthy member demotes "
             "every member's devices until it recovers.  > 0: members "
             "still unhealthy or absent when the window expires are "
             "evicted and the survivors re-form a smaller slice under "
             "the next generation.  Acts on the rendezvous host; pass it "
             "to every member anyway.  Env override: "
             f"{constants.ENV_SLICE_RESHAPE_GRACE}",
    )
    p.add_argument(
        "--slice-master-port", type=int, default=constants.SLICE_MASTER_PORT,
        metavar="PORT",
        help="torch.distributed port on rank 0's host (MASTER_PORT in the "
             f"slice env; default {constants.SLICE_MASTER_PORT})",
    )
    p.add_argument(
        "--slice-state-file", default=constants.SLICE_STATE_FILE,
        help=argparse.SUPPRESS,
    )
    # seconds of silence after which the coordinator counts a member
    # unhealthy (a short one lets a test see a member's death quickly)
    p.add_argument(
        "--slice-heartbeat-timeout", type=float,
        default=constants.SLICE_HEARTBEAT_TIMEOUT_S, help=argparse.SUPPRESS,
    )
    p.add_argument(
        "--debug-port", type=int, default=0, metavar="PORT",
        help="serve /healthz, /debug/status, /debug/threads, /metrics "
             "on --debug-host at PORT; 0 disables (default)",
    )
    p.add_argument(
        "--flight-record-dir", dest="flight_record_dir",
        default=os.environ.get(constants.ENV_FLIGHT_RECORD_DIR, ""),
        metavar="DIR",
        help="dump the flight-recorder event journal as JSON lines to DIR "
             "on exit/SIGTERM; empty disables.  Env override: "
             f"{constants.ENV_FLIGHT_RECORD_DIR}",
    )
    p.add_argument(
        "--incident-dir", dest="incident_dir",
        default=os.environ.get(constants.ENV_INCIDENT_DIR, ""),
        metavar="DIR",
        help="write alert-triggered incident bundles under DIR (requires "
             f"--debug-port).  Env override: {constants.ENV_INCIDENT_DIR}",
    )
    p.add_argument(
        "--fault-spec", dest="fault_spec",
        default=os.environ.get("TPU_DP_FAULTS", ""), metavar="SPEC",
        help="arm deterministic fault injection (chaos testing ONLY): "
             "op:kind:arg[;...], e.g. 'kubelet.register:drop:0.5;"
             "probe:hang:5'.  Env override: TPU_DP_FAULTS",
    )
    p.add_argument(
        "--fault-seed", dest="fault_seed", type=int,
        default=int(os.environ.get("TPU_DP_FAULT_SEED", "0") or 0),
        metavar="N",
        help="RNG seed for --fault-spec probabilities.  Env override: "
             "TPU_DP_FAULT_SEED (default 0)",
    )
    p.add_argument(
        "--debug-host", default="127.0.0.1", metavar="ADDR",
        help="bind address for --debug-port (default loopback)",
    )
    p.add_argument("-v", "--verbose", action="count", default=0)
    p.add_argument("--version", action="version", version=__version__)
    return p


def select_device_impl(args, nvml=None):
    """An explicit driver type, or the reference's chain: container,
    then vf-passthrough, then pf-passthrough (the first that finds
    devices)."""
    health_fn = functools.partial(get_gpu_health, args.exporter_socket)
    impls = {
        constants.CONTAINER: lambda: GpuContainerImpl(
            sysfs_root=args.sysfs_root,
            dev_root=args.dev_root,
            proc_root=args.proc_root,
            nvml=nvml,
            health_fn=health_fn,
            resource_naming_strategy=args.naming_strategy,
        ),
        constants.VF_PASSTHROUGH: lambda: GpuVfImpl(
            resource_naming_strategy=args.naming_strategy,
            sysfs_root=args.sysfs_root,
            dev_root=args.dev_root,
            health_fn=health_fn,
        ),
        constants.PF_PASSTHROUGH: lambda: GpuPfImpl(
            resource_naming_strategy=args.naming_strategy,
            sysfs_root=args.sysfs_root,
            dev_root=args.dev_root,
            health_fn=health_fn,
        ),
    }
    if args.driver_type:
        return impls[args.driver_type](), args.driver_type
    last_err = None
    for driver_type in (constants.CONTAINER, constants.VF_PASSTHROUGH,
                        constants.PF_PASSTHROUGH):
        try:
            impl = impls[driver_type]()
        except RuntimeError as e:
            log.info("driver type %s not usable: %s", driver_type, e)
            last_err = e
            continue
        log.info("autodetected driver type: %s", driver_type)
        return impl, driver_type
    raise SystemExit(f"no usable NVIDIA driver mode found: {last_err}")


def check_slice_flags(args) -> str:
    """The reference's validation of the slice flags: the problem, or
    "" when they are consistent (the CLI exits 2 on a problem)."""
    if args.slice_workers and not args.slice_rendezvous:
        return "--slice-workers without --slice-rendezvous has no effect"
    if args.slice_reshape_grace and not args.slice_rendezvous:
        return ("--slice-reshape-grace without --slice-rendezvous has no "
                "effect")
    if args.slice_reshape_grace < 0:
        return (f"invalid --slice-reshape-grace "
                f"{args.slice_reshape_grace:.1f}; must be >= 0")
    return ""


def setup_slice(args, impl, driver_type, registry=None, recorder=None):
    """Wire slice coordination when --slice-rendezvous is set: serve the
    coordinator if this is the named host, attach a client to the impl,
    start its background join and heartbeat loop.  *registry* turns the
    slice metrics on; *recorder* journals membership transitions.
    Returns (coordinator or None, client)."""
    from ..slice import SliceClient, SliceCoordinator

    address = args.slice_rendezvous
    host, _, port_s = address.rpartition(":")
    if not host or not port_s.isdigit():
        raise SystemExit(
            f"--slice-rendezvous must be HOST:PORT, got {address!r}")
    if args.slice_workers < 2:
        raise SystemExit(
            "--slice-workers must be >= 2 with --slice-rendezvous "
            f"(got {args.slice_workers})")
    if driver_type != constants.CONTAINER:
        raise SystemExit(
            "slice coordination requires the container driver type "
            f"(got {driver_type}): passthrough VMs run their own runtime")
    hostname = socket.gethostname()
    coordinator = None
    # exact hostname match only: every member runs identical flags, and
    # exactly one of them may serve the rendezvous
    if host == hostname:
        coordinator = SliceCoordinator(
            expected_workers=args.slice_workers,
            bind_address=f"[::]:{port_s}",
            master_port=args.slice_master_port,
            state_path=args.slice_state_file,
            heartbeat_timeout_s=args.slice_heartbeat_timeout,
            registry=registry,
            recorder=recorder,
            reshape_grace_s=args.slice_reshape_grace,
        ).start()
        log.info("this host (%s) serves the slice rendezvous", hostname)
    client = SliceClient(
        rendezvous_address=address,
        hostname=hostname,
        chip_count=len(impl.gpus),
        state_path=args.slice_state_file,
        local_health_fn=impl.local_health,
        registry=registry,
        recorder=recorder,
    )
    impl.set_slice_client(client)
    client.start()
    return coordinator, client


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(levelname).1s %(name)s: %(message)s",
    )
    log.info("k8s-gpu-device-plugin %s starting", __version__)
    from ..hostinfo import gpuprobe
    try:
        log.info("native shim: %s", gpuprobe.version())
    except ImportError as e:
        log.warning("native shim unavailable (%s); using portable paths", e)
    if args.pulse < 0:
        log.error("invalid pulse %d; must be >= 0", args.pulse)
        return 2
    problem = check_slice_flags(args)
    if problem:
        log.error("%s", problem)
        return 2

    nvml = nvml_mod.load(args.nvml_json)
    impl, driver_type = select_device_impl(args, nvml)
    resources = impl.get_resource_names()
    log.info("driver=%s resources=%s", driver_type,
             [f"{constants.RESOURCE_NAMESPACE}/{r}" for r in resources])

    # the node's ONE metrics registry + flight recorder
    from .. import obs, resilience
    registry = obs.Registry()
    recorder = obs.FlightRecorder(registry=registry)
    resilience.set_suppressed_metrics(
        resilience.ResilienceMetrics(registry))
    if args.fault_spec:
        resilience.install(args.fault_spec, seed=args.fault_seed,
                           recorder=recorder)

    coordinator = client = None
    if args.slice_rendezvous:
        coordinator, client = setup_slice(args, impl, driver_type,
                                          registry=registry,
                                          recorder=recorder)

    manager = PluginManager(
        impl,
        pulse_seconds=args.pulse,
        kubelet_dir=args.kubelet_dir,
        slice_client=client,
        registry=registry,
        recorder=recorder,
    )
    debug_server = None
    if args.debug_port:
        from ..observability import DebugServer
        debug_server = DebugServer(
            manager, args.debug_port, host=args.debug_host,
            incident_dir=args.incident_dir or None).start()
    # k8s sends SIGTERM on pod shutdown; route it through the same
    # cleanup as Ctrl-C so streams get the stop signal and the endpoint
    # socket is unlinked
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    if args.flight_record_dir:
        # after the sys.exit handler: the recorder's chaining SIGTERM
        # handler dumps the journal first, then delegates to it
        recorder.install_dump_handlers(args.flight_record_dir)
    try:
        manager.run(block=True)
    finally:
        manager.stop()
        if client is not None:
            client.stop()
        if coordinator is not None:
            coordinator.stop()
        if debug_server is not None:
            debug_server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
