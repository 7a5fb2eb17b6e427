"""k8s-gpu-device-plugin entry point.

    python -m tpu_k8s_device_plugin_torch.cmd.device_plugin [flags]

The port's counterpart of the JAX package's ``cmd/device_plugin.py``:
flag parsing and validation, device-impl selection, then the plugin
manager's lifecycle.  The container driver type is the one this port
has; passthrough (``--driver-type vf-passthrough`` / ``pf-passthrough``),
MIG-typed names (``--resource-naming-strategy mixed``) and multi-host
slices (``--slice-*``) raise NotImplementedError naming their ROADMAP
items.  ``--sysfs-root``, ``--dev-root``, ``--proc-root``
and ``--nvml-json`` point the agent at a fixture host.
"""

from __future__ import annotations

import argparse
import functools
import logging
import os
import signal
import sys

from .. import __version__
from ..gpu import nvml as nvml_mod
from ..gpu.device_impl import GpuContainerImpl
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
        help="device driver mode; omit to autodetect (container; the "
             "passthrough modes come with ROADMAP item "
             f"{constants.ITEM_PASSTHROUGH})",
    )
    p.add_argument(
        "--resource_naming_strategy", "--resource-naming-strategy",
        dest="naming_strategy",
        choices=[constants.RESOURCE_NAMING_STRATEGY_SINGLE,
                 constants.RESOURCE_NAMING_STRATEGY_MIXED],
        default=constants.RESOURCE_NAMING_STRATEGY_SINGLE,
        help="single: whole GPUs under nvidia.com/gpu; mixed: MIG-typed "
             "names (ROADMAP item "
             f"{constants.ITEM_PASSTHROUGH}; not in this port yet)",
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
        help="multi-host slice rendezvous (ROADMAP item "
             f"{constants.ITEM_SLICE}; not in this port yet)",
    )
    p.add_argument(
        "--slice-workers", "--slice_workers", dest="slice_workers",
        type=int, metavar="N",
        default=os.environ.get(constants.ENV_SLICE_WORKERS, "0"),
        help=f"hosts in the slice (ROADMAP item {constants.ITEM_SLICE})",
    )
    p.add_argument(
        "--slice-reshape-grace", "--slice_reshape_grace",
        dest="slice_reshape_grace", type=float, default=0.0,
        metavar="SECONDS",
        help=f"slice reshape grace (ROADMAP item {constants.ITEM_SLICE})",
    )
    p.add_argument("--slice-state-file", default="", help=argparse.SUPPRESS)
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


def _passthrough(driver_type: str):
    raise NotImplementedError(
        f"--driver-type {driver_type}: NVIDIA PF/VF passthrough (vfio-pci, "
        f"IOMMU groups, /dev/vfio) comes with ROADMAP item "
        f"{constants.ITEM_PASSTHROUGH}")


def select_device_impl(args, nvml=None):
    """The container impl (explicitly or by autodetect); the passthrough
    modes and the mixed naming strategy raise NotImplementedError naming
    their ROADMAP item."""
    if args.driver_type in (constants.VF_PASSTHROUGH,
                            constants.PF_PASSTHROUGH):
        _passthrough(args.driver_type)
    if args.naming_strategy == constants.RESOURCE_NAMING_STRATEGY_MIXED:
        raise NotImplementedError(
            "--resource-naming-strategy mixed: MIG-typed resource names "
            f"come with ROADMAP item {constants.ITEM_PASSTHROUGH}")

    def build():
        return GpuContainerImpl(
            sysfs_root=args.sysfs_root,
            dev_root=args.dev_root,
            proc_root=args.proc_root,
            nvml=nvml,
            health_fn=functools.partial(get_gpu_health,
                                        args.exporter_socket),
        )

    if args.driver_type:
        return build(), args.driver_type
    try:
        impl = build()
    except RuntimeError as e:
        raise SystemExit(
            f"no usable NVIDIA driver mode found: {e} (the passthrough "
            f"modes come with ROADMAP item {constants.ITEM_PASSTHROUGH})")
    log.info("autodetected driver type: %s", constants.CONTAINER)
    return impl, constants.CONTAINER


def check_slice_flags(args) -> None:
    if args.slice_rendezvous or args.slice_workers \
            or args.slice_reshape_grace or args.slice_state_file:
        raise NotImplementedError(
            "--slice-*: multi-host slice coordination comes with ROADMAP "
            f"item {constants.ITEM_SLICE}")


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
    check_slice_flags(args)

    nvml = nvml_mod.load(args.nvml_json)
    impl, driver_type = select_device_impl(args, nvml)
    resources = impl.get_resource_names()
    log.info("driver=%s resources=%s gpus=%d nvlink=%s", driver_type,
             [f"{constants.RESOURCE_NAMESPACE}/{r}" for r in resources],
             len(impl.gpus), impl.topology.topology_str)

    # the node's ONE metrics registry + flight recorder
    from .. import obs, resilience
    registry = obs.Registry()
    recorder = obs.FlightRecorder(registry=registry)
    resilience.set_suppressed_metrics(
        resilience.ResilienceMetrics(registry))
    if args.fault_spec:
        resilience.install(args.fault_spec, seed=args.fault_seed,
                           recorder=recorder)

    manager = PluginManager(
        impl,
        pulse_seconds=args.pulse,
        kubelet_dir=args.kubelet_dir,
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
        if debug_server is not None:
            debug_server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
