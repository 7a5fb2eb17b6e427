"""k8s-gpu-node-labeller entry point.

    python -m tpu_k8s_device_plugin_torch.cmd.node_labeller --node-name N

The port's counterpart of the JAX package's ``cmd/node_labeller.py``: a
driver-type flag, one boolean flag per label (all on by default), the
node name from the downward API, then the reconcile controller
(``--oneshot``: reconcile once and exit).
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import sys

from .. import __version__
from ..gpu import nvml as nvml_mod
from ..labeller import (
    LabelContext,
    NodeClient,
    NodeLabelController,
    generate_labels,
)
from ..types import constants

log = logging.getLogger("k8s-gpu-node-labeller")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="k8s-gpu-node-labeller",
        description="Publishes NVIDIA GPU properties as Kubernetes node "
                    "labels",
    )
    p.add_argument(
        "--driver_type", "--driver-type", dest="driver_type",
        choices=[constants.CONTAINER, constants.VF_PASSTHROUGH,
                 constants.PF_PASSTHROUGH], default=constants.CONTAINER,
    )
    for label in constants.SUPPORTED_LABELS:
        p.add_argument(
            f"--{label}",
            dest=f"label_{label.replace('-', '_')}",
            action=argparse.BooleanOptionalAction,
            default=True,
            help=f"emit the {constants.LABEL_PREFIX}.{label} label",
        )
    p.add_argument(
        "--node-name", default=None,
        help="node to label (default: $DS_NODE_NAME from the downward API)",
    )
    p.add_argument(
        "--interval", type=float, default=60.0,
        help="reconcile/watch interval seconds (default 60)",
    )
    p.add_argument(
        "--kube-api", default=None,
        help="API server base URL override (default: in-cluster config)",
    )
    p.add_argument("--sysfs-root", default="/sys", help=argparse.SUPPRESS)
    p.add_argument("--dev-root", default="/dev", help=argparse.SUPPRESS)
    p.add_argument("--proc-root", default="/proc", help=argparse.SUPPRESS)
    p.add_argument("--nvml-json", default="", help=argparse.SUPPRESS)
    p.add_argument(
        "--slice-state-file", default=constants.SLICE_STATE_FILE,
        help="membership file the device plugin's slice client keeps "
             "(the slice-* labels); absent on a single-host node",
    )
    p.add_argument("--oneshot", action="store_true",
                   help="reconcile once and exit (for jobs/tests)")
    p.add_argument("--version", action="version", version=__version__)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname).1s %(name)s: %(message)s",
    )
    log.info("k8s-gpu-node-labeller %s starting", __version__)

    node_name = args.node_name or os.environ.get("DS_NODE_NAME")
    if not node_name:
        log.error("no node name: set --node-name or DS_NODE_NAME")
        return 2

    enabled = [
        label for label in constants.SUPPORTED_LABELS
        if getattr(args, f"label_{label.replace('-', '_')}")
    ]
    log.info("node=%s labels=%s", node_name, enabled)
    nvml = nvml_mod.load(args.nvml_json)

    def compute():
        ctx = LabelContext.collect(
            driver_type=args.driver_type,
            sysfs_root=args.sysfs_root,
            dev_root=args.dev_root,
            proc_root=args.proc_root,
            nvml=nvml,
            slice_state_path=args.slice_state_file,
        )
        return generate_labels(ctx, enabled)

    controller = NodeLabelController(
        NodeClient(base_url=args.kube_api),
        node_name,
        compute,
        interval_s=args.interval,
    )
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    try:
        if args.oneshot:
            delta = controller.reconcile()
            log.info("oneshot delta: %s", delta)
        else:
            controller.run()
    except KeyboardInterrupt:
        pass
    finally:
        controller.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
