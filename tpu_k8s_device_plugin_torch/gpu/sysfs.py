"""Shared sysfs parsing helpers for discovery and health.

The port's copy of the JAX package's ``tpu/sysfs.py``: the NUMA read
goes through the native gpuprobe shim when it loads, and portable Python
otherwise.
"""

from __future__ import annotations

import logging
import os

log = logging.getLogger(__name__)

_NATIVE = False


def _native():
    """The gpuprobe shim, or None when unbuildable (cached after the
    first attempt, which pays a one-time build)."""
    global _NATIVE
    if _NATIVE is False:
        try:
            from ..hostinfo import gpuprobe
            gpuprobe.load()
            _NATIVE = gpuprobe
        except ImportError as e:
            # expected on hosts without a toolchain: the portable read
            # below is the handling, but the reason must not vanish
            log.debug("native gpuprobe shim unavailable (%s); using "
                      "portable sysfs parsing", e)
            _NATIVE = None
    return _NATIVE


def read_file(path: str) -> str:
    try:
        with open(path, "r", encoding="utf-8") as f:
            return f.read().strip()
    except OSError:
        return ""


def read_int(path: str, default: int = 0) -> int:
    s = read_file(path)
    try:
        return int(s, 0)
    except ValueError:
        return default


def numa_node(dev_dir: str) -> int:
    """NUMA node of a PCI device dir, clamped to >= 0 (-1 means
    unknown).  Prefers the native shim, with a portable fallback."""
    native = _native()
    if native is not None:
        rc = native.numa_node(dev_dir)
        if rc >= 0:
            return rc
    return max(read_int(os.path.join(dev_dir, "numa_node"), 0), 0)


def driver_name(dev_dir: str) -> str:
    """Bound driver of a PCI device dir, "" when unbound."""
    link = os.path.join(dev_dir, "driver")
    if not os.path.exists(link):
        return ""
    return os.path.basename(os.path.realpath(link))


def read_keyed(path: str) -> dict:
    """``Key: value`` lines of a driver information file, parsed by key
    (drivers add lines; positions are not a contract).  {} when absent."""
    out = {}
    try:
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                key, sep, val = line.partition(":")
                if sep:
                    out[key.strip()] = val.strip()
    except OSError:
        pass
    return out
