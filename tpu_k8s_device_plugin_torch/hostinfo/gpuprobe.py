"""ctypes binding for the gpuprobe shim (``csrc/gpuprobe.cpp``).

The port's counterpart of the JAX package's ``hostinfo/tpuprobe.py``.
The shim is compiled with the host C++ compiler by :mod:`..build` into
the package's ``_build/`` directory at first use (:func:`load`), never at
import.  :func:`load` raises ImportError when it cannot be built or
loaded; callers treat that as "no native support" and fall back to
portable Python (stat polling, ``os.path.exists``, a sysfs read).
"""

from __future__ import annotations

import ctypes
import errno
import logging
import os
import threading
from typing import Optional

from .. import build

log = logging.getLogger(__name__)

_lib: Optional[ctypes.CDLL] = None
_load_lock = threading.Lock()


def load() -> ctypes.CDLL:
    """The loaded shim, built on first use; ImportError when unbuildable."""
    global _lib
    with _load_lock:
        if _lib is None:
            try:
                lib = build.load_host("gpuprobe")
            except (RuntimeError, OSError) as e:
                raise ImportError(f"gpuprobe shim unavailable: {e}") from e
            lib.gp_version.restype = ctypes.c_char_p
            lib.gp_watch_create.restype = ctypes.c_void_p
            lib.gp_watch_create.argtypes = [ctypes.c_char_p]
            lib.gp_watch_wait.restype = ctypes.c_int
            lib.gp_watch_wait.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.gp_watch_destroy.argtypes = [ctypes.c_void_p]
            for fn in (lib.gp_probe_device, lib.gp_char_major,
                       lib.gp_numa_node):
                fn.restype = ctypes.c_int
                fn.argtypes = [ctypes.c_char_p]
            _lib = lib
        return _lib


def version() -> str:
    """Shim version banner."""
    return load().gp_version().decode()


def probe_device_node(path: str) -> int:
    """0 when *path* exists as a character device, -ENOTSUP when it
    exists but is not one (fixture trees), else -errno.  Stat-only: it
    never opens the node."""
    return load().gp_probe_device(path.encode())


def char_device_major(path: str) -> int:
    """The char-device major of *path* (195 for ``/dev/nvidia<minor>``),
    -ENOTSUP when it is not a char device, else -errno."""
    return load().gp_char_major(path.encode())


def numa_node(pci_sysfs_dir: str) -> int:
    """NUMA node of a PCI function (>= 0; unknown collapses to 0),
    -errno on read failure."""
    return load().gp_numa_node(pci_sysfs_dir.encode())


class DirWatcher:
    """inotify watch on a directory (the plugin manager's detector of
    kubelet-socket creation and removal)."""

    def __init__(self, directory: str):
        lib = load()
        ctypes.set_errno(0)
        self._lib = lib
        self._handle = lib.gp_watch_create(directory.encode())
        if not self._handle:
            err = ctypes.get_errno()
            raise OSError(
                err,
                f"inotify watch failed for {directory}: {os.strerror(err)}")

    def wait(self, timeout_s: float = 1.0) -> bool:
        """True when a filesystem event arrived before the timeout;
        raises OSError when the watch itself is broken (callers then
        re-create it or poll)."""
        if self._handle is None:
            raise ValueError("watcher is closed")
        rc = self._lib.gp_watch_wait(self._handle, int(timeout_s * 1000))
        if rc < 0:
            if rc == -errno.EINTR:
                return False  # signal during poll: a spurious wakeup
            raise OSError(-rc, f"inotify wait failed: {os.strerror(-rc)}")
        return rc > 0

    def close(self) -> None:
        if self._handle is not None:
            self._lib.gp_watch_destroy(self._handle)
            self._handle = None

    def __enter__(self) -> "DirWatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception as e:
            # interpreter teardown: the accounting is best-effort, but a
            # live process gets the DEBUG line and the suppressed counter
            try:
                from ..resilience import suppressed
                suppressed("gpuprobe.dirwatcher_del", e, logger=log)
            except Exception:  # noqa: BLE001 -- a __del__ must not raise
                pass
