"""Build and load the port's CUDA kernels.

Each source ``csrc/<name>.cu`` exports a plain C interface and is
compiled by ``nvcc`` for ``sm_90a`` into its own shared library, which
is loaded with ``ctypes``.  Sources share the headers beside them
(``csrc/*.cuh``, ``csrc/*.h``).  Libraries go to ``_build/`` inside the
package (ignored by git), named by a hash of the source, of every header
and of the compiler flags, so an edited source or header is rebuilt and
an unchanged tree is reused.  Nothing is compiled
at import: the first wrapper that launches a kernel builds it, and
:func:`build_all` builds every source at once, one ``nvcc`` process per
source, all started together.

Host sources, ``csrc/<name>.cpp`` (the node agents' ``gpuprobe`` shim),
are compiled by the host C++ compiler into the same directory, named by a
hash of the source and the flags, by :func:`load_host` at first use.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

from .resilience import faults

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]
# after the source: libcuda, for the TMA tensor maps encoded per call
NVCC_LIBS = ["-lcuda"]
CXX_FLAGS = ["-O2", "-Wall", "-fPIC", "-fvisibility=hidden", "-std=c++17",
             "-shared"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def sources() -> List[str]:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the one on
    ``PATH``, else the toolkit's default install location."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    if shutil.which("nvcc"):
        cands.append(shutil.which("nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the port's "
        "CUDA kernels are compiled from csrc/ at first use")


def headers() -> List[Path]:
    """The headers that the sources may include (``csrc/*.cuh``,
    ``csrc/*.h``)."""
    return sorted(p for pattern in ("*.cuh", "*.h")
                  for p in CSRC.glob(pattern))


def lib_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is, or will be, built:
    named by a hash of the source, every header (name and content) and
    the compiler flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in headers():
        digest.update(b"\0" + header.name.encode() + b"\0")
        digest.update(header.read_bytes())
    digest.update(b"\0" + " ".join(NVCC_FLAGS + NVCC_LIBS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for *name* unless its library is already built;
    returns ``(process, temporary output)`` or None."""
    if lib_path(name).exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path(name).with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu"),
           *NVCC_LIBS]
    # chaos hook: a compiler that fails or stalls here takes the
    # caller's build-failure path
    if faults.ACTIVE is not None:
        faults.ACTIVE.fire("build.compile")
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), tmp


def _finish(name: str, started) -> str:
    """Wait for a build from :func:`_start` and move its library into
    place.  Returns the compiler's report (registers, shared memory and
    spills per kernel), or "" when nothing was built."""
    if started is None:
        return ""
    proc, tmp = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, lib_path(name))
    return log


def build_all() -> Dict[str, str]:
    """Compile every source, in parallel; returns ``{name: nvcc log}``
    (empty for a library that was already built)."""
    with _lock:
        procs = {n: _start(n) for n in sources()}
        logs, errors = {}, []
        for n, p in procs.items():  # wait for every nvcc, then report
            try:
                logs[n] = _finish(n, p)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
        return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = ctypes.CDLL(str(lib_path(name)))
            _libs[name] = lib
        return lib


def cxx_path() -> str:
    """The host C++ compiler: ``$CXX``, else ``g++``, else ``c++``."""
    for c in (os.environ.get("CXX"), shutil.which("g++"),
              shutil.which("c++")):
        if c:
            return c
    raise RuntimeError("no C++ compiler (set CXX or put g++ on PATH); the "
                       "host shims are compiled from csrc/*.cpp at first use")


def host_lib_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cpp`` is, or will be, built:
    named by a hash of the source and the compiler flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cpp").read_bytes())
    digest.update(b"\0" + " ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def load_host(name: str) -> ctypes.CDLL:
    """The loaded library for the host source ``csrc/<name>.cpp``, built
    with the host compiler if needed.  Raises RuntimeError when it cannot
    be built."""
    key = f"host:{name}"
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            path = host_lib_path(name)
            if not path.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = path.with_suffix(f".{os.getpid()}.tmp")
                cmd = [cxx_path(), *CXX_FLAGS, "-o", str(tmp),
                       str(CSRC / f"{name}.cpp")]
                if faults.ACTIVE is not None:
                    faults.ACTIVE.fire("build.compile")
                try:
                    # tpulint: disable=C2 -- one build at a time is the design: a second caller of the library must wait for it, not compile the same output again; the compile is bounded by its timeout
                    subprocess.run(cmd, check=True, capture_output=True,
                                   text=True, timeout=120)
                except subprocess.CalledProcessError as e:
                    raise RuntimeError(
                        f"{cmd[0]} failed for csrc/{name}.cpp:\n"
                        f"{e.stdout}{e.stderr}") from e
                except (subprocess.SubprocessError, OSError) as e:
                    raise RuntimeError(
                        f"cannot build csrc/{name}.cpp: {e}") from e
                os.replace(tmp, path)
            lib = ctypes.CDLL(str(path), use_errno=True)
            _libs[key] = lib
        return lib
