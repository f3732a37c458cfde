"""Build the port's native sources into shared libraries and load them.

Each ``csrc/<name>.cu`` has a plain C interface.  ``nvcc`` compiles it for
``sm_90a`` into ``build/lib<name>-<digest>.so`` beside this file, at first
use; the digest covers the source and the flags, so an edited source is
rebuilt and an unchanged one is reused.  A ``csrc/<name>.c`` (host code,
such as the wire checksum) is built the same way by the host C compiler.
The library is loaded with ``ctypes``.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

HOST_CFLAGS = ("-std=c11", "-O3", "-shared", "-fPIC")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()

#: per source: seconds the last compile took in this process (0.0 when a
#: built library was reused) and what ptxas said (registers, spills)
build_seconds: Dict[str, float] = {}
build_log: Dict[str, str] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the port's CUDA kernels are built at first use"
        )
    return found


def _cc() -> str:
    for cand in (os.environ.get("CC"), "cc", "gcc"):
        found = cand and shutil.which(cand)
        if found:
            return found
    raise RuntimeError(
        "no host C compiler found (looked for $CC, cc and gcc): the port's "
        "host helpers are built at first use"
    )


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` (or ``csrc/<name>.c``) unless an
    up-to-date build exists; return the library's path.  Safe across
    processes (file lock)."""
    src = os.path.join(CSRC_DIR, name + ".cu")
    compiler, flags = _nvcc, NVCC_FLAGS
    if not os.path.exists(src):
        src = os.path.join(CSRC_DIR, name + ".c")
        compiler, flags = _cc, HOST_CFLAGS
    with open(src, "rb") as f:
        digest = hashlib.sha256(
            f.read() + " ".join(flags).encode()
        ).hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")
    build_seconds.setdefault(name, 0.0)
    if os.path.exists(out):
        return out
    with open(os.path.join(BUILD_DIR, f".{name}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(out):
            return out
        tmp = f"{out}.tmp.{os.getpid()}"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [compiler(), *flags, "-o", tmp, src],
            capture_output=True, text=True,
        )
        build_seconds[name] = time.perf_counter() - t0
        build_log[name] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"{compiler()} failed on {src}:\n{proc.stderr}")
        os.replace(tmp, out)
    return out


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first call."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(build(name))
        return lib
