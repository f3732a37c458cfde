"""Build the port's native sources into shared libraries and load them.

Each ``csrc/<name>.cu`` has a plain C interface.  ``nvcc`` compiles it for
``sm_90a`` into ``build/lib<name>-<digest>.so`` beside this file, at first
use; the digest covers the source and the flags, so an edited source is
rebuilt and an unchanged one is reused.  A ``csrc/<name>.c`` (host code,
such as the wire checksum) is built the same way by the host C compiler.
A host library of several C++ sources (``build_cxx``: the native server
and client lanes) is built by ``g++``, one compiler process per source,
all started together, then linked; its digest covers every source, every
header and the flags.  Each library is loaded with ``ctypes``.  Nothing
here runs at import.
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
from typing import Dict, Sequence

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

HOST_CFLAGS = ("-std=c11", "-O3", "-shared", "-fPIC")

#: the host C++ libraries' compile and link flags (the reference's
#: Makefile): -march=native ties a build to its machine's CPU
CXX_FLAGS = ("-O3", "-fPIC", "-fopenmp", "-std=c++17", "-march=native")
CXX_LDFLAGS = ("-shared", "-fopenmp", "-lpthread")

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


def _cxx() -> str:
    """The first of $CXX, g++ and c++ that can link OpenMP (that finds
    its ``libgomp.spec``): a toolchain without OpenMP may be set as $CXX
    beside the system's."""
    tried = []
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        found = cand and shutil.which(cand)
        if not found or found in tried:
            continue
        spec = subprocess.run([found, "-print-file-name=libgomp.spec"],
                              capture_output=True, text=True).stdout.strip()
        if os.path.isabs(spec) and os.path.exists(spec):
            return found
        tried.append(found)
    raise RuntimeError(
        "no host C++ compiler that links OpenMP found (looked for $CXX, g++ and c++; "
        f"without libgomp: {tried or 'none found'}): the port's native server and "
        "client lanes are built at first use"
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


def build_cxx(name: str, src_dir: str, sources: Sequence[str],
              headers: Sequence[str], out_dir: str) -> str:
    """Compile ``sources`` (with ``headers``) under ``src_dir`` into
    ``out_dir/lib<name>-<digest>.so`` unless it exists; return its path.
    One ``g++ -c`` per source, all at once, then one link; safe across
    processes (file lock).  Raises with the compiler's output on failure."""
    h = hashlib.sha256(" ".join((*CXX_FLAGS, "|", *CXX_LDFLAGS)).encode())
    for f in (*sources, *headers):
        with open(os.path.join(src_dir, f), "rb") as fh:
            h.update(f.encode() + b"\0" + fh.read())
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, f"lib{name}-{h.hexdigest()[:16]}.so")
    build_seconds.setdefault(name, 0.0)
    if os.path.exists(out):
        return out
    with open(os.path.join(out_dir, f".{name}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(out):
            return out
        cxx = _cxx()
        tmp = f"{out}.tmp.{os.getpid()}"
        objs = [f"{tmp}.{i}.o" for i in range(len(sources))]
        t0 = time.perf_counter()
        try:
            procs = [subprocess.Popen([cxx, *CXX_FLAGS, "-c", "-o", obj,
                                       os.path.join(src_dir, src)],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True)
                     for src, obj in zip(sources, objs)]
            logs = [p.communicate()[0] for p in procs]
            failed = [(src, log) for src, p, log in zip(sources, procs, logs)
                      if p.returncode != 0]
            if not failed:
                link = subprocess.run([cxx, *objs, *CXX_LDFLAGS, "-o", tmp],
                                      capture_output=True, text=True)
                logs.append(link.stdout + link.stderr)
                if link.returncode != 0:
                    failed.append(("the link", logs[-1]))
            build_seconds[name] = time.perf_counter() - t0
            build_log[name] = "".join(logs)
            if failed:
                raise RuntimeError(f"{cxx} failed on " + "; ".join(
                    f"{src}:\n{log}" for src, log in failed))
            os.replace(tmp, out)
        finally:
            for f in (*objs, tmp):
                if os.path.exists(f):
                    os.remove(f)
    return out
