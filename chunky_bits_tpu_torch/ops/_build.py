"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface (no PyTorch headers),
so one source compiles in seconds.  At first use every source is compiled
into its own shared library, all ``nvcc`` processes started together, under
``chunky_bits_tpu_torch/_build/``.  A library's file name carries a hash of
its source and the flags, so a stale build is never loaded; a file lock
serialises concurrent first use across processes, and each library is
written under a private name and renamed into place.

Nothing here runs at import time, and there is no fallback: a failed build
raises ``ErasureError`` with nvcc's output.
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
from typing import Optional

from chunky_bits_tpu_torch.errors import ErasureError

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

#: kernel sources, one shared library each
SOURCES = ("gf_apply", "gf_apply_packed", "gf_acc", "gf_acc_pack",
           "sha256_rows")

#: Hopper only: ``sm_90a`` keeps wgmma/setmaxnreg available to later kernels
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-lineinfo", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}

#: nvcc's output per source from the last build in this process (ptxas
#: register and shared-memory report); empty when the cache was warm
BUILD_LOG: dict[str, str] = {}
#: wall seconds of the last ``build_all`` in this process
BUILD_SECONDS: Optional[float] = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise ErasureError("nvcc not found: the CUDA kernels cannot be built")
    return path


def library_path(name: str) -> str:
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        src = f.read()
    tag = hashlib.sha256(src + b"\0"
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}-{tag}.so")


def build_all() -> dict[str, str]:
    """Compile every source whose library is missing, all at once, and
    return ``{name: library path}``."""
    global BUILD_SECONDS
    t0 = time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {n: library_path(n) for n in SOURCES}
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            todo = [n for n in SOURCES if not os.path.exists(paths[n])]
            if todo:
                _compile(todo, paths)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    BUILD_SECONDS = time.perf_counter() - t0
    return paths


def _compile(names: list[str], paths: dict[str, str]) -> None:
    nvcc = _nvcc()
    procs = {}
    for n in names:
        tmp = f"{paths[n]}.tmp.{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    failed = []
    try:
        for n, (tmp, proc) in procs.items():
            out, _ = proc.communicate(timeout=600)
            BUILD_LOG[n] = out.decode(errors="replace")
            if proc.returncode == 0:
                os.replace(tmp, paths[n])
            else:
                failed.append(n)
    finally:
        for tmp, proc in procs.values():
            if proc.poll() is None:  # a timeout: leave no nvcc behind
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    if failed:
        raise ErasureError("nvcc failed for " + ", ".join(
            f"{n}.cu:\n{BUILD_LOG[n]}" for n in failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building all on first
    use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        if not _LIBS:
            for n, path in build_all().items():
                _LIBS[n] = ctypes.CDLL(path)
        return _LIBS[name]
