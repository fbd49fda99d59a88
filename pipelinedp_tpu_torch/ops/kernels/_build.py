"""Builds the port's CUDA sources at first use and loads them with ctypes.

``csrc/<name>.cu`` compiles with ``nvcc -gencode arch=compute_90a,code=sm_90a``
into a shared library with a plain C interface, under
``pipelinedp_tpu_torch/build/``. The file name carries a hash of the source
and the flags, so an edited source rebuilds and a stale library is never
loaded. The first load in a process records a ``compile.program`` span
and a build record (``obs/costs.py``) with the build cache's hit or miss.
Nothing here runs at import time: the CPU tests import every module
on a host with no ``nvcc``.

The resident service (``serve/``) calls the kernels from several worker
threads, so a first build holds a per-source lock (one ``nvcc`` per source
and process, the others wait for its library), and each wrapper counts its
launches through :func:`count_launch`, under one lock.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_libs: Dict[str, ctypes.CDLL] = {}
_build_locks: Dict[str, threading.Lock] = {}
_locks_lock = threading.Lock()
_launch_lock = threading.Lock()


def count_launch(launches: Dict[str, int], name: str) -> None:
    """``launches[name] += 1``, safe against the service's threads."""
    with _launch_lock:
        launches[name] += 1


def reset_counts(launches: Dict[str, int]) -> None:
    """Sets every count of ``launches`` to 0, under the same lock."""
    with _launch_lock:
        for name in launches:
            launches[name] = 0


def find_nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, then ``PATH``, then
    ``/usr/local/cuda/bin/nvcc``. Raises when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin",
                                       "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the port's CUDA kernels build "
        "from source at first use")


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use. Raises
    with the compiler's output when the build fails."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _locks_lock:
        lock = _build_locks.setdefault(name, threading.Lock())
    with lock:
        lib = _libs.get(name)  # another thread may have built it meanwhile
        if lib is None:
            lib = _build_and_load(name)
    return lib


def _build_and_load(name: str) -> ctypes.CDLL:
    src = os.path.join(CSRC_DIR, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    path = os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")
    from pipelinedp_tpu_torch.obs import costs
    cached = os.path.exists(path)
    with costs.build_span(name, cached):
        if not cached:
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
            proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for csrc/{name}.cu (exit "
                                   f"{proc.returncode}):\n{proc.stdout}"
                                   f"{proc.stderr}")
            os.replace(tmp, path)  # atomic, so concurrent builds agree
        lib = _libs[name] = ctypes.CDLL(path)
    return lib
