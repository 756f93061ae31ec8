"""Build a C or CUDA source into a shared library and load it.

Each kernel in ``deeprec_tpu_torch/csrc/`` exposes a plain C entry, so
it builds with ``nvcc`` alone (no PyTorch headers: seconds, not
minutes) and binds with ``ctypes``; the host parser in
``deeprec_tpu_torch/native/`` and the serving C ABI in
``deeprec_tpu_torch/serving/native/`` build the same way with ``g++``. A
library goes to ``build/kernels/`` or ``build/native/`` at the
repository root, named by a hash of the source and flags; a file lock
serializes processes that build the same library at once, and
different libraries build in parallel. Nothing is built at import:
only a wrapper's first call calls :func:`load_library` or
:func:`load_host_library`.
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

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
NATIVE_DIR = os.path.join(_PKG_DIR, "native")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
HOST_BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "native")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
HOST_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
# The kernel libraries of the port, one ``csrc/<name>.cu`` each: K1, K2
# and K3, the hash probe P1, the fresh-row draw P2 and the embedding
# combine with its backward (the ``occ_`` kernels).
KERNELS = ("gather_rows", "sparse_apply", "hash_probe", "init_rows",
           "occ_combine")
# Flags of one kernel on top of NVCC_FLAGS. The optimizer applies and the
# fresh-row draw keep every multiply and add separately rounded, as their
# plain PyTorch versions do, so the two can be compared for equality.
KERNEL_FLAGS = {"sparse_apply": ("--fmad=false",),
                "init_rows": ("--fmad=false",)}

_lock = threading.Lock()
_name_locks: dict[str, threading.Lock] = {}
_loaded: dict[str, ctypes.CDLL] = {}
# Seconds spent in the compiler per library by this process (0.0: cache
# hit).
build_seconds: dict[str, float] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    path = cand if cand and os.path.exists(cand) else shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return path


def _gxx() -> str:
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError("g++ not found: it is needed to build the "
                           "port's host parser")
    return path


def _load(name: str, src: str, compiler, flags, build_dir: str
          ) -> ctypes.CDLL:
    """Build (once) and load ``src`` as library ``name`` with
    ``compiler()`` and ``flags``. Safe to call from several threads:
    each library has its own lock."""
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        if name in _loaded:
            return _loaded[name]
        with open(src, "rb") as f:
            digest = hashlib.sha256(
                f.read() + " ".join(flags).encode()).hexdigest()[:16]
        os.makedirs(build_dir, exist_ok=True)
        so = os.path.join(build_dir, f"{name}-{digest}.so")
        with open(os.path.join(build_dir, f"{name}.lock"), "w") as lk:
            fcntl.flock(lk, fcntl.LOCK_EX)
            try:
                t0 = time.perf_counter()
                if not os.path.exists(so):
                    tmp = f"{so}.{os.getpid()}.tmp"
                    proc = subprocess.run(
                        [compiler(), *flags, "-o", tmp, src],
                        capture_output=True, text=True)
                    if proc.returncode != 0:
                        raise RuntimeError(
                            f"failed to build {src}:\n{proc.stderr}")
                    os.replace(tmp, so)
                build_seconds[name] = time.perf_counter() - t0
            finally:
                fcntl.flock(lk, fcntl.LOCK_UN)
        lib = ctypes.CDLL(so)
        _loaded[name] = lib
        return lib


def load_library(name: str) -> ctypes.CDLL:
    """Build (once) with ``nvcc`` and load ``csrc/<name>.cu``."""
    return _load(name, os.path.join(CSRC_DIR, f"{name}.cu"), _nvcc,
                 NVCC_FLAGS + KERNEL_FLAGS.get(name, ()), BUILD_DIR)


def load_host_library(name: str, src: Optional[str] = None) -> ctypes.CDLL:
    """Build (once) with ``g++`` and load ``src``, by default
    ``native/<name>.cc``."""
    return _load(name, src or os.path.join(NATIVE_DIR, f"{name}.cc"), _gxx,
                 HOST_FLAGS, HOST_BUILD_DIR)
