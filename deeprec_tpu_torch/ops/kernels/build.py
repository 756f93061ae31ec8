"""Build a kernel's CUDA source into a shared library and load it.

Each kernel in ``deeprec_tpu_torch/csrc/`` exposes a plain C entry, so
it builds with ``nvcc`` alone (no PyTorch headers: seconds, not
minutes) and binds with ``ctypes``. The library goes to
``build/kernels/`` at the repository root, named by a hash of the
source and flags; a file lock serializes processes that build the same
kernel at once, and different kernels build in parallel. Nothing is
built at import: only a wrapper's first launch calls
:func:`load_library`.
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

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
# Flags of one kernel on top of NVCC_FLAGS. The optimizer applies keep
# every multiply and add separately rounded, as their plain PyTorch
# versions do, so the two can be compared for equality.
KERNEL_FLAGS = {"sparse_apply": ("--fmad=false",)}

_lock = threading.Lock()
_name_locks: dict[str, threading.Lock] = {}
_loaded: dict[str, ctypes.CDLL] = {}
# Seconds spent in nvcc per kernel by this process (0.0: cache hit).
build_seconds: dict[str, float] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    path = cand if cand and os.path.exists(cand) else shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return path


def load_library(name: str) -> ctypes.CDLL:
    """Build (once) and load ``csrc/<name>.cu``. Safe to call from
    several threads: each kernel has its own lock."""
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        if name in _loaded:
            return _loaded[name]
        flags = NVCC_FLAGS + KERNEL_FLAGS.get(name, ())
        src = os.path.join(CSRC_DIR, f"{name}.cu")
        with open(src, "rb") as f:
            digest = hashlib.sha256(
                f.read() + " ".join(flags).encode()).hexdigest()[:16]
        os.makedirs(BUILD_DIR, exist_ok=True)
        so = os.path.join(BUILD_DIR, f"{name}-{digest}.so")
        with open(os.path.join(BUILD_DIR, f"{name}.lock"), "w") as lk:
            fcntl.flock(lk, fcntl.LOCK_EX)
            try:
                t0 = time.perf_counter()
                if not os.path.exists(so):
                    tmp = f"{so}.{os.getpid()}.tmp"
                    proc = subprocess.run(
                        [_nvcc(), *flags, "-o", tmp, src],
                        capture_output=True, text=True)
                    if proc.returncode != 0:
                        raise RuntimeError(
                            f"nvcc failed to build {src}:\n{proc.stderr}")
                    os.replace(tmp, so)
                build_seconds[name] = time.perf_counter() - t0
            finally:
                fcntl.flock(lk, fcntl.LOCK_UN)
        lib = ctypes.CDLL(so)
        _loaded[name] = lib
        return lib
