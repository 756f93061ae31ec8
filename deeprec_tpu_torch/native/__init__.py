"""The port's native host ops: ``host_ops.cc`` through ``ctypes``.

Port of the Criteo half of ``deeprec_tpu/native``: the fused TSV
parser (the reference's TransCsv role), and ``hash64``, the splitmix64
id hash the host spill tier's index probes with. The
library is built with ``g++`` at the first call into ``build/native/``
(``ops/kernels/build.load_host_library``). Unlike the JAX package's
loader there is no numpy fallback: a failed build raises, and the
pure-Python line parser (``data.criteo.parse_criteo_lines``) runs only
where a caller asks for it.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from deeprec_tpu_torch.ops.kernels import build

_lib = None
_lock = threading.Lock()


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = build.load_host_library("host_ops")
            i64p = ctypes.POINTER(ctypes.c_int64)
            f32p = ctypes.POINTER(ctypes.c_float)
            lib.drt_parse_criteo.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int, f32p, f32p, i64p, i64p]
            lib.drt_parse_criteo.restype = ctypes.c_int64
            lib.drt_hash64.argtypes = [i64p, ctypes.c_int64,
                                       ctypes.c_uint64, i64p]
            lib.drt_hash64.restype = None
            _lib = lib
        return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def parse_criteo(data: bytes, max_rows: int):
    """Criteo-Kaggle TSV bytes -> ``(rows, labels [max_rows] f32, dense
    [max_rows, 13] f32, cats [max_rows, 26] int64, consumed)``: the
    first ``rows`` rows are parsed, ints log-normalized, and ``consumed``
    is the byte count of the whole lines they came from (re-feed the rest
    with the next chunk)."""
    labels = np.zeros((max_rows,), np.float32)
    dense = np.zeros((max_rows, 13), np.float32)
    cats = np.zeros((max_rows, 26), np.int64)
    consumed = np.zeros((1,), np.int64)
    rows = _library().drt_parse_criteo(
        data, len(data), max_rows, 1,  # log_transform
        _ptr(labels, ctypes.c_float), _ptr(dense, ctypes.c_float),
        _ptr(cats, ctypes.c_int64), _ptr(consumed, ctypes.c_int64))
    return int(rows), labels, dense, cats, int(consumed[0])


def hash64(ids: np.ndarray, salt: int = 0) -> np.ndarray:
    """splitmix64 of each int64 id XOR ``salt``, as int64 (the JAX
    package's ``native.hash64``, bit for bit)."""
    ids = np.ascontiguousarray(ids, np.int64)
    out = np.empty(ids.shape, np.int64)
    _library().drt_hash64(_ptr(ids.reshape(-1), ctypes.c_int64), ids.size,
                          ctypes.c_uint64(salt & (2**64 - 1)),
                          _ptr(out.reshape(-1), ctypes.c_int64))
    return out
