"""The port's native host ops: ``host_ops.cc`` through ``ctypes``.

Port of ``deeprec_tpu/native``: the fused parsers of the input pipeline
(the reference's TransCsv ops: Criteo TSV, id lists, key:value lists),
the hashes (``hash64``, the splitmix64 id hash the host spill tier's
index probes with; ``hash_bytes``, the token hash of ``id_str``
columns), and first-occurrence dedup (``unique``, fused with the hash
and the per-field offset in ``hash_offset_unique``). Each takes and
returns numpy arrays and gives the JAX package's results bit for bit.
The library is built with ``g++`` at the first call into
``build/native/`` (``ops/kernels/build.load_host_library``). Unlike the
JAX package's loader there is no numpy fallback: a failed build raises,
and the pure-Python line parser (``data.criteo.parse_criteo_lines``)
runs only where a caller asks for it.
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
            i32p = ctypes.POINTER(ctypes.c_int32)
            f32p = ctypes.POINTER(ctypes.c_float)
            cp, i64, u64 = ctypes.c_char_p, ctypes.c_int64, ctypes.c_uint64
            ch = ctypes.c_char
            for name, res, args in (
                    ("drt_parse_criteo", i64,
                     [cp, i64, i64, ctypes.c_int, f32p, f32p, i64p, i64p]),
                    ("drt_hash64", None, [i64p, i64, u64, i64p]),
                    ("drt_hash_bytes", None, [cp, i64p, i64, u64, i64p]),
                    ("drt_unique_i64", i64, [i64p, i64, i64p, i32p, i32p]),
                    ("drt_parse_idlist", i64,
                     [cp, i64, ch, ch, i64, i64, i64, i64, i64p, i32p]),
                    ("drt_parse_kvlist", i64,
                     [cp, i64, ch, ch, ch, i64, i64, f32p]),
                    ("drt_hash_offset_unique", i64,
                     [i64p, i64, i64, u64, ctypes.c_int, i64p, i32p,
                      i32p])):
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = args, res
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
                          _salt(salt), _ptr(out.reshape(-1), ctypes.c_int64))
    return out


def _salt(salt: int) -> ctypes.c_uint64:
    return ctypes.c_uint64(salt & (2**64 - 1))


def hash_bytes(tokens, salt: int = 0) -> np.ndarray:
    """FNV-1a of each token's bytes (a ``str`` as UTF-8) XOR-seeded with
    ``salt``, then splitmix64, as int64: the JAX package's
    ``native.hash_bytes``, and with ``salt`` 0 the token hash of
    ``data.criteo._hash_token``."""
    bs = [t.encode() if isinstance(t, str) else bytes(t) for t in tokens]
    n = len(bs)
    out = np.empty((n,), np.int64)
    offs = np.zeros((n + 1,), np.int64)
    np.cumsum([len(b) for b in bs], out=offs[1:])
    _library().drt_hash_bytes(b"".join(bs), _ptr(offs, ctypes.c_int64), n,
                              _salt(salt), _ptr(out, ctypes.c_int64))
    return out


def _unique_into(fn, n: int, *args):
    uniq = np.empty((n,), np.int64)
    inverse = np.empty((n,), np.int32)
    counts = np.empty((n,), np.int32)
    k = fn(*args, _ptr(uniq, ctypes.c_int64), _ptr(inverse, ctypes.c_int32),
           _ptr(counts, ctypes.c_int32)) if n else 0
    return uniq[:k], inverse, counts[:k]


def unique(ids: np.ndarray):
    """First-occurrence-ordered dedup of int64 ids (flattened):
    ``(uniq, inverse int32, counts int32)`` with ``uniq[inverse] ==
    ids``."""
    ids = np.ascontiguousarray(ids, np.int64).reshape(-1)
    return _unique_into(_library().drt_unique_i64, ids.size,
                        _ptr(ids, ctypes.c_int64), ids.size)


def parse_idlist(data: bytes, ncols: int, max_len: int,
                 field_delim: str = ",", list_delim: str = "|",
                 max_rows: int = 1 << 20, pad: int = 0):
    """Rows of ``ncols`` fields, each a ``list_delim``-separated list of
    decimal ids (the reference's TransCsvID2Dense): ``(rows, ids [rows,
    ncols, max_len] int64 padded with pad, lens [rows, ncols] int32)``;
    a list longer than ``max_len`` keeps its first ``max_len`` ids."""
    out = np.empty((max_rows, ncols, max_len), np.int64)
    lens = np.zeros((max_rows, ncols), np.int32)
    rows = _library().drt_parse_idlist(
        data, len(data), field_delim.encode(), list_delim.encode(),
        max_rows, ncols, max_len, pad, _ptr(out, ctypes.c_int64),
        _ptr(lens, ctypes.c_int32))
    return rows, out[:rows], lens[:rows]


def parse_kvlist(data: bytes, ncols: int, field_delim: str = ",",
                 list_delim: str = "|", kv_delim: str = ":",
                 max_rows: int = 1 << 20):
    """Rows of ``key:value`` pairs (the reference's TransCsvKV2Dense):
    ``(rows, dense [rows, ncols] float32)``, each value at column
    ``key``; keys outside ``[0, ncols)`` are dropped, a later pair of one
    key wins."""
    out = np.zeros((max_rows, ncols), np.float32)
    rows = _library().drt_parse_kvlist(
        data, len(data), field_delim.encode(), list_delim.encode(),
        kv_delim.encode(), max_rows, ncols, _ptr(out, ctypes.c_float))
    return rows, out[:rows]


def hash_offset_unique(ids: np.ndarray, salt: int = 0, hash: bool = False):
    """One pass over a ``[rows, ncols]`` id matrix: optionally
    ``hash64`` each id (salted), add the per-field offset ``col << 40``,
    and dedup as :func:`unique`: ``(uniq, inverse int32 [rows*ncols],
    counts)``."""
    ids = np.ascontiguousarray(ids, np.int64)
    rows, ncols = ids.shape
    return _unique_into(_library().drt_hash_offset_unique, rows * ncols,
                        _ptr(ids, ctypes.c_int64), rows, ncols, _salt(salt),
                        int(hash))
