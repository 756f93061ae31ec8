"""Fresh-row initialization on the card (P2): the initializer draw of
the rows a training lookup inserted.

The CUDA kernel is ``csrc/init_rows.cu``; its header says what it
computes, what bounds it and how it is laid out. It replaces the
fresh-row loops of the JAX package's ``lookup_train_occ``, which draw a
row for every entry and scatter the fresh ones. The kernel draws only
the fresh rows, and reads nothing back to the host to find them.

``init_fresh`` launches the kernel for CUDA tensors and raises on what
it does not take; for CPU tensors it runs :func:`init_fresh_reference`,
the plain PyTorch version the tests and ``chip_smoke.py`` hold the
kernel against. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from deeprec_tpu_torch.ops.kernels import build
from deeprec_tpu_torch.utils import stateless_random as srand

launches = 0
_count_lock = threading.Lock()
_fn = None

_KINDS = {"zeros": 0, "constant": 1, "uniform": 2, "normal": 3,
          "truncated_normal": 4}
_ESIZE = {torch.float32: 4, torch.bfloat16: 2}


def init_fresh_reference(values: torch.Tensor, fresh: torch.Tensor,
                         slots: torch.Tensor, qhi: torch.Tensor,
                         qlo: torch.Tensor, initializer: str, scale: float,
                         salt: int) -> None:
    """Write ``init_rows`` draws of ids ``(qhi, qlo)`` into ``values
    [C+1, D]`` at the slots of the entries with ``fresh`` and ``slots <
    C``, with no host read: every entry is drawn and written, the fresh
    ones at their slots and the others at row C with row C's own
    content. Fresh entries that share a slot must be occurrences of one
    id, which write the same row."""
    C = values.shape[0] - 1
    on = fresh & (slots < C)
    idx = torch.where(on, slots, C).to(torch.int64)
    rows = srand.init_rows(initializer, qhi, qlo, values.shape[1], scale,
                           salt=salt).to(values.dtype)
    values.index_put_((idx,), torch.where(on[:, None], rows, values[idx]))


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load_library("init_rows").deeprec_init_fresh
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_float, ctypes.c_float, ctypes.c_uint32,
                       ctypes.c_uint32, ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _salt_mix(salt: int) -> int:
    return (salt * 0x85EBCA6B) & 0xFFFFFFFF


def _scalars(initializer: str, scale: float, salt: int):
    """(a, b, mix1, mix2) of the kernel: the scalars as the plain
    version's PyTorch ops round them to float32, and the salt offsets
    of the hash grids it draws."""
    if initializer == "uniform":
        # minval + (maxval - minval) * u with minval = -scale.
        return -scale, scale - (-scale), _salt_mix(salt), 0
    if initializer in ("normal", "truncated_normal"):
        return scale, 0.0, _salt_mix(salt * 2 + 1), _salt_mix(salt * 2 + 2)
    return float(scale), 0.0, 0, 0


def init_fresh(values: torch.Tensor, fresh: torch.Tensor,
               slots: torch.Tensor, qhi: torch.Tensor, qlo: torch.Tensor,
               initializer: str, scale: float, salt: int) -> None:
    """In place: the rows of ``values [C+1, D]`` at the slots of the
    ``fresh`` entries get their ids' ``init_rows`` draw, as
    :func:`init_fresh_reference` writes them."""
    global launches
    if values.device.type == "cpu":
        return init_fresh_reference(values, fresh, slots, qhi, qlo,
                                    initializer, scale, salt)
    dev = values.device
    if dev.type != "cuda":
        raise ValueError(f"init_fresh: no kernel for {dev}")
    if initializer not in _KINDS:
        raise ValueError(f"unknown initializer {initializer!r}")
    if values.dtype not in _ESIZE or values.dim() != 2 or \
            not values.is_contiguous():
        raise TypeError(f"init_fresh: values must be a contiguous 2-D "
                        f"float32 or bfloat16 tensor, got {values.dtype} "
                        f"{tuple(values.shape)}")
    n = slots.shape[0]
    for name, t, dtype in (("fresh", fresh, torch.bool),
                           ("slots", slots, torch.int32),
                           ("qhi", qhi, torch.int32),
                           ("qlo", qlo, torch.int32)):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != (n,) \
                or not t.is_contiguous():
            raise ValueError(f"init_fresh: {name} must be a contiguous 1-D "
                             f"{dtype} tensor of slots' length on {dev}")
    C1, D = values.shape
    if C1 < 1 or D < 1:
        raise ValueError(f"init_fresh: empty table {tuple(values.shape)}")
    if n == 0:
        return None
    a, b, mix1, mix2 = _scalars(initializer, scale, salt)
    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(values.data_ptr(), C1 - 1, D, slots.data_ptr(),
                fresh.data_ptr(), qhi.data_ptr(), qlo.data_ptr(), n,
                _KINDS[initializer], a, b, mix1, mix2, _ESIZE[values.dtype],
                stream)
    if rc != 0:
        raise RuntimeError(f"init_fresh: kernel launch failed, cudaError "
                           f"{rc}")
    with _count_lock:
        launches += 1
    return None
