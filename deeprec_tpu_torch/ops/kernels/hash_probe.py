"""Hash-table probe on the card (P1): ``find`` and ``find_or_insert``.

The CUDA kernels are ``csrc/hash_probe.cu``; its header says what they
compute, what bounds them and how they are laid out. They replace the
rounds that ``embedding/hash_table.py``'s plain version drives from the
host (one host read a round) and that the JAX package runs in
``jax.lax.while_loop``: every round stays on the card, and neither the
kernels nor these wrappers read anything back.

These wrappers take CUDA tensors only and raise on anything else; on a
CPU tensor ``hash_table.find`` and ``hash_table.find_or_insert`` run
their plain versions, which the tests hold against the JAX package and
``chip_smoke.py`` holds these kernels against. ``launches`` counts the
launches of each wrapper.

``find_or_insert`` takes a claim buffer of ``capacity + 1`` int32
(:func:`claim_buffer`), free (``INT32_MAX``) everywhere, and leaves it
so: the table that owns it passes it to every insert, ordered on one
stream, as the training step's are.

Each ``find_or_insert`` launch writes the rounds it ran (the fast round
counts 1; a call stops at a round whose every id is dead, see the
kernel's header) into its scratch; while tracing is on
(``utils/trace.py``) the launch adds that slot into the counters
``probe_rounds`` (their sum) and ``probe_rounds_max``, on the card, so a
step captured in a CUDA graph counts every replay's rounds.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from deeprec_tpu_torch.ops.kernels import build
from deeprec_tpu_torch.utils import trace

launches = {"find": 0, "find_or_insert": 0}
_lock = threading.Lock()
_fns: dict = {}

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_ARGTYPES = {
    "deeprec_probe_find": [_P, _I64, _I64, _P, _P, _I64, _I64, _P, _P],
    "deeprec_probe_insert": [_P, _I64, _I64, _P, _P, _P, _I64, _I64, _I64,
                             _I64, _P, _P, _P, _P, _P],
    "deeprec_probe_grid_max": [],
}
_FREE = 2**31 - 1


def _kernel(symbol: str):
    if symbol not in _fns:
        fn = getattr(build.load_library("hash_probe"), symbol)
        fn.argtypes = _ARGTYPES[symbol]
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return _fns[symbol]


def _check_ids(fn, key_rows, qhi, qlo):
    """Device, type, shape and contiguity of a launch's operands;
    returns ``(n_rows, W, n)``."""
    dev = key_rows.device
    if dev.type != "cuda":
        raise ValueError(f"{fn}: no kernel for {dev}")
    if key_rows.dtype != torch.int32 or key_rows.dim() != 2:
        raise TypeError(f"{fn}: key_rows must be a 2-D int32 tensor, got "
                        f"{key_rows.dtype} {tuple(key_rows.shape)}")
    n_rows, row = key_rows.shape
    W = row // 2
    if row % 2 or W < 1 or W > 64 or W & (W - 1) or n_rows < 1:
        raise ValueError(f"{fn}: key_rows {tuple(key_rows.shape)} is not "
                         f"[capacity // W, 2W] with W a power of two <= 64")
    if n_rows * W >= 2**31:
        raise ValueError(f"{fn}: capacity {n_rows * W} does not fit int32")
    if not key_rows.is_contiguous():
        raise ValueError(f"{fn}: key_rows must be contiguous")
    n = qhi.shape[0] if qhi.dim() == 1 else -1
    for name, t in (("qhi", qhi), ("qlo", qlo)):
        if t.device != dev or t.dtype != torch.int32 or \
                tuple(t.shape) != (n,) or not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be a contiguous 1-D int32 "
                             f"tensor of qhi's length on {dev}")
    if n >= 2**31:
        raise ValueError(f"{fn}: {n} ids do not fit int32")
    return n_rows, W, n


def _scratch_size(n: int, budget: int) -> int:
    """Int32 of an insert's scratch for ``n`` ids and a straggler budget
    of ``budget``: the fast round's proposals and pending flags, the
    pending list, a round's window (ids, codes, proposals), the pending
    count, the rounds run and two counts for each block the straggler
    grid may have (the kernel's ``deeprec_probe_grid_max``)."""
    if "grid_max" not in _fns:
        _fns["grid_max"] = _kernel("deeprec_probe_grid_max")()
    return 3 * n + 3 * budget + 2 + 2 * _fns["grid_max"]


def claim_buffer(capacity: int, device) -> torch.Tensor:
    """A free claim buffer for inserts into a table of ``capacity``
    slots on ``device``."""
    return torch.full((capacity + 1,), _FREE, dtype=torch.int32,
                      device=device)


def _count(name: str):
    with _lock:
        launches[name] += 1


def find(key_rows: torch.Tensor, qhi: torch.Tensor, qlo: torch.Tensor,
         wide_rows: int) -> torch.Tensor:
    """Slots [n] int32 of ids ``(qhi, qlo)`` in the table ``key_rows``
    (``capacity`` where absent or an EMPTY-sentinel id), with a wide
    window of ``wide_rows`` bucket rows."""
    n_rows, W, n = _check_ids("hash_probe.find", key_rows, qhi, qlo)
    if not 1 <= wide_rows <= n_rows:
        raise ValueError(f"hash_probe.find: wide_rows {wide_rows} not in "
                         f"[1, {n_rows}]")
    slots = torch.empty((n,), dtype=torch.int32, device=key_rows.device)
    if n == 0:
        return slots
    fn = _kernel("deeprec_probe_find")
    with torch.cuda.device(key_rows.device):
        stream = torch.cuda.current_stream(key_rows.device).cuda_stream
        rc = fn(key_rows.data_ptr(), n_rows, W, qhi.data_ptr(),
                qlo.data_ptr(), n, wide_rows, slots.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"hash_probe.find: kernel launch failed, "
                           f"cudaError {rc}")
    _count("find")
    return slots


def find_or_insert(key_rows: torch.Tensor, qhi: torch.Tensor,
                   qlo: torch.Tensor, insert_mask: torch.Tensor,
                   claim: torch.Tensor, wide_rows: int, budget: int,
                   max_rounds: int):
    """``(slots [n] int32, is_new [n] bool)``; inserts the absent ids
    with ``insert_mask`` into ``key_rows`` in place. ``claim``: the
    table's claim buffer; ``budget``: ids a straggler round takes;
    ``max_rounds``: rounds at most, the fast round included. While
    tracing is on, the rounds run go to the counters ``probe_rounds``
    and ``probe_rounds_max``."""
    n_rows, W, n = _check_ids("hash_probe.find_or_insert", key_rows, qhi,
                              qlo)
    dev = key_rows.device
    if insert_mask.device != dev or insert_mask.dtype != torch.bool or \
            tuple(insert_mask.shape) != (n,) or \
            not insert_mask.is_contiguous():
        raise ValueError("hash_probe.find_or_insert: insert_mask must be a "
                         f"contiguous 1-D bool tensor of qhi's length on "
                         f"{dev}")
    if not 1 <= wide_rows <= n_rows:
        raise ValueError(f"hash_probe.find_or_insert: wide_rows {wide_rows} "
                         f"not in [1, {n_rows}]")
    if claim.device != dev or claim.dtype != torch.int32 or \
            tuple(claim.shape) != (n_rows * W + 1,) or \
            not claim.is_contiguous():
        raise ValueError("hash_probe.find_or_insert: claim must be a "
                         "contiguous [capacity + 1] int32 tensor on "
                         f"{dev}")
    slots = torch.empty((n,), dtype=torch.int32, device=dev)
    is_new = torch.empty((n,), dtype=torch.bool, device=dev)
    if n == 0:
        return slots, is_new
    if not 1 <= budget <= n:
        raise ValueError(f"hash_probe.find_or_insert: budget {budget} not "
                         f"in [1, {n}]")
    scratch = torch.empty((_scratch_size(n, budget),), dtype=torch.int32,
                          device=dev)
    fn = _kernel("deeprec_probe_insert")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(key_rows.data_ptr(), n_rows, W, qhi.data_ptr(),
                qlo.data_ptr(), insert_mask.data_ptr(), n, wide_rows, budget,
                max_rounds, claim.data_ptr(), slots.data_ptr(),
                is_new.data_ptr(), scratch.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"hash_probe.find_or_insert: kernel launch "
                           f"failed, cudaError {rc}")
    if trace.on():
        count_rounds(scratch[3 * n + 3 * budget + 1])
    _count("find_or_insert")
    return slots, is_new


def count_rounds(rounds) -> None:
    """Add an insert's rounds (an int or a 0-dim tensor) into the
    counters ``probe_rounds`` and ``probe_rounds_max``."""
    trace.count("probe_rounds", rounds)
    trace.count("probe_rounds_max", rounds, reduce="max")
