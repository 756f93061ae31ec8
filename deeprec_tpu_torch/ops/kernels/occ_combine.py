"""The embedding combine of one physical table and its gradient.

The port's own kernels, with no Pallas counterpart: the JAX package
leaves the occurrence gather ``rows[inverse] * mask`` and each column's
bag reduce to XLA, and their gradient to autodiff's scatter-add. Here
one :class:`torch.autograd.Function` a table computes every column's
output from the table's rows in one launch, and its backward sums the
occurrences' gradients into the rows as a deterministic, load-balanced
segmented sum. The CUDA kernels are ``csrc/occ_combine.cu``; its header
says what bounds them and how they are laid out.

A column is a :class:`Column`: its ``width`` (positions of the table's
concatenated ``[B, L]`` inverse and mask), whether it is a
``sequence`` column (one output row a position, ``[B, width, dim]``,
zero at padding) or a bag (``[B, dim]``, reduced by its ``combiner``:
sum, mean or sqrtn, over its optional ``[B, width]`` weights).

:func:`occ_combine` launches the kernels for CUDA tensors and raises on
what they do not take; for CPU tensors it runs
:func:`occ_combine_reference`, the plain PyTorch version (the
expressions the group's combine ran before, differentiated by autograd),
which the tests and ``chip_smoke.py`` hold the kernels against.
``launches`` counts kernel launches, forward and backward.

Rows are float32: the training paths hand the combine the rows of a
lookup, and the sparse optimizers (K2, K3) take float32 tables only, so
no other row dtype reaches it on the card.

The backward sorts the forward's sort keys (each occurrence's row) with
a stable ``torch.sort``, so each row's occurrences stay in occurrence
order, and sums them from zero, one running float32 sum an element: the
order of autograd's sorted scatter-add, which the plain version runs.
A row with more than
:data:`CHUNK` real occurrences is split off the warps that take the
short rows and summed by blocks of its own, a 32-element slice each.
While tracing is on (``utils/trace.py``) a call counts those rows as
``<table>/grad_split_rows``: how often the load balancing engages. The
kernels count them in the backward; the plain version counts the same
rows from the same inputs (:func:`split_rows_reference`) when it runs.
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, NamedTuple, Optional, Sequence

import torch
from torch.autograd.function import once_differentiable

from deeprec_tpu_torch.embedding import lookup as lkup
from deeprec_tpu_torch.ops.kernels import build
from deeprec_tpu_torch.utils import trace

launches = 0
_count_lock = threading.Lock()
_fns: dict = {}

# Occurrences of a row that one warp of the backward sums; a row with
# more is split off (``kChunk`` of csrc/occ_combine.cu).
CHUNK = 32
# Columns a table may have on the card (``kMaxCols``).
MAX_COLS = 64
_COMBINERS = {"sum": 0, "mean": 1, "sqrtn": 2}

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_ARGTYPES = {
    "deeprec_occ_combine_forward": [_P, _I64, _I64, _P, _P, _I64, _I64, _P,
                                    _I64, _P, _P, _P, _P],
    "deeprec_occ_combine_backward": [_P, _P, _P, _I64, _I64, _I64, _I64, _P,
                                     _I64, _P, _P, _P, _P, _P],
    "deeprec_occ_backward_scratch_bytes": [_I64, _I64],
}


class Column(NamedTuple):
    width: int
    sequence: bool = False
    combiner: str = "sum"


def occ_combine_reference(rows: torch.Tensor, inverse: torch.Tensor,
                          mask: torch.Tensor, columns: Sequence[Column],
                          weights: Sequence[Optional[torch.Tensor]]
                          ) -> List[torch.Tensor]:
    """Each column's output from ``rows [U + 1, dim]`` at the table's
    occurrences ``inverse [B, L]`` (``mask [B, L]``: the real ones):
    one gather of every occurrence, sliced by column, a bag reduced by
    ``lookup.combine_from_occ``."""
    occ = rows[inverse] * mask[..., None].to(rows.dtype)
    out, off = [], 0
    for col, w in zip(columns, weights):
        seg = occ[:, off:off + col.width]
        if col.sequence:
            out.append(seg)
        else:
            out.append(lkup.combine_from_occ(
                seg, mask[:, off:off + col.width], col.combiner, weights=w))
        off += col.width
    return out


def split_rows_reference(inverse: torch.Tensor, mask: torch.Tensor,
                         n_rows: int, chunk: int = CHUNK) -> torch.Tensor:
    """The rows of ``[0, n_rows)`` (indices clamped into it) with more
    than ``chunk`` real occurrences: a 0-dim int64."""
    rows = inverse.reshape(-1)[mask.reshape(-1)].clamp(0, n_rows - 1)
    counts = torch.bincount(rows, minlength=n_rows)
    return (counts > chunk).sum().to(torch.int64)


def _kernel(symbol: str):
    if symbol not in _fns:
        fn = getattr(build.load_library("occ_combine"), symbol)
        fn.argtypes = _ARGTYPES[symbol]
        fn.restype = (ctypes.c_int64 if symbol.endswith("_bytes")
                      else ctypes.c_int)
        _fns[symbol] = fn
    return _fns[symbol]


def _desc(columns, datas, weights) -> ctypes.Array:
    """The kernels' column table: 8 int64 a column (data pointer, weights
    pointer, batch-row and position strides, first position, width,
    kind, combiner)."""
    vals, off = [], 0
    for col, d, w in zip(columns, datas, weights):
        if d is None:
            s0 = s1 = 0
        else:
            s0 = d.stride(0)
            s1 = d.stride(1) if col.sequence else 0
        vals += [0 if d is None else d.data_ptr(),
                 0 if w is None else w.data_ptr(), s0, s1, off, col.width,
                 int(col.sequence), _COMBINERS[col.combiner]]
        off += col.width
    return (ctypes.c_int64 * len(vals))(*vals)


def _launch(symbol, *args):
    global launches
    n = ctypes.c_int64(0)
    rc = _kernel(symbol)(*args[:-1], ctypes.byref(n), args[-1])
    if rc != 0:
        raise RuntimeError(f"occ_combine: kernel launch failed, "
                           f"cudaError {rc}")
    with _count_lock:
        launches += n.value


def _row_view(g: torch.Tensor) -> torch.Tensor:
    """A column's gradient as the kernels read it: elements of a row
    adjacent (any batch-row and position strides)."""
    return g if g.stride(-1) == 1 else g.contiguous()


class _OccCombine(torch.autograd.Function):
    """Forward: every column's output of one table in one launch.
    Backward: the rows' gradient, reading each column's output gradient
    as autograd hands it over (None: that column adds nothing)."""

    @staticmethod
    def forward(ctx, rows, inverse, mask, columns, table, *weights):
        B, L = inverse.shape
        U1, dim = rows.shape
        dev = rows.device
        outs = [torch.empty((B, c.width, dim) if c.sequence else (B, dim),
                            dtype=torch.float32, device=dev)
                for c in columns]
        scale = torch.empty(B * L, dtype=torch.float32, device=dev)
        keys = torch.empty(B * L, dtype=torch.int32, device=dev)
        desc = _desc(columns, outs, weights)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            _launch("deeprec_occ_combine_forward", rows.data_ptr(), U1 - 1,
                    dim, inverse.data_ptr(), mask.data_ptr(), B, L, desc,
                    len(columns), scale.data_ptr(), keys.data_ptr(), stream)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(keys, scale)
        ctx.columns, ctx.table, ctx.shape = columns, table, (B, L, U1, dim)
        ctx.n_weights = len(weights)
        return tuple(outs)

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        keys, scale = ctx.saved_tensors
        B, L, U1, dim = ctx.shape
        dev = keys.device
        gs = [None if g is None else _row_view(g) for g in grads]
        # The CSR order: each row's occurrences, in occurrence order.
        sorted_keys, sorted_occ = torch.sort(keys, stable=True)
        grad = torch.empty((U1, dim), dtype=torch.float32, device=dev)
        n_scratch = _kernel("deeprec_occ_backward_scratch_bytes")(B * L,
                                                                 U1 - 1)
        scratch = torch.empty(n_scratch, dtype=torch.uint8, device=dev)
        split = (torch.zeros((), dtype=torch.int64, device=dev)
                 if trace.on() else None)
        desc = _desc(ctx.columns, gs, [None] * len(gs))
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            _launch("deeprec_occ_combine_backward", sorted_keys.data_ptr(),
                    sorted_occ.data_ptr(), scale.data_ptr(), B, L, U1 - 1, dim,
                    desc, len(ctx.columns), grad.data_ptr(),
                    scratch.data_ptr(),
                    None if split is None else split.data_ptr(), stream)
        if split is not None:
            trace.count("grad_split_rows", split, table=ctx.table)
        return (grad, None, None, None, None) + (None,) * ctx.n_weights


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"occ_combine: {name} on {t.device}, rows on "
                         f"{device}")
    if t.dtype != dtype:
        raise TypeError(f"occ_combine: {name} must be {dtype}, got "
                        f"{t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"occ_combine: {name} must be {tuple(shape)}, got "
                         f"{tuple(t.shape)}")


def occ_combine(rows: torch.Tensor, inverse: torch.Tensor,
                mask: torch.Tensor, columns: Sequence[Column],
                weights: Sequence[Optional[torch.Tensor]],
                table: Optional[str] = None) -> List[torch.Tensor]:
    """Each column's output, differentiable in ``rows``: a bag's
    ``[B, dim]``, a sequence column's ``[B, width, dim]``. ``inverse``
    (int64 in ``[0, U]``) and ``mask`` are the table's ``[B, L]``, its
    columns' positions side by side in ``columns``' order; ``weights``
    holds each column's ``[B, width]`` weights or None. ``table`` names
    the counter ``<table>/grad_split_rows``."""
    columns = [Column(*c) for c in columns]
    weights = list(weights)
    if len(weights) != len(columns):
        raise ValueError("occ_combine: one weights entry a column")
    if rows.device.type == "cpu":
        if trace.on() and table is not None:
            trace.count("grad_split_rows", split_rows_reference(
                inverse, mask, rows.shape[0]), table=table)
        return occ_combine_reference(rows, inverse, mask, columns, weights)
    if rows.device.type != "cuda":
        raise ValueError(f"occ_combine: no kernel for {rows.device}")
    dev = rows.device
    if rows.dtype != torch.float32:
        raise TypeError(f"occ_combine: rows must be float32, got "
                        f"{rows.dtype}")
    if rows.dim() != 2 or rows.shape[0] < 1 or rows.shape[1] < 1:
        raise ValueError(f"occ_combine: rows must be [U + 1, dim], got "
                         f"{tuple(rows.shape)}")
    if inverse.dim() != 2:
        raise ValueError(f"occ_combine: inverse must be [B, L], got "
                         f"{tuple(inverse.shape)}")
    B, L = inverse.shape
    if len(columns) > MAX_COLS:
        raise ValueError(f"occ_combine: {len(columns)} columns in one table, "
                         f"the kernels take at most {MAX_COLS}")
    if sum(c.width for c in columns) != L:
        raise ValueError(f"occ_combine: column widths add up to "
                         f"{sum(c.width for c in columns)}, inverse has {L}")
    if B * L >= 2**31 - 1 or rows.shape[0] >= 2**31 - 2:
        raise ValueError("occ_combine: more than 2**31 occurrences or rows")
    for c in columns:
        if c.combiner not in _COMBINERS:
            raise ValueError(f"occ_combine: unknown combiner {c.combiner!r}")
    _check("inverse", inverse, torch.int64, (B, L), dev)
    _check("mask", mask, torch.bool, (B, L), dev)
    rows = rows.contiguous()
    inverse, mask = inverse.contiguous(), mask.contiguous()
    ws = []
    for c, w in zip(columns, weights):
        if w is None or c.sequence:
            ws.append(None)
            continue
        if w.device != dev or tuple(w.shape) != (B, c.width):
            raise ValueError(f"occ_combine: weights must be [{B}, "
                             f"{c.width}] on {dev}, got {tuple(w.shape)} "
                             f"on {w.device}")
        ws.append(w.detach().to(torch.float32).contiguous())
    return list(_OccCombine.apply(rows, inverse, mask, tuple(columns), table,
                                  *ws))
