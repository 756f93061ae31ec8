"""Sparse optimizer row applies: Adagrad (K2) and lazy Adam (K3).

Port of the Pallas TPU kernels ``adagrad_apply_rows`` and
``adam_apply_rows`` in ``deeprec_tpu/ops/pallas/sparse_apply.py``,
extended by the update gate and the fresh-row slot reset that
``SparseAdagrad.apply`` / ``SparseAdam.apply`` wrap around them. The
CUDA kernels are ``csrc/sparse_apply.cu``; its header says what bounds
them and how they are laid out.

Both update ``[C+1, D]`` float32 tables in place at unique ``slots``:
only rows with ``update[i]`` (all rows when None) and ``0 <= slot < C``
change; row ``C``, the table's sentinel row, is never written. Rows
with ``is_new[i]`` start from the initial slot value (``init_acc`` for
Adagrad, zeros for Adam's moments). With ``base_rows`` ([n, D] float32,
the training lookup's rows) an updated row's new weight is computed
from ``base_rows[i]`` instead of ``values[slot]``, as the JAX package's
applies compute it from ``lk.rows``: a dynamic-dimension table's masked
rows, an adaptive table's migrated seeds.

Each wrapper launches its kernel for CUDA tensors and raises on what it
does not take; for CPU tensors it runs the plain PyTorch version
(``*_reference``), which the tests and ``chip_smoke.py`` hold the kernel
against. ``launches`` counts kernel launches of both wrappers by name.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from deeprec_tpu_torch.ops.kernels import build

launches = {"adagrad_apply_rows": 0, "adam_apply_rows": 0}
_count_lock = threading.Lock()
_fns: dict = {}

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_F = ctypes.c_float
_ARGTYPES = {
    "deeprec_adagrad_apply_rows": [_P, _P, _I64, _I64, _P, _P, _I64, _P, _P,
                                   _P, _F, _F, _P],
    "deeprec_adam_apply_rows": [_P, _P, _P, _I64, _I64, _P, _P, _I64, _P, _P,
                                _P, _P, _F, _F, _F, _F, _F, _P],
}


def _kernel(symbol: str):
    if symbol not in _fns:
        fn = getattr(build.load_library("sparse_apply"), symbol)
        fn.argtypes = _ARGTYPES[symbol]
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return _fns[symbol]


def _gated(values, slots, update):
    """(idx, ok): ``idx`` is the slot of each updated row and ``C`` (the
    sentinel row) for every dropped one. Dropped rows write row C's own
    content back, so row C keeps its value whatever order the writes
    land in, and nothing is indexed out of bounds."""
    C = values.shape[0] - 1
    s = slots.to(torch.int64)
    ok = (s >= 0) & (s < C)
    if update is not None:
        ok = ok & update
    return torch.where(ok, s, C), ok


def _fresh(slot_rows, is_new, init_value: float):
    """Slot rows, reset to ``init_value`` where ``is_new``."""
    if is_new is None:
        return slot_rows
    return torch.where(is_new[:, None], torch.full_like(slot_rows, init_value),
                       slot_rows)


def adagrad_apply_rows_reference(values, accum, slots, grads, lr: float, *,
                                 update: Optional[torch.Tensor] = None,
                                 is_new: Optional[torch.Tensor] = None,
                                 init_acc: float = 0.1,
                                 base_rows: Optional[torch.Tensor] = None):
    """Plain version of :func:`adagrad_apply_rows`; the spec is
    ``adagrad_apply_rows_reference`` of the Pallas module plus the gate
    and reset. Updates ``values`` and ``accum`` in place and returns
    them."""
    idx, ok = _gated(values, slots, update)
    keep = ok[:, None]
    g = grads.to(torch.float32)
    acc_old = accum[idx]
    w_old = values[idx]
    acc = _fresh(acc_old, is_new, init_acc) + g * g
    w = _base(w_old, base_rows) - lr * g * torch.rsqrt(acc)
    accum.index_put_((idx,), torch.where(keep, acc, acc_old))
    values.index_put_((idx,), torch.where(keep, w.to(values.dtype), w_old))
    return values, accum


def adam_apply_rows_reference(values, m, v, slots, grads, alpha, beta1: float,
                              beta2: float, eps: float, *,
                              update: Optional[torch.Tensor] = None,
                              is_new: Optional[torch.Tensor] = None,
                              base_rows: Optional[torch.Tensor] = None):
    """Plain version of :func:`adam_apply_rows` (``alpha`` a float or a
    one-element tensor); the spec is ``adam_apply_rows_reference`` of
    the Pallas module plus the gate and reset. In place; returns
    ``(values, m, v)``."""
    idx, ok = _gated(values, slots, update)
    keep = ok[:, None]
    g = grads.to(torch.float32)
    m_old, v_old, w_old = m[idx], v[idx], values[idx]
    mr = beta1 * _fresh(m_old, is_new, 0.0) + (1 - beta1) * g
    vr = beta2 * _fresh(v_old, is_new, 0.0) + (1 - beta2) * g * g
    if isinstance(alpha, torch.Tensor):
        alpha = alpha.reshape(())
    w = _base(w_old, base_rows) - alpha * mr / (torch.sqrt(vr) + eps)
    m.index_put_((idx,), torch.where(keep, mr, m_old))
    v.index_put_((idx,), torch.where(keep, vr, v_old))
    values.index_put_((idx,), torch.where(keep, w.to(values.dtype), w_old))
    return values, m, v


def _base(w_old, base_rows):
    """The rows an apply updates from: ``base_rows`` where given, else
    the table's own rows ``w_old``, as float32."""
    return (w_old if base_rows is None else base_rows).to(torch.float32)


def _check(fn, name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{fn}: {name} on {t.device}, values on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{fn}: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")


def _check_rows(fn, values, tables, slots, grads, update, is_new,
                base_rows):
    """Device, type, shape and contiguity of a CUDA launch's operands."""
    dev = values.device
    if dev.type != "cuda":
        raise ValueError(f"{fn}: no kernel for {dev}")
    if values.dim() != 2 or values.shape[0] < 1 or values.shape[1] < 1:
        raise ValueError(f"{fn}: values must be [C+1, D], got "
                         f"{tuple(values.shape)}")
    shape = tuple(values.shape)
    for name, t in (("values", values),) + tables:
        _check(fn, name, t, torch.float32, shape, dev)
    n = slots.shape[0] if slots.dim() == 1 else -1
    _check(fn, "slots", slots, torch.int32, (n,), dev)
    _check(fn, "grads", grads, torch.float32, (n, shape[1]), dev)
    if base_rows is not None:
        _check(fn, "base_rows", base_rows, torch.float32, (n, shape[1]), dev)
    for name, t in (("update", update), ("is_new", is_new)):
        if t is not None:
            _check(fn, name, t, torch.bool, (n,), dev)
    return n


def _ptr(t):
    return None if t is None else t.data_ptr()


def _count(name):
    with _count_lock:
        launches[name] += 1


def adagrad_apply_rows(values, accum, slots, grads, lr: float, *,
                       update: Optional[torch.Tensor] = None,
                       is_new: Optional[torch.Tensor] = None,
                       init_acc: float = 0.1,
                       base_rows: Optional[torch.Tensor] = None):
    """Sparse Adagrad in place over ``values``/``accum`` [C+1, D]
    float32 at unique ``slots`` [n] int32 with ``grads`` [n, D]:
    ``a = (is_new ? init_acc : accum[s]) + g*g``,
    ``values[s] = w - lr*g*rsqrt(a)``, ``accum[s] = a``, with ``w``
    ``base_rows[i]`` where given, else ``values[s]``. Returns
    ``(values, accum)``."""
    if values.device.type == "cpu":
        return adagrad_apply_rows_reference(
            values, accum, slots, grads, lr, update=update, is_new=is_new,
            init_acc=init_acc, base_rows=base_rows)
    n = _check_rows("adagrad_apply_rows", values, (("accum", accum),), slots,
                    grads, update, is_new, base_rows)
    if n == 0:
        return values, accum
    fn = _kernel("deeprec_adagrad_apply_rows")
    C1, D = values.shape
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        rc = fn(values.data_ptr(), accum.data_ptr(), C1, D, slots.data_ptr(),
                grads.data_ptr(), n, _ptr(update), _ptr(is_new),
                _ptr(base_rows), float(lr), float(init_acc), stream)
    if rc != 0:
        raise RuntimeError(f"adagrad_apply_rows: kernel launch failed, "
                           f"cudaError {rc}")
    _count("adagrad_apply_rows")
    return values, accum


def adam_apply_rows(values, m, v, slots, grads, alpha, beta1: float,
                    beta2: float, eps: float, *,
                    update: Optional[torch.Tensor] = None,
                    is_new: Optional[torch.Tensor] = None,
                    base_rows: Optional[torch.Tensor] = None):
    """Lazy Adam in place over ``values``/``m``/``v`` [C+1, D] float32
    at unique ``slots`` [n] int32 with ``grads`` [n, D]; ``alpha``, the
    bias-corrected step, is a one-element float32 tensor on the device
    (a float on the CPU path); rows update from ``base_rows`` where
    given. Returns ``(values, m, v)``."""
    if values.device.type == "cpu":
        return adam_apply_rows_reference(
            values, m, v, slots, grads, alpha, beta1, beta2, eps,
            update=update, is_new=is_new, base_rows=base_rows)
    n = _check_rows("adam_apply_rows", values, (("m", m), ("v", v)), slots,
                    grads, update, is_new, base_rows)
    if (not isinstance(alpha, torch.Tensor) or alpha.numel() != 1
            or alpha.dtype != torch.float32 or alpha.device != values.device):
        raise TypeError("adam_apply_rows: alpha must be a one-element "
                        "float32 tensor on the values' device")
    if n == 0:
        return values, m, v
    fn = _kernel("deeprec_adam_apply_rows")
    C1, D = values.shape
    alpha = alpha.contiguous()
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        # 1 - beta is rounded from its double value, as the plain
        # version's ``(1 - beta1) * g`` rounds it.
        rc = fn(values.data_ptr(), m.data_ptr(), v.data_ptr(), C1, D,
                slots.data_ptr(), grads.data_ptr(), n, _ptr(update),
                _ptr(is_new), _ptr(base_rows), alpha.data_ptr(), float(beta1),
                float(1 - beta1), float(beta2), float(1 - beta2), float(eps),
                stream)
    if rc != 0:
        raise RuntimeError(f"adam_apply_rows: kernel launch failed, "
                           f"cudaError {rc}")
    _count("adam_apply_rows")
    return values, m, v
