"""Post-training low precision for serving: bf16 and int8.

Port of ``deeprec_tpu/tools/low_precision.py``:

  * dense kernels -> bf16 (no calibration) or per-output-channel
    symmetric int8 (:func:`quantize_dense_int8`);
  * embedding tables quantize per row to int8 with a float32 scale
    column (:func:`quantize_ev_state`): ``dim + 4`` bytes a row instead
    of ``4 * dim``; :func:`gather_quantized` dequantizes the gathered
    rows only, never the table;
  * :class:`Calibrator` (activation ranges) and :func:`accuracy_delta`
    (the accuracy gate between two models).

The int8 ``q`` and the float32 ``scale`` equal the JAX package's bit for
bit: the scale is ``max(amax, 1e-12) / 127`` in float32 and ``q`` rounds
``w / scale`` half to even, clipped to [-127, 127]. Params are a state
dict (or any nest of dicts, lists and tuples of tensors).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from deeprec_tpu_torch.embedding import variable as ev


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(
            tree, (QuantizedTensor, QuantizedEVValues)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _is_kernel(x, min_ndim: int) -> bool:
    return (isinstance(x, torch.Tensor) and x.dim() >= min_ndim
            and x.is_floating_point())


# ---------------------------------------------------------------------------
# Dense params
# ---------------------------------------------------------------------------

def to_bf16(params, min_ndim: int = 2):
    """Cast dense kernels (``ndim >= min_ndim``) to bfloat16; biases and
    scalars stay float32."""
    return _tree_map(lambda x: x.to(torch.bfloat16)
                     if _is_kernel(x, min_ndim) else x, params)


class QuantizedTensor(NamedTuple):
    """Symmetric per-channel int8: ``w ~= q * scale``."""

    q: torch.Tensor       # int8, original shape
    scale: torch.Tensor   # float32, shape broadcastable to q

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        return self.q.to(dtype) * self.scale.to(dtype)


def _scale_of(amax: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(amax.to(torch.float32), 1e-12) / 127.0


def _quantize(w: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)


def quantize_tensor_int8(w: torch.Tensor, axis: int = -1) -> QuantizedTensor:
    """Per-channel (along ``axis``) symmetric int8 quantization."""
    keep = axis % w.dim()
    dims = tuple(a for a in range(w.dim()) if a != keep)
    amax = torch.amax(w.abs(), dim=dims, keepdim=True) if dims else w.abs()
    scale = _scale_of(amax)
    return QuantizedTensor(q=_quantize(w, scale), scale=scale)


def quantize_dense_int8(params, min_ndim: int = 2):
    """Every kernel leaf (``ndim >= min_ndim``) as a
    :class:`QuantizedTensor`; other leaves pass through."""
    return _tree_map(lambda x: quantize_tensor_int8(x)
                     if _is_kernel(x, min_ndim) else x, params)


def dequantize_dense(qparams, dtype=torch.float32):
    return _tree_map(lambda x: x.dequantize(dtype)
                     if isinstance(x, QuantizedTensor) else x, qparams)


# ---------------------------------------------------------------------------
# Embedding tables
# ---------------------------------------------------------------------------

class QuantizedEVValues(NamedTuple):
    """Per-row int8 value matrix: ``values[i] ~= q[i] * scale[i]``."""

    q: torch.Tensor      # [C+1, dim] int8
    scale: torch.Tensor  # [C+1, 1] float32

    def nbytes(self) -> int:
        return (self.q.numel() * self.q.element_size()
                + self.scale.numel() * self.scale.element_size())


def quantize_ev_values(values: torch.Tensor) -> QuantizedEVValues:
    scale = _scale_of(torch.amax(values.abs(), dim=1, keepdim=True))
    return QuantizedEVValues(q=_quantize(values, scale), scale=scale)


def quantize_ev_state(state: ev.EVState) -> ev.EVState:
    """A serving-side table whose ``values`` is a
    :class:`QuantizedEVValues`; read it with :func:`gather_quantized`."""
    return dataclasses.replace(state,
                               values=quantize_ev_values(state.values))


def gather_quantized(qv: QuantizedEVValues, idx,
                     dtype=torch.float32) -> torch.Tensor:
    """``q[idx] * scale[idx]``: the dequantization runs on the gathered
    ``[n, dim]`` block only."""
    return qv.q[idx].to(dtype) * qv.scale[idx].to(dtype)


# ---------------------------------------------------------------------------
# Calibration
# ---------------------------------------------------------------------------

def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


class Calibrator:
    """Running abs-max activation ranges: feed named activations batch by
    batch; :meth:`scales` gives symmetric int8 scales (with
    ``percentile``, that percentile of the observed magnitudes)."""

    def __init__(self, percentile: Optional[float] = None):
        self._amax: Dict[str, float] = {}
        self._samples: Dict[str, list] = {}
        self._pct = percentile

    def observe(self, name: str, x):
        a = np.abs(_numpy(x))
        if self._pct is not None:
            self._samples.setdefault(name, []).append(a.reshape(-1))
        self._amax[name] = max(self._amax.get(name, 0.0), float(a.max()))

    def scales(self) -> Dict[str, float]:
        out = {}
        for name, amax in self._amax.items():
            if self._pct is not None and name in self._samples:
                cat = np.concatenate(self._samples[name])
                amax = float(np.percentile(cat, self._pct))
            out[name] = max(amax, 1e-12) / 127.0
        return out


def accuracy_delta(predict_fp32: Callable, predict_lp: Callable,
                   batches, metric: Callable) -> Dict[str, float]:
    """Both models over ``batches`` (each with a ``label``):
    ``{'fp32': m, 'lp': m, 'delta': lp - fp32}``."""
    outs_a, outs_b, labels = [], [], []
    for b in batches:
        outs_a.append(_numpy(predict_fp32(b)))
        outs_b.append(_numpy(predict_lp(b)))
        labels.append(_numpy(b["label"]))
    a = metric(np.concatenate(labels), np.concatenate(outs_a))
    b_ = metric(np.concatenate(labels), np.concatenate(outs_b))
    return {"fp32": float(a), "lp": float(b_), "delta": float(b_ - a)}
