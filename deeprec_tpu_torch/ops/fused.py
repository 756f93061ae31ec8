"""Fused elementwise and reduction ops of the reference's kernel set.

Port of ``deeprec_tpu/ops/fused.py``, in plain PyTorch (the JAX package
has no Pallas kernel here; nothing on the training or serving path
calls these):

* ``fused_l2_normalize``: FusedL2Normalize / FusedL2NormalizeGrad
  (``core/kernels/fused_l2_normalize/``), an ``autograd.Function``
  whose backward is the JAX package's VJP: y-aware, with no recompute
  of the norm;
* ``sparse_segment_sum``, ``_mean`` and ``_sqrtn``
  (``core/kernels/segment_reduction_ali_ops.cc``): a gather and a
  segment reduction; empty segments give zeros, and segment ids out of
  ``[0, num_segments)`` are dropped, as ``jax.ops.segment_sum`` drops
  them;
* ``unique_ids``: the device-side static-size dedup, re-exported from
  ``embedding.lookup``.
"""

from __future__ import annotations

import torch

from deeprec_tpu_torch.embedding.lookup import dedup as unique_ids  # re-export


class _L2Normalize(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis: int, epsilon: float):
        sq = torch.sum(torch.square(x), dim=axis, keepdim=True)
        inv = torch.rsqrt(torch.clamp(sq, min=epsilon))
        y = x * inv
        ctx.axis = axis
        ctx.save_for_backward(y, inv)
        return y

    @staticmethod
    def backward(ctx, g):
        # dL/dx = inv * (g - y * sum(g * y, axis))  (FusedL2NormalizeGrad)
        y, inv = ctx.saved_tensors
        proj = torch.sum(g * y, dim=ctx.axis, keepdim=True)
        return inv * (g - y * proj), None, None


def fused_l2_normalize(x, axis: int = -1, epsilon: float = 1e-12):
    """``y = x / sqrt(max(sum(x^2, axis), epsilon))``: FusedL2Normalize."""
    return _L2Normalize.apply(x, axis, epsilon)


def sparse_segment_sum(data, indices, segment_ids, num_segments: int):
    """``out[s] = sum over i with segment_ids[i] == s of
    data[indices[i]]``, ``[num_segments, ...]``."""
    rows = data[indices]
    ok = (segment_ids >= 0) & (segment_ids < num_segments)
    seg = torch.where(ok, segment_ids, num_segments).to(torch.int64)
    out = torch.zeros((num_segments + 1,) + tuple(rows.shape[1:]),
                      dtype=rows.dtype, device=rows.device)
    return out.index_add(0, seg, rows)[:num_segments]


def _segment_counts(segment_ids, num_segments: int, like):
    ones = torch.ones(segment_ids.shape, dtype=like.dtype,
                      device=like.device)
    cnt = sparse_segment_sum(ones, torch.arange(ones.shape[0],
                                                device=ones.device),
                             segment_ids, num_segments)
    return torch.clamp(cnt, min=1).reshape((-1,) + (1,) * (like.dim() - 1))


def sparse_segment_mean(data, indices, segment_ids, num_segments: int):
    s = sparse_segment_sum(data, indices, segment_ids, num_segments)
    return s / _segment_counts(segment_ids, num_segments, s)


def sparse_segment_sqrtn(data, indices, segment_ids, num_segments: int):
    s = sparse_segment_sum(data, indices, segment_ids, num_segments)
    return s * torch.rsqrt(_segment_counts(segment_ids, num_segments, s))
