"""Multi-Hash Variable: compositional (quotient-remainder) embeddings.

Port of ``deeprec_tpu/embedding/multi_hash.py``
(``get_multihash_variable``, ``docs/Multi-Hash-Variable.md``): a large
vocabulary is factored into N small dense tables, and a key's embedding
combines one row of each (add, mult or concat), so memory grows with
``sum(buckets)`` rather than with the vocabulary. The part tables are
ordinary dense parameters ``part_{i}`` that train with the dense
optimizer; there is no hash table and no kernel.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from deeprec_tpu_torch.utils import keys as keylib


def qr_indices(hi, lo, buckets: Sequence[int]):
    """Quotient-remainder index of each part: ``idx_i = (id //
    prod(buckets[:i])) % buckets[i]`` on the uint32 low half of the id
    (int64 tensors), collision-free for ids below ``prod(buckets)``."""
    idxs = []
    acc = lo.to(torch.int64) & 0xFFFFFFFF
    for b in buckets:
        idxs.append(acc % b)
        acc = acc // b
    return idxs


class MultiHashEmbedding(nn.Module):
    """Embeds a padded-dense ``SparseIds`` feature through N
    quotient-remainder part tables, ``part_{i}`` of ``[buckets[i],
    dim]``, drawn from a normal of stddev 0.01. ``operation``: "add",
    "mult" or "concat" (``[B, dim * N]``); the bag is pooled by
    ``combiner`` ("sum", "mean" or "sqrtn") over its real ids."""

    def __init__(self, buckets: Sequence[int], dim: int,
                 operation: str = "add", combiner: str = "mean",
                 dtype: torch.dtype = torch.float32, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if operation not in ("add", "mult", "concat"):
            raise ValueError(f"unknown operation {operation!r}")
        if combiner not in ("sum", "mean", "sqrtn"):
            raise ValueError(f"unknown combiner {combiner!r}")
        self.buckets = tuple(int(b) for b in buckets)
        self.operation = operation
        self.combiner = combiner
        self.dtype = dtype
        for i, b in enumerate(self.buckets):
            part = torch.randn(b, dim, generator=generator) * 0.01
            self.register_parameter(f"part_{i}",
                                    nn.Parameter(part.to(device)))

    def forward(self, ids):
        B, L = ids.hi.shape
        mask = ~((ids.hi == keylib.EMPTY_HI) & (ids.lo == keylib.EMPTY_LO))
        idxs = qr_indices(ids.hi.reshape(-1), ids.lo.reshape(-1),
                          self.buckets)
        parts = [getattr(self, f"part_{i}").to(self.dtype)[idx]
                 for i, idx in enumerate(idxs)]
        if self.operation == "add":
            rows = parts[0]
            for p in parts[1:]:
                rows = rows + p
        elif self.operation == "mult":
            rows = parts[0]
            for p in parts[1:]:
                rows = rows * p
        else:
            rows = torch.cat(parts, dim=-1)
        rows = rows.reshape(B, L, -1) * mask[..., None].to(rows.dtype)
        s = rows.sum(dim=1)
        if self.combiner == "sum":
            return s
        cnt = torch.clamp(mask.sum(dim=1), min=1).to(rows.dtype)
        if self.combiner == "mean":
            return s / cnt[:, None]
        return s / torch.sqrt(cnt)[:, None]
