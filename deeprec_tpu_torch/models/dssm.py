"""DSSM two-tower retrieval, port of ``deeprec_tpu/models/dssm.py``.

User tower: the user id and the behavior sequence's mean; item tower:
item id and category. Trained with in-batch softmax negatives.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from deeprec_tpu_torch.feature_column.feature_column import EmbeddingGroup
from deeprec_tpu_torch.layers.core import MLP
from deeprec_tpu_torch.models.din import (apply_fn, behavior_columns,
                                          embedding_dim, masked_mean)
from deeprec_tpu_torch.train.losses import softmax_ce_in_batch

__all__ = ["DSSM", "behavior_columns", "apply_fn", "dssm_loss", "make"]


class DSSM(nn.Module):
    """Returns ``(user_vec [B, tower[-1]], item_vec)`` in float32."""

    def __init__(self, dim: int, tower: Sequence[int] = (256, 128, 32),
                 dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        self.user_tower = MLP(2 * dim, tower, dtype=dtype, device=device)
        self.item_tower = MLP(2 * dim, tower, dtype=dtype, device=device)

    def forward(self, embs, numeric=None):
        seq_i, mask = embs["seq_items"]
        u_in = torch.cat([embs["user"], masked_mean(seq_i, mask)], dim=1)
        i_in = torch.cat([embs["item"], embs["cat"]], dim=1)
        return (self.user_tower(u_in).to(torch.float32),
                self.item_tower(i_in).to(torch.float32))


def make(group: EmbeddingGroup, **kw) -> DSSM:
    return DSSM(embedding_dim(group), **kw)


def dssm_loss(out, batch, temperature: float = 0.2):
    user_vec, item_vec = out
    return softmax_ce_in_batch(user_vec, item_vec, temperature)
