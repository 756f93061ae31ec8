"""BST (Behavior Sequence Transformer), port of
``deeprec_tpu/models/bst.py``: transformer blocks over [behavior
sequence + candidate] with learned position embeddings; [user,
candidate, the candidate position's output, the masked mean] -> MLP ->
logit.

A torch module needs its shapes when it is built, so ``BST`` takes the
sequence length ``seq_len`` (the flax module reads it off its input).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from deeprec_tpu_torch.feature_column.feature_column import EmbeddingGroup
from deeprec_tpu_torch.layers.core import (MLP, LogitsHead, TransformerBlock,
                                           normal)
from deeprec_tpu_torch.models.din import (apply_fn, behavior_columns,
                                          candidate_and_sequence,
                                          embedding_dim, masked_mean)

__all__ = ["BST", "behavior_columns", "apply_fn", "make"]


class BST(nn.Module):
    def __init__(self, dim: int, seq_len: int, num_blocks: int = 1,
                 num_heads: int = 2, hidden: Sequence[int] = (256, 64),
                 dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        self.num_blocks = num_blocks
        self.pos_emb = nn.Parameter(torch.empty((seq_len + 1, 2 * dim),
                                                device=device))
        for i in range(num_blocks):
            self.add_module(f"block_{i}", TransformerBlock(
                2 * dim, num_heads=num_heads, dtype=dtype, device=device))
        self.mlp = MLP(7 * dim, hidden, dtype=dtype, device=device)
        self.head = LogitsHead(hidden[-1], device=device)

    def init_params(self, generator):
        self.pos_emb.copy_(normal(self.pos_emb.shape, 0.02, generator))

    def forward(self, embs, numeric=None):
        user, cand, seq, mask = candidate_and_sequence(embs)
        B = seq.shape[0]
        # The candidate is the sequence's last position.
        x = torch.cat([seq, cand[:, None, :]], dim=1)        # [B, T+1, 2D]
        m = torch.cat([mask, torch.ones((B, 1), dtype=mask.dtype,
                                        device=mask.device)], dim=1)
        x = x + self.pos_emb[None]
        for i in range(self.num_blocks):
            x = getattr(self, f"block_{i}")(x, m)
        h = F.relu(self.mlp(torch.cat(
            [user, cand, x[:, -1, :], masked_mean(x, m)], dim=1)))
        return self.head(h)


def make(group: EmbeddingGroup, **kw) -> BST:
    return BST(embedding_dim(group), **kw)
