"""DLRM, port of ``deeprec_tpu/models/dlrm.py``.

A bottom MLP embeds the numeric features to the embedding width; the
pairwise dots over [dense embedding] + field embeddings (``"dot"``), or
the raw embeddings (``"cat"``), feed the top MLP and the logit.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from deeprec_tpu_torch import config as cfglib
from deeprec_tpu_torch.data import criteo as criteo_data
from deeprec_tpu_torch.feature_column.feature_column import (EmbeddingColumn,
                                                             EmbeddingGroup,
                                                             NumericColumn)
from deeprec_tpu_torch.layers.core import MLP, LogitsHead, dot_interaction

NUM_INT = 13
NUM_CAT = 26


def criteo_columns(embedding_dim: int = 16, capacity: int = 1 << 16,
                   ev_option: cfglib.EmbeddingVariableOption | None = None,
                   reference_shapes: bool = False):
    """``reference_shapes``: a uniform 10,000-bucket capacity per column,
    ``capacity`` then a ceiling."""
    ev_option = ev_option or cfglib.EmbeddingVariableOption()
    cap = (criteo_data.capacity_for(10000, ceiling=capacity)
           if reference_shapes else capacity)
    cols = [NumericColumn(f"I{i}") for i in range(1, NUM_INT + 1)]
    cols += [EmbeddingColumn(name=f"C{i}", dim=embedding_dim,
                             capacity=cap, combiner="sum",
                             ev_option=ev_option)
             for i in range(1, NUM_CAT + 1)]
    return cols


def input_width(group: EmbeddingGroup) -> tuple[int, int, int]:
    """(numeric width, number of fields, field width)."""
    return (sum(c.shape for c in group.numeric), len(group.embedding),
            group.embedding[0].dim)


class DLRM(nn.Module):
    """embs: dict of ``C*`` [B, D]; numeric [B, 13]."""

    def __init__(self, num_numeric: int, num_fields: int, field_dim: int,
                 embedding_dim: int = 16,
                 bottom: Sequence[int] = (512, 256),
                 top: Sequence[int] = (1024, 1024, 512, 256),
                 dtype: torch.dtype = torch.float32,
                 interaction_op: str = "dot", device="cuda"):
        super().__init__()
        if interaction_op not in ("dot", "cat"):
            raise ValueError(f"interaction_op {interaction_op!r}: dot | cat")
        self.interaction_op = interaction_op
        self.bot = MLP(num_numeric, tuple(bottom) + (embedding_dim,),
                       dtype=dtype, device=device)
        if interaction_op == "cat":
            top_in = embedding_dim + num_fields * field_dim
        else:
            n = num_fields + 1
            top_in = embedding_dim + n * (n - 1) // 2
        self.top = MLP(top_in, top, dtype=dtype, device=device)
        self.head = LogitsHead(top[-1], device=device)

    def forward(self, embs, numeric):
        dense_emb = F.relu(self.bot(numeric))
        field = [v for _, v in sorted(embs.items())]
        if self.interaction_op == "cat":
            x = torch.cat([dense_emb] + [f.to(dense_emb.dtype)
                                         for f in field], dim=1)
        else:
            fe = torch.stack([dense_emb.to(field[0].dtype)] + field, dim=1)
            z = dot_interaction(fe)                        # [B, F*(F+1)/2]
            x = torch.cat([dense_emb, z.to(dense_emb.dtype)], dim=1)
        return self.head(F.relu(self.top(x)))


def make(group: EmbeddingGroup, **kw) -> DLRM:
    return DLRM(*input_width(group), **kw)


def apply_fn(module: DLRM, group: EmbeddingGroup):
    """``fn(params, embs, batch) -> logits [B]``."""
    def fn(params, embs, batch):
        return torch.func.functional_call(
            module, params, (embs, group.numeric_features(batch)))
    return fn
