"""DIN (Deep Interest Network), port of ``deeprec_tpu/models/din.py``.

The candidate's item and category embeddings attend over the user's
behavior sequence (candidate and sequence share the item and category
tables), then [user, candidate, attended, sequence mean, candidate *
attended] -> MLP -> logit.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from deeprec_tpu_torch import config as cfglib
from deeprec_tpu_torch.feature_column.feature_column import (
    EmbeddingColumn, EmbeddingGroup, SequenceEmbeddingColumn)
from deeprec_tpu_torch.layers.core import MLP, DINAttention, LogitsHead


def behavior_columns(embedding_dim: int = 16, capacity: int = 1 << 15,
                     ev_option=None, num_items=None, num_cats=None,
                     num_users=None):
    """``user``; ``item`` and ``cat`` bags and the ``seq_items`` and
    ``seq_cats`` sequences, sharing the ``item_emb`` and ``cat_emb``
    tables. ``num_items/num_cats/num_users`` declare bounded id spaces
    (``EmbeddingColumn.num_buckets``), which bound each step's unique
    ids."""
    ev_option = ev_option or cfglib.EmbeddingVariableOption()
    kw = dict(dim=embedding_dim, capacity=capacity, ev_option=ev_option)
    return [
        EmbeddingColumn(name="user", num_buckets=num_users, **kw),
        EmbeddingColumn(name="item", shared_name="item_emb",
                        combiner="sum", num_buckets=num_items, **kw),
        EmbeddingColumn(name="cat", shared_name="cat_emb",
                        combiner="sum", num_buckets=num_cats, **kw),
        SequenceEmbeddingColumn(name="seq_items", shared_name="item_emb",
                                num_buckets=num_items, **kw),
        SequenceEmbeddingColumn(name="seq_cats", shared_name="cat_emb",
                                num_buckets=num_cats, **kw),
    ]


def embedding_dim(group: EmbeddingGroup) -> int:
    """The behavior columns' common width (user, item, cat)."""
    dims = {c.dim for c in group.embedding}
    if len(dims) != 1:
        raise ValueError(f"behavior columns of several widths {dims}")
    return dims.pop()


def candidate_and_sequence(embs):
    """(user [B, D], candidate [B, 2D], sequence [B, T, 2D], mask [B, T])
    of a behavior embedding dict."""
    cand = torch.cat([embs["item"], embs["cat"]], dim=1)
    seq_i, mask = embs["seq_items"]
    seq_c, _ = embs["seq_cats"]
    return embs["user"], cand, torch.cat([seq_i, seq_c], dim=-1), mask


def masked_mean(seq, mask):
    """Mean over the real positions of ``seq`` [B, T, W] (rows already
    zero at padding), at least one position counted."""
    cnt = torch.clamp(mask.sum(dim=1, keepdim=True), min=1)
    return seq.sum(dim=1) / cnt.to(seq.dtype)


class DIN(nn.Module):
    def __init__(self, dim: int, hidden: Sequence[int] = (200, 80),
                 att_hidden: Sequence[int] = (80, 40),
                 dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        self.att = DINAttention(2 * dim, hidden=att_hidden, dtype=dtype,
                                device=device)
        self.mlp = MLP(9 * dim, hidden, dtype=dtype, device=device)
        self.head = LogitsHead(hidden[-1], device=device)

    def forward(self, embs, numeric=None):
        user, cand, seq, mask = candidate_and_sequence(embs)
        att = self.att(cand, seq, mask)
        x = torch.cat([user, cand, att, masked_mean(seq, mask), cand * att],
                      dim=1)
        return self.head(F.relu(self.mlp(x)))


def make(group: EmbeddingGroup, **kw) -> DIN:
    return DIN(embedding_dim(group), **kw)


def apply_fn(module, group: EmbeddingGroup):
    """``fn(params, embs, batch) -> the module's output``."""
    def fn(params, embs, batch):
        return torch.func.functional_call(module, params, (embs,))
    return fn
