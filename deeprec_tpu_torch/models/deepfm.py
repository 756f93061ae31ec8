"""DeepFM, port of ``deeprec_tpu/models/deepfm.py``.

First-order weights, the FM second-order interaction over the field
embeddings and a DNN, summed into one logit. Parameter names follow
the flax module's (``dnn.dense_i``, ``head.logits``).
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
from deeprec_tpu_torch.layers.core import MLP, LogitsHead, fm_interaction

NUM_INT = 13
NUM_CAT = 26


def criteo_columns(embedding_dim: int = 16, capacity: int = 1 << 16,
                   ev_option: cfglib.EmbeddingVariableOption | None = None,
                   reference_shapes: bool = False,
                   wide_in_deep: bool = False):
    """I1..I13 numeric; per field a ``C{i}`` embedding and a zero-
    initialized 1-wide ``C{i}_wide`` first-order weight, or, with
    ``wide_in_deep``, one ``dim + 1`` column whose channel 0 is that
    weight. ``reference_shapes``: per-column capacities from the
    reference bucket counts, ``capacity`` then a ceiling."""
    ev_option = ev_option or cfglib.EmbeddingVariableOption()
    cols = [NumericColumn(f"I{i}") for i in range(1, NUM_INT + 1)]
    for i in range(1, NUM_CAT + 1):
        cap = (criteo_data.capacity_for(
            criteo_data.CRITEO_HASH_BUCKETS[i - 1], ceiling=capacity)
            if reference_shapes else capacity)
        if wide_in_deep:
            cols.append(EmbeddingColumn(
                name=f"C{i}", dim=embedding_dim + 1, capacity=cap,
                combiner="mean", ev_option=ev_option))
            continue
        cols.append(EmbeddingColumn(
            name=f"C{i}", dim=embedding_dim, capacity=cap,
            combiner="mean", ev_option=ev_option))
        cols.append(EmbeddingColumn(
            name=f"C{i}_wide", dim=1, capacity=cap, combiner="sum",
            initializer="zeros", ev_option=ev_option))
    return cols


def input_width(group: EmbeddingGroup) -> tuple[int, int]:
    """(width of the DNN's input, width of one field's FM embedding)."""
    emb = group.embedding
    if any(c.name.endswith("_wide") for c in emb):
        fields = [c.dim for c in emb if not c.name.endswith("_wide")]
    else:
        fields = [c.dim - 1 for c in emb]
    return sum(fields) + sum(c.shape for c in group.numeric), fields[0]


class DeepFM(nn.Module):
    """embs: dict with ``C*`` (and ``C*_wide``) entries; numeric [B, 13]."""

    def __init__(self, in_features: int, field_dim: int,
                 hidden: Sequence[int] = (1024, 512, 256),
                 dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        self.dnn = MLP(in_features, hidden, dtype=dtype, device=device)
        self.head = LogitsHead(hidden[-1] + field_dim, device=device)

    def forward(self, embs, numeric):
        items = sorted(embs.items())
        field = [v for k, v in items if not k.endswith("_wide")]
        linear = [v for k, v in items if k.endswith("_wide")]
        if not linear:
            # wide_in_deep layout: channel 0 is the first-order weight.
            linear = [v[:, :1] for v in field]
            field = [v[:, 1:] for v in field]
        fe = torch.stack(field, dim=1)                      # [B, F, D]
        fm = fm_interaction(fe)                              # [B, D]
        first_order = torch.cat(linear, dim=1).sum(dim=1)
        x = torch.cat([fe.reshape(fe.shape[0], -1)]
                      + ([numeric] if numeric is not None else []), dim=1)
        deep = F.relu(self.dnn(x))
        logit = self.head(torch.cat([deep, fm.to(deep.dtype)], dim=1))
        return logit + first_order.to(torch.float32)


def make(group: EmbeddingGroup, **kw) -> DeepFM:
    return DeepFM(*input_width(group), **kw)


def apply_fn(module: DeepFM, group: EmbeddingGroup):
    """``fn(params, embs, batch) -> logits [B]``."""
    def fn(params, embs, batch):
        return torch.func.functional_call(
            module, params, (embs, group.numeric_features(batch)))
    return fn
