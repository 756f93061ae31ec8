"""WDL (Wide & Deep), port of ``deeprec_tpu/models/wdl.py``.

Wide part: per-field dim-1 weights summed into a linear logit; deep
part: MLP over [deep embeddings, numeric] with the reference tower
sizes 1024/512/256. Parameter names follow the flax module's
(``deep.dense_i``, ``head.logits``), so ``convert.wdl_params_from_numpy``
carries its weights across.
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
from deeprec_tpu_torch.layers.core import MLP, LogitsHead

NUM_INT = 13
NUM_CAT = 26


def criteo_columns(
    embedding_dim: int = 16,
    capacity: int = 1 << 16,
    ev_option: cfglib.EmbeddingVariableOption | None = None,
    combiner: str = "mean",
    reference_shapes: bool = False,
    wide_in_deep: bool = False,
    static_buckets: bool = False,
):
    """Criteo-Kaggle column set: I1..I13 numeric, C1..C26 categorical,
    each with a deep embedding and a wide (dim-1) weight.

    ``reference_shapes``: per-column dims (64/128), capacities sized
    from the reference bucket counts (``capacity`` is then a per-column
    ceiling), and those counts declared as ``num_buckets``, which bounds
    each step's unique ids. ``wide_in_deep``: the wide weight rides as
    channel 0 of the deep table (dim+1) instead of a separate dim-1
    table. ``static_buckets``: static hash-bucket columns (the
    reference's default, ``categorical_column_with_hash_bucket``) of
    the reference bucket counts, or of ``capacity`` buckets when not
    reference-shaped.
    """
    ev_option = ev_option or cfglib.EmbeddingVariableOption()
    cols = [NumericColumn(f"I{i}") for i in range(1, NUM_INT + 1)]
    for i in range(1, NUM_CAT + 1):
        if reference_shapes:
            dim = criteo_data.WDL_EMBEDDING_DIMS[i - 1]
            buckets = criteo_data.CRITEO_HASH_BUCKETS[i - 1]
            cap = criteo_data.capacity_for(
                buckets, ceiling=capacity,
                headroom=2.2 if buckets <= (1 << 16) else 1.3)
        else:
            dim, cap, buckets = embedding_dim, capacity, None
        extra = dict(num_buckets=buckets)
        if static_buckets:
            extra = dict(num_buckets=buckets or capacity, static_bucket=True)
        if wide_in_deep:
            cols.append(EmbeddingColumn(
                name=f"C{i}", dim=dim + 1, capacity=cap,
                combiner=combiner, ev_option=ev_option, **extra))
            continue
        cols.append(EmbeddingColumn(
            name=f"C{i}", dim=dim, capacity=cap,
            combiner=combiner, ev_option=ev_option, **extra))
        cols.append(EmbeddingColumn(
            name=f"C{i}_wide", dim=1, capacity=cap, combiner="sum",
            initializer="zeros", ev_option=ev_option, **extra))
    return cols


def input_width(group: EmbeddingGroup) -> int:
    """Width of the deep tower's input for ``group``'s columns."""
    emb = group.embedding
    if any(c.name.endswith("_wide") for c in emb):
        deep = sum(c.dim for c in emb if not c.name.endswith("_wide"))
    else:
        deep = sum(c.dim - 1 for c in emb)
    return deep + sum(c.shape for c in group.numeric)


class WDL(nn.Module):
    """embs: dict with C*/C*_wide entries; numeric [B, 13]."""

    def __init__(self, in_features: int,
                 hidden: Sequence[int] = (1024, 512, 256),
                 dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        self.deep = MLP(in_features, hidden, dtype=dtype, device=device)
        self.head = LogitsHead(hidden[-1], device=device)

    def forward(self, embs, numeric):
        wide = [v for k, v in sorted(embs.items()) if k.endswith("_wide")]
        deep = [v for k, v in sorted(embs.items()) if not k.endswith("_wide")]
        if not wide:
            # wide_in_deep layout: channel 0 is the field's wide weight.
            wide = [v[:, :1] for v in deep]
            deep = [v[:, 1:] for v in deep]
        wide_logit = torch.cat(wide, dim=1).sum(dim=1)
        x = torch.cat(deep + ([numeric] if numeric is not None else []),
                      dim=1)
        h = F.relu(self.deep(x))
        return self.head(h) + wide_logit.to(torch.float32)


def apply_fn(module: WDL, group: EmbeddingGroup):
    """``fn(params, embs, batch) -> logits [B]`` with ``params`` a
    state dict of ``module``."""
    def fn(params, embs, batch):
        return torch.func.functional_call(
            module, params, (embs, group.numeric_features(batch)))
    return fn


def apply_fn_fused(module: WDL, group: EmbeddingGroup):
    """Apply over ``group.combine_tables`` output, for ``wide_in_deep``
    column sets: each table's [B, n_cols, dim] occurrence tensor is split
    into its columns' [B, dim] embeddings, which go through the dict
    path's forward, so the same params give the same outputs, bit for
    bit. Use with ``make_train_step(..., combine_fn=group.combine_tables)``.
    (The JAX package's version gathers one [B, total] matrix through
    index maps instead, which saves XLA the column slices; in eager
    PyTorch the gathers and their accumulating backward cost more than
    the slices they replace.)

    Raises ``ValueError`` for a column set with separate ``*_wide``
    columns, whose channel 0 is not a wide weight. (The JAX package's
    ``apply_fn_fused`` takes such a set and silently reads channel 0 of
    every deep embedding as a wide weight.)"""
    wide_cols = [c.name for c in group.embedding if c.name.endswith("_wide")]
    if wide_cols:
        raise ValueError(
            f"apply_fn_fused needs the wide weight in channel 0 of each "
            f"column (wide_in_deep); this column set has separate wide "
            f"columns {wide_cols[:3]}: use apply_fn")

    def fn(params, tbl_embs, batch):
        embs = {cname: occ[:, j] for occ, cols in tbl_embs.values()
                for j, cname in enumerate(cols)}
        return torch.func.functional_call(
            module, params, (embs, group.numeric_features(batch)))
    return fn
