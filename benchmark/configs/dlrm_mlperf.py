"""``dlrm_mlperf`` on the port: the columns, the towers and the FLOPs.

26 columns of ``arch_sparse_feature_size``, each an EmbeddingVariable
table of a power-of-two capacity of 1.3x its slice of rows (the port's
``capacity_for`` rule), summed bags; the 13 numeric columns; the towers
are the port's ``models.dlrm.DLRM`` with the dot interaction.
"""

from __future__ import annotations

import torch

from deeprec_tpu_torch import config as cfglib
from deeprec_tpu_torch.data.criteo import capacity_for
from deeprec_tpu_torch.feature_column.feature_column import (EmbeddingColumn,
                                                             NumericColumn)
from deeprec_tpu_torch.models import dlrm


def columns(cfg):
    t = cfg["table"]
    evo = cfglib.EmbeddingVariableOption(record_freq=t["record_freq"],
                                         record_version=t["record_version"])
    n_int = cfg["arch_mlp_bot"][0]
    cols = [NumericColumn(f"I{i + 1}") for i in range(n_int)]
    for i, rows in enumerate(cfg["num_embeddings_per_feature"]):
        cols.append(EmbeddingColumn(
            name=f"C{i + 1}", dim=cfg["arch_sparse_feature_size"],
            capacity=capacity_for(rows, headroom=t["headroom"]),
            combiner=cfg["combiner"], initializer=cfg["initializer"],
            ev_option=evo))
    return cols


def towers(cfg, group, device):
    if cfg["arch_interaction_op"] != "dot" or cfg["arch_interaction_itself"]:
        raise ValueError("dlrm_mlperf builds the dot interaction without "
                         "self-interaction only")
    bot, top = cfg["arch_mlp_bot"], cfg["arch_mlp_top"]
    module = dlrm.make(group, embedding_dim=bot[-1], bottom=tuple(bot[1:-1]),
                       top=tuple(top[:-1]),
                       dtype=getattr(torch, cfg["compute_dtype"]),
                       interaction_op="dot", device=device)
    return module, dlrm.apply_fn(module, group)


def vocab(cfg):
    """Row count of each column's id space (this chip's slice)."""
    return cfg["num_embeddings_per_feature"]


def macs_per_sample(cfg) -> int:
    """Multiply-adds a sample: the bottom MLP, the batched product of
    the dot interaction ((F + 1)**2 * D, as it is computed), and the top
    MLP over the bottom output and the F * (F + 1) / 2 pair dots."""
    bot, top = cfg["arch_mlp_bot"], cfg["arch_mlp_top"]
    n_f = len(cfg["num_embeddings_per_feature"]) + 1
    d = cfg["arch_sparse_feature_size"]
    top_w = [bot[-1] + n_f * (n_f - 1) // 2] + list(top)
    return (sum(a * b for a, b in zip(bot, bot[1:])) + n_f * n_f * d
            + sum(a * b for a, b in zip(top_w, top_w[1:])))
