"""``wdl_criteo`` on the port: the columns, the towers and the FLOPs.

The columns are the source's 26 Criteo columns at their embedding dims,
each with its wide weight as channel 0 of its row (dim + 1), as
EmbeddingVariable tables of a power-of-two capacity (the port's
``capacity_for`` rule: 1.3x the hash buckets, 2.2x at or under 65,536
buckets, at most ``capacity_ceiling``) that declare their bucket count,
and the 13 numeric columns; the towers are the port's ``models.wdl.WDL``.
"""

from __future__ import annotations

import torch

from deeprec_tpu_torch import config as cfglib
from deeprec_tpu_torch.data.criteo import capacity_for
from deeprec_tpu_torch.feature_column.feature_column import (EmbeddingColumn,
                                                             NumericColumn)
from deeprec_tpu_torch.models import wdl


def columns(cfg):
    t = cfg["table"]
    evo = cfglib.EmbeddingVariableOption(record_freq=t["record_freq"],
                                         record_version=t["record_version"])
    cols = [NumericColumn(f"I{i + 1}") for i in range(cfg["num_int_features"])]
    for i, (b, d) in enumerate(zip(cfg["hash_bucket_sizes"],
                                   cfg["embedding_dims"])):
        head = t["headroom_small"] if b <= t["small_bucket_limit"] \
            else t["headroom"]
        cols.append(EmbeddingColumn(
            name=f"C{i + 1}", dim=d + 1,
            capacity=capacity_for(b, ceiling=t["capacity_ceiling"],
                                  headroom=head),
            combiner=cfg["combiner"], initializer=cfg["initializer"],
            ev_option=evo, num_buckets=b))
    return cols


def towers(cfg, group, device):
    module = wdl.WDL(wdl.input_width(group),
                     hidden=tuple(cfg["dnn_hidden_units"]),
                     dtype=getattr(torch, cfg["compute_dtype"]),
                     device=device)
    return module, wdl.apply_fn(module, group)


def vocab(cfg):
    """Row count of each column's id space, in column order."""
    return cfg["hash_bucket_sizes"]


def macs_per_sample(cfg) -> int:
    """Multiply-adds a sample of the dense layers: the deep tower over
    the deep embeddings and numeric features, and the logit layer."""
    widths = ([sum(cfg["embedding_dims"]) + cfg["num_int_features"]]
              + list(cfg["dnn_hidden_units"]) + [1])
    return sum(a * b for a, b in zip(widths, widths[1:]))
