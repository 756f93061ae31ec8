"""``toy_seq`` on the port: a test configuration of the harness's
column forms (a bag of one id, a table shared by a bag and a sequence,
a mean bag of several ids with padding) over behavior traffic.

Columns: ``user`` (a bag of one id), ``item`` (a summed bag of one id)
and ``seq_items`` (a sequence) sharing the table ``item_emb``, and
``recent_cats`` (the mean of the history's first ``recent_cats``
categories, EMPTY past the history's length), all of
``embedding_dim``. Towers: the user, item, masked history mean and
recent-category rows through the port's ``MLP`` (``dnn_hidden_units``,
ReLU) and ``LogitsHead``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.behavior import BehaviorStream
from deeprec_tpu_torch import config as cfglib
from deeprec_tpu_torch.feature_column.feature_column import (
    EmbeddingColumn, SequenceEmbeddingColumn)
from deeprec_tpu_torch.layers.core import MLP, LogitsHead
from deeprec_tpu_torch.models.din import masked_mean


def columns(cfg):
    t = cfg["table"]
    kw = dict(dim=cfg["embedding_dim"], capacity=cfg["capacity"],
              ev_option=cfglib.EmbeddingVariableOption(
                  record_freq=t["record_freq"],
                  record_version=t["record_version"]))
    return [EmbeddingColumn(name="user", **kw),
            EmbeddingColumn(name="item", shared_name="item_emb",
                            combiner="sum", **kw),
            SequenceEmbeddingColumn(name="seq_items", shared_name="item_emb",
                                    **kw),
            EmbeddingColumn(name="recent_cats", combiner="mean", **kw)]


class Towers(nn.Module):
    def __init__(self, dim, hidden, device):
        super().__init__()
        self.mlp = MLP(4 * dim, hidden, device=device)
        self.head = LogitsHead(hidden[-1], device=device)

    def forward(self, embs, numeric=None):
        seq, mask = embs["seq_items"]
        x = torch.cat([embs["user"], embs["item"], masked_mean(seq, mask),
                       embs["recent_cats"]], dim=1)
        return self.head(F.relu(self.mlp(x)))


def towers(cfg, group, device):
    module = Towers(cfg["embedding_dim"], cfg["dnn_hidden_units"], device)

    def fn(params, embs, batch):
        return torch.func.functional_call(module, params, (embs,))
    return module, fn


class _Stream:
    """``BehaviorStream`` with ``recent_cats``: the first ids of each
    sample's ``seq_cats``."""

    def __init__(self, cfg, traffic, seed, device):
        self.behavior = BehaviorStream(traffic, seed, device)
        self.n = cfg["recent_cats"]
        self.widths = dict(self.behavior.widths, recent_cats=self.n)

    def chunks(self, n):
        for s, e, c in self.behavior.chunks(n):
            c["ids"]["recent_cats"] = c["ids"]["seq_cats"][:, :self.n]
            yield s, e, c


def stream(cfg, traffic, seed, device):
    return _Stream(cfg, traffic, seed, device)


def macs_per_sample(cfg) -> int:
    widths = [4 * cfg["embedding_dim"]] + list(cfg["dnn_hidden_units"]) + [1]
    return sum(a * b for a, b in zip(widths, widths[1:]))
