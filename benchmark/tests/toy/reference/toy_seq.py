"""Plain towers of ``toy_seq``: the user, item, masked history mean and
recent-category rows, concatenated, through ReLU layers of
``dnn_hidden_units`` and a logit layer, in float32. Weights are named
``mlp.dense_<i>.weight`` / ``.bias`` and ``head.logits.weight`` /
``.bias``, ``[out, in]``."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def forward(params, embs, numeric, cfg):
    seq, mask = embs["seq_items"]
    hist = seq.sum(dim=1) / torch.clamp(mask.sum(dim=1), min=1)[:, None]
    x = torch.cat([embs["user"], embs["item"], hist, embs["recent_cats"]],
                  dim=1)
    for i in range(len(cfg["dnn_hidden_units"])):
        x = F.relu(F.linear(x, params[f"mlp.dense_{i}.weight"],
                            params[f"mlp.dense_{i}.bias"]))
    return F.linear(x, params["head.logits.weight"],
                    params["head.logits.bias"])[:, 0]


def columns(cfg):
    """The embedding columns, in column order."""
    d = cfg["embedding_dim"]
    return [{"name": "user", "dim": d, "combiner": "mean"},
            {"name": "item", "dim": d, "table": "item_emb"},
            {"name": "seq_items", "dim": d, "table": "item_emb",
             "kind": "sequence"},
            {"name": "recent_cats", "dim": d, "combiner": "mean"}]
