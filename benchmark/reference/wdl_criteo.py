"""Plain towers of ``wdl_criteo``: Wide & Deep over the Criteo columns.

Each column's row is its wide weight (channel 0) and its deep embedding
(the rest). The wide logit is the sum of the wide weights; the deep
tower takes the deep embeddings in column-name order, then the 13
numeric features, through ReLU layers of ``dnn_hidden_units`` computed
in ``compute_dtype`` (inputs, weights and biases cast to it, parameters
kept in float32), and a float32 logit layer on top. Weights are named
``deep.dense_<i>.weight`` / ``.bias`` and ``head.logits.weight`` /
``.bias``, ``[out, in]``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def forward(params, embs, numeric, cfg):
    dt = getattr(torch, cfg["compute_dtype"])
    names = sorted(embs)
    wide = torch.cat([embs[n][:, :1] for n in names], dim=1).sum(dim=1)
    x = torch.cat([embs[n][:, 1:] for n in names] + [numeric], dim=1)
    x = x.to(dt)
    for i in range(len(cfg["dnn_hidden_units"])):
        x = F.relu(F.linear(x, params[f"deep.dense_{i}.weight"].to(dt),
                            params[f"deep.dense_{i}.bias"].to(dt)))
    out = F.linear(x.to(torch.float32), params["head.logits.weight"],
                   params["head.logits.bias"])[:, 0]
    return out + wide.to(torch.float32)


def columns(cfg):
    """(name, row width) of the embedding columns, in column order: each
    row holds the wide weight and the deep embedding."""
    return [(f"C{i + 1}", d + 1) for i, d in enumerate(cfg["embedding_dims"])]
