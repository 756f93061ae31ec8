"""Plain towers of ``dlrm_mlperf``: DLRM with the dot interaction.

The bottom MLP (``arch_mlp_bot``, ReLU after every layer) embeds the 13
numeric features to the embedding width; the pairwise dot products of
that vector and the 26 field embeddings (fields in name order; float32,
upper triangle without the diagonal, row-major) follow it into the top
MLP (``arch_mlp_top`` less its last layer, ReLU after every layer) and
a float32 logit layer. The MLPs compute in ``compute_dtype`` (inputs,
weights and biases cast to it; parameters float32). Weights are named
``bot.dense_<i>``, ``top.dense_<i>`` and ``head.logits`` (``.weight``
``[out, in]``, ``.bias``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _mlp(x, params, prefix, n, dt):
    x = x.to(dt)
    for i in range(n):
        x = F.relu(F.linear(x, params[f"{prefix}.dense_{i}.weight"].to(dt),
                            params[f"{prefix}.dense_{i}.bias"].to(dt)))
    return x


def forward(params, embs, numeric, cfg):
    dt = getattr(torch, cfg["compute_dtype"])
    bot = _mlp(numeric, params, "bot", len(cfg["arch_mlp_bot"]) - 1, dt)
    fields = [embs[n] for n in sorted(embs)]
    fe = torch.stack([bot.to(torch.float32)] + fields, dim=1)
    z = torch.bmm(fe, fe.transpose(1, 2))
    i, j = torch.triu_indices(fe.shape[1], fe.shape[1], offset=1,
                              device=fe.device)
    x = torch.cat([bot, z[:, i, j].to(dt)], dim=1)
    top = _mlp(x, params, "top", len(cfg["arch_mlp_top"]) - 1, dt)
    return F.linear(top.to(torch.float32), params["head.logits.weight"],
                    params["head.logits.bias"])[:, 0]


def columns(cfg):
    """(name, row width) of the embedding columns, in column order."""
    return [(f"C{i + 1}", cfg["arch_sparse_feature_size"])
            for i in range(len(cfg["num_embeddings_per_feature"]))]
