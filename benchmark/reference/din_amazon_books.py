"""Plain towers of ``din_amazon_books``: DIN (Zhou et al., KDD 2018,
arXiv:1706.06978) as DeepRec's ``modelzoo/DIN`` builds it.

With ``d`` the embedding width, the user row ``u``, the candidate
``c = [item, cat]`` (2d) and each history position's row
``k_t = [seq_items_t, seq_cats_t]`` (2d, zero at padding) with its mask
``m_t``:

* ``s_t = MLP_att([c, k_t, c - k_t, c * k_t])``, ReLU after each of the
  ``att_hidden_units`` layers and none after the last, one score, at
  every position;
* ``w = softmax over t of s_t / sqrt(2d)``, the padded positions' scores
  set to the float32 minimum first;
* ``a = sum_t w_t k_t``, and ``h = sum_t k_t / max(sum_t m_t, 1)``;
* ``x = [u, c, a, h, c * a]`` (9d) through ReLU layers of
  ``dnn_hidden_units`` and a float32 logit layer.

The MLPs compute in ``compute_dtype`` (inputs, weights and biases cast to
it; parameters float32); the rest is float32. Weights are named as the
port's module names them: ``att.att_mlp.dense_<i>``, ``mlp.dense_<i>``
and ``head.logits`` (``.weight`` ``[out, in]``, ``.bias``).

Departures from the paper (those of the JAX package's DIN, which the
port follows): the weights are a softmax of the scores scaled by
1/sqrt(2d), where the paper keeps unnormalised weights; ReLU, where the
paper uses PReLU or Dice; no batch normalisation.

It imports neither the port nor JAX. TF32 is off while it runs
(``reference/train.py``'s ``exact_float32``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _mlp(x, params, prefix, n, dt, last_relu):
    x = x.to(dt)
    for i in range(n):
        x = F.linear(x, params[f"{prefix}.dense_{i}.weight"].to(dt),
                     params[f"{prefix}.dense_{i}.bias"].to(dt))
        if last_relu or i < n - 1:
            x = F.relu(x)
    return x


def forward(params, embs, numeric, cfg):
    dt = getattr(torch, cfg["compute_dtype"])
    user = embs["user"]
    cand = torch.cat([embs["item"], embs["cat"]], dim=1)
    seq_i, mask = embs["seq_items"]
    seq_c, _ = embs["seq_cats"]
    keys = torch.cat([seq_i, seq_c], dim=-1)
    B, T, D = keys.shape
    q = cand[:, None, :].expand(B, T, D)
    feats = torch.cat([q, keys, q - keys, q * keys], dim=-1)
    n_att = len(cfg["att_hidden_units"]) + 1
    score = _mlp(feats, params, "att.att_mlp", n_att, dt,
                 False)[..., 0].to(torch.float32)
    score = torch.where(mask, score, torch.finfo(torch.float32).min)
    w = torch.softmax(score / math.sqrt(D), dim=1)
    att = torch.einsum("bt,btd->bd", w, keys)
    hist = keys.sum(dim=1) / torch.clamp(
        mask.sum(dim=1, keepdim=True), min=1).to(keys.dtype)
    x = torch.cat([user, cand, att, hist, cand * att], dim=1)
    top = _mlp(x, params, "mlp", len(cfg["dnn_hidden_units"]), dt, True)
    return F.linear(top.to(torch.float32), params["head.logits.weight"],
                    params["head.logits.bias"])[:, 0]


def columns(cfg):
    """The embedding columns, in column order: the user a bag of its own
    table, the candidate's item and category one-id bags of the shared
    ``item_emb`` and ``cat_emb``, the history's items and categories
    sequences of the same tables."""
    d = cfg["embedding_dim"]
    return [{"name": "user", "dim": d},
            {"name": "item", "dim": d, "table": "item_emb"},
            {"name": "cat", "dim": d, "table": "cat_emb"},
            {"name": "seq_items", "dim": d, "table": "item_emb",
             "kind": "sequence"},
            {"name": "seq_cats", "dim": d, "table": "cat_emb",
             "kind": "sequence"}]
