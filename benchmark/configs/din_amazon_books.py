"""``din_amazon_books`` on the port: the columns, the towers, the
traffic and the FLOPs.

The columns are ``models.din.behavior_columns`` at ``embedding_dim``:
``user``, the ``item`` and ``cat`` bags and the ``seq_items`` and
``seq_cats`` sequences, ``item``/``seq_items`` sharing ``item_emb`` and
``cat``/``seq_cats`` sharing ``cat_emb``, each declaring its
vocabulary, as EmbeddingVariable tables of one power-of-two capacity of
``headroom`` times the largest vocabulary (the port's ``capacity_for``
rule). The towers are the port's ``models.din.DIN``. The traffic is
``benchmark.behavior.BehaviorStream`` over the configuration's
vocabularies and history width, so they are stated once, here.
"""

from __future__ import annotations

import torch

from benchmark.behavior import BehaviorStream
from deeprec_tpu_torch import config as cfglib
from deeprec_tpu_torch.data.criteo import capacity_for
from deeprec_tpu_torch.models import din


def columns(cfg):
    t = cfg["table"]
    evo = cfglib.EmbeddingVariableOption(record_freq=t["record_freq"],
                                         record_version=t["record_version"])
    cap = capacity_for(max(cfg["num_users"], cfg["num_items"],
                           cfg["num_cats"]), headroom=t["headroom"])
    return din.behavior_columns(cfg["embedding_dim"], cap,
                                ev_option=evo, num_items=cfg["num_items"],
                                num_cats=cfg["num_cats"],
                                num_users=cfg["num_users"])


def towers(cfg, group, device):
    module = din.DIN(cfg["embedding_dim"],
                     hidden=tuple(cfg["dnn_hidden_units"]),
                     att_hidden=tuple(cfg["att_hidden_units"]),
                     dtype=getattr(torch, cfg["compute_dtype"]),
                     device=device)
    return module, din.apply_fn(module, group)


def stream(cfg, traffic, seed, device):
    return BehaviorStream(dict(traffic, seq_len=cfg["max_seq_len"],
                               num_items=cfg["num_items"],
                               num_cats=cfg["num_cats"],
                               num_users=cfg["num_users"]), seed, device)


def macs_per_sample(cfg) -> int:
    """Multiply-adds a sample, as the program computes them: the
    attention MLP over all ``max_seq_len`` positions, padding included
    ([q, k, q-k, q*k] of width 4 x 2D, then the hidden units, then one
    score), the weighted sum of the 2D-wide keys, and the top MLP over
    [user, candidate, attended, history mean, candidate * attended]
    (9D) and its logit."""
    d, T = cfg["embedding_dim"], cfg["max_seq_len"]
    att = [8 * d] + list(cfg["att_hidden_units"]) + [1]
    top = [9 * d] + list(cfg["dnn_hidden_units"]) + [1]
    return (T * sum(a * b for a, b in zip(att, att[1:])) + T * 2 * d
            + sum(a * b for a, b in zip(top, top[1:])))
