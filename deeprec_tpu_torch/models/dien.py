"""DIEN (Deep Interest Evolution Network), port of
``deeprec_tpu/models/dien.py``.

Interest extractor: a GRU over the behavior sequence, with an auxiliary
next-behavior loss; interest evolution: an AUGRU whose update gate is
scaled by the candidate's attention over the extracted interests.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from deeprec_tpu_torch.feature_column.feature_column import EmbeddingGroup
from deeprec_tpu_torch.layers.core import AUGRU, GRU, MLP, LogitsHead
from deeprec_tpu_torch.models.din import (apply_fn, behavior_columns,
                                          candidate_and_sequence,
                                          embedding_dim)
from deeprec_tpu_torch.train.losses import bce_with_logits

__all__ = ["DIEN", "behavior_columns", "apply_fn", "dien_loss", "make"]


def _softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) with no linear cut-off."""
    return torch.logaddexp(x, torch.zeros_like(x))


class DIEN(nn.Module):
    """Returns ``(logit [B], aux loss [])``."""

    def __init__(self, dim: int, gru_hidden: int = 32,
                 hidden: Sequence[int] = (200, 80),
                 dtype: torch.dtype = torch.float32,
                 use_aux_loss: bool = True, device="cuda"):
        super().__init__()
        H = self.gru_hidden = gru_hidden
        self.use_aux_loss = use_aux_loss
        self.extractor = GRU(2 * dim, H, dtype=dtype, device=device)
        self.q_proj = MLP(2 * dim, (H,), dtype=dtype, device=device)
        self.evolution = AUGRU(H, H, dtype=dtype, device=device)
        self.mlp = MLP(3 * dim + H, hidden, dtype=dtype, device=device)
        self.head = LogitsHead(hidden[-1], device=device)
        if use_aux_loss:
            self.aux_proj = MLP(2 * dim, (H,), dtype=dtype, device=device)

    def forward(self, embs, numeric=None):
        user, cand, seq, mask = candidate_and_sequence(embs)
        outs, _ = self.extractor(seq, mask)                  # [B, T, H]
        # Attention of the candidate over the extracted interests.
        q = self.q_proj(cand)                                # [B, H]
        score = torch.einsum("bh,bth->bt", q, outs).to(torch.float32)
        score = torch.where(mask, score, torch.finfo(torch.float32).min)
        att = torch.softmax(score / math.sqrt(self.gru_hidden), dim=1)
        att = torch.where(mask, att, 0.0)
        final = self.evolution(outs, att.to(outs.dtype), mask)
        x = torch.cat([user, cand, final], dim=1)
        logit = self.head(F.relu(self.mlp(x)))

        aux = torch.zeros((), dtype=torch.float32, device=logit.device)
        if self.use_aux_loss:
            # The GRU state at t should score the true next behavior
            # above an in-batch negative (the batch rolled by one).
            h_t = outs[:, :-1, :]
            pos = seq[:, 1:, :]
            neg = torch.roll(pos, 1, dims=0)
            m = (mask[:, 1:] & mask[:, :-1]).to(torch.float32)

            def score_pair(beh):
                return (h_t * self.aux_proj(beh)).sum(dim=-1).to(
                    torch.float32)
            ls = _softplus(-score_pair(pos)) + _softplus(score_pair(neg))
            aux = (ls * m).sum() / torch.clamp(m.sum(), min=1.0)
        return logit, aux


def make(group: EmbeddingGroup, **kw) -> DIEN:
    return DIEN(embedding_dim(group), **kw)


def dien_loss(out, batch, aux_weight: float = 1.0):
    """Per-example BCE plus the scalar aux loss (the trainer's mean over
    the batch then counts it once, with weight ``aux_weight``)."""
    logit, aux = out
    return bce_with_logits(logit, batch["label"]) + aux_weight * aux
