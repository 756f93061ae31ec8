"""Evaluation metrics.

Port of ``deeprec_tpu/train/metrics.py``: the exact per-batch AUC (the
Mann-Whitney rank statistic), the streaming histogram AUC of
``Estimator.evaluate`` (``tf.metrics.auc``'s thresholded form, 4,096
buckets), accuracy and the in-batch recall@k of two-tower models. The
accumulators are float32, as the JAX package keeps them without x64.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def batch_auc(logits, labels) -> torch.Tensor:
    """Exact AUC of one batch via the Mann-Whitney rank statistic; tied
    scores take ranks in input order (a stable sort), as in the JAX
    package. 0.5 when one class is absent."""
    scores = logits.to(torch.float32)
    labels = labels.to(torch.float32)
    n = scores.shape[0]
    order = torch.argsort(scores, stable=True)
    ranks = torch.zeros_like(scores)
    ranks[order] = torch.arange(1, n + 1, dtype=torch.float32,
                                device=scores.device)
    n_pos = labels.sum()
    n_neg = n - n_pos
    u = (ranks * labels).sum() - n_pos * (n_pos + 1) / 2.0
    return torch.where(n_pos * n_neg > 0, u / (n_pos * n_neg),
                       torch.tensor(0.5, device=scores.device))


class AucState(NamedTuple):
    """Streaming histogram AUC: per-bucket positive and negative counts
    of the sigmoid scores."""

    pos: torch.Tensor  # [num_buckets] float32
    neg: torch.Tensor


def auc_init(num_buckets: int = 4096, device="cuda") -> AucState:
    return AucState(torch.zeros(num_buckets, dtype=torch.float32,
                                device=device),
                    torch.zeros(num_buckets, dtype=torch.float32,
                                device=device))


def auc_update(state: AucState, logits, labels) -> AucState:
    """Add a batch's scores to the histogram (new tensors)."""
    dev = state.pos.device
    p = torch.sigmoid(logits.to(dev, torch.float32))
    nb = state.pos.shape[0]
    idx = torch.clamp((p * nb).to(torch.int32), 0, nb - 1).to(torch.int64)
    lab = labels.to(dev, torch.float32)
    return AucState(state.pos.index_add(0, idx, lab),
                    state.neg.index_add(0, idx, 1.0 - lab))


def auc_result(state: AucState) -> torch.Tensor:
    """Trapezoidal AUC over the bucket thresholds, from the high-score
    end."""
    pos, neg = state.pos, state.neg
    tp = torch.cumsum(pos.flip(0), 0)
    fp = torch.cumsum(neg.flip(0), 0)
    tpr = tp / torch.clamp(pos.sum(), min=1.0)
    fpr = fp / torch.clamp(neg.sum(), min=1.0)
    zero = torch.zeros(1, dtype=tpr.dtype, device=tpr.device)
    tpr = torch.cat([zero, tpr])
    fpr = torch.cat([zero, fpr])
    return ((fpr[1:] - fpr[:-1]) * (tpr[1:] + tpr[:-1]) / 2.0).sum()


def accuracy(logits, labels) -> torch.Tensor:
    pred = torch.sigmoid(logits.to(torch.float32)) >= 0.5
    return (pred == (labels > 0.5)).to(torch.float32).mean()


def recall_at_k(user_vec, item_vec, k: int = 10):
    """In-batch recall@k for two-tower eval, on host arrays."""
    user_vec, item_vec = np.asarray(user_vec), np.asarray(item_vec)
    u = user_vec / (np.linalg.norm(user_vec, axis=1, keepdims=True) + 1e-8)
    v = item_vec / (np.linalg.norm(item_vec, axis=1, keepdims=True) + 1e-8)
    sims = u @ v.T
    topk = np.argsort(-sims, axis=1)[:, :k]
    hits = (topk == np.arange(len(u))[:, None]).any(axis=1)
    return hits.mean()
