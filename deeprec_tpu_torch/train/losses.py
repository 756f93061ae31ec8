"""Loss functions, port of ``deeprec_tpu/train/losses.py``. Per-example
losses: the reduction is the trainer's job."""

from __future__ import annotations

import torch


def bce_with_logits(logits, labels):
    """Sigmoid cross-entropy per example: [B] -> [B], in float32."""
    logits = logits.to(torch.float32)
    labels = labels.to(torch.float32)
    return (torch.maximum(logits, torch.zeros_like(logits))
            - logits * labels + torch.log1p(torch.exp(-torch.abs(logits))))


def softmax_ce_in_batch(user_vec, item_vec, temperature: float = 1.0):
    """In-batch sampled softmax of two-tower retrieval: each row's
    positive is the diagonal, the other rows its negatives. [B]."""
    u = user_vec / (torch.linalg.vector_norm(user_vec, dim=1, keepdim=True)
                    + 1e-8)
    v = item_vec / (torch.linalg.vector_norm(item_vec, dim=1, keepdim=True)
                    + 1e-8)
    logp = torch.log_softmax((u @ v.T) / temperature, dim=1)
    return -torch.diagonal(logp)
