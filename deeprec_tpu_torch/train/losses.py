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
