"""Dense building blocks: the MLP tower and the float32 logits head.

Port of ``MLP`` and ``LogitsHead`` from ``deeprec_tpu/layers/core.py``.
With ``dtype=torch.bfloat16`` the parameters stay float32 and each
layer casts its input, weight and bias to bfloat16 before the product,
as flax's ``Dense(dtype=bfloat16, param_dtype=float32)`` does; the
logits head always computes in float32.

Layers are built without initialization (``skip_init``); call
:func:`init_dense` with a ``torch.Generator``, or load a state dict.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


def _linear(in_features: int, out_features: int, device) -> nn.Linear:
    return nn.utils.skip_init(nn.Linear, in_features, out_features,
                              device=device)


def init_dense(module: nn.Module, generator: torch.Generator):
    """LeCun-normal weights (std 1/sqrt(fan_in), the flax Dense
    default up to truncation) and zero biases for every ``nn.Linear``
    under ``module``, drawn from ``generator`` on the CPU."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Linear):
                w = torch.randn(m.weight.shape, generator=generator)
                m.weight.copy_(w * m.in_features ** -0.5)
                m.bias.zero_()


class MLP(nn.Module):
    """Stack of Linear layers named ``dense_0 ..``, ReLU between them
    (none after the last)."""

    def __init__(self, in_features: int, units: Sequence[int],
                 dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        self.dtype = dtype
        self.n_layers = len(units)
        for i, u in enumerate(units):
            self.add_module(f"dense_{i}", _linear(in_features, u, device))
            in_features = u

    def forward(self, x):
        x = x.to(self.dtype)
        for i in range(self.n_layers):
            layer = getattr(self, f"dense_{i}")
            x = F.linear(x, layer.weight.to(self.dtype),
                         layer.bias.to(self.dtype))
            if i < self.n_layers - 1:
                x = F.relu(x)
        return x


class LogitsHead(nn.Module):
    """Final projection to one logit per row, in float32."""

    def __init__(self, in_features: int, device="cuda"):
        super().__init__()
        self.logits = _linear(in_features, 1, device)

    def forward(self, x):
        return self.logits(x.to(torch.float32))[..., 0]
