"""Dense-parameter optimizer of the training step.

``Adagrad`` reproduces ``optax.adagrad(learning_rate)``, the dense
optimizer the JAX package's models train with, operation by operation:
the sum of squares starts at ``initial_accumulator_value``; a step
computes ``t = g*g + t``, then ``u = where(t > 0, rsqrt(t + eps), 0) * g``
and ``p = p + (-lr) * u``. (``torch.optim.Adagrad`` differs: it starts
its sum at 0 and divides by ``sqrt(t) + eps``.) Plain PyTorch, no
kernel. Parameters and state update in place.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch


@dataclasses.dataclass(frozen=True)
class Adagrad:
    learning_rate: float
    initial_accumulator_value: float = 0.1
    eps: float = 1e-7

    def init(self, params: Dict[str, torch.Tensor]):
        return {"sum_of_squares": {
            k: torch.full_like(v, self.initial_accumulator_value)
            for k, v in params.items()}}

    @torch.no_grad()
    def apply(self, params: Dict[str, torch.Tensor],
              grads: Dict[str, torch.Tensor], state) -> None:
        """One step over every parameter, in place."""
        for k, p in params.items():
            g = grads[k]
            t = state["sum_of_squares"][k]
            t.copy_(g * g + t)
            u = torch.where(t > 0, torch.rsqrt(t + self.eps), 0.0) * g
            p.add_(-self.learning_rate * u)
