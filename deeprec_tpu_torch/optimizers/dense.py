"""Dense-parameter optimizers of the training step.

``Adagrad`` reproduces ``optax.adagrad(learning_rate)``, the dense
optimizer of the JAX package's benchmark, operation by operation:
the sum of squares starts at ``initial_accumulator_value``; a step
computes ``t = g*g + t``, then ``u = where(t > 0, rsqrt(t + eps), 0) * g``
and ``p = p + (-lr) * u``. (``torch.optim.Adagrad`` differs: it starts
its sum at 0 and divides by ``sqrt(t) + eps``.)

``Adam`` reproduces ``optax.adam(learning_rate)``, the model zoo's
dense optimizer (``tools/train_zoo_torch.py --dense adam:2e-3``): ``mu =
(1-b1)*g + b1*mu``, ``nu = (1-b2)*g*g + b2*nu``, the step count ``c``
incremented, ``mu_hat = mu / (1 - b1**c)``, ``nu_hat = nu / (1 -
b2**c)``, ``u = mu_hat / (sqrt(nu_hat) + eps)`` and ``p = p + (-lr) *
u``, in float32 with the count int32, as optax keeps it.

Both are plain PyTorch, no kernel. Parameters and state update in
place, with no host tensor and no host read, so a training step
captured in a CUDA graph replays them. A state is a dict whose entries
are a tensor (``count``) or a state dict of per-parameter tensors
(``sum_of_squares``; ``mu``, ``nu``), named as optax's fields, so
checkpoints carry it in the JAX package's layout.
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


@dataclasses.dataclass(frozen=True)
class Adam:
    learning_rate: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: Dict[str, torch.Tensor]):
        dev = next(iter(params.values())).device
        return {"count": torch.zeros((), dtype=torch.int32, device=dev),
                "mu": {k: torch.zeros_like(v) for k, v in params.items()},
                "nu": {k: torch.zeros_like(v) for k, v in params.items()}}

    @torch.no_grad()
    def apply(self, params: Dict[str, torch.Tensor],
              grads: Dict[str, torch.Tensor], state) -> None:
        """One step over every parameter, in place."""
        state["count"].add_(1)
        c = state["count"].to(torch.float32)
        # The bases are filled on the device: a host tensor would be a
        # copy from pageable memory, which a CUDA graph cannot capture.
        bc1 = 1 - torch.pow(torch.full_like(c, self.b1), c)
        bc2 = 1 - torch.pow(torch.full_like(c, self.b2), c)
        for k, p in params.items():
            g = grads[k]
            mu, nu = state["mu"][k], state["nu"][k]
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            p.add_(-self.learning_rate * u)
