"""Sparse per-row optimizer applies for EmbeddingVariables.

Port of ``deeprec_tpu/optimizers/sparse.py`` for ``SparseAdagrad`` and
``SparseAdam``. Slot rows share the primary's slot index: slot arrays
are ``[capacity+1, dim]`` parallel to ``EVState.values``. Rows the
feature filter did not admit get no update, and rows inserted this step
start from fresh slot values (``lk.is_new``).

``apply`` runs one hand-written kernel per table and call
(``ops/kernels/sparse_apply.py``: K2 for Adagrad, K3 for Adam), which
updates the table and its slot rows in place; the JAX package returns
new arrays. The kernel reads each updated row's weight from ``values``
where the JAX package reads ``lk.rows``. The two are equal for every
updated row: ``lookup_train_occ`` fetches admitted rows from
``values`` and nothing writes ``values`` between the lookup and the
apply. The exception is a dynamic-dimension table (``block_num > 1``),
whose rows are masked after the fetch: ``apply`` raises for it.

SGD, AdagradDecay, AdamAsync, Ftrl and FtrlV2 are not ported yet;
``make`` raises ``NotImplementedError`` naming them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from deeprec_tpu_torch import config as cfglib
from deeprec_tpu_torch.embedding.variable import LookupResult
from deeprec_tpu_torch.ops.kernels import sparse_apply


def _gate(cfg: cfglib.TableConfig, lk: LookupResult):
    """Update mask: admitted rows inside the table. (The JAX package
    also returns the dropping scatter and safe gather indices; the
    kernels take the mask and index by slot themselves.)"""
    if cfg.block_num > 1:
        raise NotImplementedError(
            f"table {cfg.name}: sparse applies on dynamic-dimension tables "
            "(block_num > 1) are not ported")
    return lk.admitted & (lk.slots < cfg.capacity)


@dataclasses.dataclass(frozen=True)
class SparseAdagrad:
    """KvResourceSparseApplyAdagrad analog."""

    learning_rate: float = 0.05
    initial_accumulator_value: float = 0.1

    def init(self, cfg: cfglib.TableConfig, device):
        return {"accum": torch.full((cfg.capacity + 1, cfg.dim),
                                    self.initial_accumulator_value,
                                    dtype=torch.float32, device=device)}

    def apply(self, cfg, slot_state, values, lk: LookupResult, grad_rows,
              global_step: int, lr: Optional[float] = None):
        """In place; returns ``(slot_state, values)``."""
        upd = _gate(cfg, lk)
        lr = self.learning_rate if lr is None else lr
        sparse_apply.adagrad_apply_rows(
            values, slot_state["accum"], lk.slots, grad_rows.contiguous(),
            lr, update=upd, is_new=lk.is_new,
            init_acc=self.initial_accumulator_value)
        return slot_state, values


@dataclasses.dataclass(frozen=True)
class SparseAdam:
    """KvResourceSparseApplyAdam analog: lazy Adam, only touched rows
    update m/v; bias correction uses the table-level beta powers, which
    start at ``beta1``/``beta2`` and advance on the device after use."""

    learning_rate: float = 0.001
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def init(self, cfg: cfglib.TableConfig, device):
        def zeros():
            return torch.zeros((cfg.capacity + 1, cfg.dim),
                               dtype=torch.float32, device=device)

        def scalar(x):
            return torch.tensor(x, dtype=torch.float32, device=device)

        return {"m": zeros(), "v": zeros(),
                "beta1_power": scalar(self.beta1),
                "beta2_power": scalar(self.beta2)}

    def apply(self, cfg, slot_state, values, lk: LookupResult, grad_rows,
              global_step: int, lr: Optional[float] = None):
        """In place on the rows; returns ``(slot_state, values)`` with the
        beta powers advanced."""
        upd = _gate(cfg, lk)
        lr = self.learning_rate if lr is None else lr
        b1p = slot_state["beta1_power"]
        b2p = slot_state["beta2_power"]
        alpha = (lr * torch.sqrt(1 - b2p) / (1 - b1p)).reshape(1)
        sparse_apply.adam_apply_rows(
            values, slot_state["m"], slot_state["v"], lk.slots,
            grad_rows.contiguous(), alpha, self.beta1, self.beta2,
            self.epsilon, update=upd, is_new=lk.is_new)
        return {**slot_state, "beta1_power": b1p * self.beta1,
                "beta2_power": b2p * self.beta2}, values


BY_NAME = {"adagrad": SparseAdagrad, "adam": SparseAdam}
_NOT_PORTED = {"sgd": "SparseSGD", "gradient_descent": "SparseSGD",
               "adagrad_decay": "SparseAdagradDecay",
               "adam_async": "SparseAdamAsync", "ftrl": "SparseFtrl",
               "ftrl_v2": "SparseFtrlV2"}


def make(name: str, **kw):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"sparse optimizer {name!r} ({_NOT_PORTED[name]}) is not ported")
    return BY_NAME[name](**kw)
