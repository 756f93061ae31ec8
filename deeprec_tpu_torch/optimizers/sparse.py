"""Sparse per-row optimizer applies for EmbeddingVariables.

Port of ``deeprec_tpu/optimizers/sparse.py``: SGD (gradient descent),
Adagrad, AdagradDecay, Adam, AdamAsync, Ftrl and FtrlV2. Slot rows
share the primary's slot index: slot arrays are ``[capacity+1, dim]``
parallel to ``EVState.values``. Rows the feature filter did not admit
get no update, and rows inserted this step start from fresh slot values
(``lk.is_new``). Every apply updates the table, its slot rows and
Adam's beta powers in place; the JAX package returns new arrays.
``global_step`` is a Python int or a 0-dim int32 tensor on the table's
device (``variable.Step``), with bit-identical results.

Adagrad, Adam and AdamAsync run one hand-written kernel per table and
call (``ops/kernels/sparse_apply.py``: K2 for Adagrad, K3 for both
Adams). The JAX package updates each row from ``lk.rows``. For most
tables that equals ``values`` at every updated row (the lookup fetches
admitted rows from ``values`` and nothing writes ``values`` between the
lookup and the apply), and the kernel reads ``values``. Two kinds of
table differ, and for them the kernel takes ``lk.rows`` as its
``base_rows`` operand: a dynamic-dimension table (``block_num > 1``),
whose locked blocks the lookup zeroes after the fetch, and an adaptive
table, whose newly hot rows ``EmbeddingGroup.migrate_adaptive`` seeds
from the static table.

SGD, AdagradDecay and Ftrl have no Pallas kernel in the JAX package,
which leaves them to XLA; here they are plain PyTorch on the device of
the table. They read ``lk.rows``, as the JAX package does, and write
through the sentinel-row index of ``variable._drop_idx``: rows that are
not updated write row C's own content back to it, so row C never
changes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from deeprec_tpu_torch import config as cfglib
from deeprec_tpu_torch.embedding.variable import (LookupResult, Step,
                                                  _drop_idx)
from deeprec_tpu_torch.ops.kernels import sparse_apply


def _gate(cfg: cfglib.TableConfig, lk: LookupResult):
    """``(update, base_rows)`` of a kernel apply: the update mask
    (admitted rows inside the table; the JAX package also returns the
    dropping scatter and safe gather indices, the kernels index by slot
    themselves) and the rows to update from where they may differ from
    ``values`` (``lk.rows`` of a dynamic-dimension or adaptive table),
    else None."""
    base = (lk.rows.to(torch.float32).contiguous()
            if cfg.block_num > 1 or cfg.adaptive_hot_threshold is not None
            else None)
    return lk.admitted & (lk.slots < cfg.capacity), base


def _plain_gate(cfg: cfglib.TableConfig, lk: LookupResult):
    """(idx, upd, safe) of a plain apply: the int64 write index (the
    slot of an updated row, row C for the others), the update mask and
    the gather index ``min(slot, C)``."""
    idx, upd = _drop_idx(lk.slots, cfg.capacity, lk.admitted)
    return idx, upd, torch.clamp(lk.slots, max=cfg.capacity).to(torch.int64)


def _fresh(slot_arr, safe, is_new, init_value: float):
    """Slot rows at ``safe``, reset to ``init_value`` where ``is_new``."""
    cur = slot_arr[safe]
    return torch.where(is_new[:, None], torch.full_like(cur, init_value), cur)


def _put(dst, idx, upd, rows):
    """``dst[idx] = rows`` for updated rows; the others write row C's
    own content back to row C."""
    C = dst.shape[0] - 1
    dst.index_put_((idx,), torch.where(upd[:, None], rows.to(dst.dtype),
                                       dst[C]))


@dataclasses.dataclass(frozen=True)
class SparseSGD:
    """KvResourceSparseApplyGradientDescent analog."""

    learning_rate: float = 0.01

    def init(self, cfg: cfglib.TableConfig, device):
        return {}

    def apply(self, cfg, slot_state, values, lk: LookupResult, grad_rows,
              global_step: Step, lr: Optional[float] = None):
        """In place; returns ``(slot_state, values)``."""
        lr = self.learning_rate if lr is None else lr
        idx, upd, _ = _plain_gate(cfg, lk)
        _put(values, idx, upd, lk.rows - lr * grad_rows)
        return slot_state, values


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
              global_step: Step, lr: Optional[float] = None):
        """In place; returns ``(slot_state, values)``."""
        upd, base = _gate(cfg, lk)
        lr = self.learning_rate if lr is None else lr
        sparse_apply.adagrad_apply_rows(
            values, slot_state["accum"], lk.slots, grad_rows.contiguous(),
            lr, update=upd, is_new=lk.is_new,
            init_acc=self.initial_accumulator_value, base_rows=base)
        return slot_state, values


@dataclasses.dataclass(frozen=True)
class SparseAdagradDecay:
    """AdagradDecay: the accumulator decays by ``decay_rate`` every
    ``decay_step`` global steps, floored at ``decay_baseline``. Sparse
    rows decay lazily by the whole decay periods since their last touch
    (``lk.prev_versions``)."""

    learning_rate: float = 0.05
    initial_accumulator_value: float = 0.1
    decay_step: int = 10000
    decay_rate: float = 0.9
    decay_baseline: float = 1e-7

    def init(self, cfg: cfglib.TableConfig, device):
        return {"accum": torch.full((cfg.capacity + 1, cfg.dim),
                                    self.initial_accumulator_value,
                                    dtype=torch.float32, device=device)}

    def apply(self, cfg, slot_state, values, lk: LookupResult, grad_rows,
              global_step: Step, lr: Optional[float] = None):
        """In place; returns ``(slot_state, values)``."""
        lr = self.learning_rate if lr is None else lr
        idx, upd, safe = _plain_gate(cfg, lk)
        g = grad_rows.to(torch.float32)
        acc = _fresh(slot_state["accum"], safe, lk.is_new,
                     self.initial_accumulator_value)
        prev = torch.clamp(lk.prev_versions, min=0)
        periods = ((global_step // self.decay_step)
                   - prev // self.decay_step).to(torch.float32)
        decay = torch.pow(torch.full_like(periods, self.decay_rate), periods)
        acc = torch.clamp(acc * decay[:, None], min=self.decay_baseline)
        acc = acc + g * g
        w = lk.rows.to(torch.float32) - lr * g * torch.rsqrt(acc)
        _put(slot_state["accum"], idx, upd, acc)
        _put(values, idx, upd, w)
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
              global_step: Step, lr: Optional[float] = None):
        """In place, the beta powers too (so a step captured in a CUDA
        graph advances them at every replay); returns ``(slot_state,
        values)``."""
        upd, base = _gate(cfg, lk)
        lr = self.learning_rate if lr is None else lr
        b1p = slot_state["beta1_power"]
        b2p = slot_state["beta2_power"]
        sparse_apply.adam_apply_rows(
            values, slot_state["m"], slot_state["v"], lk.slots,
            grad_rows.contiguous(), self._alpha(lr, b1p, b2p), self.beta1,
            self.beta2, self.epsilon, update=upd, is_new=lk.is_new,
            base_rows=base)
        b1p.mul_(self.beta1)
        b2p.mul_(self.beta2)
        return slot_state, values

    def _alpha(self, lr, b1p, b2p):
        """K3's step size, a one-element tensor on the card: the
        bias-corrected learning rate."""
        return (lr * torch.sqrt(1 - b2p) / (1 - b1p)).reshape(1)


@dataclasses.dataclass(frozen=True)
class SparseAdamAsync(SparseAdam):
    """AdamAsync: with ``apply_sparse_adam=True`` the arithmetic of
    :class:`SparseAdam`; with False the original form, alpha = the
    learning rate (no bias correction). The beta powers advance after
    every apply either way."""

    apply_sparse_adam: bool = True

    def _alpha(self, lr, b1p, b2p):
        if self.apply_sparse_adam:
            return super()._alpha(lr, b1p, b2p)
        if isinstance(lr, torch.Tensor):
            return lr.to(torch.float32).reshape(1)
        return torch.full((1,), lr, dtype=torch.float32, device=b1p.device)


@dataclasses.dataclass(frozen=True)
class SparseFtrl:
    """KvResourceSparseApplyFtrl analog; ``l2_shrinkage`` > 0 gives the
    FtrlV2 variant."""

    learning_rate: float = 0.1
    learning_rate_power: float = -0.5
    initial_accumulator_value: float = 0.1
    l1: float = 0.0
    l2: float = 0.0
    l2_shrinkage: float = 0.0

    def init(self, cfg: cfglib.TableConfig, device):
        shape = (cfg.capacity + 1, cfg.dim)
        return {"accum": torch.full(shape, self.initial_accumulator_value,
                                    dtype=torch.float32, device=device),
                "linear": torch.zeros(shape, dtype=torch.float32,
                                      device=device)}

    def apply(self, cfg, slot_state, values, lk: LookupResult, grad_rows,
              global_step: Step, lr: Optional[float] = None):
        """In place; returns ``(slot_state, values)``."""
        lr = self.learning_rate if lr is None else lr
        idx, upd, safe = _plain_gate(cfg, lk)
        g = grad_rows.to(torch.float32)
        w = lk.rows.to(torch.float32)
        acc = _fresh(slot_state["accum"], safe, lk.is_new,
                     self.initial_accumulator_value)
        lin = _fresh(slot_state["linear"], safe, lk.is_new, 0.0)
        g_shrink = g + 2.0 * self.l2_shrinkage * w
        new_acc = acc + g * g
        p = -self.learning_rate_power
        sigma = (torch.pow(new_acc, p) - torch.pow(acc, p)) / lr
        lin = lin + g_shrink - sigma * w
        quad = torch.pow(new_acc, p) / lr + 2.0 * self.l2
        new_rows = torch.where(torch.abs(lin) > self.l1,
                               (torch.sign(lin) * self.l1 - lin) / quad, 0.0)
        _put(slot_state["accum"], idx, upd, new_acc)
        _put(slot_state["linear"], idx, upd, lin)
        _put(values, idx, upd, new_rows)
        return slot_state, values


def SparseFtrlV2(**kw):
    """FtrlV2 = Ftrl with gradient L2-shrinkage (reference op
    ``KvResourceSparseApplyFtrlV2``)."""
    kw.setdefault("l2_shrinkage", 1e-3)
    return SparseFtrl(**kw)


BY_NAME = {
    "sgd": SparseSGD,
    "gradient_descent": SparseSGD,
    "adagrad": SparseAdagrad,
    "adagrad_decay": SparseAdagradDecay,
    "adam": SparseAdam,
    "adam_async": SparseAdamAsync,
    "ftrl": SparseFtrl,
}


def make(name: str, **kw):
    return BY_NAME[name](**kw)
