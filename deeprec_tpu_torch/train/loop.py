"""Train state, the training step and the eval step.

Port of ``TrainState``, ``create_train_state`` and the single-device
branches of ``make_train_step`` and ``make_eval_step`` from
``deeprec_tpu/train/loop.py`` (``mesh=None``, ``micro_batch_num=1``;
the combine is ``group.combine`` or a ``combine_fn`` such as
``group.combine_tables``). Sharded steps, micro-batching and
``make_epoch_step`` are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from deeprec_tpu_torch.embedding import lookup as lkup
from deeprec_tpu_torch.embedding import variable as ev
from deeprec_tpu_torch.feature_column.feature_column import EmbeddingGroup
from deeprec_tpu_torch.utils import keys as keylib


@dataclasses.dataclass
class TrainState:
    params: Dict[str, torch.Tensor]      # dense model state dict
    ev: Dict[str, ev.EVState]            # EVState per table
    step: int = 0                        # global step
    slots: Dict[str, Any] = dataclasses.field(default_factory=dict)
    dense_opt: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)


def create_train_state(group: EmbeddingGroup, params: Dict[str, torch.Tensor],
                       dense_opt=None, sparse_opt=None,
                       device="cuda") -> TrainState:
    """Fresh tables on ``device``, with the optimizers' state when they
    are given (a state that only serves needs neither)."""
    params = {k: v.to(device) for k, v in params.items()}
    return TrainState(
        params=params, ev=group.create_state(device),
        slots=(group.init_optimizer(sparse_opt, device)
               if sparse_opt is not None else {}),
        dense_opt=dense_opt.init(params) if dense_opt is not None else {})


def make_train_step(group: EmbeddingGroup, apply_fn: Callable,
                    loss_fn: Callable, sparse_opt, dense_opt,
                    micro_batch_num: int = 1,
                    combine_fn: Optional[Callable] = None):
    """``(TrainState, batch) -> (TrainState, metrics)``: lookup, combine,
    forward, loss ``sum(per_example) / B``, backward into the dense
    params and into each table's unique rows, dense and sparse applies.

    Unlike the JAX package's step, which returns new arrays, this step
    updates the state in place: the hash tables' key rows, the table
    rows, ``freqs`` and ``versions``, the optimizer slots and the dense
    params all change in the tensors of the state passed in, and the
    returned state holds the same tensors with ``step`` advanced. It runs
    on the device the state lives on. ``metrics`` holds the loss and the
    ids the unique budgets dropped (``n_overflow``), as 0-dim tensors on
    that device.

    ``combine_fn`` overrides ``group.combine``: pass
    ``group.combine_tables`` with a matching fused ``apply_fn``
    (``wdl.apply_fn_fused``) to hand the model each table's occurrences
    in one tensor; it requires ``micro_batch_num == 1``.
    """
    if combine_fn is not None and micro_batch_num != 1:
        raise ValueError("combine_fn requires micro_batch_num == 1")
    if micro_batch_num != 1:
        raise NotImplementedError(
            "micro_batch_num > 1 (gradient accumulation over micro-batches) "
            "is not ported")

    def _step(ts: TrainState, batch):
        gs = ts.step
        states, gl = group.lookup_train(ts.ev, batch, gs)
        rows = {t: lk.rows.detach().requires_grad_()
                for t, lk in gl.lks.items()}
        params = {k: v.detach().requires_grad_()
                  for k, v in ts.params.items()}
        combine = combine_fn if combine_fn is not None else group.combine
        out = apply_fn(params, combine(gl, rows), batch)
        per_ex = loss_fn(out, batch)
        loss = per_ex.sum() / per_ex.shape[0]
        names, tables = list(params), list(rows)
        grads = torch.autograd.grad(
            loss, [params[k] for k in names] + [rows[t] for t in tables])
        dense_opt.apply(ts.params, dict(zip(names, grads)), ts.dense_opt)
        slots, states = group.apply_gradients(
            sparse_opt, ts.slots, states, gl,
            dict(zip(tables, grads[len(names):])), gs)
        metrics = {"loss": loss.detach(),
                   "n_overflow": group.overflow_total(gl)}
        return ts.replace(ev=states, slots=slots, step=gs + 1), metrics

    return _step


def make_eval_step(group: EmbeddingGroup, apply_fn: Callable):
    """``(TrainState, batch) -> model outputs``, no mutation. Every id
    occurrence is looked up on its own (identity ``inverse``), as the
    JAX package's unsharded eval does."""

    @torch.no_grad()
    def _eval(ts: TrainState, batch):
        embs = {}
        for tname, tcols in group._columns_by_table().items():
            cfg = group.tables[tname]
            ids_hi, ids_lo, widths = group._packed_view(batch, tname, tcols)
            mask = ~((ids_hi == keylib.EMPTY_HI) & (ids_lo == keylib.EMPTY_LO))
            B, L = ids_hi.shape
            rows = ev.lookup(cfg, ts.ev[tname], ids_hi.reshape(-1),
                             ids_lo.reshape(-1))
            inverse = torch.arange(B * L, device=rows.device).reshape(B, L)
            off = 0
            for c, w in zip(tcols, widths):
                embs[c.name] = lkup.combine_bags(
                    rows, inverse[:, off:off + w], mask[:, off:off + w],
                    c.combiner)
                off += w
        return apply_fn(ts.params, embs, batch)

    return _eval
