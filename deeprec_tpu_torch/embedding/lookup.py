"""Bag combining of looked-up rows, and the training lookup of one table.

Port of ``combine_bags``, ``combine_from_occ``, ``BagLookup`` and
``bag_lookup_train`` from ``deeprec_tpu/embedding/lookup.py``
(combiners sum / mean / sqrtn over padded-dense ``[B, L]`` bags). The
sorted ``dedup`` path, which only CBF-filtered tables take, is not
ported: those tables raise at creation.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from deeprec_tpu_torch import config as cfglib
from deeprec_tpu_torch.embedding import variable as ev
from deeprec_tpu_torch.utils import keys as keylib


def _reduce(s, w, combiner: str):
    if combiner == "sum":
        return s
    if combiner == "mean":
        denom = w.sum(dim=1)
    elif combiner == "sqrtn":
        denom = torch.sqrt((w * w).sum(dim=1))
    else:
        raise ValueError(f"unknown combiner {combiner!r}")
    return s / torch.clamp(denom, min=1.0)[:, None]


def combine_bags(rows, inverse, mask, combiner: str):
    """Reduce per-occurrence rows into per-bag embeddings.

    rows:    [n_unique, dim]
    inverse: [B, L] indices into rows
    mask:    [B, L] bool, real (non-padding) positions
    Returns [B, dim].
    """
    m = mask.to(rows.dtype)
    return _reduce((rows[inverse] * m[..., None]).sum(dim=1), m, combiner)


def combine_from_occ(per_occ, mask, combiner: str):
    """Reduce pre-gathered, mask-multiplied per-occurrence rows
    ``[B, L, dim]`` into per-bag embeddings ``[B, dim]``: the tail of
    :func:`combine_bags` for callers that gather once per table."""
    return _reduce(per_occ.sum(dim=1), mask.to(per_occ.dtype), combiner)


class BagLookup(NamedTuple):
    """Everything the train step needs from one table's lookup."""

    lk: ev.LookupResult          # per-unique-id lookup (rows: the grad input)
    inverse: torch.Tensor        # [B, L]
    mask: torch.Tensor           # [B, L]
    n_overflow: torch.Tensor     # [] int32, uniques dropped by the budget


def bag_lookup_train(cfg: cfglib.TableConfig, state: ev.EVState, ids_hi,
                     ids_lo, global_step: int, salt: int = 0,
                     unique_budget=None) -> tuple[ev.EVState, BagLookup]:
    """Training lookup for one padded-dense sparse feature [B, L]
    through :func:`variable.lookup_train_occ` (a static table:
    :func:`variable.lookup_train_static`); ``state`` is updated in
    place."""
    B, L = ids_hi.shape
    mask = ~((ids_hi == keylib.EMPTY_HI) & (ids_lo == keylib.EMPTY_LO))
    if cfg.static_buckets:
        state, occ = ev.lookup_train_static(
            cfg, state, ids_hi.reshape(-1), ids_lo.reshape(-1), global_step,
            budget=unique_budget)
        return state, BagLookup(lk=occ.lk, inverse=occ.inverse.reshape(B, L),
                                mask=mask, n_overflow=occ.n_overflow)
    if isinstance(cfg.ev_option.filter_option, cfglib.CBFFilter):
        raise NotImplementedError(
            f"table {cfg.name}: the sorted CBF training lookup is not ported")
    state, occ = ev.lookup_train_occ(
        cfg, state, ids_hi.reshape(-1), ids_lo.reshape(-1), global_step,
        salt=salt, budget=unique_budget)
    return state, BagLookup(lk=occ.lk, inverse=occ.inverse.reshape(B, L),
                            mask=mask, n_overflow=occ.n_overflow)
