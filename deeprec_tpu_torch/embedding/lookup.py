"""Id dedup, bag combining of looked-up rows, and the training lookup
of one table.

Port of ``dedup``, ``combine_bags``, ``combine_from_occ``,
``BagLookup``, ``bag_lookup_train`` and ``bag_lookup_infer`` from
``deeprec_tpu/embedding/lookup.py`` (combiners sum / mean / sqrtn over
padded-dense ``[B, L]`` bags, optionally weighted per occurrence). CBF-filtered tables take the sorted path
(``dedup``, then ``variable.lookup_train``), every other EV table the
sort-free ``variable.lookup_train_occ``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from deeprec_tpu_torch import config as cfglib
from deeprec_tpu_torch.embedding import variable as ev
from deeprec_tpu_torch.utils import keys as keylib


class DedupResult(NamedTuple):
    uhi: torch.Tensor      # [n] unique id hi (EMPTY-padded)
    ulo: torch.Tensor      # [n] unique id lo
    counts: torch.Tensor   # [n] int32 occurrences (0 for padding)
    inverse: torch.Tensor  # [n] int64 index into the unique arrays


def dedup(hi, lo) -> DedupResult:
    """Deduplicate an id batch on its device, with output size equal to
    the input size: the ``jnp.unique(..., axis=0, size=n,
    fill_value=EMPTY)`` of the JAX package. Unique ids come in the
    signed lexicographic order of their (hi, lo) pairs (so the EMPTY
    id, hi = int32 min, comes first where the batch holds padding),
    followed by EMPTY fill rows; ``counts`` is 0 for ids whose hi is
    the sentinel's. One sort of an int64 key ``(hi << 32) + (lo +
    2**31)``, which orders as the pairs do, then run flags, a cumsum and
    scatters into the fixed-size outputs: no ``torch.unique``, whose
    size is data-dependent, and no host read. A run's count is the
    distance to the next run's start, not a sum of ones: a scatter-add
    of the padding's long run would queue its atomics on one counter."""
    n = hi.shape[0]
    dev = hi.device
    key = (hi.to(torch.int64) << 32) + (lo.to(torch.int64) + 2**31)
    skey, order = torch.sort(key, stable=True)
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = skey[1:] != skey[:-1]
    run = torch.cumsum(first.to(torch.int64), 0) - 1
    inverse = torch.empty(n, dtype=torch.int64, device=dev)
    inverse[order] = run
    # A run's first entry writes its unique's slot; the others write
    # spill slots of their own (n + position; entry 0 always starts a
    # run, so slot n is never one), cut off after: the padding's long
    # run would otherwise queue its writes on one slot.
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    at = torch.where(first, run, n + pos)
    uhi = torch.full((2 * n,), keylib.EMPTY_HI, dtype=torch.int32,
                     device=dev)
    ulo = torch.full((2 * n,), keylib.EMPTY_LO, dtype=torch.int32,
                     device=dev)
    uhi[at] = hi[order]
    ulo[at] = lo[order]
    uhi, ulo = uhi[:n], ulo[:n]
    # start[u]: the sorted position where run u starts; n past the last.
    start = torch.full((2 * n,), n, dtype=torch.int64, device=dev)
    start[at] = pos
    counts = (start[1:n + 1] - start[:n]).to(torch.int32)
    counts = torch.where(uhi != keylib.EMPTY_HI, counts, 0)
    return DedupResult(uhi, ulo, counts, inverse)


def _reduce(s, w, combiner: str, weighted: bool):
    """Bag sums ``s`` [B, dim] over the occurrence weights ``w`` [B, L]
    (the mask itself when unweighted): mean divides by sum(w), sqrtn by
    sqrt(sum(w^2)), floored at 1 unweighted and at 1e-9 weighted."""
    if combiner == "sum":
        return s
    if combiner == "mean":
        denom = w.sum(dim=1)
    elif combiner == "sqrtn":
        denom = torch.sqrt((w * w).sum(dim=1))
    else:
        raise ValueError(f"unknown combiner {combiner!r}")
    return s / torch.clamp(denom, min=1e-9 if weighted else 1.0)[:, None]


def combine_bags(rows, inverse, mask, combiner: str, weights=None):
    """Reduce per-occurrence rows into per-bag embeddings.

    rows:    [n_unique, dim]
    inverse: [B, L] indices into rows
    mask:    [B, L] bool, real (non-padding) positions
    weights: optional [B, L] per-occurrence weights (the
             ``weighted_categorical_column``): sum_i w_i x_i, mean
             divides by sum(w), sqrtn by sqrt(sum(w^2))
    Returns [B, dim].
    """
    m = mask.to(rows.dtype)
    w = m if weights is None else weights.to(rows.dtype) * m
    return _reduce((rows[inverse] * w[..., None]).sum(dim=1), w, combiner,
                   weights is not None)


def combine_from_occ(per_occ, mask, combiner: str, weights=None):
    """Reduce pre-gathered, mask-multiplied per-occurrence rows
    ``[B, L, dim]`` into per-bag embeddings ``[B, dim]``: the tail of
    :func:`combine_bags` for callers that gather once per table."""
    m = mask.to(per_occ.dtype)
    if weights is None:
        return _reduce(per_occ.sum(dim=1), m, combiner, False)
    w = weights.to(per_occ.dtype)
    return _reduce((per_occ * w[..., None]).sum(dim=1), w * m, combiner,
                   True)


class BagLookup(NamedTuple):
    """Everything the train step needs from one table's lookup."""

    lk: ev.LookupResult          # per-unique-id lookup (rows: the grad input)
    inverse: torch.Tensor        # [B, L]
    mask: torch.Tensor           # [B, L]
    n_overflow: torch.Tensor     # [] int32, uniques dropped by the budget


def bag_lookup_train(cfg: cfglib.TableConfig, state: ev.EVState, ids_hi,
                     ids_lo, global_step: ev.Step, salt: int = 0,
                     unique_budget=None) -> tuple[ev.EVState, BagLookup]:
    """Training lookup for one padded-dense sparse feature [B, L]
    through :func:`variable.lookup_train_occ` (a static table:
    :func:`variable.lookup_train_static`; a CBF table: :func:`dedup`
    then :func:`variable.lookup_train`, with no unique budget); ``state``
    is updated in place."""
    B, L = ids_hi.shape
    mask = ~((ids_hi == keylib.EMPTY_HI) & (ids_lo == keylib.EMPTY_LO))
    if cfg.static_buckets:
        state, occ = ev.lookup_train_static(
            cfg, state, ids_hi.reshape(-1), ids_lo.reshape(-1), global_step,
            budget=unique_budget)
        return state, BagLookup(lk=occ.lk, inverse=occ.inverse.reshape(B, L),
                                mask=mask, n_overflow=occ.n_overflow)
    if isinstance(cfg.ev_option.filter_option, cfglib.CBFFilter):
        # Admission needs each unique id's count before the insert. The
        # JAX package's default ``n_overflow`` is a constant built at
        # import; here a zero on the state's device.
        dd = dedup(ids_hi.reshape(-1), ids_lo.reshape(-1))
        state, lk = ev.lookup_train(cfg, state, dd.uhi, dd.ulo, dd.counts,
                                    global_step, salt=salt)
        return state, BagLookup(
            lk=lk, inverse=dd.inverse.reshape(B, L), mask=mask,
            n_overflow=torch.zeros((), dtype=torch.int32,
                                   device=state.values.device))
    state, occ = ev.lookup_train_occ(
        cfg, state, ids_hi.reshape(-1), ids_lo.reshape(-1), global_step,
        salt=salt, budget=unique_budget)
    return state, BagLookup(lk=occ.lk, inverse=occ.inverse.reshape(B, L),
                            mask=mask, n_overflow=occ.n_overflow)


def bag_lookup_infer(cfg: cfglib.TableConfig, state: ev.EVState, ids_hi,
                     ids_lo) -> torch.Tensor:
    """Inference lookup of one padded-dense feature [B, L] through
    :func:`variable.lookup`: no dedup bookkeeping, no mutation; every
    occurrence reads its own row, combined by the table's combiner.
    Returns [B, dim]."""
    B, L = ids_hi.shape
    rows = ev.lookup(cfg, state, ids_hi.reshape(-1), ids_lo.reshape(-1))
    mask = ~((ids_hi == keylib.EMPTY_HI) & (ids_lo == keylib.EMPTY_LO))
    inverse = torch.arange(B * L, device=rows.device).reshape(B, L)
    return combine_bags(rows, inverse, mask, cfg.combiner)
