"""Adaptive embedding: hot ids in an EV table, cold ids in a static
hash-bucket table.

Port of ``deeprec_tpu/embedding/adaptive.py``
(``categorical_column_with_adaptive_embedding``,
``docs/Adaptive-Embedding.md``): frequent ids get collision-free EV
rows, infrequent ids share a dense ``[num_buckets, dim]`` table, and
when an id becomes hot its EV row is seeded from the static row it
trained in. Hotness is the EV's own frequency counter crossing
``hot_threshold``.

The static table is an ordinary dense parameter: the combine's
``torch.where`` sends each id's gradient to exactly one side, the EV
row of a hot id or the static row of a cold one. The EV half runs the
table's kernels (P1's insert, P2's draw, K1's fetch) through
``variable.lookup_train``; its apply (K2, K3) updates from the
lookup's rows, which hold the seeds after :func:`migrate_new_hot`.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from deeprec_tpu_torch import config as cfglib
from deeprec_tpu_torch.embedding import hash_table as ht
from deeprec_tpu_torch.embedding import lookup as lkup
from deeprec_tpu_torch.embedding import variable as ev
from deeprec_tpu_torch.ops.kernels import gather
from deeprec_tpu_torch.utils import keys as keylib


class AdaptiveLookup(NamedTuple):
    lk: ev.LookupResult       # EV-side unique lookup (rows: the grad input)
    hot: torch.Tensor         # [n_unique] bool: reads the EV row
    newly_hot: torch.Tensor   # [n_unique] bool: crossed the threshold now
    bucket: torch.Tensor      # [n_unique] int32 static-table row
    inverse: torch.Tensor     # [B, L]
    mask: torch.Tensor        # [B, L]


def bucket_of(qhi, qlo, num_buckets: int, salt: int) -> torch.Tensor:
    """Static-table row of each id: ``hash_mix`` with salt ``salt + 13``
    modulo ``num_buckets``, int64."""
    return keylib.hash_mix(qhi, qlo, salt=salt + 13) % num_buckets


def static_index(bucket, qhi, num_buckets: int) -> torch.Tensor:
    """int64 rows of the static table to gather for a lookup's uniques:
    ``bucket`` for real ids, and for padding entries (EMPTY ids, whose
    rows no occurrence reads) rows spread over the table. The gather's
    backward sums duplicate rows one after the other, so the padding of
    a batch (most of its uniques) must not share one row."""
    spread = torch.arange(bucket.shape[0], device=bucket.device) % num_buckets
    return torch.where(qhi != keylib.EMPTY_HI, bucket.long(), spread)


def _bits(cfg, state, lk, counts, *, hot_threshold, num_buckets, salt):
    """hot / newly_hot / bucket at the lookup's unique level, from the
    freqs after this step's update and the per-unique in-batch
    counts."""
    freq_after = state.freqs[torch.clamp(lk.slots, max=cfg.capacity).long()]
    freq_before = freq_after - counts
    hot = lk.admitted & (freq_after >= hot_threshold)
    newly_hot = hot & (freq_before < hot_threshold)
    bucket = bucket_of(lk.qhi, lk.qlo, num_buckets, salt).to(torch.int32)
    return hot, newly_hot, bucket


def lookup_train(cfg: cfglib.TableConfig, state: ev.EVState, ids_hi, ids_lo,
                 global_step: ev.Step, *, hot_threshold: int,
                 num_buckets: int, salt: int = 0
                 ) -> tuple[ev.EVState, AdaptiveLookup]:
    """Training lookup of one padded-dense feature [B, L]: dedup, then
    ``variable.lookup_train`` (``state`` updated in place)."""
    B, L = ids_hi.shape
    dd = lkup.dedup(ids_hi.reshape(-1), ids_lo.reshape(-1))
    state, lk = ev.lookup_train(cfg, state, dd.uhi, dd.ulo, dd.counts,
                                global_step, salt=salt)
    hot, newly_hot, bucket = _bits(
        cfg, state, lk, dd.counts, hot_threshold=hot_threshold,
        num_buckets=num_buckets, salt=salt)
    mask = ~((ids_hi == keylib.EMPTY_HI) & (ids_lo == keylib.EMPTY_LO))
    return state, AdaptiveLookup(
        lk=lk, hot=hot, newly_hot=newly_hot, bucket=bucket,
        inverse=dd.inverse.reshape(B, L), mask=mask)


class ShardedAdaptiveLookup(NamedTuple):
    """A mesh lookup's result: ``lk`` and the bits at the owner-unique
    level (aligned with ``lk.rows``); ``routing`` is the id exchange the
    rows ride back through (``EmbeddingGroup.combine``)."""

    lk: ev.LookupResult
    hot: torch.Tensor
    newly_hot: torch.Tensor
    bucket: torch.Tensor
    routing: Any               # sharded.Routing
    inverse: torch.Tensor      # [B, L]
    mask: torch.Tensor         # [B, L]


def lookup_train_sharded(cfg: cfglib.TableConfig, state: ev.EVState, ids_hi,
                         ids_lo, global_step: ev.Step, *, mesh,
                         hot_threshold: int, num_buckets: int, salt: int = 0,
                         capacity_factor: float = 2.0):
    """Sharded training lookup: the EV half rides the id exchange
    (``sharded.bag_lookup_train``); hotness and migration bits are
    computed on the owner shard, where the id's freq counter lives, from
    the owner's summed counts. The hot/cold merge happens at the owner
    level before the return exchange (the static table is a dense param
    every rank holds)."""
    from deeprec_tpu_torch.embedding import sharded as shlib

    state, sbl = shlib.bag_lookup_train(
        cfg, state, ids_hi, ids_lo, global_step, mesh=mesh,
        capacity_factor=capacity_factor, salt=salt)
    hot, newly_hot, bucket = _bits(
        cfg, state, sbl.lk, sbl.counts, hot_threshold=hot_threshold,
        num_buckets=num_buckets, salt=salt)
    r = sbl.routing
    return state, ShardedAdaptiveLookup(
        lk=sbl.lk, hot=hot, newly_hot=newly_hot, bucket=bucket, routing=r,
        inverse=r.inverse, mask=r.mask)


def _infer_rows(cfg, state, qhi, qlo, static_table, hot_threshold,
                num_buckets, salt):
    """Read-only rows of ids ``[n]``: the EV row (P1's find, K1's fetch)
    of an id resident with frequency >= ``hot_threshold``, else its
    static bucket's row."""
    slots = ht.find(state.table, qhi, qlo, max_probes=cfg.max_probes)
    safe = torch.clamp(slots, max=cfg.capacity).long()
    hot = (slots < cfg.capacity) & (state.freqs[safe] >= hot_threshold)
    ev_rows = gather.gather_rows(state.values, slots)
    static_rows = static_table[bucket_of(qhi, qlo, num_buckets, salt)]
    return torch.where(hot[:, None], ev_rows, static_rows.to(ev_rows.dtype))


def lookup_infer_rows_sharded(cfg, state, ids_hi, ids_lo, static_table, *,
                              mesh, hot_threshold: int, num_buckets: int,
                              salt: int = 0, capacity_factor: float = 2.0):
    """Read-only sharded lookup: ids go to their owners, which merge the
    hot EV rows and the cold static rows; the merged rows come back.
    Returns ``(local_rows, inverse [B, L], mask [B, L])``."""
    from deeprec_tpu_torch.embedding import sharded as shlib

    def owner_rows(rhi, rlo):
        rows = _infer_rows(cfg, state, rhi, rlo, static_table,
                           hot_threshold, num_buckets, salt)
        return torch.where((rhi != keylib.EMPTY_HI)[:, None], rows, 0.0)

    return shlib.exchange_rows_infer(ids_hi, ids_lo, owner_rows, mesh=mesh,
                                     capacity_factor=capacity_factor)


def migrate_new_hot(cfg: cfglib.TableConfig, state: ev.EVState,
                    al: AdaptiveLookup, static_table) -> ev.EVState:
    """Seed the EV rows of ids that just became hot from their static
    rows, in the table (the JAX package's value-migration step; the
    group seeds ``lk.rows`` instead, see
    ``EmbeddingGroup.migrate_adaptive``). ``state`` is updated in place
    and returned."""
    idx, ok = ev._drop_idx(al.lk.slots, cfg.capacity, al.newly_hot)
    seed = static_table[al.bucket.long()].to(state.values.dtype)
    state.values.index_put_((idx,), torch.where(
        ok[:, None], seed, state.values[cfg.capacity]))
    return state


def combine(rows, static_table, al: AdaptiveLookup, combiner: str):
    """[B, dim] bag embeddings, differentiable in ``rows`` and
    ``static_table``."""
    idx = static_index(al.bucket, al.lk.qhi, static_table.shape[0])
    merged = torch.where(al.hot[:, None], rows,
                         static_table[idx].to(rows.dtype))
    return lkup.combine_bags(merged, al.inverse, al.mask, combiner)


def lookup_infer(cfg: cfglib.TableConfig, state: ev.EVState, ids_hi, ids_lo,
                 static_table, *, hot_threshold: int, num_buckets: int,
                 salt: int = 0) -> torch.Tensor:
    """Inference read (no mutation): per-occurrence rows ``[B*L, dim]``,
    the EV row of an id resident with frequency >= ``hot_threshold``,
    else its static bucket's."""
    return _infer_rows(cfg, state, ids_hi.reshape(-1), ids_lo.reshape(-1),
                       static_table, hot_threshold, num_buckets, salt)
