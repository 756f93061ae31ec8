"""Open-addressing hash table on device tensors.

Port of ``deeprec_tpu/embedding/hash_table.py``; its module docstring
explains the design. The layout is kept bit for bit so a table
converted from the JAX package probes the same slots:

  * ``key_rows`` is ``[capacity // W, 2*W]`` int32 with ``W = 64``;
    slot ``i`` holds its key's hi half at ``key_rows[i // W, 2*(i % W)]``
    and its lo half right after it.
  * Probing starts at the hash bucket rounded down to its W-row; one
    bucket row is scanned first, stragglers rescan ``WIDE_ROWS`` rows.
  * Inserts inside one batch are serialized by a scatter-min claim: the
    lowest batch index wins a slot, losers go to the next round.

On CUDA tensors ``find`` and ``find_or_insert`` run the hand-written
probe kernel P1 (``ops/kernels/hash_probe.py``, ``csrc/hash_probe.cu``),
which keeps every round on the card, as the JAX package's
``lax.while_loop`` does: no host read. On CPU tensors they run the plain
versions here (``find_reference``, ``find_or_insert_reference``), whose
rounds a Python loop drives, gated on ``.any()`` (one host read a
round); the tests hold them against the JAX package and
``chip_smoke.py`` holds the kernel against them. ``find_or_insert``
writes keys into ``table.key_rows`` in place.

Slot convention: valid slots are ``0 .. capacity-1``; ``capacity`` is
the not-found / overflow sentinel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from deeprec_tpu_torch.ops.kernels import hash_probe
from deeprec_tpu_torch.utils import keys as keylib
from deeprec_tpu_torch.utils import trace

BUCKET_W = 64
WIDE_ROWS = 2


@dataclasses.dataclass
class HashTable:
    """Slot ``i`` lives at ``key_rows[i // W, 2*(i % W)]`` (hi) and
    ``+1`` (lo), with ``W = min(64, capacity)``."""

    key_rows: torch.Tensor  # [capacity // W, 2*W] int32, interleaved
    # P1's claim buffer ([capacity + 1] int32, free between calls), made
    # at the table's first insert on the card.
    claim: Optional[torch.Tensor] = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def capacity(self) -> int:
        return self.key_rows.shape[-2] * (self.key_rows.shape[-1] // 2)

    @property
    def key_pair(self) -> torch.Tensor:
        """[capacity, 2] int32 view."""
        return self.key_rows.reshape(self.capacity, 2)

    @property
    def key_hi(self) -> torch.Tensor:
        return self.key_pair[:, 0]

    @property
    def key_lo(self) -> torch.Tensor:
        return self.key_pair[:, 1]


def _bucket_w(capacity: int) -> int:
    return min(BUCKET_W, capacity)


def create(capacity: int, device) -> HashTable:
    if capacity < 1 or capacity & (capacity - 1):
        raise ValueError(f"capacity {capacity} must be a power of two")
    W = _bucket_w(capacity)
    row = torch.tensor([keylib.EMPTY_HI, keylib.EMPTY_LO], dtype=torch.int32,
                       device=device).repeat(W)
    return HashTable(key_rows=row.repeat(capacity // W, 1))


def _start_slots(qhi, qlo, capacity: int):
    """Row-aligned probe start of each id."""
    return keylib.bucket_of(qhi, qlo, capacity) & (capacity - _bucket_w(capacity))


def _first_true(mask):
    """Index of the first True along dim 1 (0 where none)."""
    return torch.argmax(mask.to(torch.uint8), dim=1)


def _match_logic(kp, qhi, qlo, pos, capacity):
    """Shared tail of a probe scan over fetched keys kp [n, W, 2].

    Returns (found, found_slot, has_reuse, reuse_slot, saw_empty), each
    [n]; slots equal to ``capacity`` mean "none".
    """
    khi = kp[..., 0]
    klo = kp[..., 1]
    match = (khi == qhi[:, None]) & (klo == qlo[:, None])
    sent_hi = khi == keylib.EMPTY_HI
    empty = sent_hi & (klo == keylib.EMPTY_LO)
    tomb = sent_hi & (klo == keylib.TOMB_LO)

    found = match.any(dim=1)
    at_found = pos.gather(1, _first_true(match)[:, None])[:, 0]
    found_slot = torch.where(found, at_found, capacity)

    reusable = empty | tomb
    has_reuse = reusable.any(dim=1)
    at_reuse = pos.gather(1, _first_true(reusable)[:, None])[:, 0]
    reuse_slot = torch.where(has_reuse, at_reuse, capacity)
    return found, found_slot, has_reuse, reuse_slot, empty.any(dim=1)


def _scan_fast(key_rows, qhi, qlo, starts):
    """One bucket-row fetch per id; ``starts`` must be row-aligned."""
    n_rows, row_elems = key_rows.shape
    W = row_elems // 2
    n = qhi.shape[0]
    kp = key_rows[starts // W].reshape(n, W, 2)
    offs = torch.arange(W, dtype=torch.int32, device=key_rows.device)
    pos = starts[:, None] + offs[None, :]
    return _match_logic(kp, qhi, qlo, pos, n_rows * W)


def _wide_rows(key_rows, max_probes: int) -> int:
    """Bucket rows of the straggler window: at least ``WIDE_ROWS`` and
    ``max_probes`` slots, at most the whole table."""
    n_rows, row_elems = key_rows.shape
    return min(n_rows, max(WIDE_ROWS, -(-max_probes // (row_elems // 2))))


def _scan_wide(key_rows, qhi, qlo, starts, max_probes: int):
    """Straggler rescan: ``R`` consecutive bucket rows per id with
    row-granular wraparound from the aligned ``starts``."""
    n_rows, row_elems = key_rows.shape
    W = row_elems // 2
    capacity = n_rows * W
    n = qhi.shape[0]
    R = _wide_rows(key_rows, max_probes)
    dev = key_rows.device
    r0 = starts // W
    ridx = (r0[:, None] + torch.arange(R, dtype=torch.int32, device=dev)
            [None, :]) % n_rows
    kp = key_rows[ridx].reshape(n, R * W, 2)
    offs = torch.arange(R * W, dtype=torch.int32, device=dev)
    pos = (starts[:, None] + offs[None, :]) & (capacity - 1)
    return _match_logic(kp, qhi, qlo, pos, capacity)


def _straggler_budget(n: int) -> int:
    """Fixed size of the compacted wide-scan buffer (see the JAX
    module: the drain loop always retires every pending id)."""
    return int(min(n, max(1024, n // 64)))


def _compact(mask, n: int, M: int):
    """The first M set positions of ``mask``, ascending; padding = n."""
    idx = torch.nonzero(mask).reshape(-1)[:M].to(torch.int32)
    pad = torch.full((M - idx.shape[0],), n, dtype=torch.int32,
                     device=mask.device)
    return torch.cat([idx, pad])


def _write_keys(key_rows, widx, qhi, qlo):
    """Write key pairs at slots ``widx`` in place; ``widx >= capacity``
    is skipped."""
    W = key_rows.shape[1] // 2
    capacity = key_rows.shape[0] * W
    keep = widx < capacity
    w = widx[keep].to(torch.int64)
    rows, col = w // W, 2 * (w % W)
    key_rows[rows, col] = qhi[keep]
    key_rows[rows, col + 1] = qlo[keep]


def find(table: HashTable, qhi, qlo, max_probes: int = 64):
    """Lookup only. Returns slots [n] int32; ``capacity`` if absent.
    EMPTY-sentinel ids (padding) return ``capacity``. CUDA tensors go
    through the P1 kernel, CPU tensors through :func:`find_reference`."""
    if table.key_rows.device.type == "cpu":
        return find_reference(table, qhi, qlo, max_probes)
    return hash_probe.find(table.key_rows, qhi.contiguous(),
                           qlo.contiguous(),
                           _wide_rows(table.key_rows, max_probes))


def find_reference(table: HashTable, qhi, qlo, max_probes: int = 64):
    """Plain version of :func:`find`, on any device: the fast scan,
    then straggler rounds over compacted pending ids while any is
    pending (a host read a round)."""
    capacity = table.capacity
    n = qhi.shape[0]
    buckets = _start_slots(qhi, qlo, capacity)
    is_sentinel = qhi == keylib.EMPTY_HI
    found, found_slot, _, _, saw_empty = _scan_fast(
        table.key_rows, qhi, qlo, buckets)
    slots = torch.where(found & ~is_sentinel, found_slot, capacity)
    if capacity <= _bucket_w(capacity):
        return slots  # a single row is the whole table
    pending = ~is_sentinel & ~found & ~saw_empty
    M = _straggler_budget(n)
    while bool(pending.any()):
        idx = _compact(pending, n, M)
        real = idx < n
        safe = torch.clamp(idx, max=n - 1)
        f2, fs2, _, _, _ = _scan_wide(
            table.key_rows,
            torch.where(real, qhi[safe], keylib.EMPTY_HI),
            torch.where(real, qlo[safe], keylib.EMPTY_LO),
            torch.where(real, buckets[safe], 0),
            max_probes)
        ridx = idx[real]
        slots[ridx] = torch.where(f2, fs2, capacity)[real]
        pending[ridx] = False
    return slots


def find_or_insert(table: HashTable, qhi, qlo, insert_mask,
                   max_probes: int = 64, max_rounds: int = 128):
    """Find each id; insert those with ``insert_mask`` set when absent.

    Duplicate ids within the batch resolve to one slot, with ``is_new``
    true for exactly one occurrence. Returns ``(table, slots, is_new)``
    with ``table`` the argument, updated in place. ``slots`` is
    ``capacity`` for not-found / overflow / sentinel ids; callers must
    initialize the row data of ``is_new`` slots. CUDA tensors go through
    the P1 kernel, CPU tensors through :func:`find_or_insert_reference`.
    While tracing is on (``utils/trace.py``) either adds the rounds it
    ran into the counters ``probe_rounds`` and ``probe_rounds_max``
    (the plain version's as the kernel counts them: up to its first
    all-dead round).
    """
    if table.key_rows.device.type == "cpu":
        stats = {} if trace.on() else None
        out = find_or_insert_reference(table, qhi, qlo, insert_mask,
                                       max_probes, max_rounds, stats)
        if stats is not None:
            hash_probe.count_rounds(stats["first_dead_round"]
                                    or stats["rounds"])
        return out
    if table.claim is None:
        table.claim = hash_probe.claim_buffer(table.capacity,
                                              table.key_rows.device)
    slots, is_new = hash_probe.find_or_insert(
        table.key_rows, qhi.contiguous(), qlo.contiguous(),
        insert_mask.to(torch.bool).contiguous(), table.claim,
        _wide_rows(table.key_rows, max_probes),
        _straggler_budget(qhi.shape[0]), max_rounds)
    return table, slots, is_new


def find_or_insert_reference(table: HashTable, qhi, qlo, insert_mask,
                             max_probes: int = 64, max_rounds: int = 128,
                             stats: Optional[dict] = None):
    """Plain version of :func:`find_or_insert`, on any device: the fast
    round, then straggler rounds over the first ``_straggler_budget(n)``
    pending ids in ascending order while any is pending and fewer than
    ``max_rounds`` rounds ran (a host read a round, and more inside
    it). A given ``stats`` dict gets ``rounds``, the rounds run (the
    fast round counts 1), and ``first_dead_round``, the number of the
    first straggler round whose every id was dead (an insert whose wide
    window holds neither its key nor a reusable slot), or None: the
    kernel stops there, as every later round changes nothing."""
    n = qhi.shape[0]
    capacity = table.capacity
    key_rows = table.key_rows
    dev = key_rows.device
    buckets = _start_slots(qhi, qlo, capacity)
    tokens = torch.arange(n, dtype=torch.int32, device=dev)
    is_sentinel = qhi == keylib.EMPTY_HI
    want_insert = insert_mask.to(torch.bool) & ~is_sentinel

    # Fast round: one bucket-row scan. Claims need an EMPTY in the
    # window as proof of absence (a tombstone alone is none).
    found, found_slot, has_reuse, reuse_slot, saw_empty = _scan_fast(
        key_rows, qhi, qlo, buckets)
    pending = ~is_sentinel
    slots = torch.where(pending & found, found_slot, capacity)
    is_new = torch.zeros(n, dtype=torch.bool, device=dev)
    pending = pending & ~found
    want = pending & has_reuse & want_insert & saw_empty
    if bool(want.any()):
        prop = torch.where(want, reuse_slot, capacity)
        claim = torch.full((capacity + 1,), n, dtype=torch.int32, device=dev)
        claim.scatter_reduce_(0, prop.to(torch.int64),
                              torch.where(want, tokens, n), "amin")
        won = want & (claim[prop.to(torch.int64)] == tokens)
        _write_keys(key_rows, torch.where(won, prop, capacity), qhi, qlo)
        slots = torch.where(won, prop, slots)
        is_new |= won
        pending = pending & ~won
    # Lookup-only ids whose fast window proved absence are done.
    pending = pending & (want_insert | ~saw_empty)

    M = _straggler_budget(n)
    r = 1
    first_dead = None
    while r < max_rounds and bool(pending.any()):
        # Full-width round over a compacted pending subset.
        idx = _compact(pending, n, M)
        real = idx < n
        safe = torch.clamp(idx, max=n - 1)
        q2h = torch.where(real, qhi[safe], keylib.EMPTY_HI)
        q2l = torch.where(real, qlo[safe], keylib.EMPTY_LO)
        found, found_slot, has_reuse, reuse_slot, _ = _scan_wide(
            key_rows, q2h, q2l, torch.where(real, buckets[safe], 0),
            max_probes)
        hit = real & found
        slots[idx[hit]] = found_slot[hit]
        # Claim: lowest original batch index wins each proposed slot.
        want2 = real & ~found & has_reuse & want_insert[safe]
        prop = torch.where(want2, reuse_slot, capacity)
        claim = torch.full((capacity + 1,), n, dtype=torch.int32, device=dev)
        claim.scatter_reduce_(0, prop.to(torch.int64),
                              torch.where(want2, idx, n), "amin")
        won = want2 & (claim[prop.to(torch.int64)] == idx)
        _write_keys(key_rows, torch.where(won, prop, capacity), q2h, q2l)
        slots[idx[won]] = prop[won]
        is_new[idx[won]] = True
        # Done: found, claim winners, and lookup-only ids (a full-width
        # scan without a match concludes absence).
        done = hit | won | (real & ~found & ~want_insert[safe])
        pending[idx[done]] = False
        r += 1
        if stats is not None and first_dead is None:
            dead = ~found & ~has_reuse & want_insert[safe]
            if bool((dead | ~real).all()):
                first_dead = r
    if stats is not None:
        stats.update(rounds=r, first_dead_round=first_dead)
    return table, slots, is_new


def remove_slots(table: HashTable, slot_mask) -> HashTable:
    """Tombstone, in place, every occupied slot where ``slot_mask``
    ([capacity] bool) is set; an EMPTY or tombstoned slot stays as it
    is. Tombstones keep probe chains intact and are reused by later
    inserts. Returns ``table``."""
    kp = table.key_pair
    kill = slot_mask.to(torch.bool) & live_mask(table)
    kp[:, 0].masked_fill_(kill, keylib.TOMB_HI)
    kp[:, 1].masked_fill_(kill, keylib.TOMB_LO)
    return table


def live_mask(table: HashTable):
    """[capacity] bool: slots holding a real key."""
    sent = table.key_hi == keylib.EMPTY_HI
    return ~(sent & ((table.key_lo == keylib.EMPTY_LO)
                     | (table.key_lo == keylib.TOMB_LO)))


def num_live(table: HashTable) -> torch.Tensor:
    """Live keys, a 0-dim int32 tensor on the table's device (no host
    read)."""
    return live_mask(table).sum(dtype=torch.int32)
