"""EmbeddingVariable: dynamic-capacity embedding table.

Port of ``deeprec_tpu/embedding/variable.py``: table state, the
read-only ``lookup`` (hash find, then the row fetch with default select
in one ``gather_rows`` kernel), the sort-free training lookup
``lookup_train_occ`` (insert, first-occurrence dedup, budget compaction,
row init, metadata, admission and the same fused fetch), the training
lookup of deduplicated ids ``lookup_train`` (the CBF-filtered tables'
path: counting-Bloom admission, insert of the admitted ids, row init,
metadata, fetch), eviction (``shrink``, ``delete_keys``) and the
4-tensor checkpoint export/import; and the static hash-bucket table
(``create``'s full matrix, ``lookup_train_static``, ``lookup_static``,
row-indexed export/import).

Row arrays have ``capacity + 1`` rows; row ``capacity`` is the overflow
sentinel, stays zero and is never written. The JAX package returns new
arrays; here the training lookups, eviction and ``import_arrays`` write
the state's tensors in place: a reference-shape table is gigabytes, and
a copy per step or per import chunk would not fit.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from deeprec_tpu_torch import config as cfglib
from deeprec_tpu_torch.embedding import hash_table as ht
from deeprec_tpu_torch.ops.kernels import gather
from deeprec_tpu_torch.ops.kernels import init_rows as init_kernel
from deeprec_tpu_torch.utils import keys as keylib
from deeprec_tpu_torch.utils import stateless_random as srand
from deeprec_tpu_torch.utils import trace


# The global step a training lookup stamps into versions: a Python int,
# or a 0-dim int32 tensor on the table's device (the form a step captured
# in a CUDA graph reads at each replay). Both give bit-identical state.
Step = Union[int, torch.Tensor]


def step_fill(shape, global_step: Step, device) -> torch.Tensor:
    """int32 tensor of ``shape`` holding ``global_step`` everywhere: a
    fill for an int, a broadcast copy of a 0-dim tensor (no host read)."""
    if isinstance(global_step, torch.Tensor):
        return global_step.to(torch.int32).expand(shape).clone()
    return torch.full(shape, global_step, dtype=torch.int32, device=device)


@dataclasses.dataclass
class EVState:
    """Device state of one embedding table."""

    table: ht.HashTable
    values: torch.Tensor        # [C+1, dim] param rows
    freqs: torch.Tensor         # [C+1] int32 occurrence counts
    versions: torch.Tensor      # [C+1] int32 last-touched step (-1 unset)
    default_bank: torch.Tensor  # [default_value_dim, dim]
    bloom: torch.Tensor         # [num_counters] int32 CBF ([1] if unused)


class LookupResult(NamedTuple):
    slots: torch.Tensor          # [n] int32 row index (capacity: overflow)
    rows: torch.Tensor           # [n, dim] embedding rows (defaults where needed)
    admitted: torch.Tensor       # [n] bool: row participates in training
    is_new: torch.Tensor         # [n] bool: initialized by this lookup
    prev_versions: torch.Tensor  # [n] int32 last-touch step before it
    qhi: torch.Tensor
    qlo: torch.Tensor


class OccLookup(NamedTuple):
    """Result of :func:`lookup_train_occ`: unique-level lookup plus the
    occurrence-to-unique map."""

    lk: LookupResult        # arrays sized [U+1]; row U is the shared
    #                         overflow/padding pseudo-unique, never trained
    inverse: torch.Tensor   # [n] int64 in [0, U]
    n_overflow: torch.Tensor  # [] int32: ids dropped by the budget plus
    #                           ids the table could not place


# Rows of a static matrix drawn per init_rows call: the hash grid of a
# chunk is int64 [rows, dim], so the 1.7M x 129 reference matrix is made
# in pieces of ~70 MB rather than in several GB of intermediates.
_STATIC_INIT_ROWS = 1 << 16


def _create_static(cfg: cfglib.TableConfig, device, salt: int, bank,
                   shard: int, num_shards: int):
    """Static hash-bucket table: the full [N, dim] matrix drawn up front
    (row r is the initializer's draw for the pseudo-id (7777 + salt,
    g), g = r * num_shards + shard its global slot), a zero sentinel row
    N, and 1-element dummy metadata and hash table, as in the JAX
    package."""
    N, dim = cfg.capacity, cfg.dim
    values = torch.zeros((N + 1, dim), dtype=cfg.dtype, device=device)
    for start in range(0, N, _STATIC_INIT_ROWS):
        end = min(start + _STATIC_INIT_ROWS, N)
        row_lo = (torch.arange(start, end, dtype=torch.int32, device=device)
                  * num_shards + shard)
        row_hi = torch.full_like(row_lo, 7777 + salt)
        values[start:end] = srand.init_rows(
            cfg.initializer, row_hi, row_lo, dim, cfg.init_scale,
            salt=salt).to(cfg.dtype)
    return EVState(
        table=ht.create(1, device),
        values=values,
        freqs=torch.zeros((1,), dtype=torch.int32, device=device),
        versions=torch.full((1,), -1, dtype=torch.int32, device=device),
        default_bank=bank.to(cfg.dtype),
        bloom=torch.zeros((1,), dtype=torch.int32, device=device),
    )


def create(cfg: cfglib.TableConfig, device, salt: int = 0, shard: int = 0,
           num_shards: int = 1) -> EVState:
    """Empty table on ``device`` (a static table: its full initialized
    matrix). ``salt`` decorrelates the default bank and a static
    matrix's draws across tables, as in the JAX package. A static
    table's shard ``shard`` of ``num_shards`` (``sharded.create_shard``)
    holds global slot ``r * num_shards + shard`` at local row ``r``; an
    EV table's shards start empty alike."""
    capacity, dim = cfg.capacity, cfg.dim
    dvd = max(1, cfg.ev_option.default_value_dim)
    if cfg.initializer in ("zeros", "constant"):
        bank_hi = torch.full((dvd,), 7777 + salt, dtype=torch.int32,
                             device=device)
        bank_lo = torch.arange(dvd, dtype=torch.int32, device=device)
        bank = srand.init_rows(cfg.initializer, bank_hi, bank_lo, dim,
                               cfg.init_scale)
    else:
        # Random initializers: unseen keys read zeros.
        bank = torch.zeros((dvd, dim), dtype=torch.float32, device=device)
    if cfg.static_buckets:
        return _create_static(cfg, device, salt, bank, shard, num_shards)
    f = cfg.ev_option.filter_option
    n_counters = f.num_counters if isinstance(f, cfglib.CBFFilter) else 1
    return EVState(
        table=ht.create(capacity, device),
        values=torch.zeros((capacity + 1, dim), dtype=cfg.dtype,
                           device=device),
        freqs=torch.zeros((capacity + 1,), dtype=torch.int32, device=device),
        versions=torch.full((capacity + 1,), -1, dtype=torch.int32,
                            device=device),
        default_bank=bank.to(cfg.dtype),
        bloom=torch.zeros((n_counters,), dtype=torch.int32, device=device),
    )


def _bloom_positions(f: cfglib.CBFFilter, qhi, qlo) -> torch.Tensor:
    """[k, n] int64 counter positions of each id: ``hash_mix`` with
    salt ``1000 + j`` modulo ``num_counters``, in uint32 arithmetic (the
    hash's int64 lanes hold uint32 values)."""
    return torch.stack([keylib.hash_mix(qhi, qlo, salt=1000 + j)
                        % f.num_counters for j in range(f.num_hash_func)])


def _tracking(cfg: cfglib.TableConfig) -> tuple[bool, bool]:
    """(track_freq, track_version): whether per-step metadata updates
    run. ``record_freq/record_version=False`` elide them unless a
    subsystem needs them (counter filter and dyn-dim need freqs,
    eviction needs versions, multi-tier storage needs both: LFU ranks
    by freq, LRU by version)."""
    ev = cfg.ev_option
    f = ev.filter_option
    tiered = ev.storage_option.storage_type != cfglib.StorageType.HBM
    track_freq = (ev.record_freq
                  or (isinstance(f, cfglib.CounterFilter)
                      and f.filter_freq > 0)
                  or cfg.block_num > 1
                  or tiered)
    track_version = (ev.record_version or ev.evict_option is not None
                     or tiered)
    return track_freq, track_version


def _drop_idx(slots, capacity: int, keep=None):
    """int64 scatter index: ``slots`` where ``slots < capacity`` (and
    ``keep``), else the sentinel row ``capacity``. The JAX package
    routes dropped entries out of bounds for a ``mode='drop'`` scatter;
    here callers write the sentinel row's own content back to it, or
    add zero, so it stays as it is and nothing is indexed out of
    bounds."""
    ok = slots < capacity
    if keep is not None:
        ok = ok & keep
    return torch.where(ok, slots, capacity).to(torch.int64), ok


def _default_sel(state: EVState, qhi, qlo):
    """Default-bank row of each id (``id % default_value_dim``), or
    None for a single default row. This is the JAX package's
    ``_default_rows`` as an index: the ``gather_rows`` kernel reads the
    bank row itself, in the same pass as the table rows."""
    dvd = state.default_bank.shape[0]
    return None if dvd == 1 else keylib.mod_of(qhi, qlo, dvd)


def _draw(cfg: cfglib.TableConfig, state: EVState, fresh, slots, qhi, qlo,
          salt: int) -> None:
    """P2: the initializer's rows of the ``fresh`` entries, written in
    place. While tracing is on it is the span ``draw``, and the rows
    drawn go to the counter ``fresh_rows``."""
    with trace.span("draw"):
        init_kernel.init_fresh(state.values, fresh, slots, qhi, qlo,
                               cfg.initializer, cfg.init_scale, salt)
        if trace.on():
            trace.count("fresh_rows", fresh.sum())


def lookup_train(cfg: cfglib.TableConfig, state: EVState, qhi, qlo, counts,
                 global_step: Step, salt: int = 0
                 ) -> tuple[EVState, LookupResult]:
    """Training lookup of deduplicated ids ``[n]`` (padding: the EMPTY
    id) with their occurrence ``counts`` in the step, as
    ``lookup.dedup`` gives them: the CBF-filtered tables' path.

    A CBF table reads each id's counters before this batch's adds (the
    minimum over its ``num_hash_func`` positions), adds the id's count at
    each position (duplicate positions accumulate) and admits the id
    when that minimum plus its own count reaches ``filter_freq``; only
    admitted ids are inserted (P1). Other tables insert every real id.
    Inserted rows get their draw (P2), a zero freq, and
    ``prev_versions`` the step; then every placed row's freq grows by
    its count and its version becomes the step. The fetch is K1 with
    the default select; a counter filter gates ``admitted`` by freq.

    ``state`` is updated in place and returned. Sync-free: no host
    read."""
    capacity = cfg.capacity
    counts = counts.to(torch.int32)
    is_real = qhi != keylib.EMPTY_HI
    f = cfg.ev_option.filter_option
    if isinstance(f, cfglib.CBFFilter):
        pos = _bloom_positions(f, qhi, qlo)
        add = torch.where(is_real, counts, 0)
        pre = state.bloom[pos].amin(dim=0)
        for j in range(f.num_hash_func):
            state.bloom.index_add_(0, pos[j], add)
        insert_mask = is_real & (pre + add >= f.filter_freq)
    else:
        insert_mask = is_real

    with trace.span("probe"):
        _, slots, is_new = ht.find_or_insert(
            state.table, qhi, qlo, insert_mask, max_probes=cfg.max_probes)
    _draw(cfg, state, is_new, slots, qhi, qlo, salt)
    safe = torch.clamp(slots, max=capacity).to(torch.int64)
    prev_versions = torch.where(is_new, global_step,
                                state.versions[safe]).to(torch.int32)
    new_idx, _ = _drop_idx(slots, capacity, is_new)
    state.freqs.index_put_((new_idx,), torch.where(
        is_new, 0, state.freqs[capacity]).to(torch.int32))
    widx, ok = _drop_idx(slots, capacity)
    # The ids are distinct, so each placed row takes one count: a read,
    # an add and a write, not a scatter-add, whose atomics would queue
    # on row C, where every unplaced and padding entry goes.
    state.freqs.index_put_((widx,), state.freqs[widx]
                           + torch.where(ok, counts, 0))
    state.versions.index_put_((widx,), torch.where(
        ok, global_step, state.versions[capacity]).to(torch.int32))

    admitted = slots < capacity
    if isinstance(f, cfglib.CounterFilter) and f.filter_freq > 0:
        admitted = admitted & (state.freqs[safe] >= f.filter_freq)
    with trace.span("fetch"):
        rows = gather.gather_rows(state.values, slots, admitted,
                                  state.default_bank,
                                  _default_sel(state, qhi, qlo))
    if cfg.block_num > 1:
        rows = _dyn_dim_mask(cfg, rows, state.freqs[safe])
    return state, LookupResult(slots=slots, rows=rows, admitted=admitted,
                               is_new=is_new, prev_versions=prev_versions,
                               qhi=qhi, qlo=qlo)


def _compact(rep, rep_token, is_real, tokens, U: int):
    """Compact the representatives (``rep``; ``rep_token``: each
    token's representative; ``tokens``: ``arange(n)`` int32) to ``U``
    u-rows by cumsum ranks. Returns
    ``pick(a, fill)`` (the u-rows' entries of a per-token array, padded
    with ``fill`` to U + 1), ``inverse`` [n] int64 in [0, U] (U: padding
    or beyond the budget) and ``n_overflow``, the representatives beyond
    the budget."""
    n, dev = rep.shape[0], rep.device
    # pos[t] is token t's rank among representatives. Tokens outside the
    # budget write entry U of u_of, which is sliced off (the JAX package
    # drops them with an out-of-range index).
    pos = torch.cumsum(rep.to(torch.int32), 0, dtype=torch.int32) - 1
    in_budget = rep & (pos < U)
    u_of = torch.full((U + 1,), n, dtype=torch.int32, device=dev)
    u_of[torch.where(in_budget, pos, U).to(torch.int64)] = tokens
    u_idx = u_of[:U]
    upad = u_idx >= n
    safe_u = torch.clamp(u_idx, max=n - 1).to(torch.int64)
    prep = pos[torch.clamp(rep_token, max=n - 1).to(torch.int64)]
    inverse = torch.where(is_real & (prep < U), prep, U).to(torch.int64)
    n_overflow = torch.clamp(rep.sum(dtype=torch.int32) - U, min=0)

    def pick(a, fill):
        return torch.cat([torch.where(upad, fill, a[safe_u]),
                          torch.full((1,), fill, dtype=a.dtype, device=dev)])

    return pick, inverse, n_overflow


def claim_dedup(slots, is_real, capacity: int):
    """The sort-free dedup of :func:`lookup_train_occ`: the first
    occurrence of each slot (a scatter-min of the batch index over
    ``capacity + 1`` entries) is its representative; ids the table could
    not place (slot ``capacity``) are each their own. Returns
    ``(tokens, in_tab, rep_token, rep)``: ``arange(n)`` int32, the
    placed mask, each id's representative and the representative
    mask (real ids only)."""
    n, dev = slots.shape[0], slots.device
    tokens = torch.arange(n, dtype=torch.int32, device=dev)
    in_tab = slots < capacity
    slot_d = torch.clamp(slots, max=capacity).to(torch.int64)
    placed = is_real & in_tab
    first = torch.full((capacity + 1,), n, dtype=torch.int32, device=dev)
    first.scatter_reduce_(0, torch.where(placed, slot_d, capacity),
                          torch.where(placed, tokens, n), "amin",
                          include_self=True)
    rep_token = torch.where(in_tab, first[slot_d], tokens)
    return tokens, in_tab, rep_token, is_real & (rep_token == tokens)


def lookup_train_occ(cfg: cfglib.TableConfig, state: EVState, qhi, qlo,
                     global_step: Step, salt: int = 0,
                     budget: Optional[int] = None
                     ) -> tuple[EVState, OccLookup]:
    """Training lookup straight from per-occurrence ids ``[n]``.

    Inserts new ids, dedups by first occurrence of each slot (a
    scatter-min, no sort), compacts the representatives to the static
    budget ``U`` by cumsum ranks (``budget=None``: ``U = n``, no
    compaction), initializes fresh rows, updates freq/version metadata
    where tracked, and fetches rows with the default select through
    the ``gather_rows`` kernel. Ids beyond the budget read defaults,
    get no update and are counted in ``n_overflow``.

    ``state`` is updated in place and returned.
    """
    if isinstance(cfg.ev_option.filter_option, cfglib.CBFFilter):
        raise ValueError("lookup_train_occ does not support CBF filters")
    capacity = cfg.capacity
    n = qhi.shape[0]
    U = n if budget is None else min(budget, n)
    dev = qhi.device
    is_real = qhi != keylib.EMPTY_HI

    with trace.span("probe"):
        _, slots, is_new = ht.find_or_insert(
            state.table, qhi, qlo, is_real, max_probes=cfg.max_probes)
    n_table_overflow = (is_real & (slots >= capacity)).sum(dtype=torch.int32)

    tokens, in_tab, rep_token, rep = claim_dedup(slots, is_real, capacity)

    if budget is None:
        # U = n: every occurrence doubles as a unique row; the non-
        # representatives carry the dropped slot and no inverse points
        # at them.
        inverse = torch.where(is_real, torch.where(in_tab, rep_token, tokens),
                              n).to(torch.int64)

        def pad(a, fill):
            return torch.cat([a, torch.full((1,), fill, dtype=a.dtype,
                                            device=dev)])

        uhi = pad(qhi, keylib.EMPTY_HI)
        ulo = pad(qlo, keylib.EMPTY_LO)
        uslots = pad(torch.where(rep, slots, capacity), capacity)
        u_new = pad(is_new, False)
        n_overflow = torch.zeros((), dtype=torch.int32, device=dev)
    else:
        pick, inverse, n_overflow = _compact(rep, rep_token, is_real,
                                             tokens, U)
        uhi = pick(qhi, keylib.EMPTY_HI)
        ulo = pick(qlo, keylib.EMPTY_LO)
        uslots = pick(slots, capacity)
        u_new = pick(is_new, False)

    track_freq, track_version = _tracking(cfg)
    if track_freq:
        # Occurrence level, so ids inserted beyond the budget start
        # their count clean too. Fresh slots are unique, the reset
        # writes 0 there and row C's own value to row C.
        widx, _ = _drop_idx(slots, capacity, is_new)
        state.freqs.index_put_((widx,), torch.where(
            is_new, 0, state.freqs[capacity]).to(torch.int32))
        oidx, ok = _drop_idx(slots, capacity, is_real)
        state.freqs.index_add_(0, oidx, ok.to(torch.int32))

    usafe = torch.clamp(uslots, max=capacity).to(torch.int64)
    u_in = uslots < capacity
    if track_version:
        # Row init at the first trained touch (version < 0): covers ids
        # inserted beyond the budget and reused slots alike.
        raw_prev = state.versions[usafe]
        u_new = u_in & ((raw_prev < 0) | u_new)
        _draw(cfg, state, u_new, uslots, uhi, ulo, salt)
        prev_versions = torch.where(u_new, global_step, raw_prev)
        widx, ok = _drop_idx(uslots, capacity)
        state.versions.index_put_((widx,), torch.where(
            ok, global_step, state.versions[capacity]).to(torch.int32))
    else:
        # LightHeader mode: rows initialize at insert time, at the
        # occurrence level so beyond-budget inserts initialize too.
        # ``is_new`` marks one occurrence of each inserted id, which
        # draws its row once.
        _draw(cfg, state, is_new, slots, qhi, qlo, salt)
        u_new = u_in & u_new
        prev_versions = step_fill(uslots.shape, global_step, dev)
    prev_versions = prev_versions.to(torch.int32)

    f = cfg.ev_option.filter_option
    freq_rows = None
    if (isinstance(f, cfglib.CounterFilter) and f.filter_freq > 0) \
            or cfg.block_num > 1:
        freq_rows = state.freqs[usafe]
    if isinstance(f, cfglib.CounterFilter) and f.filter_freq > 0:
        admitted = u_in & (freq_rows >= f.filter_freq)
    else:
        admitted = u_in

    with trace.span("fetch"):
        rows = gather.gather_rows(state.values, uslots, admitted,
                                  state.default_bank,
                                  _default_sel(state, uhi, ulo))
    if cfg.block_num > 1:
        rows = _dyn_dim_mask(cfg, rows, freq_rows)
    return state, OccLookup(
        lk=LookupResult(slots=uslots, rows=rows, admitted=admitted,
                        is_new=u_new, prev_versions=prev_versions, qhi=uhi,
                        qlo=ulo),
        inverse=inverse, n_overflow=n_overflow + n_table_overflow)


def lookup_train_static(cfg: cfglib.TableConfig, state: EVState, qhi, qlo,
                        global_step: Step,
                        budget: Optional[int] = None
                        ) -> tuple[EVState, OccLookup]:
    """Training lookup of a static hash-bucket table, whose ids the
    group transform already mapped to rows (``lo = offset + id mod
    N``, ``hi = 0``): dedup by the first occurrence of each row (a
    scatter-min over N + 1 entries), compaction of the representatives
    to the budget ``U`` by cumsum ranks (``budget=None``: ``U = n``),
    and the row fetch through the ``gather_rows`` kernel. No probe, no
    insert, no admission and no metadata: ``state`` is returned as it
    came, every row is an old one (``is_new`` all False) and the rows
    inside the table are admitted."""
    N = cfg.capacity
    n = qhi.shape[0]
    U = n if budget is None else min(budget, n)
    dev = qhi.device
    is_real = qhi != keylib.EMPTY_HI
    tokens = torch.arange(n, dtype=torch.int32, device=dev)
    slots = torch.where(is_real, qlo, N)
    slot_d = slots.to(torch.int64)

    first = torch.full((N + 1,), n, dtype=torch.int32, device=dev)
    first.scatter_reduce_(0, slot_d, torch.where(is_real, tokens, n),
                          "amin", include_self=True)
    rep_token = first[slot_d]
    rep = is_real & (rep_token == tokens)
    pick, inverse, n_overflow = _compact(rep, rep_token, is_real,
                                             tokens, U)
    uhi = pick(qhi, keylib.EMPTY_HI)
    ulo = pick(qlo, keylib.EMPTY_LO)
    uslots = pick(slots, N)
    with trace.span("fetch"):
        rows = gather.gather_rows(state.values, uslots)
    lk = LookupResult(
        slots=uslots, rows=rows, admitted=uslots < N,
        is_new=torch.zeros(uslots.shape, dtype=torch.bool, device=dev),
        prev_versions=step_fill(uslots.shape, global_step, dev),
        qhi=uhi, qlo=ulo)
    return state, OccLookup(lk=lk, inverse=inverse, n_overflow=n_overflow)


def lookup_static(cfg: cfglib.TableConfig, state: EVState, qhi,
                  qlo) -> torch.Tensor:
    """Inference lookup of a static table (rows in ``qlo``; padding
    reads the zero sentinel row) through the ``gather_rows`` kernel."""
    N = cfg.capacity
    return gather.gather_rows(state.values,
                              torch.where(qhi != keylib.EMPTY_HI, qlo, N))


def _dyn_dim_mask(cfg: cfglib.TableConfig, rows, freqs_rows):
    """Dynamic-dimension EV: zero the blocks a key's frequency has not
    yet unlocked."""
    if cfg.block_num <= 1:
        return rows
    block_dim = cfg.dim // cfg.block_num
    # Compared threshold by threshold: a tensor of them would be a copy
    # from the host, which a captured step may not make.
    blocknums = 1 + sum((freqs_rows >= int(t)).to(torch.int32)
                        for t in cfg.dyn_dim_thresholds)
    block_idx = torch.arange(cfg.block_num, device=rows.device)
    mask = block_idx[None, :] < blocknums[:, None]
    mask = mask.repeat_interleave(block_dim, dim=1)
    return rows * mask.to(rows.dtype)


def lookup(cfg: cfglib.TableConfig, state: EVState, qhi, qlo) -> torch.Tensor:
    """Inference lookup: no mutation; missing or unadmitted keys read
    the default bank, row ``id % default_value_dim`` (the JAX package's
    ``_default_rows``; here it is the kernel's fused select, and a
    single default row is read in place rather than gathered).
    Returns rows [n, dim]."""
    if cfg.static_buckets:
        return lookup_static(cfg, state, qhi, qlo)
    capacity = cfg.capacity
    slots = ht.find(state.table, qhi, qlo, max_probes=cfg.max_probes)
    admitted = slots < capacity
    safe = torch.clamp(slots, max=capacity).to(torch.int64)
    f = cfg.ev_option.filter_option
    if isinstance(f, cfglib.CounterFilter) and f.filter_freq > 0:
        admitted = admitted & (state.freqs[safe] >= f.filter_freq)
    if _tracking(cfg)[1]:
        # Version-tracked tables fill a row's values at its first
        # trained touch; versions < 0 marks a row not yet filled.
        admitted = admitted & (state.versions[safe] >= 0)
    rows = gather.gather_rows(state.values, slots, admitted,
                              state.default_bank,
                              _default_sel(state, qhi, qlo))
    if cfg.block_num > 1:
        rows = _dyn_dim_mask(cfg, rows, state.freqs[safe])
    return rows


def num_live(state: EVState) -> torch.Tensor:
    """Live keys of the table, a 0-dim int32 tensor on its device."""
    return ht.num_live(state.table)


# Rows of the table whose sum of squares ``shrink`` takes at a time, so
# an L2 pass over a gigabyte table holds no [C, D] temporary.
_SHRINK_ROWS = 1 << 16


def _forget(state: EVState, mask) -> EVState:
    """Tombstone the slots of ``mask`` ([capacity] bool) and clear
    their metadata (freq 0, version -1), in place: a later reuse of the
    slot starts clean."""
    ht.remove_slots(state.table, mask)
    state.freqs[:-1].masked_fill_(mask, 0)
    state.versions[:-1].masked_fill_(mask, -1)
    return state


def shrink(cfg: cfglib.TableConfig, state: EVState,
           global_step: int) -> EVState:
    """Apply the table's eviction policy, in place (checkpoint-time
    shrink): ``GlobalStepEvict`` drops live keys with a version ``v >=
    0`` and ``global_step - v > steps_to_live``; ``L2WeightEvict`` those
    whose row's float32 sum of squares is below the threshold squared,
    taken ``_SHRINK_ROWS`` rows at a time. Evicted slots become
    tombstones with freq 0 and version -1. Returns ``state``."""
    ev_opt = cfg.ev_option.evict_option
    if ev_opt is None:
        return state
    live = ht.live_mask(state.table)
    body = state.versions[:-1]
    if isinstance(ev_opt, cfglib.GlobalStepEvict):
        if ev_opt.steps_to_live <= 0:
            return state
        evict = live & (body >= 0) & (
            (global_step - body) > ev_opt.steps_to_live)
    elif isinstance(ev_opt, cfglib.L2WeightEvict):
        thr = torch.tensor(ev_opt.l2_weight_threshold ** 2,
                           dtype=torch.float32)
        evict = torch.empty_like(live)
        for start in range(0, cfg.capacity, _SHRINK_ROWS):
            end = min(start + _SHRINK_ROWS, cfg.capacity)
            v = state.values[start:end].to(torch.float32)
            evict[start:end] = (v * v).sum(dim=1) < thr.to(v.device)
        evict &= live
    else:
        return state
    return _forget(state, evict)


def delete_keys(cfg: cfglib.TableConfig, state: EVState,
                ids: np.ndarray) -> EVState:
    """Remove the given int64 ids from the table, in place: their slots
    become tombstones with freq 0 and version -1; absent ids are
    ignored. Host-driven (the incremental checkpoint's tombstone
    replay): the ids go through ``find`` in chunks of 8,192, padded with
    the EMPTY id, as in the JAX package. Returns ``state``."""
    ids = np.unique(np.asarray(ids, np.int64))
    ids = ids[~np.isin(ids, (keylib.EMPTY_ID, keylib.TOMB_ID))]
    if ids.size == 0:
        return state
    capacity = cfg.capacity
    dev = state.values.device
    mask = torch.zeros((capacity + 1,), dtype=torch.bool, device=dev)
    chunk = 8192
    for start in range(0, ids.size, chunk):
        b = ids[start:start + chunk]
        b = np.concatenate(
            [b, np.full(chunk - b.size, keylib.EMPTY_ID, np.int64)])
        hi, lo = keylib.split_ids(b)
        slots = ht.find(state.table, torch.from_numpy(hi).to(dev),
                        torch.from_numpy(lo).to(dev),
                        max_probes=cfg.max_probes)
        mask[torch.clamp(slots, max=capacity).to(torch.int64)] = True
    return _forget(state, mask[:capacity])


# -- checkpoint export / import: the 4-tensor EV format ---------------------

def export_arrays(cfg: cfglib.TableConfig, state: EVState) -> dict[str, np.ndarray]:
    """Host snapshot of live rows: keys/values/freqs/versions, in slot
    order, and a CBF table's counters as ``bloom``. A static table
    exports every row, keyed by its row index (its id space is its row
    space)."""
    if cfg.static_buckets:
        N = cfg.capacity
        return {"keys": np.arange(N, dtype=np.int64),
                "values": state.values[:N].cpu().numpy(),
                "freqs": np.zeros((N,), np.int32),
                "versions": np.zeros((N,), np.int32)}
    idx = torch.nonzero(ht.live_mask(state.table)).reshape(-1)
    pair = state.table.key_pair[idx].cpu().numpy()
    out = {
        "keys": keylib.join_ids(pair[:, 0], pair[:, 1]),
        "values": state.values[idx].cpu().numpy(),
        "freqs": state.freqs[idx].cpu().numpy(),
        "versions": state.versions[idx].cpu().numpy(),
    }
    if isinstance(cfg.ev_option.filter_option, cfglib.CBFFilter):
        out["bloom"] = state.bloom.cpu().numpy()
    return out


def _to_device(a: np.ndarray, dev) -> torch.Tensor:
    """A host array as a tensor on ``dev``; on a card staged in pinned
    memory and copied with ``non_blocking=True`` on the current stream
    (no host wait)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dev.type != "cuda":
        return t.to(dev)
    return t.pin_memory().to(dev, non_blocking=True)


def import_arrays(cfg: cfglib.TableConfig, state: EVState,
                  arrays: dict[str, np.ndarray], partition_id: int = 0,
                  partition_num: int = 1, chunk: int = 8192,
                  extra_targets: Optional[dict[str, torch.Tensor]] = None,
                  return_mask: bool = False):
    """Bulk-insert rows (keys, values, freqs, versions) into ``state``,
    in place, ``chunk`` keys at a time, keeping only the keys of
    partition ``partition_id`` of ``partition_num``: restore-time
    re-sharding, so a checkpoint of any shard count restores onto any
    other. An EV key belongs to the partition its shard hash names
    (``keys.shard_of_np``). Ids the probe leaves unplaced at its round
    cap (``find_or_insert``'s ``max_rounds``, reached when many ids of a
    chunk start in one bucket row, as keys exported in slot order do)
    are inserted again, in a pass of their own, while a pass places
    any; the JAX package drops them. Ids whose probe window is full are
    dropped, as in the JAX package. The host arrays go to a card through
    pinned memory, asynchronously; a pass reads its placed mask back
    (one host read).

    ``extra_targets``: further row-aligned ``[C+1, ...]`` tensors (an
    optimizer's slot rows) written at the same slots, in place, from
    ``arrays["slot/<name>"]``. Returns ``state``, or ``(state,
    extra_targets)`` when they are given.

    ``return_mask``: also return a host bool mask over ``arrays["keys"]``
    of the rows that landed in the table (last in the returned tuple): a
    caller moving rows out of another tier keeps the source copy of a
    row the table dropped.

    A CBF table takes its counters from ``arrays["bloom"]`` where
    given. A static table takes the keys as global row indices: with
    ``partition_num > 1`` it keeps the rows ``g % partition_num ==
    partition_id`` at local row ``g // partition_num``; rows beyond its
    ``N`` are dropped (its mask marks the partition's rows, as the JAX
    package's does)."""
    ids = np.asarray(arrays["keys"], np.int64)
    if cfg.static_buckets:
        out = _import_static(cfg, state, ids, arrays, extra_targets,
                             partition_id, partition_num)
        if not return_mask:
            return out
        keep = (ids % partition_num == partition_id if partition_num > 1
                else np.ones(ids.shape[0], bool))
        return (*out, keep) if extra_targets is not None else (out, keep)
    keep = (keylib.shard_of_np(ids, partition_num) == partition_id
            if partition_num > 1 else np.ones(ids.shape[0], bool))
    ids = ids[keep]
    vals = np.asarray(arrays["values"])[keep]
    freqs = np.asarray(arrays["freqs"]).astype(np.int32)[keep]
    versions = np.asarray(arrays["versions"]).astype(np.int32)[keep]
    extras = {name: np.asarray(arrays[f"slot/{name}"])[keep]
              for name in (extra_targets or {})}
    dev = state.values.device
    capacity = cfg.capacity
    landed = np.zeros(ids.shape[0], bool)
    if "bloom" in arrays and isinstance(cfg.ev_option.filter_option,
                                        cfglib.CBFFilter):
        state.bloom = _to_device(np.array(arrays["bloom"], np.int32), dev)
    for start in range(0, ids.shape[0], chunk):
        pending = np.arange(start, min(start + chunk, ids.shape[0]))
        while pending.size:
            batch = np.concatenate(
                [ids[pending],
                 np.full(chunk - pending.size, keylib.EMPTY_ID, np.int64)])
            hi, lo = keylib.split_ids(batch)
            _, slots, _ = ht.find_or_insert(
                state.table, _to_device(hi, dev), _to_device(lo, dev),
                torch.ones(chunk, dtype=torch.bool, device=dev),
                max_probes=cfg.max_probes)
            widx, ok = _drop_idx(slots[: pending.size], capacity)

            def put(dst, src):
                # A dropped row writes row C's own content back to row C.
                rows = _to_device(src[pending], dev).to(dst.dtype)
                keep_row = ok.reshape((-1,) + (1,) * (rows.dim() - 1))
                dst.index_put_((widx,), torch.where(keep_row, rows,
                                                    dst[capacity]))

            put(state.values, vals)
            put(state.freqs, freqs)
            put(state.versions, versions)
            for name, src in extras.items():
                put(extra_targets[name], src)
            placed = ok.cpu().numpy()
            landed[pending[placed]] = True
            # Ids still pending at the probe's round cap (many ids of
            # one bucket row, as in slot order) go again, while a pass
            # places any; the JAX package drops them.
            if not placed.any():
                break
            pending = pending[~placed]
    out = (state, extra_targets) if extra_targets is not None else (state,)
    if return_mask:
        full = np.zeros(keep.shape[0], bool)
        full[np.nonzero(keep)[0]] = landed
        return (*out, full)
    return out if extra_targets is not None else state


def _import_static(cfg: cfglib.TableConfig, state: EVState, ids: np.ndarray,
                   arrays: dict[str, np.ndarray],
                   extra_targets: Optional[dict[str, torch.Tensor]],
                   partition_id: int, partition_num: int):
    dev = state.values.device
    local = ids // partition_num
    ok = ((ids >= 0) & (ids % partition_num == partition_id)
          & (local < cfg.capacity))
    idx = torch.from_numpy(local[ok]).to(dev)

    def put(dst, src):
        dst[idx] = torch.from_numpy(np.asarray(src)[ok]).to(dev, dst.dtype)

    put(state.values, arrays["values"])
    for name, dst in (extra_targets or {}).items():
        put(dst, arrays[f"slot/{name}"])
    if extra_targets is not None:
        return state, extra_targets
    return state
