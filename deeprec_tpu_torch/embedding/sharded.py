"""Row-sharded embedding tables over a mesh of ranks.

Port of ``deeprec_tpu/embedding/sharded.py``: SOK's synchronous
model-parallel embedding (ids exchanged all-to-all, looked up on the
owner, rows exchanged back) and PS mod partitioning, for EV tables and
static hash-bucket tables, plus the replicated placement of small
tables. Every rank of the :class:`~deeprec_tpu_torch.parallel.mesh.Mesh`
holds one shard and its own local batch; the functions here take this
rank's tensors, as the JAX ones do inside ``shard_map``.

Each ``jax.lax.all_to_all(..., tiled=True)`` is ``Mesh.all_to_all``, an
equal-split ``all_to_all_single`` of a ``[S*K, ...]`` tensor; ``K``
comes from :func:`per_peer_slots` on the host, so every shape is static
and no step reads the card. The owner-side lookups are the unsharded
table's own: ``variable.lookup_train`` (P1's insert, P2's draw, K1's
fetch) on the ids that arrive from the S peers, deduplicated on the
owner, and the sparse optimizer (K2, K3) applies there.

Gradients: the owner's unique rows are the differentiable input. The
return exchange in :func:`combine` is an autograd function whose
backward is the same all-to-all applied to the gradient (JAX gets it
from the all-to-all's transpose), so each row's gradient from every
peer lands on its owner. A replicated table's union rows are the same
on every rank, and each rank's gradient covers only its own batch: the
train step sums them across ranks with one all-reduce
(``train/loop.py``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from deeprec_tpu_torch import config as cfglib
from deeprec_tpu_torch.embedding import lookup as lkup
from deeprec_tpu_torch.embedding import variable as ev
from deeprec_tpu_torch.ops.kernels import gather
from deeprec_tpu_torch.parallel.mesh import Mesh
from deeprec_tpu_torch.utils import keys as keylib


class Routing(NamedTuple):
    """Per-rank routing metadata from one sharded lookup."""

    dest: torch.Tensor           # [n_unique_local] int32 send slot,
    #                              S*K = dropped (overflow or padding)
    owner_inverse: torch.Tensor  # [S*K] recv entry -> owner-unique index
    inverse: torch.Tensor        # [B, L] local occurrence -> local unique
    mask: torch.Tensor           # [B, L] non-padding positions
    n_overflow: torch.Tensor     # [] int32 ids dropped by the capacity factor
    recv_pad: torch.Tensor       # [S*K] bool: recv entry carries no id


def _dest_of(owner, num_shards: int, per_peer: int):
    """Send-buffer slot of each id given its owner shard (``num_shards``
    = padding). Ids beyond ``per_peer`` for one owner overflow: they
    read zeros and get no update this step, and are counted."""
    n = owner.shape[0]
    S, K = num_shards, per_peer
    dev = owner.device
    order = torch.argsort(owner, stable=True)
    sorted_owner = owner[order].contiguous()
    starts = torch.searchsorted(
        sorted_owner, torch.arange(S + 1, dtype=owner.dtype, device=dev))
    rank = (torch.arange(n, dtype=torch.int64, device=dev)
            - starts[torch.clamp(sorted_owner, max=S).to(torch.int64)])
    ok = (sorted_owner < S) & (rank < K)
    dest_sorted = torch.where(ok, sorted_owner.to(torch.int64) * K + rank,
                              S * K).to(torch.int32)
    dest = torch.empty(n, dtype=torch.int32, device=dev)
    dest[order] = dest_sorted
    n_overflow = ((~ok) & (sorted_owner < S)).sum(dtype=torch.int32)
    return dest, n_overflow


def _route_ids(uhi, ulo, num_shards: int, per_peer: int):
    """Bucket local unique ids by owner (the shard hash) into the
    ``[S*K]`` send layout; see :func:`_dest_of`."""
    owner = torch.where(uhi != keylib.EMPTY_HI,
                        keylib.shard_of(uhi, ulo, num_shards), num_shards)
    return _dest_of(owner.to(torch.int32), num_shards, per_peer)


def _spill(index, size: int):
    """int64 ``index`` with every entry at or past ``size`` moved to a
    spill slot of its own, ``size + j`` for entry ``j``: a scatter whose
    dropped entries all wrote one slot would queue them on it."""
    j = torch.arange(index.shape[0], dtype=torch.int64, device=index.device)
    return torch.where(index < size, index.to(torch.int64), size + j)


def _fill_send(dest, payload, fill, S: int, K: int):
    """Scatter ``[n]`` payload into the ``[S*K]`` send buffer, dropping
    the entries with ``dest == S*K``."""
    buf = torch.full((S * K + dest.shape[0],), fill, dtype=payload.dtype,
                     device=payload.device)
    buf[_spill(dest, S * K)] = payload
    return buf[:S * K]


def per_peer_slots(n: int, num_shards: int, capacity_factor: float) -> int:
    """Per-peer send-buffer slots for ``n`` local ids, rounded up to a
    multiple of 8: the K of every sharded exchange."""
    K = max(8, int(-(-n * capacity_factor // num_shards)))
    return -(-K // 8) * 8


class ShardedBagLookup(NamedTuple):
    lk: ev.LookupResult   # owner-side unique rows (the differentiable input)
    routing: Routing
    # Owner-side summed in-batch count of each unique id, [S*K] (what
    # the owner's freq update consumed; zeros for a static table). The
    # JAX package defaults it to a 0-d zero, so its static lookup
    # returns shape () (sharded.py:91); here every lookup sets [S*K].
    counts: torch.Tensor


class _Exchange(torch.autograd.Function):
    """The row exchange back to the requesting ranks, differentiable:
    its backward is the same all-to-all on the gradient, which sends
    each row's gradient to the row's owner."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.all_to_all(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_to_all(g), None


def bag_lookup_train(cfg: cfglib.TableConfig, state: ev.EVState, ids_hi,
                     ids_lo, global_step: ev.Step, *, mesh: Mesh,
                     capacity_factor: float = 2.0,
                     salt: int = 0) -> tuple[ev.EVState, ShardedBagLookup]:
    """Sharded training lookup of an EV table. ``cfg.capacity`` is the
    per-shard capacity and ``state`` this rank's shard, updated in place;
    ``ids_hi/ids_lo`` the local ``[B, L]`` batch."""
    S = mesh.size
    B, L = ids_hi.shape
    n = B * L
    dd = lkup.dedup(ids_hi.reshape(-1), ids_lo.reshape(-1))
    K = per_peer_slots(n, S, capacity_factor)
    dest, n_overflow = _route_ids(dd.uhi, dd.ulo, S, K)
    send = torch.stack([_fill_send(dest, dd.uhi, keylib.EMPTY_HI, S, K),
                        _fill_send(dest, dd.ulo, keylib.EMPTY_LO, S, K),
                        _fill_send(dest, dd.counts, 0, S, K)], dim=-1)
    recv = mesh.all_to_all(send)                         # [S*K, 3]
    rhi, rlo, rcnt = (recv[:, i].contiguous() for i in range(3))
    # Owner-side dedup: one id may arrive from several peers; the
    # optimizer must see it once, with the counts summed.
    ddo = lkup.dedup(rhi, rlo)
    csum = _block_sum(ddo.inverse, rcnt, S * K, S, rhi == keylib.EMPTY_HI)
    state, lk = ev.lookup_train(cfg, state, ddo.uhi, ddo.ulo, csum,
                                global_step, salt=salt)
    mask = ~((ids_hi == keylib.EMPTY_HI) & (ids_lo == keylib.EMPTY_LO))
    routing = Routing(dest=dest, owner_inverse=ddo.inverse,
                      inverse=dd.inverse.reshape(B, L), mask=mask,
                      n_overflow=n_overflow,
                      recv_pad=rhi == keylib.EMPTY_HI)
    return state, ShardedBagLookup(lk=lk, routing=routing, counts=csum)


def _block_sum(index, values, size: int, blocks: int, pad):
    """``out[u] = sum of values[j] with index[j] == u`` over ``size``
    rows, where each of ``blocks`` equal blocks of ``index`` names a row
    at most once outside ``pad``: a read, an add and a write a block, in
    block order. Padding entries go to spill rows that are cut off. (A
    scatter-add would queue its atomics on the one row that the
    buffers' padding shares, and sum in no fixed order.)"""
    out = values.new_zeros((size + index.shape[0],) + tuple(values.shape[1:]))
    tgt = _spill(torch.where(pad, size, index), size)
    for t, v in zip(tgt.tensor_split(blocks), values.tensor_split(blocks)):
        out.index_put_((t,), out[t] + v)
    return out[:size]


class _PaddedGather(torch.autograd.Function):
    """``rows[idx]`` with zero rows where ``pad``, differentiable in
    ``rows``; its backward is :func:`_block_sum` over ``blocks`` blocks
    in which ``idx`` names each row at most once (an exchange buffer:
    one block a peer)."""

    @staticmethod
    def forward(ctx, rows, idx, pad, blocks):
        ctx.save_for_backward(idx, pad)
        ctx.n_rows, ctx.blocks = rows.shape[0], blocks
        out = rows.index_select(0, torch.where(pad, 0, idx).to(torch.int64))
        return out.masked_fill_(pad[:, None], 0)

    @staticmethod
    def backward(ctx, g):
        idx, pad = ctx.saved_tensors
        return (_block_sum(idx, g, ctx.n_rows, ctx.blocks, pad), None, None,
                None)


def local_rows(owner_rows, routing: Routing, mesh: Mesh):
    """This rank's unique rows ``[n_unique_local, dim]`` from the
    owners' rows: the differentiable return exchange; an overflowed or
    padding id reads a zero row."""
    # An owner row is asked for at most once by each peer, a local
    # unique takes one send slot.
    per_recv = _PaddedGather.apply(owner_rows, routing.owner_inverse,
                                   routing.recv_pad, mesh.size)  # [S*K, dim]
    back = _Exchange.apply(per_recv, mesh)
    return _PaddedGather.apply(back, routing.dest,
                               routing.dest == back.shape[0], 1)


def combine(owner_rows, sbl_or_routing, combiner: str, *, mesh: Mesh):
    """Exchange the owner rows back and combine them into ``[B, dim]``
    bags; differentiable in ``owner_rows``."""
    r = (sbl_or_routing.routing
         if isinstance(sbl_or_routing, ShardedBagLookup) else sbl_or_routing)
    return lkup.combine_bags(local_rows(owner_rows, r, mesh), r.inverse,
                             r.mask, combiner)


class RepRouting(NamedTuple):
    """Routing metadata of a replicated table's lookup (no exchange)."""

    union_of_local: torch.Tensor  # [n] local unique -> union unique
    inverse: torch.Tensor         # [B, L] local occurrence -> local unique
    mask: torch.Tensor            # [B, L] non-padding positions


def bag_lookup_train_replicated(cfg: cfglib.TableConfig, state: ev.EVState,
                                ids_hi, ids_lo, global_step: ev.Step, *,
                                mesh: Mesh, salt: int = 0):
    """Training lookup of an EV table held whole on every rank (the
    placement for small tables: no exchange, no overflow). Every rank
    all-gathers the ranks' local unique ids and counts, dedups the union
    and runs the same ``lookup_train`` on it, so the replicas stay
    bit-identical. Returns ``(state, (lk, RepRouting))``; the union
    rows' gradient is this rank's share, summed across ranks by the
    caller (once)."""
    B, L = ids_hi.shape
    n = B * L
    dd = lkup.dedup(ids_hi.reshape(-1), ids_lo.reshape(-1))
    g = mesh.all_gather(torch.stack([dd.uhi, dd.ulo, dd.counts], dim=-1))
    ghi, glo, gcnt = (g[:, i].contiguous() for i in range(3))  # [S*n]
    ddo = lkup.dedup(ghi, glo)
    csum = _block_sum(ddo.inverse, gcnt, ghi.shape[0], mesh.size,
                      ghi == keylib.EMPTY_HI)
    state, lk = ev.lookup_train(cfg, state, ddo.uhi, ddo.ulo, csum,
                                global_step, salt=salt)
    # Local unique j sits at gathered position rank*n + j.
    routing = RepRouting(
        union_of_local=ddo.inverse[mesh.rank * n:(mesh.rank + 1) * n],
        inverse=dd.inverse.reshape(B, L),
        mask=~((ids_hi == keylib.EMPTY_HI) & (ids_lo == keylib.EMPTY_LO)))
    return state, (lk, routing)


def combine_replicated(union_rows, routing: RepRouting, combiner: str):
    """Bag combine for a replicated table: this rank's rows are a slice
    of the union (no exchange). Differentiable in ``union_rows``."""
    return lkup.combine_bags(union_rows[routing.union_of_local],
                             routing.inverse, routing.mask, combiner)


def exchange_rows_infer(ids_hi, ids_lo,
                        owner_rows_fn: Callable, *, mesh: Mesh,
                        capacity_factor: float = 2.0):
    """Read-only exchange: route the deduplicated ids to their owners,
    compute their rows there with ``owner_rows_fn(rhi, rlo) -> [S*K,
    dim]`` and send the rows back, uncombined. Returns ``(local_rows [n,
    dim], inverse [B, L], mask [B, L])`` for per-column slicing."""
    S = mesh.size
    B, L = ids_hi.shape
    dd = lkup.dedup(ids_hi.reshape(-1), ids_lo.reshape(-1))
    K = per_peer_slots(B * L, S, capacity_factor)
    dest, _ = _route_ids(dd.uhi, dd.ulo, S, K)
    send = torch.stack([_fill_send(dest, dd.uhi, keylib.EMPTY_HI, S, K),
                        _fill_send(dest, dd.ulo, keylib.EMPTY_LO, S, K)],
                       dim=-1)
    recv = mesh.all_to_all(send)
    rows = owner_rows_fn(recv[:, 0].contiguous(), recv[:, 1].contiguous())
    back = mesh.all_to_all(rows)
    back = torch.cat([back, back.new_zeros((1, back.shape[1]))])
    mask = ~((ids_hi == keylib.EMPTY_HI) & (ids_lo == keylib.EMPTY_LO))
    return back[dest], dd.inverse.reshape(B, L), mask


def lookup_rows_infer(cfg, state, ids_hi, ids_lo, *, mesh: Mesh,
                      capacity_factor: float = 2.0):
    """Read-only sharded lookup of an EV table: P1's find and K1's fetch
    on the owner (see :func:`exchange_rows_infer`)."""
    return exchange_rows_infer(
        ids_hi, ids_lo, lambda rhi, rlo: ev.lookup(cfg, state, rhi, rlo),
        mesh=mesh, capacity_factor=capacity_factor)


def bag_lookup_infer(cfg, state, ids_hi, ids_lo, *, mesh: Mesh,
                     combiner: Optional[str] = None,
                     capacity_factor: float = 2.0):
    """Inference: route, look up (no mutation), combine."""
    rows, inverse, mask = lookup_rows_infer(
        cfg, state, ids_hi, ids_lo, mesh=mesh,
        capacity_factor=capacity_factor)
    return lkup.combine_bags(rows, inverse, mask, combiner or cfg.combiner)


# -- static hash-bucket tables, row-sharded ---------------------------------
# PS mod partitioning (``tf.fixed_size_partitioner``, partition_strategy
# "mod"): the group transform already mapped ids to GLOBAL slots (``lo =
# offset + id mod buckets``, ``hi = 0``); shard ``s`` of ``S`` owns the
# global slots ``g`` with ``g % S == s``, at local row ``g // S``.
# ``cfg.capacity`` is the per-shard row count, and ``capacity * S`` the
# global slot space.


def _static_local_uniques(qhi, qlo, N: int, budget: Optional[int]):
    """First-occurrence dedup of global static slots. Returns ``(uslot
    [U+1] int32, inverse [n] int64 in [0, U], n_budget_overflow [])``;
    entry U is the shared padding sentinel (slot ``N``). Without a
    budget U = n, and entries that represent no slot carry ``N``."""
    n = qhi.shape[0]
    dev = qhi.device
    is_real = qhi != keylib.EMPTY_HI
    tokens = torch.arange(n, dtype=torch.int32, device=dev)
    slots = torch.where(is_real, qlo, N).to(torch.int32)
    slot_d = slots.to(torch.int64)
    first = torch.full((N + 1,), n, dtype=torch.int32, device=dev)
    first.scatter_reduce_(0, slot_d, torch.where(is_real, tokens, n),
                          "amin", include_self=True)
    rep_tok = first[slot_d]
    rep = is_real & (rep_tok == tokens)
    sentinel = torch.full((1,), N, dtype=torch.int32, device=dev)
    U = n if budget is None else min(budget, n)
    if U >= n:
        uslot = torch.cat([torch.where(rep, slots, N).to(torch.int32),
                           sentinel])
        inverse = torch.where(is_real, rep_tok, n).to(torch.int64)
        return uslot, inverse, torch.zeros((), dtype=torch.int32,
                                           device=dev)
    pos = torch.cumsum(rep.to(torch.int32), 0, dtype=torch.int32) - 1
    in_budget = rep & (pos < U)
    u_of = torch.full((U + 2,), n, dtype=torch.int32, device=dev)
    u_of[torch.where(in_budget, pos, U + 1).to(torch.int64)] = tokens
    u_idx = u_of[:U]
    pad = u_idx >= n
    safe_u = torch.clamp(u_idx, max=n - 1).to(torch.int64)
    uslot = torch.cat([torch.where(pad, N, slots[safe_u]).to(torch.int32),
                       sentinel])
    prep = pos[torch.clamp(rep_tok, max=n - 1).to(torch.int64)]
    inverse = torch.where(is_real & (prep < U), prep, U).to(torch.int64)
    n_over = torch.clamp(rep.sum(dtype=torch.int32) - U, min=0)
    return uslot, inverse, n_over


def _route_static(uslot, N: int, mesh: Mesh, capacity_factor: float):
    """``(dest, n_overflow, recv)``: the local unique slots mod-routed
    to their owners (``slot % S``) and exchanged; ``recv [S*K]`` holds
    the global slots this rank owns, ``N`` for padding."""
    S = mesh.size
    K = per_peer_slots(uslot.shape[0], S, capacity_factor)
    owner = torch.where(uslot < N, uslot % S, S).to(torch.int32)
    dest, n_overflow = _dest_of(owner, S, K)
    recv = mesh.all_to_all(_fill_send(dest, uslot, N, S, K))
    return dest, n_overflow, recv


def bag_lookup_train_static(cfg: cfglib.TableConfig, state: ev.EVState,
                            ids_hi, ids_lo, global_step: ev.Step, *,
                            mesh: Mesh, capacity_factor: float = 2.0,
                            budget: Optional[int] = None
                            ) -> tuple[ev.EVState, ShardedBagLookup]:
    """Sharded training lookup of a static hash-bucket table; ``state``
    is this rank's shard (``[capacity+1, dim]`` local rows). No insert,
    admission or metadata: one int32 plane of global slots crosses each
    way, and the owner fetches its rows through K1."""
    S = mesh.size
    B, L = ids_hi.shape
    Nloc = cfg.capacity
    N = Nloc * S
    uslot, inverse, n_budget_over = _static_local_uniques(
        ids_hi.reshape(-1), ids_lo.reshape(-1), N, budget)
    dest, n_overflow, recv = _route_static(uslot, N, mesh, capacity_factor)
    SK = recv.shape[0]
    dev = recv.device
    toks = torch.arange(SK, dtype=torch.int32, device=dev)
    lrow = torch.where(recv < N, recv // S, Nloc).to(torch.int64)
    # Owner-side dedup (one slot may come from several peers; the
    # optimizer must see it once): the first recv entry of each row.
    ofirst = torch.full((Nloc + 1,), SK, dtype=torch.int32, device=dev)
    ofirst.scatter_reduce_(0, lrow, toks, "amin", include_self=True)
    orep = (lrow < Nloc) & (ofirst[lrow] == toks)
    owner_inverse = torch.clamp(ofirst[lrow], max=SK - 1).to(torch.int64)
    oslots = torch.where(orep, lrow, Nloc).to(torch.int32)
    lk = ev.LookupResult(
        slots=oslots, rows=gather.gather_rows(state.values, oslots),
        admitted=orep,
        is_new=torch.zeros(SK, dtype=torch.bool, device=dev),
        prev_versions=ev.step_fill((SK,), global_step, dev),
        qhi=torch.where(recv < N, 0, keylib.EMPTY_HI).to(torch.int32),
        qlo=torch.where(recv < N, recv, keylib.EMPTY_LO).to(torch.int32))
    mask = ~((ids_hi == keylib.EMPTY_HI) & (ids_lo == keylib.EMPTY_LO))
    routing = Routing(dest=dest, owner_inverse=owner_inverse,
                      inverse=inverse.reshape(B, L), mask=mask,
                      n_overflow=n_overflow + n_budget_over,
                      recv_pad=recv >= N)
    # A static table keeps no freqs, so its owner consumed no counts.
    return state, ShardedBagLookup(
        lk=lk, routing=routing,
        counts=torch.zeros(SK, dtype=torch.int32, device=dev))


def lookup_rows_infer_static(cfg, state, ids_hi, ids_lo, *, mesh: Mesh,
                             capacity_factor: float = 2.0):
    """Read-only sharded static lookup: dedup the slots, route them to
    their owners, fetch the local rows through K1 and exchange them
    back. Returns ``(local_rows [n+1, dim], inverse [B, L], mask)``."""
    S = mesh.size
    B, L = ids_hi.shape
    Nloc = cfg.capacity
    N = Nloc * S
    uslot, inverse, _ = _static_local_uniques(
        ids_hi.reshape(-1), ids_lo.reshape(-1), N, None)
    dest, _, recv = _route_static(uslot, N, mesh, capacity_factor)
    rows = gather.gather_rows(
        state.values, torch.where(recv < N, recv // S, Nloc).to(torch.int32))
    back = mesh.all_to_all(rows)
    back = torch.cat([back, back.new_zeros((1, back.shape[1]))])
    mask = ~((ids_hi == keylib.EMPTY_HI) & (ids_lo == keylib.EMPTY_LO))
    return back[dest], inverse.reshape(B, L), mask


def bag_lookup_train_replicated_static(cfg: cfglib.TableConfig,
                                       state: ev.EVState, ids_hi, ids_lo,
                                       global_step: ev.Step, *, mesh: Mesh,
                                       budget: Optional[int] = None):
    """Training lookup of a static table held whole on every rank: each
    rank all-gathers the ranks' unique slots and fetches the union's rows
    (K1), identical everywhere. Returns ``(state, (lk, RepRouting))``;
    the gradient is summed across ranks by the caller, as for
    :func:`bag_lookup_train_replicated`."""
    N = cfg.capacity
    uslot, inverse, _ = _static_local_uniques(
        ids_hi.reshape(-1), ids_lo.reshape(-1), N, budget)
    U1 = uslot.shape[0]
    gslot = mesh.all_gather(uslot)                            # [S*U1]
    SU = gslot.shape[0]
    dev = gslot.device
    toks = torch.arange(SU, dtype=torch.int32, device=dev)
    gslot_d = gslot.to(torch.int64)
    ufirst = torch.full((N + 1,), SU, dtype=torch.int32, device=dev)
    ufirst.scatter_reduce_(0, gslot_d, toks, "amin", include_self=True)
    urep = (gslot < N) & (ufirst[gslot_d] == toks)
    uslots = torch.where(urep, gslot, N).to(torch.int32)
    lk = ev.LookupResult(
        slots=uslots, rows=gather.gather_rows(state.values, uslots),
        admitted=urep,
        is_new=torch.zeros(SU, dtype=torch.bool, device=dev),
        prev_versions=ev.step_fill((SU,), global_step, dev),
        qhi=torch.where(gslot < N, 0, keylib.EMPTY_HI).to(torch.int32),
        qlo=torch.where(gslot < N, gslot, keylib.EMPTY_LO).to(torch.int32))
    # Local unique j (the padding sentinel included) sits at gathered
    # position pos[j]; its union row is its representative's, or its
    # own zero row for padding.
    pos = mesh.rank * U1 + torch.arange(U1, dtype=torch.int64, device=dev)
    mine = gslot_d[pos]
    union_of_local = torch.where(
        mine < N, torch.clamp(ufirst[mine], max=SU - 1).to(torch.int64),
        pos)
    B, L = ids_hi.shape
    routing = RepRouting(
        union_of_local=union_of_local, inverse=inverse.reshape(B, L),
        mask=~((ids_hi == keylib.EMPTY_HI) & (ids_lo == keylib.EMPTY_LO)))
    return state, (lk, routing)


def create_shard(cfg: cfglib.TableConfig, device, shard: int,
                 num_shards: int, salt: int = 0) -> ev.EVState:
    """Shard ``shard`` of ``num_shards`` of a row-sharded table on
    ``device``: an empty EV table of the per-shard capacity, or a static
    table's local rows, where local row ``r`` holds global slot ``r*S +
    shard``, drawn as the unsharded table draws that slot (the JAX
    package's ``create_stacked``, one shard of it)."""
    return ev.create(cfg, device, salt=salt, shard=shard,
                     num_shards=num_shards)
