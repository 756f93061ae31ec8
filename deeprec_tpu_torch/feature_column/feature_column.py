"""Feature columns and the embedding group.

Port of ``deeprec_tpu/feature_column/feature_column.py``: columns,
unsharded ``EmbeddingGroup`` construction with coalescing (EV tables of
one signature share a physical table, told apart by XOR salts on both
id halves; static hash-bucket tables of one dim class share a matrix,
told apart by row offsets), id transforms, batch packing on the
device and on the host (the latter with the full and the compact wire
format), state and optimizer-slot creation, and the single-device
training side: the per-table training lookup with its unique budget,
the per-column combine (one gather per table), the fused per-table
combine (``combine_tables``) and the sparse optimizer apply; and the
checkpoint-time eviction pass (``shrink``).

Batch convention:
  * numeric column ``name`` -> float32 [B] or [B, k]
  * sparse column ``name``  -> ``SparseIds(hi [B, L], lo [B, L])``,
    padded with the EMPTY sentinel id.

Sequence columns (``SequenceEmbeddingColumn``) combine to their
per-position rows and mask.

A group built for a mesh (``axis_name``, ``num_shards``) places each
physical table (``placement``): "sharded" tables are row-sharded over
the ranks, each rank holding its shard (``embedding/sharded.py``:
ids exchanged all-to-all, looked up on the owner, rows exchanged
back), and "replicated" ones are held whole on every rank (a union
lookup of the ranks' ids, no exchange). The mesh itself is passed to
``lookup_train`` and ``create_state``; a mesh group routes its sharded
tables through the exchange even at one rank.

Column variants: a weighted column (``weight_name``) scales each
occurrence by its batch weight before the bag combine; a
dynamic-dimension column with ``dyn_dim_hot_capacity`` splits into a
base table and a ``<table>#hot`` sibling holding blocks 1.. at the
small capacity (``embedding/dyn_dim.py``), whose columns' outputs are
concatenated back in :meth:`EmbeddingGroup.combine`; an adaptive column
(``adaptive_hot_threshold``) reads cold ids from a static bucket table,
a dense param ``params["adaptive_static.<table>"]``
(:meth:`EmbeddingGroup.adaptive_static_params`), and hot ids from its
EV table (``embedding/adaptive.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from deeprec_tpu_torch import config as cfglib
from deeprec_tpu_torch.embedding import adaptive as adlib
from deeprec_tpu_torch.embedding import dyn_dim as ddlib
from deeprec_tpu_torch.embedding import lookup as lkup
from deeprec_tpu_torch.embedding import sharded
from deeprec_tpu_torch.embedding import variable as ev
from deeprec_tpu_torch.ops.kernels import occ_combine as occlib
from deeprec_tpu_torch.utils import keys as keylib
from deeprec_tpu_torch.utils import stateless_random as srand
from deeprec_tpu_torch.utils import trace


def _member_salt(i: int) -> tuple[int, int]:
    """(hi, lo) int32 XOR salts for coalesced-table member ``i``:
    splitmix64 of i+1, both halves forced non-zero."""
    m = (1 << 64) - 1
    x = ((i + 1) * 0x9E3779B97F4A7C15) & m
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & m
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & m
    x ^= x >> 31
    hi, lo = (x >> 32) & 0xFFFFFFFF, x & 0xFFFFFFFF
    hi, lo = hi or 0x5851F42D, lo or 0x5851F42D
    to_i32 = lambda v: v - (1 << 32) if v >= (1 << 31) else v  # noqa: E731
    return to_i32(hi), to_i32(lo)


class SparseIds(NamedTuple):
    """Padded-dense sparse feature: split int64 ids."""

    hi: torch.Tensor  # [B, L] int32
    lo: torch.Tensor  # [B, L] int32

    @staticmethod
    def from_numpy(ids: np.ndarray, device="cuda") -> "SparseIds":
        ids = np.asarray(ids, np.int64)
        hi, lo = keylib.split_ids(ids.reshape(-1))
        return SparseIds(torch.from_numpy(hi).reshape(ids.shape).to(device),
                         torch.from_numpy(lo).reshape(ids.shape).to(device))


class CompactIds(NamedTuple):
    """Half-width wire format of one physical table's ids: one int32
    [B, L] tensor of the raw (unsalted) ids, int32 min marking EMPTY
    padding. ``EmbeddingGroup._packed_view`` rebuilds the (hi, lo) pair
    and applies the salts or bucket offsets on the device."""

    ids: torch.Tensor  # [B, L] int32


def batch_to(batch: Dict[str, Any], device) -> Dict[str, Any]:
    """Move every tensor (and ``SparseIds``/``CompactIds``) leaf of a
    batch to ``device``; numpy leaves become tensors there."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, SparseIds):
            out[k] = SparseIds(v.hi.to(device), v.lo.to(device))
        elif isinstance(v, CompactIds):
            out[k] = CompactIds(v.ids.to(device))
        else:
            out[k] = torch.as_tensor(v).to(device)
    return out


@dataclasses.dataclass(frozen=True)
class NumericColumn:
    """``tf.feature_column.numeric_column`` analog."""

    name: str
    shape: int = 1


@dataclasses.dataclass(frozen=True)
class EmbeddingColumn:
    """``categorical_column_with_embedding`` + ``embedding_column``.
    ``shared_name`` makes several columns share one table."""

    name: str
    dim: int
    capacity: int = 1 << 17
    combiner: str = "mean"
    initializer: str = "truncated_normal"
    # None -> 1/sqrt(dim), the reference embedding_column default.
    init_scale: Optional[float] = None
    ev_option: cfglib.EmbeddingVariableOption = dataclasses.field(
        default_factory=cfglib.EmbeddingVariableOption)
    shared_name: Optional[str] = None
    max_probes: int = 64
    # Declared id-space size (mod-bucket columns: the hash bucket
    # count). Bounds the distinct ids one step can route to the table,
    # min(num_buckets, B*L) per column, which shrinks every unique-level
    # row op to that budget (``variable.lookup_train_occ``). None keeps
    # the exact budget U = n.
    num_buckets: Optional[int] = None
    # Static hash-bucket column (``categorical_column_with_hash_bucket``
    # + ``embedding_column``, the reference's default column type):
    # requires ``num_buckets``; ids address a fully initialized
    # [num_buckets, dim] matrix by ``id mod num_buckets``, collisions by
    # design, with no hash table, probe, admission or eviction.
    static_bucket: bool = False
    # Dynamic-dimension EV: dim splits into ``dyn_dim_blocks`` blocks
    # unlocked by frequency (``dyn_dim_thresholds``, blocks - 1 of
    # them). With ``dyn_dim_hot_capacity`` the group stores blocks 1..
    # in a sibling table of that capacity whose rows a key gets once it
    # crosses the first threshold (``embedding/dyn_dim.py``); without
    # it, the full matrix is stored and the locked blocks are masked.
    dyn_dim_blocks: int = 1
    dyn_dim_thresholds: tuple = ()
    dyn_dim_hot_capacity: Optional[int] = None
    # ``weighted_categorical_column``: the batch key of a [B, L] float
    # weight per occurrence, applied before the bag combiner (sum_i w_i
    # x_i; mean divides by sum w, sqrtn by sqrt(sum w^2)).
    weight_name: Optional[str] = None
    # ``categorical_column_with_adaptive_embedding``: cold ids share a
    # static table of ``adaptive_buckets`` rows (a dense param, see
    # ``EmbeddingGroup.adaptive_static_params``); ids whose frequency
    # reaches ``adaptive_hot_threshold`` get their own EV rows, seeded
    # from their static row.
    adaptive_hot_threshold: Optional[int] = None
    adaptive_buckets: int = 1 << 16

    @property
    def table_name(self) -> str:
        return self.shared_name or self.name

    def table_config(self) -> cfglib.TableConfig:
        scale = (self.init_scale if self.init_scale is not None
                 else self.dim ** -0.5)
        if self.static_bucket:
            if not self.num_buckets:
                raise ValueError(
                    f"column {self.name}: static_bucket requires "
                    "num_buckets")
            return cfglib.TableConfig(
                name=self.table_name, dim=self.dim,
                capacity=int(self.num_buckets),
                initializer=self.initializer, init_scale=scale,
                combiner=self.combiner, static_buckets=True)
        return cfglib.TableConfig(
            name=self.table_name, dim=self.dim, capacity=self.capacity,
            initializer=self.initializer, init_scale=scale,
            ev_option=self.ev_option, combiner=self.combiner,
            max_probes=self.max_probes, block_num=self.dyn_dim_blocks,
            dyn_dim_thresholds=self.dyn_dim_thresholds,
            adaptive_hot_threshold=self.adaptive_hot_threshold,
            adaptive_buckets=(self.adaptive_buckets
                              if self.adaptive_hot_threshold else 0))


@dataclasses.dataclass(frozen=True)
class SequenceEmbeddingColumn(EmbeddingColumn):
    """Behavior-sequence column: :meth:`EmbeddingGroup.combine` returns
    its per-position rows ``[B, L, dim]`` and mask ``[B, L]`` instead of
    a combined bag (the DIN, DIEN, BST and DSSM input)."""


class AdaptiveBits(NamedTuple):
    """Per-unique routing of an adaptive table: a hot id reads its EV
    row, a cold one its static bucket (``embedding/adaptive.py``)."""

    hot: torch.Tensor        # [n_unique] bool
    newly_hot: torch.Tensor  # [n_unique] bool
    bucket: torch.Tensor     # [n_unique] int32 static-table row


class ColumnLookup(NamedTuple):
    """Differentiation-side info for one column's lookup."""

    column: Any
    table_name: str
    inverse: torch.Tensor   # [B, L]
    mask: torch.Tensor      # [B, L]
    # A mesh table's ``sharded.Routing`` or ``sharded.RepRouting``.
    routing: Any = None
    weights: Optional[torch.Tensor] = None  # [B, L] per-occurrence weights
    adp: Optional[AdaptiveBits] = None      # adaptive columns only


class GroupLookup(NamedTuple):
    """All lookups of one step."""

    lks: Dict[str, ev.LookupResult]      # per table (rows: the grad inputs)
    columns: Dict[str, ColumnLookup]     # per column
    # Distinct ids dropped by each table's unique budget (on a mesh, by
    # a sharded table's exchange) this step.
    budget_overflow: Dict[str, torch.Tensor]
    mesh: Any = None                     # the mesh of a sharded lookup


class EmbeddingGroup:
    """Owns every embedding table of a model, on one device or, with
    ``axis_name``, on a mesh of ``num_shards`` ranks.

    ``placement`` picks each physical table's layout on a mesh: None
    (every table sharded), "auto" (replicate a table whose full
    footprint, values and two slot arrays of float32 plus 16 bytes a
    row, fits ``replicate_threshold`` bytes) or a dict {logical or
    physical table name: "sharded" | "replicated"}; a coalesced table
    follows its members where they agree. A sharded table's
    ``capacity`` is its per-shard capacity (a static table's: its
    per-shard row count, rounded up)."""

    PACKED_PREFIX = "__packed__"
    NUMERIC_PLANE = "__numeric__"

    def __init__(self, columns: Sequence[Any], *, coalesce: bool = False,
                 axis_name: Optional[str] = None, num_shards: int = 1,
                 placement: Any = None,
                 replicate_threshold: int = 4 << 20):
        self.numeric = [c for c in columns if isinstance(c, NumericColumn)]
        self.embedding = [c for c in columns
                          if isinstance(c, EmbeddingColumn)]
        if num_shards > 1 and axis_name is None:
            raise ValueError(f"num_shards={num_shards} needs an axis_name "
                             "(the mesh axis the shards ride on)")
        self.axis_name = axis_name
        self.num_shards = int(num_shards)
        self._placement_req = placement
        self._replicate_threshold = int(replicate_threshold)
        self.placement: Dict[str, str] = {}
        self.tables: Dict[str, cfglib.TableConfig] = {}
        self.salts: Dict[str, int] = {}
        self._pack_widths: Optional[Dict[str, list]] = None
        # Logical table -> (physical table, id salt or 0).
        self._phys_of: Dict[str, tuple[str, Any]] = {}
        # Base physical table -> its hot-block sibling (dyn_dim split).
        self._dyn_hot: Dict[str, str] = {}
        logical: Dict[str, cfglib.TableConfig] = {}
        hot_caps: Dict[str, int] = {}
        for c in self.embedding:
            tc = c.table_config()
            if tc.name in logical:
                if logical[tc.name].dim != tc.dim:
                    raise ValueError(f"shared table {tc.name}: dim mismatch")
            else:
                logical[tc.name] = tc
                if tc.block_num > 1 and c.dyn_dim_hot_capacity:
                    hot_caps[tc.name] = int(c.dyn_dim_hot_capacity)
        # Tables are added in the JAX package's order (their salts, hence
        # their draws, follow it): dyn-dim splits, static tables,
        # adaptive tables, the rest. A split table's base and hot sibling
        # bypass coalescing, so both look up the same unsalted ids.
        for name, hc in hot_caps.items():
            base_cfg, hot_cfg = ddlib.split_configs(logical.pop(name), hc)
            self._phys_of[name] = (name, 0)
            self._add_table(base_cfg)
            self._add_table(hot_cfg, inherit=base_cfg.name)
            self._dyn_hot[name] = hot_cfg.name
        # Static tables; with ``coalesce``, one matrix per dim class whose
        # members own disjoint row ranges.
        # Logical static table -> (row offset, bucket count).
        self._static_map: Dict[str, tuple[int, int]] = {}
        static: Dict[tuple, list] = {}
        for name in [n for n, tc in logical.items() if tc.static_buckets]:
            tc = logical.pop(name)
            sig = ((tc.dim, tc.initializer, tc.init_scale, str(tc.dtype))
                   if coalesce else (name,))
            static.setdefault(sig, []).append((name, tc))
        for members in static.values():
            members = sorted(members, key=lambda m: m[0])
            phys_name = (members[0][0] if len(members) == 1 else
                         "static:" + ",".join(n for n, _ in members))
            off = 0
            for name, tc in members:
                self._phys_of[name] = (phys_name, 0)
                self._static_map[name] = (off, tc.capacity)
                off += tc.capacity
            self._add_table(dataclasses.replace(members[0][1],
                                                name=phys_name, capacity=off),
                            members=[n for n, _ in members])
        # Adaptive tables bypass coalescing: their lookup's hot/bucket
        # routing is the table's own.
        for name in [n for n, tc in logical.items()
                     if tc.adaptive_hot_threshold is not None]:
            tc = logical.pop(name)
            if tc.block_num > 1:
                raise ValueError(
                    f"table {name}: adaptive embedding cannot combine "
                    "with dynamic-dimension blocks")
            self._phys_of[name] = (name, 0)
            self._add_table(tc)
        if not coalesce:
            for name, tc in logical.items():
                self._phys_of[name] = (name, 0)
                self._add_table(tc)
            return
        groups: Dict[tuple, list] = {}
        for name, tc in logical.items():
            sig = (tc.dim, tc.initializer, tc.init_scale, str(tc.dtype),
                   tc.ev_option, tc.max_probes, tc.block_num,
                   tc.dyn_dim_thresholds)
            groups.setdefault(sig, []).append((name, tc))
        for members in groups.values():
            if len(members) == 1:
                name, tc = members[0]
                self._phys_of[name] = (name, 0)
                self._add_table(tc)
                continue
            total = sum(tc.capacity for _, tc in members)
            cap = 1
            while cap < total:
                cap <<= 1
            phys_name = "coalesced:" + ",".join(
                sorted(n for n, _ in members))
            for i, (name, _) in enumerate(sorted(members)):
                self._phys_of[name] = (phys_name, _member_salt(i))
            self._add_table(dataclasses.replace(members[0][1],
                                                name=phys_name, capacity=cap),
                            members=[n for n, _ in members])

    def _resolve_placement(self, tc: cfglib.TableConfig, members=None,
                           inherit: Optional[str] = None) -> str:
        req = self._placement_req
        if self.num_shards <= 1 or req is None:
            return "sharded"
        if tc.adaptive_hot_threshold is not None:
            # The static half is a dense param on every rank already;
            # replicating the EV half too would be worse than widening
            # the static table.
            return "sharded"
        if isinstance(req, dict):
            if tc.name in req:
                return req[tc.name]
            votes = {req[m] for m in members or () if m in req}
            if len(votes) == 1:
                return votes.pop()
            if inherit is not None and inherit in self.placement:
                return self.placement[inherit]
            return "sharded"
        if req == "auto":
            # Replicating costs the full table on every rank; it saves the
            # table's two all-to-alls and its skew-overflow exposure.
            bytes_full = tc.capacity * (tc.dim * 4 * 3 + 16)
            return ("replicated" if bytes_full <= self._replicate_threshold
                    else "sharded")
        raise ValueError(f"unknown placement {req!r}")

    def _add_table(self, tc: cfglib.TableConfig, members=None,
                   inherit: Optional[str] = None):
        place = self._resolve_placement(tc, members, inherit)
        if place not in ("sharded", "replicated"):
            raise ValueError(f"table {tc.name}: unknown placement {place!r}")
        if self.num_shards > 1 and place == "sharded":
            # Static: ceil, so the global slot space capacity * S (slot g
            # on shard g % S at local row g // S) covers every offset.
            per = (-(-tc.capacity // self.num_shards) if tc.static_buckets
                   else tc.capacity // self.num_shards)
            tc = dataclasses.replace(tc, capacity=max(8, per))
        self.placement[tc.name] = place
        self.salts[tc.name] = len(self.tables) + 1
        self.tables[tc.name] = tc

    def _is_stacked(self, tname: str) -> bool:
        """True for a row-sharded table of a mesh group: this rank holds
        one shard of it (the JAX package's state has a leading [S] axis
        there, hence the name)."""
        return (self.axis_name is not None
                and self.placement[tname] == "sharded")

    def _is_replicated(self, tname: str) -> bool:
        """True for a table held whole on every rank of a mesh group."""
        return (self.axis_name is not None
                and self.placement[tname] == "replicated")

    def placement_plan(self) -> Dict[str, str]:
        """Resolved placement of every physical table."""
        return dict(self.placement)

    def physical_table_of(self, column: EmbeddingColumn) -> str:
        return self._phys_of[column.table_name][0]

    def _columns_by_table(self) -> Dict[str, list]:
        by_table: Dict[str, list] = {}
        for c in self.embedding:
            by_table.setdefault(self.physical_table_of(c), []).append(c)
        return by_table

    # -- id transforms ----------------------------------------------------
    def transform_ids(self, column: EmbeddingColumn, ids_hi, ids_lo):
        """XOR the column's coalescing salt into both halves of real ids.
        Exact sentinels pass through; a salted id landing on a sentinel
        pair is nudged off it (flip bit 1 of lo). A static column maps
        real ids to their row instead: ``hi = 0``, ``lo = offset + id
        mod buckets``."""
        st = self._static_map.get(column.table_name)
        if st is not None:
            off, nb = st
            sent = (ids_hi == keylib.EMPTY_HI) & (
                (ids_lo == keylib.EMPTY_LO) | (ids_lo == keylib.TOMB_LO))
            slot = off + keylib.mod_of(ids_hi, ids_lo, nb)
            return (torch.where(sent, ids_hi, 0).to(torch.int32),
                    torch.where(sent, ids_lo, slot).to(torch.int32))
        salt = self._phys_of[column.table_name][1]
        if salt == 0:
            return ids_hi, ids_lo
        salt_hi, salt_lo = salt
        sent = (ids_hi == keylib.EMPTY_HI) & (
            (ids_lo == keylib.EMPTY_LO) | (ids_lo == keylib.TOMB_LO))
        hi = torch.where(sent, ids_hi, ids_hi ^ salt_hi)
        lo = torch.where(sent, ids_lo, ids_lo ^ salt_lo)
        hit = ~sent & (hi == keylib.EMPTY_HI) & (
            (lo == keylib.EMPTY_LO) | (lo == keylib.TOMB_LO))
        return hi, torch.where(hit, lo ^ 2, lo)

    def transform_ids_np(self, column: EmbeddingColumn, ids: np.ndarray):
        """Host mirror of :meth:`transform_ids` on raw int64 ids."""
        hi, lo = keylib.split_ids(np.asarray(ids, np.int64))
        st = self._static_map.get(column.table_name)
        if st is not None:
            off, nb = st
            sent = (hi == keylib.EMPTY_HI) & (
                (lo == keylib.EMPTY_LO) | (lo == keylib.TOMB_LO))
            slot = (np.int64(off)
                    + (np.asarray(ids, np.int64).view(np.uint64)
                       % np.uint64(nb)).astype(np.int64)).astype(np.int32)
            return (np.where(sent, hi, 0).astype(np.int32),
                    np.where(sent, lo, slot).astype(np.int32))
        salt = self._phys_of[column.table_name][1]
        if salt == 0:
            return hi, lo
        salt_hi, salt_lo = salt
        sent = (hi == keylib.EMPTY_HI) & (
            (lo == keylib.EMPTY_LO) | (lo == keylib.TOMB_LO))
        hi2 = np.where(sent, hi, hi ^ np.int32(salt_hi))
        lo2 = np.where(sent, lo, lo ^ np.int32(salt_lo))
        hit = ~sent & (hi2 == keylib.EMPTY_HI) & (
            (lo2 == keylib.EMPTY_LO) | (lo2 == keylib.TOMB_LO))
        return hi2, np.where(hit, lo2 ^ np.int32(2), lo2)

    # -- packed batches ---------------------------------------------------
    def pack_batch(self, batch):
        """Device packing of a per-column batch (``SparseIds`` leaves on
        any device): each physical table's ids, transformed (salts,
        bucket rows) on their device, become one ``SparseIds`` pair
        ``[B, sum(L)]``; other leaves pass through. Records the column
        widths on the group (``_pack_widths``) on first use, as
        :meth:`pack_batch_np` does, whose output it equals bit for bit
        on the same raw ids."""
        packed: Dict[str, Any] = {}
        widths: Dict[str, list] = {}
        for tname, tcols in self._columns_by_table().items():
            his, los = zip(*(self.transform_ids(c, batch[c.name].hi,
                                                batch[c.name].lo)
                             for c in tcols))
            packed[self.PACKED_PREFIX + tname] = SparseIds(
                torch.cat(his, dim=1), torch.cat(los, dim=1))
            widths[tname] = [int(h.shape[1]) for h in his]
        if self._pack_widths is None:
            self._pack_widths = widths
        for k, v in batch.items():
            if not isinstance(v, SparseIds):
                packed[k] = v
        return packed

    def pack_batch_np(self, batch, device="cuda", compact: bool = False):
        """Host packing of raw numpy leaves (int64 id matrices for sparse
        columns) into tensors on ``device``: each physical table's ids
        become one ``SparseIds`` pair, transformed (salts, bucket rows)
        and concatenated on the host; other leaves become tensors.

        ``compact=True`` is the half-width wire format: a table whose
        every id round-trips through int32 ships as one raw int32
        :class:`CompactIds` plane (the transform then runs on the
        device, in :meth:`_packed_view`), the numeric columns as one
        bfloat16 plane under ``NUMERIC_PLANE``, other float leaves as
        bfloat16 and int64 leaves as int32 where that is lossless.
        Tables with wider ids keep the full pair."""
        packed: Dict[str, Any] = {}
        widths: Dict[str, list] = {}
        int32_min = np.int32(-(2**31))
        for tname, tcols in self._columns_by_table().items():
            raw, ws = [], []
            for c in tcols:
                ids = np.asarray(batch[c.name], np.int64)
                raw.append(ids[:, None] if ids.ndim == 1 else ids)
                ws.append(int(raw[-1].shape[1]))
            widths[tname] = ws
            if compact:
                cat = np.concatenate(raw, axis=1)
                cat32 = cat.astype(np.int32)
                # EMPTY padding rides the wire as int32 min, which real
                # ids must then avoid.
                is_pad = cat == keylib.EMPTY_ID
                lossless = ((cat32.astype(np.int64) == cat)
                            & (cat32 != int32_min))
                if bool((lossless | is_pad).all()):
                    packed[self.PACKED_PREFIX + tname] = CompactIds(
                        torch.from_numpy(np.where(is_pad, int32_min,
                                                  cat32)).to(device))
                    continue
            his, los = zip(*(self.transform_ids_np(c, ids)
                             for c, ids in zip(tcols, raw)))
            packed[self.PACKED_PREFIX + tname] = SparseIds(
                torch.from_numpy(np.concatenate(his, axis=1)).to(device),
                torch.from_numpy(np.concatenate(los, axis=1)).to(device))
        if self._pack_widths is None:
            self._pack_widths = widths
        skip = {c.name for c in self.embedding}
        num_names = {c.name for c in self.numeric}
        if compact and self.numeric and num_names <= set(batch):
            # One plane instead of a leaf per numeric column: every
            # host-to-device copy pays a fixed cost.
            parts = [np.asarray(batch[c.name], np.float32)
                     for c in self.numeric]
            plane = np.concatenate(
                [a[:, None] if a.ndim == 1 else a for a in parts], axis=1)
            packed[self.NUMERIC_PLANE] = torch.from_numpy(plane).to(
                torch.bfloat16).to(device)
            skip |= num_names
        for k, v in batch.items():
            if k in skip:
                continue
            a = np.asarray(v)
            if compact and a.dtype in (np.float64, np.float32):
                t = torch.from_numpy(a).to(torch.bfloat16)
            elif (compact and a.dtype == np.int64
                  and bool((a.astype(np.int32) == a).all())):
                t = torch.from_numpy(a.astype(np.int32))
            else:
                t = torch.as_tensor(a)
            packed[k] = t.to(device)
        return packed

    def _packed_view(self, batch, tname, tcols):
        """(ids_hi, ids_lo, widths) for one physical table from either a
        packed or a per-column batch."""
        key = self.PACKED_PREFIX + tname
        if key in batch:
            s = batch[key]
            widths = self._pack_widths[tname]
            if not isinstance(s, CompactIds):
                return s.hi, s.lo, widths
            hi, lo = keylib.split_ids_tensor(s.ids)
            pad = s.ids == -(2**31)
            hi = torch.where(pad, keylib.EMPTY_HI, hi)
            lo = torch.where(pad, keylib.EMPTY_LO, lo)
            his, los, off = [], [], 0
            for c, w in zip(tcols, widths):
                h, l = self.transform_ids(c, hi[:, off:off + w],
                                          lo[:, off:off + w])
                his.append(h)
                los.append(l)
                off += w
            return torch.cat(his, dim=1), torch.cat(los, dim=1), widths
        his, los = [], []
        for c in tcols:
            s = batch[c.name]
            if not isinstance(s, SparseIds):
                raise TypeError(
                    f"column {c.name!r}: expected SparseIds, got "
                    f"{type(s).__name__}; pack raw id arrays with "
                    "group.pack_batch_np(batch) or SparseIds.from_numpy")
            hi, lo = self.transform_ids(c, s.hi, s.lo)
            his.append(hi)
            los.append(lo)
        return (torch.cat(his, dim=1), torch.cat(los, dim=1),
                [h.shape[1] for h in his])

    # -- state ----------------------------------------------------------
    def create_state(self, device, shard: int = 0) -> Dict[str, ev.EVState]:
        """Fresh tables on ``device``; a sharded table's shard ``shard``
        (the rank's, on a mesh)."""
        return {n: (sharded.create_shard(c, device, shard, self.num_shards,
                                         salt=self.salts[n])
                    if self._is_stacked(n)
                    else ev.create(c, device, salt=self.salts[n]))
                for n, c in self.tables.items()}

    def init_optimizer(self, opt, device) -> Dict[str, Any]:
        """Sparse-optimizer slot state of every table on ``device``."""
        return {n: opt.init(c, device) for n, c in self.tables.items()}

    # -- training ---------------------------------------------------------
    def _check_mesh(self, mesh):
        if (mesh is None) != (self.axis_name is None):
            raise ValueError(
                "a group built with axis_name looks up on a mesh, and "
                f"only such a group does (axis_name={self.axis_name!r}, "
                f"mesh={mesh!r})")
        if mesh is not None and (mesh.size != self.num_shards
                                 or mesh.axis_name != self.axis_name):
            raise ValueError(f"{mesh!r} does not match the group's "
                             f"{self.num_shards} shards on axis "
                             f"{self.axis_name!r}")

    def _table_lookup(self, tname, state, ids_hi, ids_lo, global_step,
                      budget, mesh):
        """One physical table's training lookup under its placement:
        ``(state, lk, inverse, mask, routing, n_overflow, adp)``; a
        replicated table drops no id, and ``adp`` is an adaptive
        table's :class:`AdaptiveBits` (None for the others)."""
        cfg = self.tables[tname]
        salt = self.salts[tname]
        zero = torch.zeros((), dtype=torch.int32, device=ids_hi.device)
        if cfg.adaptive_hot_threshold is not None:
            kw = dict(hot_threshold=cfg.adaptive_hot_threshold,
                      num_buckets=cfg.adaptive_buckets, salt=salt)
            if self._is_stacked(tname):
                state, al = adlib.lookup_train_sharded(
                    cfg, state, ids_hi, ids_lo, global_step, mesh=mesh, **kw)
                routing, n_over = al.routing, al.routing.n_overflow
            else:
                state, al = adlib.lookup_train(cfg, state, ids_hi, ids_lo,
                                               global_step, **kw)
                routing, n_over = None, zero
            return (state, al.lk, al.inverse, al.mask, routing, n_over,
                    AdaptiveBits(hot=al.hot, newly_hot=al.newly_hot,
                                 bucket=al.bucket))
        if self._is_stacked(tname):
            if cfg.static_buckets:
                state, sbl = sharded.bag_lookup_train_static(
                    cfg, state, ids_hi, ids_lo, global_step, mesh=mesh,
                    budget=budget)
            else:
                state, sbl = sharded.bag_lookup_train(
                    cfg, state, ids_hi, ids_lo, global_step, mesh=mesh,
                    salt=salt)
            r = sbl.routing
            return state, sbl.lk, r.inverse, r.mask, r, r.n_overflow, None
        if self._is_replicated(tname):
            if cfg.static_buckets:
                state, (lk, r) = sharded.bag_lookup_train_replicated_static(
                    cfg, state, ids_hi, ids_lo, global_step, mesh=mesh,
                    budget=budget)
            else:
                state, (lk, r) = sharded.bag_lookup_train_replicated(
                    cfg, state, ids_hi, ids_lo, global_step, mesh=mesh,
                    salt=salt)
            return state, lk, r.inverse, r.mask, r, zero, None
        state, bl = lkup.bag_lookup_train(
            cfg, state, ids_hi, ids_lo, global_step, salt=salt,
            unique_budget=budget)
        return state, bl.lk, bl.inverse, bl.mask, None, bl.n_overflow, None

    def lookup_train(self, states, batch, global_step: ev.Step, mesh=None):
        """Returns ``(states, GroupLookup)``; the tables of ``states``
        are updated in place (inserts, row init, metadata). A mesh group
        takes its ``mesh`` (``parallel.mesh.Mesh``); ``states`` and
        ``batch`` are then this rank's. A weighted column takes its
        weights from ``batch[column.weight_name]``. A dyn-dim split
        table's hot sibling looks up the same ids; its columns' lookups
        are filed as ``<column>#hot``.

        While tracing is on (``utils/trace.py``) each physical table's
        lookup is the span ``lookup/<table>`` (P1, P2 and K1 inside it
        are ``probe``, ``draw`` and ``fetch``) and counts, under
        ``<table>/``: ``probe_rounds`` and ``probe_rounds_max`` (P1's
        rounds), ``fresh_rows`` (the rows P2 drew), ``dropped_ids`` (its
        ``budget_overflow``) and ``steps``."""
        self._check_mesh(mesh)
        lks: Dict[str, ev.LookupResult] = {}
        cols: Dict[str, ColumnLookup] = {}
        budget_overflow: Dict[str, torch.Tensor] = {}
        for tname, tcols in self._columns_by_table().items():
            ids_hi, ids_lo, widths = self._packed_view(batch, tname, tcols)
            budget = self._unique_budget(tcols, widths, ids_hi.shape)
            weights = [batch[c.weight_name] if c.weight_name else None
                       for c in tcols]
            for t, suffix in ((tname, ""),
                              (self._dyn_hot.get(tname), "#hot")):
                if t is None:
                    continue
                with trace.span(f"lookup/{t}", table=t):
                    (states[t], lks[t], inverse, mask, routing,
                     budget_overflow[t], adp) = self._table_lookup(
                        t, states[t], ids_hi, ids_lo, global_step, budget,
                        mesh)
                    trace.count("dropped_ids", budget_overflow[t])
                    trace.count("steps", 1, device=ids_hi.device)
                off = 0
                for c, w, cw in zip(tcols, widths, weights):
                    cols[c.name + suffix] = ColumnLookup(
                        column=c, table_name=t,
                        inverse=inverse[:, off:off + w],
                        mask=mask[:, off:off + w], routing=routing,
                        weights=cw, adp=adp)
                    off += w
        return states, GroupLookup(lks=lks, columns=cols,
                                   budget_overflow=budget_overflow,
                                   mesh=mesh)

    def _local_rows(self, gl: GroupLookup, rows: Dict[str, torch.Tensor],
                    params=None):
        """Per table, the rows this rank's occurrences index: the
        lookup's own rows, a replicated table's slice of the union, or a
        sharded table's rows exchanged back from their owners (the
        differentiable return exchange). An adaptive table's cold
        uniques take their static bucket's row first, at the lookup's
        (owner's) level, so each id's gradient goes to exactly one side:
        its EV row or the static param."""
        first = {}
        for cl in gl.columns.values():
            first.setdefault(cl.table_name, cl)
        out = {}
        for tname, r in rows.items():
            cl = first.get(tname)
            rt = cl.routing if cl is not None else None
            if cl is not None and cl.adp is not None:
                static = self._adaptive_static(params, tname)
                idx = adlib.static_index(cl.adp.bucket, gl.lks[tname].qhi,
                                         static.shape[0])
                r = torch.where(cl.adp.hot[:, None], r,
                                static[idx].to(r.dtype))
            if isinstance(rt, sharded.Routing):
                out[tname] = sharded.local_rows(r, rt, gl.mesh)
            elif isinstance(rt, sharded.RepRouting):
                out[tname] = r[rt.union_of_local]
            else:
                out[tname] = r
        return out

    def _occurrences(self, gl: GroupLookup, rows: Dict[str, torch.Tensor],
                     params=None, stacked: bool = False):
        """Per physical table: ``(table, items, outputs)`` with ``items``
        its ``(column name, ColumnLookup)`` pairs and ``outputs`` each
        one's combined rows (``stacked``: the table's one ``[B, L_total,
        dim]`` tensor of masked occurrence rows), from one
        ``occ_combine`` call a table (``ops/kernels/occ_combine.py``:
        one launch forward, a segmented sum backward)."""
        by_tbl: Dict[str, list] = {}
        for cname, cl in gl.columns.items():
            by_tbl.setdefault(cl.table_name, []).append((cname, cl))
        rows = self._local_rows(gl, rows, params)
        for tname, items in by_tbl.items():
            inv = torch.cat([cl.inverse for _, cl in items], dim=1)
            msk = torch.cat([cl.mask for _, cl in items], dim=1)
            if stacked:
                cols = [occlib.Column(inv.shape[1], sequence=True)]
                weights = [None]
            else:
                cols = [occlib.Column(
                    cl.inverse.shape[1],
                    isinstance(cl.column, SequenceEmbeddingColumn),
                    cl.column.combiner) for _, cl in items]
                weights = [cl.weights for _, cl in items]
            yield tname, items, occlib.occ_combine(
                rows[tname], inv, msk, cols, weights, table=tname)

    def combine(self, gl: GroupLookup, rows: Dict[str, torch.Tensor],
                params=None):
        """``rows[table]`` -> per-column embeddings, differentiable in
        ``rows`` (and in the static tables of ``params``, which adaptive
        columns need): a bag column's [B, dim], a sequence column's
        ``([B, L, dim] rows, zero at padding; mask [B, L])``. A dyn-dim
        split column's hot blocks are concatenated onto its base
        block."""
        out = {}
        for _, items, embs in self._occurrences(gl, rows, params):
            for (cname, cl), e in zip(items, embs):
                out[cname] = ((e, cl.mask)
                              if isinstance(cl.column, SequenceEmbeddingColumn)
                              else e)
        return self._merge_dyn_hot(out)

    def combine_tables(self, gl: GroupLookup,
                       rows: Dict[str, torch.Tensor], params=None):
        """Fused per-table combine: one masked occurrence tensor per
        physical table, without the per-column split, for models that
        take whole-table matrices (``wdl.apply_fn_fused``). Every member
        column must be a width-1 unweighted bag column (single-valued
        fields, where the combiner does not matter); raises
        ``ValueError`` otherwise, a sequence column included, whatever
        its width. Returns ``{table: ([B, n_cols, dim] rows, [column
        names])}`` (a dyn-dim hot sibling's under its own table, its
        columns as ``<column>#hot``), differentiable in ``rows`` (and
        ``params``) as :meth:`combine` is."""
        for cname, cl in gl.columns.items():
            if (isinstance(cl.column, SequenceEmbeddingColumn)
                    or cl.inverse.shape[1] != 1 or cl.weights is not None):
                raise ValueError(
                    f"combine_tables: column {cname!r} is not a width-1 "
                    "unweighted bag column; use combine()")
        return {tname: (embs[0], [cname for cname, _ in items])
                for tname, items, embs in self._occurrences(
                    gl, rows, params, stacked=True)}

    @staticmethod
    def _merge_dyn_hot(out):
        """Concatenate each ``<column>#hot`` output onto its column's
        (cold keys read zeros there)."""
        for cname in [k for k in out if k.endswith("#hot")]:
            base = cname[:-len("#hot")]
            h = out.pop(cname)
            if isinstance(out[base], tuple):
                seq, m = out[base]
                out[base] = (torch.cat([seq, h[0]], dim=-1), m)
            else:
                out[base] = torch.cat([out[base], h], dim=-1)
        return out

    def apply_gradients(self, opt, slot_states, states, gl: GroupLookup,
                        grad_rows: Dict[str, torch.Tensor],
                        global_step: ev.Step,
                        lr=None):
        """Sparse-apply each table's row gradients, in place. Returns
        ``(slot_states, states)``. On a mesh a sharded table's apply
        runs on this rank's shard, with the gradients the return
        exchange sent back to the owner; a replicated table's takes the
        gradient summed over the ranks, so every replica applies the
        same update."""
        for tname, g in grad_rows.items():
            st = states[tname]
            with trace.span(f"sparse_apply/{tname}"):
                slot_states[tname], st.values = opt.apply(
                    self.tables[tname], slot_states[tname], st.values,
                    gl.lks[tname], g, global_step, lr=lr)
        return slot_states, states

    def shrink(self, states, global_step: int):
        """Checkpoint-time eviction over every table, in place
        (``variable.shrink``; on a mesh, this rank's shards); returns
        ``states``."""
        for tname, cfg in self.tables.items():
            states[tname] = ev.shrink(cfg, states[tname], global_step)
        return states

    @staticmethod
    def _unique_budget(tcols, widths, ids_shape) -> Optional[int]:
        """Static bound on the distinct ids one step can route into a
        table: the sum over member columns of min(num_buckets, B*L_col),
        aligned up to 64. None (U = n) unless every member declares
        ``num_buckets`` and the bound is below n."""
        B = ids_shape[0]
        total = 0
        for c, w in zip(tcols, widths):
            if c.num_buckets is None:
                return None
            total += min(c.num_buckets, B * w)
        n = B * (ids_shape[1] if len(ids_shape) > 1 else 1)
        total = -(-total // 64) * 64
        return total if total < n else None

    @staticmethod
    def overflow_total(gl: GroupLookup) -> torch.Tensor:
        """Ids dropped this step by the tables' unique budgets or, on a
        mesh, by the sharded exchange's capacity factor (0 in exact
        configurations): they read defaults and get no update. This
        rank's count; the train step sums it over the ranks."""
        return sum(gl.budget_overflow.values())

    # -- adaptive embedding ----------------------------------------------
    ADAPTIVE_STATIC = "adaptive_static."

    @property
    def adaptive_tables(self) -> Dict[str, cfglib.TableConfig]:
        return {t: c for t, c in self.tables.items()
                if c.adaptive_hot_threshold is not None}

    @classmethod
    def _adaptive_static(cls, params, tname: str):
        try:
            return params[cls.ADAPTIVE_STATIC + tname]
        except (TypeError, KeyError):
            raise ValueError(
                f"adaptive table {tname!r} needs its static bucket table: "
                "merge EmbeddingGroup.adaptive_static_params() into the "
                "params and pass them to combine()") from None

    def adaptive_static_params(self, device="cuda",
                               seed: int = 0) -> Dict[str, torch.Tensor]:
        """The dense static bucket table of every adaptive table,
        ``{"adaptive_static.<table>": [buckets, dim]}``, to merge into
        the params (``{**module.state_dict(), **group.
        adaptive_static_params()}``): they train with the dense
        optimizer and checkpoints carry them with the params. Row ``b``
        is the table's initializer drawn for the pseudo-id (salt + seed,
        b), as in the JAX package, whose ``{"adaptive_static": {table:
        ...}}`` subtree ``convert.params_from_numpy`` maps to these
        names."""
        out = {}
        for tname, cfg in self.adaptive_tables.items():
            b = torch.arange(cfg.adaptive_buckets, dtype=torch.int32,
                             device=device)
            hi = torch.full_like(b, self.salts[tname] + seed)
            out[self.ADAPTIVE_STATIC + tname] = srand.init_rows(
                cfg.initializer, hi, b, cfg.dim, cfg.init_scale,
                salt=self.salts[tname])
        return out

    @classmethod
    def model_params(cls, params: Dict[str, torch.Tensor]):
        """``params`` without the adaptive static tables: what the
        model's ``apply_fn`` takes."""
        return {k: v for k, v in params.items()
                if not k.startswith(cls.ADAPTIVE_STATIC)}

    def migrate_adaptive(self, states, gl: GroupLookup, params):
        """Value-reuse migration: the uniques that just crossed the hot
        threshold take the static row they trained in as their row in
        ``lk.rows`` (the differentiable input), so this step's forward
        uses it and the sparse apply writes ``seed - update`` back to the
        EV (K2 and K3 update an adaptive table from ``lk.rows``). Call
        between ``lookup_train`` and the loss; ``params`` are read as
        constants. Returns ``(states, gl)``; without adaptive tables,
        as they came."""
        if not self.adaptive_tables:
            return states, gl
        lks = dict(gl.lks)
        seen = set()
        for cl in gl.columns.values():
            t = cl.table_name
            if cl.adp is None or t in seen:
                continue
            seen.add(t)
            lk = lks[t]
            seed = self._adaptive_static(params, t)[cl.adp.bucket.long()]
            lks[t] = lk._replace(rows=torch.where(
                cl.adp.newly_hot[:, None], seed.to(lk.rows.dtype), lk.rows))
        return states, gl._replace(lks=lks)

    def numeric_features(self, batch):
        """Stack numeric columns -> [B, sum(shapes)] float32 (a compact
        batch's numeric plane, read back as float32)."""
        if self.NUMERIC_PLANE in batch:
            return batch[self.NUMERIC_PLANE].to(torch.float32)
        parts = []
        for c in self.numeric:
            x = batch[c.name].to(torch.float32)
            parts.append(x[:, None] if x.dim() == 1 else x)
        if not parts:
            return None
        return torch.cat(parts, dim=1)
