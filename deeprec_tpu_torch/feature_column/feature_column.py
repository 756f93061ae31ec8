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

Not ported yet: sharded placement, adaptive, sequence, weighted and
dyn-dim hot columns.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from deeprec_tpu_torch import config as cfglib
from deeprec_tpu_torch.embedding import lookup as lkup
from deeprec_tpu_torch.embedding import variable as ev
from deeprec_tpu_torch.utils import keys as keylib


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
            max_probes=self.max_probes)


class ColumnLookup(NamedTuple):
    """Differentiation-side info for one column's lookup."""

    column: Any
    table_name: str
    inverse: torch.Tensor   # [B, L]
    mask: torch.Tensor      # [B, L]


class GroupLookup(NamedTuple):
    """All lookups of one step."""

    lks: Dict[str, ev.LookupResult]      # per table (rows: the grad inputs)
    columns: Dict[str, ColumnLookup]     # per column
    # Distinct ids dropped by each table's unique budget this step.
    budget_overflow: Dict[str, torch.Tensor]


class EmbeddingGroup:
    """Owns every embedding table of a model (single device)."""

    PACKED_PREFIX = "__packed__"
    NUMERIC_PLANE = "__numeric__"

    def __init__(self, columns: Sequence[Any], *, coalesce: bool = False):
        self.numeric = [c for c in columns if isinstance(c, NumericColumn)]
        self.embedding = [c for c in columns
                          if isinstance(c, EmbeddingColumn)]
        self.tables: Dict[str, cfglib.TableConfig] = {}
        self.salts: Dict[str, int] = {}
        self._pack_widths: Optional[Dict[str, list]] = None
        # Logical table -> (physical table, id salt or 0).
        self._phys_of: Dict[str, tuple[str, Any]] = {}
        logical: Dict[str, cfglib.TableConfig] = {}
        for c in self.embedding:
            tc = c.table_config()
            if tc.name in logical:
                if logical[tc.name].dim != tc.dim:
                    raise ValueError(f"shared table {tc.name}: dim mismatch")
            else:
                logical[tc.name] = tc
        # Static tables first (their salts, hence their draws, come
        # first, as in the JAX package); with ``coalesce``, one matrix per
        # dim class whose members own disjoint row ranges.
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
                                                name=phys_name, capacity=off))
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
                                                name=phys_name, capacity=cap))

    def _add_table(self, tc: cfglib.TableConfig):
        self.salts[tc.name] = len(self.tables) + 1
        self.tables[tc.name] = tc

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
    def create_state(self, device) -> Dict[str, ev.EVState]:
        return {n: ev.create(c, device, salt=self.salts[n])
                for n, c in self.tables.items()}

    def init_optimizer(self, opt, device) -> Dict[str, Any]:
        """Sparse-optimizer slot state of every table on ``device``."""
        return {n: opt.init(c, device) for n, c in self.tables.items()}

    # -- training ---------------------------------------------------------
    def lookup_train(self, states, batch, global_step: ev.Step):
        """Returns ``(states, GroupLookup)``; the tables of ``states``
        are updated in place (inserts, row init, metadata)."""
        lks: Dict[str, ev.LookupResult] = {}
        cols: Dict[str, ColumnLookup] = {}
        budget_overflow: Dict[str, torch.Tensor] = {}
        for tname, tcols in self._columns_by_table().items():
            cfg = self.tables[tname]
            ids_hi, ids_lo, widths = self._packed_view(batch, tname, tcols)
            budget = self._unique_budget(tcols, widths, ids_hi.shape)
            states[tname], bl = lkup.bag_lookup_train(
                cfg, states[tname], ids_hi, ids_lo, global_step,
                salt=self.salts[tname], unique_budget=budget)
            lks[tname] = bl.lk
            budget_overflow[tname] = bl.n_overflow
            off = 0
            for c, w in zip(tcols, widths):
                cols[c.name] = ColumnLookup(
                    column=c, table_name=tname,
                    inverse=bl.inverse[:, off:off + w],
                    mask=bl.mask[:, off:off + w])
                off += w
        return states, GroupLookup(lks=lks, columns=cols,
                                   budget_overflow=budget_overflow)

    @staticmethod
    def _occurrences(gl: GroupLookup, rows: Dict[str, torch.Tensor]):
        """Per physical table: ``(items, occ, msk)`` with ``items`` its
        ``(column name, ColumnLookup)`` pairs, ``occ`` the masked rows of
        every occurrence ``[B, L_total, dim]`` (one gather per table,
        one backward scatter-add per table) and ``msk`` its mask."""
        by_tbl: Dict[str, list] = {}
        for cname, cl in gl.columns.items():
            by_tbl.setdefault(cl.table_name, []).append((cname, cl))
        for tname, items in by_tbl.items():
            r = rows[tname]
            inv = torch.cat([cl.inverse for _, cl in items], dim=1)
            msk = torch.cat([cl.mask for _, cl in items], dim=1)
            yield tname, items, r[inv] * msk[..., None].to(r.dtype), msk

    def combine(self, gl: GroupLookup, rows: Dict[str, torch.Tensor]):
        """``rows[table]`` -> per-column bag embeddings [B, dim],
        differentiable in ``rows``."""
        out = {}
        for _, items, occ, msk in self._occurrences(gl, rows):
            off = 0
            for cname, cl in items:
                w = cl.inverse.shape[1]
                out[cname] = lkup.combine_from_occ(
                    occ[:, off:off + w], msk[:, off:off + w],
                    cl.column.combiner)
                off += w
        return out

    def combine_tables(self, gl: GroupLookup,
                       rows: Dict[str, torch.Tensor]):
        """Fused per-table combine: one masked occurrence tensor per
        physical table, without the per-column split, for models that
        take whole-table matrices (``wdl.apply_fn_fused``). Every member
        column must be a width-1 bag column (single-valued fields, where
        the combiner does not matter); raises ``ValueError`` otherwise.
        Returns ``{table: ([B, n_cols, dim] rows, [column names])}``,
        differentiable in ``rows`` as :meth:`combine` is."""
        for cname, cl in gl.columns.items():
            if cl.inverse.shape[1] != 1:
                raise ValueError(
                    f"combine_tables: column {cname!r} is not a width-1 "
                    "unweighted bag column; use combine()")
        return {tname: (occ, [cname for cname, _ in items])
                for tname, items, occ, _ in self._occurrences(gl, rows)}

    def apply_gradients(self, opt, slot_states, states, gl: GroupLookup,
                        grad_rows: Dict[str, torch.Tensor],
                        global_step: ev.Step,
                        lr=None):
        """Sparse-apply each table's row gradients, in place. Returns
        ``(slot_states, states)``."""
        for tname, g in grad_rows.items():
            st = states[tname]
            slot_states[tname], st.values = opt.apply(
                self.tables[tname], slot_states[tname], st.values,
                gl.lks[tname], g, global_step, lr=lr)
        return slot_states, states

    def shrink(self, states, global_step: int):
        """Checkpoint-time eviction over every table, in place
        (``variable.shrink``); returns ``states``."""
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
        """Ids dropped this step by the tables' unique budgets (0 in
        exact configurations): they read defaults and get no update."""
        return sum(gl.budget_overflow.values())

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
