"""Feature columns and the embedding group.

Port of ``deeprec_tpu/feature_column/feature_column.py``: columns,
unsharded ``EmbeddingGroup`` construction with coalescing (members of
one table signature share a physical table, told apart by XOR salts on
both id halves), id transforms, host-side batch packing, state and
optimizer-slot creation, and the single-device training side: the
per-table training lookup with its unique budget, the fused combine
and the sparse optimizer apply.

Batch convention:
  * numeric column ``name`` -> float32 [B] or [B, k]
  * sparse column ``name``  -> ``SparseIds(hi [B, L], lo [B, L])``,
    padded with the EMPTY sentinel id.

Not ported yet: sharded placement, static-bucket, adaptive, sequence,
weighted and dyn-dim hot columns, ``CompactIds``.
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
    def from_numpy(ids: np.ndarray, device="cpu") -> "SparseIds":
        ids = np.asarray(ids, np.int64)
        hi, lo = keylib.split_ids(ids.reshape(-1))
        return SparseIds(torch.from_numpy(hi).reshape(ids.shape).to(device),
                         torch.from_numpy(lo).reshape(ids.shape).to(device))


def batch_to(batch: Dict[str, Any], device) -> Dict[str, Any]:
    """Move every tensor (and ``SparseIds``) leaf of a batch to
    ``device``; numpy leaves become tensors there."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, SparseIds):
            out[k] = SparseIds(v.hi.to(device), v.lo.to(device))
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
    # Static hash-bucket column (no hash table): not ported yet.
    static_bucket: bool = False

    @property
    def table_name(self) -> str:
        return self.shared_name or self.name

    def table_config(self) -> cfglib.TableConfig:
        if self.static_bucket:
            raise NotImplementedError(
                f"column {self.name}: static hash-bucket tables are not "
                "ported")
        scale = (self.init_scale if self.init_scale is not None
                 else self.dim ** -0.5)
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
        pair is nudged off it (flip bit 1 of lo)."""
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
    def pack_batch_np(self, batch, device="cpu"):
        """Host packing: salt and concatenate each physical table's raw
        int64 id matrices into one ``SparseIds`` pair on ``device``;
        other leaves become tensors on ``device``. (The JAX package's
        ``compact=True`` wire format is not ported.)"""
        packed: Dict[str, Any] = {}
        widths: Dict[str, list] = {}
        for tname, tcols in self._columns_by_table().items():
            his, los, ws = [], [], []
            for c in tcols:
                ids = np.asarray(batch[c.name], np.int64)
                if ids.ndim == 1:
                    ids = ids[:, None]
                hi, lo = self.transform_ids_np(c, ids)
                his.append(hi)
                los.append(lo)
                ws.append(int(ids.shape[1]))
            packed[self.PACKED_PREFIX + tname] = SparseIds(
                torch.from_numpy(np.concatenate(his, axis=1)).to(device),
                torch.from_numpy(np.concatenate(los, axis=1)).to(device))
            widths[tname] = ws
        if self._pack_widths is None:
            self._pack_widths = widths
        emb_names = {c.name for c in self.embedding}
        for k, v in batch.items():
            if k not in emb_names:
                packed[k] = torch.as_tensor(np.asarray(v)).to(device)
        return packed

    def _packed_view(self, batch, tname, tcols):
        """(ids_hi, ids_lo, widths) for one physical table from either a
        packed or a per-column batch."""
        key = self.PACKED_PREFIX + tname
        if key in batch:
            s = batch[key]
            return s.hi, s.lo, self._pack_widths[tname]
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
    def lookup_train(self, states, batch, global_step: int):
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

    def combine(self, gl: GroupLookup, rows: Dict[str, torch.Tensor]):
        """``rows[table]`` -> per-column bag embeddings [B, dim],
        differentiable in ``rows``. One per-occurrence gather per table
        (one backward scatter-add per table, not one per column)."""
        out = {}
        by_tbl: Dict[str, list] = {}
        for cname, cl in gl.columns.items():
            by_tbl.setdefault(cl.table_name, []).append((cname, cl))
        for tname, items in by_tbl.items():
            r = rows[tname]
            inv = torch.cat([cl.inverse for _, cl in items], dim=1)
            msk = torch.cat([cl.mask for _, cl in items], dim=1)
            occ = r[inv] * msk[..., None].to(r.dtype)
            off = 0
            for cname, cl in items:
                w = cl.inverse.shape[1]
                out[cname] = lkup.combine_from_occ(
                    occ[:, off:off + w], msk[:, off:off + w],
                    cl.column.combiner)
                off += w
        return out

    def apply_gradients(self, opt, slot_states, states, gl: GroupLookup,
                        grad_rows: Dict[str, torch.Tensor], global_step: int,
                        lr=None):
        """Sparse-apply each table's row gradients, in place. Returns
        ``(slot_states, states)``."""
        for tname, g in grad_rows.items():
            st = states[tname]
            slot_states[tname], st.values = opt.apply(
                self.tables[tname], slot_states[tname], st.values,
                gl.lks[tname], g, global_step, lr=lr)
        return slot_states, states

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
        """Stack numeric columns -> [B, sum(shapes)] float32."""
        parts = []
        for c in self.numeric:
            x = batch[c.name].to(torch.float32)
            parts.append(x[:, None] if x.dim() == 1 else x)
        if not parts:
            return None
        return torch.cat(parts, dim=1)
