"""Multi-tier embedding storage: a device hot tier, host-RAM and disk
spill tiers.

Port of ``deeprec_tpu/embedding/multi_tier.py``, the rebuild of
DeepRec's multi-level storage manager (``StorageManager::GetOrCreate``
over DRAM/PMEM/SSD tiers, ``BatchEviction`` moving cold rows down,
LRU/LFU ``BatchCache`` ranks choosing them). The tiers ride the input
pipeline rather than the lookup:

  * the **hot tier** is the table's device ``EVState``: every lookup in
    a step reads device memory only;
  * the **spill tier** (:class:`HostKV`) holds demoted keys on the host
    (value row, freq, version, optimizer slot rows) in numpy arrays
    behind a vectorized open-addressing index (:class:`_NpIndex`); an
    optional **disk tier** (:class:`DiskKV`) pages its coldest rows into
    ``np.memmap`` logs;
  * **promotion** (:meth:`TieredTable.prepare_promotion`,
    :meth:`~TieredTable.apply_promotion`) runs before a step on the ids
    it will touch: the spill tiers are asked first, the device is asked
    (P1's ``find``, on the candidates only) which of those are already
    resident, and the rest are inserted with their trained rows
    (``variable.import_arrays``, through pinned memory);
  * **demotion** (:meth:`TieredTable.maybe_demote`) moves the coldest
    rows (LRU: smallest version, LFU: smallest freq) out when live
    occupancy passes the high watermark, down to the low one. The rank,
    the stable sort and the victims' gather run on the device; only the
    victims' rows cross to the host, and their slots become tombstones.

A key's value, freq, version and optimizer slot rows survive demote and
promote bit for bit. The host classes are the JAX package's numpy code
unchanged (the same probe sequence, rehash points, row order,
``coldest`` and ``export`` order), so spill files of either package are
equal array for array.

On a mesh (``TieredGroup(..., mesh=mesh)``) each rank keeps the spill
tiers of its own shard. A rank's batch holds only its own rows, while
its shard serves ids of every rank's batch, so :meth:`TieredGroup.pre_step`
all-gathers the batch's distinct ids over the mesh and each rank
promotes the ids it owns (``keys.shard_of_np``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from deeprec_tpu_torch import config as cfglib
from deeprec_tpu_torch import native
from deeprec_tpu_torch.embedding import hash_table as ht
from deeprec_tpu_torch.embedding import variable as ev
from deeprec_tpu_torch.feature_column.feature_column import (CompactIds,
                                                             SparseIds)
from deeprec_tpu_torch.utils import keys as keylib


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype of a torch dtype."""
    return torch.empty((), dtype=dtype).numpy().dtype


def _host(x) -> np.ndarray:
    """A tensor's (or array's) data as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _to_host(tensors) -> list:
    """Tensors of one device as host numpy arrays. From a card: copies
    into pinned memory with ``non_blocking=True`` and one wait for them
    all."""
    if not tensors or tensors[0].device.type != "cuda":
        return [t.numpy() for t in tensors]
    outs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            for t in tensors]
    for o, t in zip(outs, tensors):
        o.copy_(t, non_blocking=True)
    torch.cuda.current_stream(tensors[0].device).synchronize()
    return [o.numpy() for o in outs]


class _NpIndex:
    """Vectorized host open-addressing index: int64 key -> int32 row.

    Linear probing over a power-of-two capacity with EMPTY/TOMB
    sentinels; lookup, insert and delete are whole-array numpy passes
    (no per-id Python)."""

    def __init__(self, cap: int = 1 << 13):
        self._cap = cap
        self._keys = np.full(cap, keylib.EMPTY_ID, np.int64)
        self._rows = np.full(cap, -1, np.int32)
        self._n_live = 0
        self._n_tomb = 0

    def __len__(self):
        return self._n_live

    def _start(self, ids: np.ndarray) -> np.ndarray:
        return (native.hash64(ids).view(np.uint64)
                & np.uint64(self._cap - 1)).astype(np.int64)

    def lookup(self, ids: np.ndarray) -> np.ndarray:
        """rows[n] int32, -1 for missing. Each pass advances every
        still-searching id one slot."""
        ids = np.asarray(ids, np.int64)
        n = ids.size
        rows = np.full(n, -1, np.int32)
        if n == 0 or self._n_live == 0:
            return rows
        cur = self._start(ids)
        active = np.ones(n, bool)
        for _ in range(self._cap):
            k = self._keys[cur]
            hit = active & (k == ids)
            rows[hit] = self._rows[cur[hit]]
            stop = hit | (active & (k == keylib.EMPTY_ID))
            active &= ~stop
            if not active.any():
                break
            cur[active] = (cur[active] + 1) & (self._cap - 1)
        return rows

    def insert(self, ids: np.ndarray, rows: np.ndarray):
        """Insert ids (unique, not currently present) -> given rows."""
        ids = np.asarray(ids, np.int64)
        n = ids.size
        if n == 0:
            return
        if (self._n_live + self._n_tomb + n) * 4 > self._cap * 3:
            self._rehash(max(self._cap * 2,
                             1 << int(np.ceil(np.log2(
                                 4 * (self._n_live + n) // 3 + 1)))))
        rows = np.asarray(rows, np.int32)
        cur = self._start(ids)
        pending = np.arange(n)
        while pending.size:
            c = cur[pending]
            # Probe each pending id forward to its first free slot.
            act = np.ones(pending.size, bool)
            for _ in range(self._cap):
                k = self._keys[c]
                free = (k == keylib.EMPTY_ID) | (k == keylib.TOMB_ID)
                act &= ~free
                if not act.any():
                    break
                c[act] = (c[act] + 1) & (self._cap - 1)
            # Two ids may claim one slot: the first occurrence wins,
            # the losers probe on from the next slot.
            _, first = np.unique(c, return_index=True)
            win = np.zeros(pending.size, bool)
            win[first] = True
            wp = pending[win]
            self._n_tomb -= int(
                (self._keys[c[win]] == keylib.TOMB_ID).sum())
            self._keys[c[win]] = ids[wp]
            self._rows[c[win]] = rows[wp]
            self._n_live += int(win.sum())
            cur[pending] = (c + 1) & (self._cap - 1)
            pending = pending[~win]

    def delete(self, ids: np.ndarray) -> np.ndarray:
        """Tombstone ids; returns the freed rows (hits only)."""
        ids = np.asarray(ids, np.int64)
        if ids.size == 0 or self._n_live == 0:
            return np.zeros(0, np.int32)
        cur = self._start(ids)
        freed = []
        active = np.ones(ids.size, bool)
        for _ in range(self._cap):
            k = self._keys[cur]
            hit = active & (k == ids)
            if hit.any():
                slots = cur[hit]
                freed.append(self._rows[slots].copy())
                self._keys[slots] = keylib.TOMB_ID
                self._rows[slots] = -1
                self._n_live -= slots.size
                self._n_tomb += slots.size
            stop = hit | (active & (k == keylib.EMPTY_ID))
            active &= ~stop
            if not active.any():
                break
            cur[active] = (cur[active] + 1) & (self._cap - 1)
        if self._n_tomb * 4 > self._cap:
            self._rehash(self._cap)
        return (np.concatenate(freed) if freed
                else np.zeros(0, np.int32))

    def _rehash(self, new_cap: int):
        live = self._keys != keylib.EMPTY_ID
        live &= self._keys != keylib.TOMB_ID
        keys, rows = self._keys[live], self._rows[live]
        self._cap = new_cap
        self._keys = np.full(new_cap, keylib.EMPTY_ID, np.int64)
        self._rows = np.full(new_cap, -1, np.int32)
        self._n_live = 0
        self._n_tomb = 0
        self.insert(keys, rows)

    def live_keys(self) -> np.ndarray:
        m = (self._keys != keylib.EMPTY_ID) & (self._keys != keylib.TOMB_ID)
        return self._keys[m].copy()


class HostKV:
    """Host-RAM spill store: id -> (value row, freq, version, slot rows).

    Columnar (one growing numpy array a field) behind an
    :class:`_NpIndex`, so batch get, put and delete are whole-array
    passes. Free rows are a stack: a put takes them from its top."""

    GROW = 4096

    def __init__(self, dim: int, slot_shapes: Dict[str, tuple],
                 slot_dtypes: Dict[str, Any], value_dtype=np.float32):
        self._index = _NpIndex()
        self._free: list[int] = []
        self._cap = 0
        self._dim = dim
        self._value_dtype = value_dtype
        self._slot_shapes = dict(slot_shapes)
        self._slot_dtypes = dict(slot_dtypes)
        self._values = np.zeros((0, dim), value_dtype)
        self._freqs = np.zeros((0,), np.int32)
        self._versions = np.zeros((0,), np.int32)
        self._slots = {n: np.zeros((0,) + s, self._slot_dtypes[n])
                       for n, s in self._slot_shapes.items()}

    def __len__(self):
        return len(self._index)

    def __contains__(self, key: int):
        return self._index.lookup(np.array([key], np.int64))[0] >= 0

    def contains_batch(self, ids) -> np.ndarray:
        return self._index.lookup(np.asarray(ids, np.int64)) >= 0

    def _grow(self, need: int):
        new_cap = self._cap + max(need, self.GROW)

        def g(a, shape):
            out = np.zeros((new_cap,) + shape, a.dtype)
            out[: self._cap] = a[: self._cap]
            return out

        self._values = g(self._values, (self._dim,))
        self._freqs = g(self._freqs, ())
        self._versions = g(self._versions, ())
        for n in self._slots:
            self._slots[n] = g(self._slots[n], self._slot_shapes[n])
        self._free.extend(range(self._cap, new_cap))
        self._cap = new_cap

    def put_batch(self, ids, values, freqs, versions,
                  slots: Dict[str, np.ndarray]):
        """Upsert rows of unique ids (duplicate misses in one batch
        would take two rows)."""
        ids = np.asarray(ids, np.int64)
        n = ids.shape[0]
        if n == 0:
            return
        rows = self._index.lookup(ids).astype(np.int64)
        miss = rows < 0
        n_miss = int(miss.sum())
        if n_miss:
            if n_miss > len(self._free):
                self._grow(n_miss - len(self._free))
            # The stack's top n rows, top first.
            new_rows = np.array(self._free[-n_miss:][::-1], np.int64)
            del self._free[-n_miss:]
            rows[miss] = new_rows
            self._index.insert(ids[miss], new_rows)
        self._values[rows] = values
        self._freqs[rows] = freqs
        self._versions[rows] = versions
        for name, arr in slots.items():
            self._slots[name][rows] = arr

    def get_batch(self, ids):
        """Returns (hit_mask [n] bool, values, freqs, versions, slots);
        rows of misses are zeros (version -1)."""
        ids = np.asarray(ids, np.int64)
        rows = self._index.lookup(ids).astype(np.int64)
        hit = rows >= 0
        rows = np.where(hit, rows, 0)
        values = np.where(hit[:, None], self._values[rows], 0).astype(
            self._value_dtype)
        freqs = np.where(hit, self._freqs[rows], 0).astype(np.int32)
        versions = np.where(hit, self._versions[rows], -1).astype(np.int32)
        slots = {n_: np.where(
            hit.reshape((-1,) + (1,) * len(self._slot_shapes[n_])),
            self._slots[n_][rows], 0).astype(self._slot_dtypes[n_])
            for n_ in self._slots}
        return hit, values, freqs, versions, slots

    def delete_batch(self, ids):
        freed = self._index.delete(np.asarray(ids, np.int64))
        self._free.extend(freed.tolist())

    def keys(self) -> np.ndarray:
        return self._index.live_keys()

    def coldest(self, n: int) -> np.ndarray:
        """The n live ids with the smallest versions (LRU order): the
        page-down candidates for a lower tier."""
        ids = self.keys()
        if ids.size <= n:
            return ids
        rows = self._index.lookup(ids)
        order = np.argsort(self._versions[rows], kind="stable")
        return ids[order[:n]]

    def export(self):
        """Snapshot for checkpoints: ``keys``, ``values``, ``freqs``,
        ``versions`` and ``slot/<name>`` rows, in index order."""
        ids = self.keys()
        _, values, freqs, versions, slots = self.get_batch(ids)
        out = {"keys": ids, "values": values, "freqs": freqs,
               "versions": versions}
        for n, a in slots.items():
            out[f"slot/{n}"] = a
        return out


class DiskKV(HostKV):
    """Disk-backed cold tier: :class:`HostKV`'s layout with every field
    an ``np.memmap`` over a file in ``path`` (grown by extending the
    files in place). :meth:`sync` flushes the pages and saves the index,
    so the same directory re-attaches after a restart."""

    def __init__(self, dim: int, slot_shapes, slot_dtypes, path: str,
                 value_dtype=np.float32):
        self._path = path
        os.makedirs(path, exist_ok=True)
        super().__init__(dim, slot_shapes, slot_dtypes,
                         value_dtype=value_dtype)
        idx = os.path.join(path, "index.npz")
        if os.path.exists(idx):
            with np.load(idx, allow_pickle=False) as saved:
                keys, rows = saved["keys"], saved["rows"]
                cap = int(saved["cap"][0])
            if cap:
                self._grow(cap)
                self._index.insert(keys, rows)
                live = np.zeros(cap, bool)
                live[rows] = True
                self._free = [int(r) for r in np.nonzero(~live)[0]]

    def _mm(self, name: str, shape: tuple, dtype, cap: int):
        f = os.path.join(self._path, name + ".bin")
        nbytes = (int(np.prod((cap,) + shape, dtype=np.int64))
                  * np.dtype(dtype).itemsize)
        if not os.path.exists(f):
            open(f, "wb").close()
        with open(f, "r+b") as fh:
            if os.path.getsize(f) < nbytes:
                fh.truncate(nbytes)
        return np.memmap(f, dtype=dtype, mode="r+",
                         shape=(cap,) + shape)

    def _grow(self, need: int):
        new_cap = self._cap + max(need, self.GROW)
        self._values = self._mm("values", (self._dim,),
                                self._value_dtype, new_cap)
        self._freqs = self._mm("freqs", (), np.int32, new_cap)
        self._versions = self._mm("versions", (), np.int32, new_cap)
        for n in list(self._slots):
            self._slots[n] = self._mm(
                f"slot_{n}", self._slot_shapes[n], self._slot_dtypes[n],
                new_cap)
        self._free.extend(range(self._cap, new_cap))
        self._cap = new_cap

    def sync(self):
        """Flush the data pages and save the id index for re-attach."""
        for a in [self._values, self._freqs, self._versions,
                  *self._slots.values()]:
            if isinstance(a, np.memmap):
                a.flush()
        ids = self.keys()
        rows = self._index.lookup(ids)
        np.savez(os.path.join(self._path, "index.npz"), keys=ids,
                 rows=rows, cap=np.array([self._cap]))


@dataclasses.dataclass
class TierStats:
    promoted: int = 0
    demoted: int = 0
    spill_rows: int = 0
    hbm_live: int = 0
    disk_rows: int = 0
    paged_down: int = 0


class TieredTable:
    """The tiers of one table (one shard of it on a mesh).

    A training step::

        payload = tiered.prepare_promotion(state, next_batch_ids)
        state, slots = tiered.apply_promotion(state, slots, payload)
        ... the train step ...
        state, slots = tiered.maybe_demote(state, slots)

    The state and the slot tensors are updated in place and returned.
    """

    def __init__(self, cfg: cfglib.TableConfig,
                 slot_template: Dict[str, torch.Tensor],
                 policy: str = "lru",
                 high_watermark: float = 0.85,
                 low_watermark: float = 0.70,
                 promote_chunk: int = 4096,
                 disk_path: Optional[str] = None,
                 host_capacity: Optional[int] = None):
        if policy not in ("lru", "lfu"):
            raise ValueError(f"policy must be lru|lfu, got {policy!r}")
        self.cfg = cfg
        self.policy = policy
        self.high = high_watermark
        self.low = low_watermark
        self.promote_chunk = promote_chunk
        shapes, dtypes = {}, {}
        for name, arr in slot_template.items():
            if arr.dim() >= 1 and arr.shape[0] == cfg.capacity + 1:
                shapes[name] = tuple(arr.shape[1:])
                dtypes[name] = _np_dtype(arr.dtype)
        value_dtype = _np_dtype(cfg.dtype)
        self.host = HostKV(cfg.dim, shapes, dtypes, value_dtype=value_dtype)
        # The optional third tier: warm rows page down to disk when host
        # RAM holds more than ``host_capacity``.
        self.cold = (DiskKV(cfg.dim, shapes, dtypes, disk_path,
                            value_dtype=value_dtype)
                     if disk_path else None)
        self.host_capacity = host_capacity
        self.stats = TierStats()

    def _n_spilled(self) -> int:
        return len(self.host) + (len(self.cold) if self.cold is not None
                                 else 0)

    # -- promotion ---------------------------------------------------------
    def _resident(self, state: ev.EVState, ids: np.ndarray) -> np.ndarray:
        """Which of ``ids`` the device table holds: P1's ``find`` of
        these ids only (a slot below C), one host read."""
        dev = state.values.device
        hi, lo = keylib.split_ids(ids)
        slots = ht.find(state.table, ev._to_device(hi, dev),
                        ev._to_device(lo, dev),
                        max_probes=self.cfg.max_probes)
        return _host(slots) < self.cfg.capacity

    def prepare_promotion(self, state: ev.EVState, ids: np.ndarray):
        """Of the upcoming raw int64 ``ids`` (duplicates fine), the rows
        the spill tiers hold and the device does not: a payload dict
        (ids, values, freqs, versions, slots), or None. Spill copies of
        ids already resident are stale and are dropped. Runs nothing on
        the device when no id is in a spill tier."""
        n_cold = len(self.cold) if self.cold is not None else 0
        if len(self.host) + n_cold == 0:
            return None
        ids = np.unique(np.asarray(ids, np.int64))
        ids = ids[np.isin(ids, (keylib.EMPTY_ID, keylib.TOMB_ID),
                          invert=True)]
        if not len(ids):
            return None
        in_warm = self.host.contains_batch(ids)
        in_cold = (self.cold.contains_batch(ids) if n_cold
                   else np.zeros(len(ids), bool))
        cand = ids[in_warm | in_cold]
        if cand.size == 0:
            return None
        in_hbm = self._resident(state, cand)
        stale = cand[in_hbm]
        if stale.size:
            # The device row is the one being trained (a capped
            # promotion let the lookup insert it fresh): drop the spill
            # copy, so a checkpoint never holds a key twice.
            self.host.delete_batch(stale)
            if n_cold:
                self.cold.delete_batch(stale)
        cand = cand[~in_hbm]
        if cand.size == 0:
            return None
        cand = cand[: self.promote_chunk]
        hit, values, freqs, versions, slots = self.host.get_batch(cand)
        if n_cold and not hit.all():
            # Misses come from the cold tier (a warm copy is the newer
            # one by construction of page-down).
            hc, vc, fc, verc, sc = self.cold.get_batch(cand)
            take = ~hit & hc
            values = np.where(take[:, None], vc, values)
            freqs = np.where(take, fc, freqs)
            versions = np.where(take, verc, versions)
            for n_ in slots:
                t = take.reshape((-1,) + (1,) * (slots[n_].ndim - 1))
                slots[n_] = np.where(t, sc[n_], slots[n_])
            hit = hit | hc
        if not hit.all():
            raise RuntimeError("spill tiers lost a candidate row")
        return {"ids": cand, "values": values, "freqs": freqs,
                "versions": versions, "slots": slots}

    def apply_promotion(self, state: ev.EVState,
                        slot_state: Dict[str, torch.Tensor], payload):
        """Insert the payload's rows into the device table with their
        slot rows (``variable.import_arrays``, in place); only rows that
        landed leave the spill tiers (a table full between demotions
        keeps the others there, to retry at the next step)."""
        if payload is None:
            return state, slot_state
        arrays = {"keys": payload["ids"], "values": payload["values"],
                  "freqs": payload["freqs"], "versions": payload["versions"]}
        extra = {}
        for n, a in payload["slots"].items():
            arrays[f"slot/{n}"] = a
            extra[n] = slot_state[n]
        state, _, landed = ev.import_arrays(
            self.cfg, state, arrays, chunk=min(self.promote_chunk, 8192),
            extra_targets=extra, return_mask=True)
        self.host.delete_batch(payload["ids"][landed])
        if self.cold is not None:
            self.cold.delete_batch(payload["ids"][landed])
        self.stats.promoted += int(landed.sum())
        return state, slot_state

    # -- demotion ----------------------------------------------------------
    def maybe_demote(self, state: ev.EVState,
                     slot_state: Dict[str, torch.Tensor],
                     keep_mask=None):
        """``BatchEviction``: when live rows pass the high watermark,
        move the coldest to the spill tier until the low watermark.

        The rank (LRU: version, LFU: freq; int64 max for dead and
        ``keep_mask``-pinned slots) and its stable sort run on the
        device, ties to the lower slot; the first ``n_live - low * C``
        slots that are live are the victims, and only their rows and
        slot rows are copied to the host. Host reads: the live count,
        the victim count and one wait for the copies."""
        cap = self.cfg.capacity
        table = state.table
        dev = state.values.device
        live = ht.live_mask(table)
        n_live = int(live.sum())
        self.stats.hbm_live = n_live
        self.stats.spill_rows = len(self.host)
        if n_live <= int(self.high * cap):
            return state, slot_state
        n_evict = n_live - int(self.low * cap)
        meta = state.versions if self.policy == "lru" else state.freqs
        big = torch.iinfo(torch.int64).max
        rank = torch.where(live, meta[:-1].to(torch.int64), big)
        if keep_mask is not None:
            rank = torch.where(torch.as_tensor(keep_mask, device=dev), big,
                               rank)
        order = torch.sort(rank, stable=True).indices[:n_evict]
        victims = order[live[order]]
        if victims.numel() == 0:
            return state, slot_state
        rows = {n: a for n, a in slot_state.items()
                if a.dim() >= 1 and a.shape[0] == cap + 1}
        pair, values, freqs, versions, *slot_rows = _to_host(
            [table.key_pair[victims], state.values[victims],
             state.freqs[victims], state.versions[victims]]
            + [a[victims] for a in rows.values()])
        ids = keylib.join_ids(pair[:, 0], pair[:, 1])
        self.host.put_batch(ids, values, freqs, versions,
                            dict(zip(rows, slot_rows)))
        ht.remove_slots(table, torch.zeros(cap, dtype=torch.bool,
                                           device=dev).index_fill_(
                                               0, victims, True))
        self.stats.demoted += int(victims.numel())
        self.stats.hbm_live = n_live - int(victims.numel())
        self._maybe_page_down()
        self.stats.spill_rows = len(self.host)
        return state, slot_state

    def _maybe_page_down(self):
        """Warm to cold: when the host tier holds more than
        ``host_capacity`` rows, its least recently versioned rows move
        to the disk tier, down to 0.8 of it."""
        if (self.cold is None or self.host_capacity is None
                or len(self.host) <= self.host_capacity):
            if self.cold is not None:
                self.stats.disk_rows = len(self.cold)
            return
        n_down = len(self.host) - int(0.8 * self.host_capacity)
        ids = self.host.coldest(n_down)
        _, values, freqs, versions, slots = self.host.get_batch(ids)
        self.cold.put_batch(ids, values, freqs, versions, slots)
        self.host.delete_batch(ids)
        self.stats.paged_down += int(ids.size)
        self.stats.disk_rows = len(self.cold)

    # -- checkpoint --------------------------------------------------------
    def export_spill(self):
        """The spill tiers' rows in the 4-tensor + ``slot/<name>``
        layout (host rows, then disk rows)."""
        out = self.host.export()
        if self.cold is not None and len(self.cold):
            cold = self.cold.export()
            out = {k: np.concatenate([out[k], cold[k]]) for k in out}
        return out

    def import_spill(self, arrays):
        ids = np.asarray(arrays["keys"], np.int64)
        slots = {n[len("slot/"):]: np.asarray(a) for n, a in arrays.items()
                 if n.startswith("slot/")}
        self.host.put_batch(ids, np.asarray(arrays["values"]),
                            np.asarray(arrays["freqs"]),
                            np.asarray(arrays["versions"]), slots)


class TieredGroup:
    """Multi-tier storage in the training loop, for every table whose
    ``StorageOption.storage_type`` is ``HBM_HOST`` or ``HBM_HOST_DISK``.

    Before each step it promotes the spill rows the batch will touch;
    after each step (every ``demote_every``) it demotes cold rows past
    the watermark. Both run on the calling thread::

        tiered = TieredGroup(group, ts.slots)
        for batch in data:
            ts = tiered.pre_step(ts, batch)
            ts, metrics = step(ts, batch)
            ts = tiered.post_step(ts)

    ``batch`` may be the step's batch (packed or per column, on any
    device: its ids are read back to the host) or the raw numpy batch
    it was packed from (int64 id matrices a column: no device read).

    On a ``mesh`` (a sharded group) each rank holds one
    :class:`TieredTable` a table, for its shard, and a rank's batch is
    its own rows: :meth:`pre_step` all-gathers every rank's distinct
    ids of a table (their counts first, then the ids padded to the
    largest count; skipped when no rank's tiers hold a row) and the rank
    promotes those it owns. Every rank calls :meth:`pre_step` and
    :meth:`post_step` at every step. A table replicated over a mesh of
    more than one rank raises ``ValueError``: it has no shard to tier.
    ``stats`` and ``export_spill`` are this rank's.
    """

    def __init__(self, group, slot_states, policy: str = "lru",
                 high_watermark: float = 0.85, low_watermark: float = 0.70,
                 demote_every: int = 16, mesh=None):
        group._check_mesh(mesh)
        self.group = group
        self.mesh = mesh
        self.demote_every = demote_every
        self._n_steps = 0
        self.S = group.num_shards
        self.shard = 0 if mesh is None else mesh.rank
        self.tiered: Dict[str, TieredTable] = {}
        for tname, cfg in group.tables.items():
            st = cfg.ev_option.storage_option
            if st.storage_type == cfglib.StorageType.HBM:
                continue
            if self.S > 1 and not group._is_stacked(tname):
                raise ValueError(
                    f"table {tname}: multi-tier storage requires "
                    "'sharded' placement on a sharded group")
            disk = None
            if st.storage_type == cfglib.StorageType.HBM_HOST_DISK:
                base = st.storage_path or os.path.join(
                    os.environ.get("TMPDIR", "/tmp"), "deeprec_cold")
                safe = tname.replace("/", "_").replace(":", "_")
                disk = os.path.join(base, f"{safe}-s{self.shard}")
            self.tiered[tname] = TieredTable(
                cfg, slot_states[tname], policy=policy,
                high_watermark=high_watermark, low_watermark=low_watermark,
                disk_path=disk, host_capacity=st.host_capacity)

    def _batch_ids_for(self, tname: str, batch) -> np.ndarray:
        """The raw int64 ids (transformed: salts, as the table keys
        them) of every occurrence of the table's columns in ``batch``."""
        g = self.group
        key = g.PACKED_PREFIX + tname
        if key in batch:
            s = batch[key]
            if isinstance(s, CompactIds):
                raw = _host(s.ids).astype(np.int64)
                raw = np.where(raw == -(2 ** 31), keylib.EMPTY_ID, raw)
                tcols = [c for c in g.embedding
                         if g.physical_table_of(c) == tname]
                out, off = [], 0
                for c, w in zip(tcols, g._pack_widths[tname]):
                    hi, lo = g.transform_ids_np(c, raw[:, off:off + w])
                    out.append(keylib.join_ids(hi.reshape(-1),
                                               lo.reshape(-1)))
                    off += w
                return np.concatenate(out)
            return keylib.join_ids(_host(s.hi).reshape(-1),
                                   _host(s.lo).reshape(-1))
        ids = []
        for c in g.embedding:
            if g.physical_table_of(c) != tname:
                continue
            s = batch[c.name]
            raw = (keylib.join_ids(_host(s.hi).reshape(-1),
                                   _host(s.lo).reshape(-1))
                   if isinstance(s, SparseIds)
                   else np.asarray(s, np.int64).reshape(-1))
            hi, lo = g.transform_ids_np(c, raw)
            ids.append(keylib.join_ids(hi, lo))
        return (np.concatenate(ids) if ids
                else np.zeros((0,), np.int64))

    def _owned_ids(self, tiered: TieredTable, ids: np.ndarray):
        """Every rank's distinct ``ids`` that this rank's shard owns, or
        None when no rank's tiers hold a row (every rank decides alike,
        from the same gathered counts)."""
        mesh = self.mesh
        ids = np.unique(ids)
        ids = ids[ids != keylib.EMPTY_ID]
        counts = mesh.all_gather(torch.tensor(
            [ids.size, tiered._n_spilled()], dtype=torch.int64,
            device=mesh.device))
        counts = _host(counts).reshape(mesh.size, 2)
        width = int(counts[:, 0].max())
        if counts[:, 1].sum() == 0 or width == 0:
            return None
        buf = np.full(width, keylib.EMPTY_ID, np.int64)
        buf[:ids.size] = ids
        every = _host(mesh.all_gather(ev._to_device(buf, mesh.device)))
        every = every[every != keylib.EMPTY_ID]
        return every[keylib.shard_of_np(every, self.S) == self.shard]

    def pre_step(self, ts, batch):
        """Promote the spill rows ``batch`` will touch (in place)."""
        for tname, tiered in self.tiered.items():
            ids = self._batch_ids_for(tname, batch)
            if self.mesh is not None and self.group._is_stacked(tname):
                ids = self._owned_ids(tiered, ids)
                if ids is None:
                    continue
            payload = tiered.prepare_promotion(ts.ev[tname], ids)
            if payload is not None:
                tiered.apply_promotion(ts.ev[tname], ts.slots[tname],
                                       payload)
        return ts

    def post_step(self, ts):
        """Demote cold rows past the watermark, every ``demote_every``
        calls (in place)."""
        self._n_steps += 1
        if self._n_steps % self.demote_every:
            return ts
        for tname, tiered in self.tiered.items():
            tiered.maybe_demote(ts.ev[tname], ts.slots[tname])
        return ts

    def stats(self) -> Dict[str, TierStats]:
        """Per-table stats (a copy; this rank's shard on a mesh)."""
        return {n: dataclasses.replace(t.stats)
                for n, t in self.tiered.items()}

    # -- checkpoint --------------------------------------------------------
    def export_spill(self) -> Dict[str, Dict]:
        """``{table: {shard: arrays}}``: this rank's spill rows."""
        return {n: {self.shard: t.export_spill()}
                for n, t in self.tiered.items()}

    def import_spill(self, blob: Dict[str, Dict]):
        """Restore the spill tiers from ``{table: {shard: arrays}}`` of
        any shard count: every shard's rows merged, and this rank keeps
        the keys its shard owns (the N-to-M contract of the device
        restore)."""
        for tname, shards in blob.items():
            if tname not in self.tiered:
                continue
            merged: Dict[str, list] = {}
            for arrs in shards.values():
                for k, v in arrs.items():
                    merged.setdefault(k, []).append(np.asarray(v))
            if not merged.get("keys"):
                continue
            cat = {k: np.concatenate(v) for k, v in merged.items()}
            if self.S > 1:
                m = keylib.shard_of_np(cat["keys"], self.S) == self.shard
                if not m.any():
                    continue
                cat = {k: v[m] for k, v in cat.items()}
            self.tiered[tname].import_spill(cat)
