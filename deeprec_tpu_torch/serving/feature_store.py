"""Pluggable feature stores for remote-sparse serving.

Port of ``deeprec_tpu/serving/feature_store.py``: in remote mode the
embedding tables do not live on the serving host; lookups go to an
external key-value store and only the dense model runs on the card.

Stores map ``(table_name, int64 id) -> float32 row``.
:class:`RedisFeatureStore` uses the ``redis`` package when it is
installed and the port's own RESP2 client (``serving/resp.py``)
otherwise; :class:`InMemoryFeatureStore` is the test double and doubles
as a single-process cache.

:func:`publish_sparse` pushes a model's rows into a store. Unlike the
JAX package, which publishes every shard of a row-sharded static table
under the shard's local row indices (so the shards overwrite each
other), a sharded static shard publishes its global slots ``local_row *
num_shards + shard``, as the port's checkpoints key it; a replicated
table is published once, by rank 0. On a mesh every rank publishes the
shards it holds.

:class:`RemoteServingModel` fetches rows from the store, combines the
bags on the host in float32 numpy, as the JAX package does, and runs the
towers on the device of its dense params.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

import numpy as np
import torch

from deeprec_tpu_torch.embedding import variable as ev
from deeprec_tpu_torch.feature_column.feature_column import (
    EmbeddingGroup, SequenceEmbeddingColumn, batch_to)
from deeprec_tpu_torch.train.loop import TrainState
from deeprec_tpu_torch.utils import keys as keylib


class FeatureStore:
    """The store interface."""

    def get_batch(self, table: str, ids: np.ndarray,
                  dim: int) -> tuple[np.ndarray, np.ndarray]:
        """-> (found [n] bool, rows [n, dim] float32, zeros on miss)."""
        raise NotImplementedError

    def put_batch(self, table: str, ids: np.ndarray,
                  rows: np.ndarray) -> None:
        raise NotImplementedError

    def delete_table(self, table: str) -> None:
        raise NotImplementedError


class InMemoryFeatureStore(FeatureStore):
    """Thread-safe in-process store (the test double; also a local cache
    tier in front of Redis)."""

    def __init__(self):
        self._tables: Dict[str, Dict[int, np.ndarray]] = {}
        self._lock = threading.Lock()

    def get_batch(self, table, ids, dim):
        ids = np.asarray(ids, np.int64)
        rows = np.zeros((ids.shape[0], dim), np.float32)
        found = np.zeros(ids.shape[0], bool)
        t = self._tables.get(table)
        if t is None:
            return found, rows
        with self._lock:
            for j, i in enumerate(ids.tolist()):
                r = t.get(i)
                if r is not None:
                    rows[j] = r
                    found[j] = True
        return found, rows

    def put_batch(self, table, ids, rows):
        ids = np.asarray(ids, np.int64)
        rows = np.asarray(rows, np.float32)
        with self._lock:
            t = self._tables.setdefault(table, {})
            for i, r in zip(ids.tolist(), rows):
                t[i] = r.copy()

    def delete_table(self, table):
        with self._lock:
            self._tables.pop(table, None)

    def num_rows(self, table: str) -> int:
        return len(self._tables.get(table, {}))


class RedisFeatureStore(FeatureStore):
    """Redis-backed store. Key layout: ``{prefix}/{table}/{id}`` -> the
    row's raw float32 bytes, as the JAX package writes them."""

    def __init__(self, url: str = "redis://localhost:6379/0",
                 prefix: str = "deeprec"):
        try:
            import redis  # noqa: PLC0415 - optional dependency
            self._r = redis.from_url(url)
        except ImportError:
            from deeprec_tpu_torch.serving.resp import RespClient
            self._r = RespClient.from_url(url)
        self._prefix = prefix

    def _key(self, table, i):
        return f"{self._prefix}/{table}/{int(i)}"

    def get_batch(self, table, ids, dim):
        ids = np.asarray(ids, np.int64)
        vals = self._r.mget([self._key(table, i) for i in ids])
        rows = np.zeros((ids.shape[0], dim), np.float32)
        found = np.zeros(ids.shape[0], bool)
        for j, v in enumerate(vals):
            if v is not None:
                rows[j] = np.frombuffer(v, np.float32)
                found[j] = True
        return found, rows

    def put_batch(self, table, ids, rows):
        pipe = self._r.pipeline()
        for i, r in zip(np.asarray(ids, np.int64),
                        np.asarray(rows, np.float32)):
            pipe.set(self._key(table, i), r.tobytes())
        pipe.execute()

    def delete_table(self, table):  # pragma: no cover - destructive
        for k in self._r.scan_iter(f"{self._prefix}/{table}/*"):
            self._r.delete(k)


# ---------------------------------------------------------------------------
# Publishing: push a model's sparse rows into the store.
# ---------------------------------------------------------------------------

def export_sparse(ts: TrainState, group: EmbeddingGroup,
                  min_version: Optional[int] = None,
                  mesh=None) -> Dict[str, tuple[np.ndarray, np.ndarray]]:
    """``{table: (keys int64, rows float32)}``: what :func:`publish_sparse`
    writes. Every live row, or with ``min_version`` the rows touched at
    or after that step (a static table has no touched-row record and is
    exported whole). A sharded static shard's keys are its global slots;
    a replicated table is exported by rank 0 only. A mesh group needs
    ``mesh``: without the rank, the shards would overwrite each other."""
    if group.axis_name is not None and mesh is None:
        raise ValueError("export_sparse/publish_sparse of a mesh group "
                         "needs mesh= (every rank passes its own)")
    rank = 0 if mesh is None else mesh.rank
    out = {}
    for tname, cfg in group.tables.items():
        stacked = group._is_stacked(tname)
        if not stacked and rank != 0:
            continue
        arrs = ev.export_arrays(cfg, ts.ev[tname])
        keys, values = arrs["keys"], arrs["values"]
        if stacked and cfg.static_buckets:
            keys = keys * group.num_shards + rank
        if min_version is not None and not cfg.static_buckets:
            keep = arrs["versions"] >= min_version
            keys, values = keys[keep], values[keep]
        out[tname] = (keys, np.asarray(values, np.float32))
    return out


def publish_sparse(ts: TrainState, group: EmbeddingGroup,
                   store: FeatureStore, min_version: Optional[int] = None,
                   mesh=None) -> Dict[str, int]:
    """Write :func:`export_sparse`'s rows into ``store`` (``min_version``:
    the delta since that step); on a mesh every rank calls it with its
    state. Returns the rows written per table by this rank."""
    out = {}
    for tname, (keys, rows) in export_sparse(ts, group, min_version,
                                             mesh).items():
        store.put_batch(tname, keys, rows)
        out[tname] = int(keys.shape[0])
    return out


# ---------------------------------------------------------------------------
# Remote serving: sparse rows from the store, the dense model on the card.
# ---------------------------------------------------------------------------

class RemoteServingModel:
    """Score with store-resident embeddings and a local dense model.

    ``apply_fn(params, embs, batch)`` is the training contract. The bag
    combine runs on the host on the fetched rows (fp32 numpy, as in the
    JAX package); the embeddings and the batch then move to the device
    of ``params``, where the towers run. ``batch`` is packed
    (``pack_batch_np``) or per column (``SparseIds``)."""

    def __init__(self, group: EmbeddingGroup, apply_fn: Callable,
                 params: Dict[str, torch.Tensor], store: FeatureStore,
                 cache: Optional[InMemoryFeatureStore] = None):
        self.group = group
        self.apply_fn = apply_fn
        self.params = params
        self.store = store
        self.cache = cache
        self._device = next(iter(params.values())).device

    def _fetch(self, table: str, ids: np.ndarray, dim: int):
        if self.cache is not None:
            found, rows = self.cache.get_batch(table, ids, dim)
            if found.all():
                return rows
            miss = ~found
            f2, r2 = self.store.get_batch(table, ids[miss], dim)
            rows[miss] = r2
            if f2.any():
                self.cache.put_batch(table, ids[miss][f2], r2[f2])
            return rows
        _, rows = self.store.get_batch(table, ids, dim)
        return rows

    def _embeddings(self, batch) -> Dict[str, np.ndarray]:
        """The host-combined embedding dict: ``[B, dim]`` float32 per bag
        column, ``(rows [B, L, dim], mask [B, L])`` per sequence
        column."""
        embs = {}
        for tname, tcols in self.group._columns_by_table().items():
            cfg = self.group.tables[tname]
            t_hi, t_lo, widths = self.group._packed_view(batch, tname,
                                                         tcols)
            hi, lo = t_hi.cpu().numpy(), t_lo.cpu().numpy()
            B = hi.shape[0]
            off = 0
            for c, w in zip(tcols, widths):
                ids = keylib.join_ids(hi[:, off:off + w].reshape(-1),
                                      lo[:, off:off + w].reshape(-1))
                off += w
                mask = ids != keylib.EMPTY_ID
                rows = np.zeros((ids.shape[0], cfg.dim), np.float32)
                if mask.any():
                    rows[mask] = self._fetch(tname, ids[mask], cfg.dim)
                rows = rows.reshape(B, w, cfg.dim)
                m = mask.reshape(B, w)
                if isinstance(c, SequenceEmbeddingColumn):
                    embs[c.name] = (rows, m)
                    continue
                s = rows.sum(axis=1)
                cnt = np.maximum(m.sum(axis=1), 1).astype(np.float32)
                if c.combiner == "sum":
                    embs[c.name] = s
                elif c.combiner == "mean":
                    embs[c.name] = s / cnt[:, None]
                else:  # sqrtn
                    embs[c.name] = s / np.sqrt(cnt)[:, None]
        return embs

    @torch.no_grad()
    def predict(self, batch) -> torch.Tensor:
        dev = self._device
        embs = {k: (tuple(torch.from_numpy(a).to(dev) for a in v)
                    if isinstance(v, tuple) else torch.from_numpy(v).to(dev))
                for k, v in self._embeddings(batch).items()}
        return self.apply_fn(self.group.model_params(self.params), embs,
                             batch_to(batch, dev))
