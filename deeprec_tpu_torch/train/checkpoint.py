"""Checkpoints in the JAX package's format: full and incremental.

Port of ``CheckpointManager`` from ``deeprec_tpu/train/checkpoint.py``.
A checkpoint is a directory ``full-<step>`` or ``incr-<step>`` holding
``meta.json``, ``dense.npz``, one ``table-<name>-s<shard>.npz`` per
table shard and, where resources are registered (``register_aux``),
``aux.json``. ``dense.npz`` keys its leaves by JAX tree-path strings:
``['params']/['deep']/['dense_0']/['kernel']`` for the params and
``['dense_opt']/[0]/.<field>/...`` for the dense optimizer's state
(optax's ``(ScaleByRssState(sum_of_squares), EmptyState())`` for
Adagrad, ``(ScaleByAdamState(count, mu, nu), EmptyState())`` for Adam).
A table file holds the 4-tensor EV format (keys/values/freqs/versions)
plus the sparse optimizer's state: its row-aligned slot arrays as
``slot/['<name>']`` (``accum``; ``m`` and ``v``; ``accum`` and
``linear``), one row per key, and its other leaves as
``scalar/['beta1_power']``, ``scalar/['beta2_power']``; a CBF table's
counters as ``bloom``; an incremental save's ``tombstones``, the keys
evicted since the last save (``shrink_tables``) that are not live
again. A static hash-bucket table is saved in full on every save,
incremental ones included, keyed by row index. The JAX package and the
port read each other's checkpoints, optimizer state included.

On a mesh (``CheckpointManager(..., mesh=mesh)``) each rank writes
``table-<name>-s<rank>.npz`` for its shard of every sharded table (a
static shard keyed by its global slots, ``local_row * S + rank``), and
rank 0 writes the replicated tables, ``dense.npz``, ``aux.json``,
``meta.json`` (``num_shards``, ``table_shards``) and the tombstones,
gathered from every rank into the ``s0`` file, as the JAX package
lays them out. Rank 0 makes the staging directory and renames it into
place, with barriers between. A restore merges every saved shard and
keeps this rank's partition (``variable.import_arrays``), so a
checkpoint of either package restores at any shard count.

Restore fills what the template state carries: a template without
optimizer state (serving) skips the ``slot/*``, ``scalar/*`` and
``dense_opt`` leaves. A delta's ``bloom`` replaces the counters; its
``tombstones`` are deleted after its rows are written, so an evicted
key does not come back and a re-inserted one stays.

With a ``TieredGroup`` attached (``attach_tiered``), every save, full
and incremental, also writes each table's spill tiers (host and disk
rows, the 4-tensor format plus ``slot/<name>`` rows) as
``spill-<name>-s<shard>.npz`` wherever they hold keys; on a mesh each
rank writes its shard's. A restore hands every spill file of each
applied checkpoint to the group's ``import_spill``, which keeps the keys
this rank owns, so spill files too restore at any shard count and
cross between the packages.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from deeprec_tpu_torch.convert import params_from_numpy, params_to_numpy
from deeprec_tpu_torch.embedding import hash_table as ht
from deeprec_tpu_torch.embedding import variable as ev
from deeprec_tpu_torch.feature_column.feature_column import EmbeddingGroup
from deeprec_tpu_torch.train.loop import TrainState
from deeprec_tpu_torch.utils import keys as keylib

_PATH_PART = re.compile(r"^\['(.+)'\]$")
_PARAMS = "['params']"
_DENSE_OPT = "['dense_opt']/[0]"


def _flatten_params(tree, prefix="['params']") -> Dict[str, np.ndarray]:
    """Nested dict -> JAX tree-path keyed flat dict."""
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/['{k}']"
        if hasattr(v, "items"):
            flat.update(_flatten_params(v, key))
        else:
            flat[key] = v
    return flat


def _subtree(flat: Dict[str, np.ndarray], prefix: str):
    """The subtree of a flat dense dict under ``prefix``, as nested
    dicts."""
    tree: Dict = {}
    for key, arr in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        parts = [_PATH_PART.match(p) for p in key[len(prefix) + 1:].split("/")]
        if not all(parts):
            raise KeyError(f"unexpected dense leaf {key}")
        node = tree
        names = [m.group(1) for m in parts]
        for p in names[:-1]:
            node = node.setdefault(p, {})
        node[names[-1]] = arr
    return tree


def _dense_leaves(ts: TrainState) -> Dict[str, np.ndarray]:
    """The params and the dense optimizer's fields (a state dict of
    per-parameter tensors, or one tensor such as Adam's ``count``)."""
    flat = _flatten_params(params_to_numpy(ts.params), _PARAMS)
    for name, v in ts.dense_opt.items():
        key = f"{_DENSE_OPT}/.{name}"
        if isinstance(v, dict):
            flat.update(_flatten_params(params_to_numpy(v), key))
        else:
            flat[key] = v.cpu().numpy()
    return flat


def _dense_tree(flat, prefix, like: Dict[str, torch.Tensor], name: str):
    """State dict of the leaves under ``prefix``, on the devices and in
    the types of ``like``."""
    loaded = params_from_numpy(_subtree(flat, prefix))
    if set(loaded) != set(like):
        raise KeyError(f"{name}: dense leaves {sorted(loaded)} under "
                       f"{prefix} do not match the model's {sorted(like)}")
    return {k: loaded[k].to(v.device, v.dtype) for k, v in like.items()}


def _row_aligned(cfg, slots: Dict[str, torch.Tensor]):
    """The slot arrays with one row per table row."""
    return {k: v for k, v in slots.items()
            if v.dim() >= 1 and v.shape[0] == cfg.capacity + 1}


def _live_rows(cfg, state: ev.EVState):
    """Index of the rows ``export_arrays`` saves, in its order: every
    row of a static table, the live slots of an EV table."""
    if cfg.static_buckets:
        return slice(0, cfg.capacity)
    return torch.nonzero(ht.live_mask(state.table)).reshape(-1)


def _export_table(cfg, state: ev.EVState, slots: Dict[str, torch.Tensor],
                  min_version: Optional[int], partition_id: int = 0,
                  partition_num: int = 1) -> Dict[str, np.ndarray]:
    """Live rows with their slot rows (all, or touched since
    ``min_version`` where the table records versions; otherwise, and
    for a static table always, a delta is a full dump, as in the JAX
    package), and the scalar slots. A static shard's keys are its global
    slots ``local_row * partition_num + partition_id``."""
    out = ev.export_arrays(cfg, state)
    out.pop("bloom", None)
    if cfg.static_buckets:
        out["keys"] = out["keys"] * partition_num + partition_id
    rows = _row_aligned(cfg, slots)
    if rows:
        idx = _live_rows(cfg, state)
        for k, v in rows.items():
            out[f"slot/['{k}']"] = v[idx].cpu().numpy()
    if (min_version is not None and not cfg.static_buckets
            and ev._tracking(cfg)[1]):
        keep = out["versions"] >= min_version
        out = {k: v[keep] for k, v in out.items()}
    for k, v in slots.items():
        if k not in rows:
            out[f"scalar/['{k}']"] = v.cpu().numpy()
    if state.bloom.shape[0] > 1:
        out["bloom"] = state.bloom.cpu().numpy()
    return out


def _clone_ev(st: ev.EVState) -> ev.EVState:
    return dataclasses.replace(
        st, table=ht.HashTable(st.table.key_rows.clone()),
        values=st.values.clone(), freqs=st.freqs.clone(),
        versions=st.versions.clone(), bloom=st.bloom.clone())


def _live_keys(cfg, state: ev.EVState) -> np.ndarray:
    """int64 keys of the table's live slots (a static table: its row
    indices)."""
    if cfg.static_buckets:
        return np.arange(cfg.capacity, dtype=np.int64)
    pair = state.table.key_pair[ht.live_mask(state.table)].cpu().numpy()
    return keylib.join_ids(pair[:, 0], pair[:, 1])


def _set_scalars(slots: Dict[str, torch.Tensor],
                 scalars: Dict[str, np.ndarray]) -> None:
    """Overwrite the template's scalar slots with the checkpoint's."""
    for k, v in slots.items():
        key = f"['{k}']"
        if key in scalars:
            slots[k] = torch.from_numpy(np.array(scalars[key])).to(
                v.device, v.dtype)


class CheckpointManager:
    """Save/restore ``TrainState``s of ``group`` under ``directory``."""

    def __init__(self, directory: str, group: EmbeddingGroup, keep: int = 3,
                 mesh=None):
        self.dir = directory
        self.group = group
        self.keep = keep
        self.mesh = mesh
        self.rank = 0 if mesh is None else mesh.rank
        # Keys evicted by ``shrink_tables`` since the last save, per
        # table: the next incremental save writes them as tombstones, so
        # a full + delta restore does not bring them back.
        self._tombstones: Dict[str, set] = {}
        # Saveable resources riding every checkpoint (a WorkQueue):
        # name -> (get_state, set_state), JSON-serializable state.
        self._aux: Dict[str, tuple[Callable[[], Any],
                                   Callable[[Any], None]]] = {}
        # The multi-tier spill stores riding every checkpoint.
        self._tiered = None
        if self.rank == 0:
            os.makedirs(directory, exist_ok=True)
        self._barrier()

    def _barrier(self):
        if self.mesh is not None:
            self.mesh.barrier()

    def register_aux(self, name: str, get_state: Callable[[], Any],
                     set_state: Callable[[Any], None]):
        """Attach a saveable resource: ``get_state()`` is written into
        ``aux.json`` at every save, ``set_state(state)`` is called with
        it by every applied checkpoint that holds it (the newest
        wins)."""
        self._aux[name] = (get_state, set_state)

    def attach_tiered(self, tiered_group):
        """Save ``tiered_group``'s spill rows (an
        ``embedding.multi_tier.TieredGroup``) with every checkpoint and
        import them, re-bucketed to this rank, on restore."""
        self._tiered = tiered_group

    def shrink_tables(self, ts: TrainState,
                      global_step: Optional[int] = None) -> TrainState:
        """Checkpoint-time eviction (``group.shrink``, in place, at
        ``global_step``, by default the state's step) with every
        evicted key journaled for the next incremental save's
        tombstones (on a mesh, each rank journals its shards). Use it,
        not a bare ``group.shrink``, whenever incremental checkpoints
        are written. Returns ``ts``."""
        step = int(ts.step) if global_step is None else int(global_step)
        tables = self.group.tables
        before = {t: _live_keys(c, ts.ev[t]) for t, c in tables.items()}
        self.group.shrink(ts.ev, step)
        for t, cfg in tables.items():
            gone = np.setdiff1d(before[t], _live_keys(cfg, ts.ev[t]))
            if gone.size:
                self._tombstones.setdefault(t, set()).update(gone.tolist())
        return ts

    def _steps(self, kind: str):
        pat = re.compile(rf"{kind}-(\d+)$")
        return sorted(int(m.group(1)) for m in map(pat.match,
                                                   os.listdir(self.dir)) if m)

    # -- save -------------------------------------------------------------
    def save(self, ts: TrainState, *, incremental: bool = False,
             since_step: Optional[int] = None) -> str:
        """Write a full (default) or incremental checkpoint at the
        state's current step (on a mesh: every rank calls it)."""
        step = int(ts.step)
        kind = "incr" if incremental else "full"
        path = os.path.join(self.dir, f"{kind}-{step}")
        tmp = path + ".tmp"
        lead = self.rank == 0
        if lead:
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "dense.npz"), **_dense_leaves(ts))
        self._barrier()
        min_version = since_step if incremental else None
        group = self.group
        for tname, cfg in group.tables.items():
            stacked = group._is_stacked(tname)
            if not (stacked or lead):
                continue
            si, n_sh = ((self.rank, group.num_shards) if stacked
                        else (0, 1))
            arrs = _export_table(cfg, ts.ev[tname], ts.slots.get(tname, {}),
                                 min_version, si, n_sh)
            if incremental:
                # Journaled evictions minus keys inserted again since. A
                # key lives on its owner only, so each shard's own
                # difference is its part of the table's.
                journal = np.fromiter(self._tombstones.get(tname, ()),
                                      np.int64)
                tombs = np.setdiff1d(journal, _live_keys(cfg, ts.ev[tname]))
                if stacked and self.mesh is not None:
                    tombs = np.unique(np.concatenate(
                        self.mesh.all_gather_object(tombs)))
                if si == 0:
                    arrs["tombstones"] = tombs
            np.savez(os.path.join(tmp, f"table-{tname}-s{si}.npz"), **arrs)
        if self._tiered is not None:
            for tname, shards in self._tiered.export_spill().items():
                for si, arrs in shards.items():
                    if len(arrs["keys"]):
                        np.savez(os.path.join(
                            tmp, f"spill-{tname}-s{si}.npz"), **arrs)
        if lead:
            if self._aux:
                with open(os.path.join(tmp, "aux.json"), "w") as f:
                    json.dump({n: get() for n, (get, _) in self._aux.items()},
                              f)
            meta = {
                "step": step,
                "kind": kind,
                "since_step": since_step,
                "num_shards": group.num_shards,
                "table_shards": {t: (group.num_shards
                                     if group._is_stacked(t) else 1)
                                 for t in group.tables},
                "tables": sorted(group.tables),
            }
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
        self._barrier()
        if lead:
            if os.path.exists(path):
                shutil.rmtree(path)
            os.rename(tmp, path)
            self._gc()
        self._barrier()
        # The snapshot or delta just written holds every journaled
        # eviction.
        self._tombstones.clear()
        return path

    def _gc(self):
        fulls = self._steps("full")
        for old in fulls[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"full-{old}"),
                          ignore_errors=True)
        if fulls[:-self.keep]:
            # Deltas older than the oldest kept full are unreplayable.
            floor = fulls[:-self.keep][-1]
            for inc in self._steps("incr"):
                if inc <= floor:
                    shutil.rmtree(os.path.join(self.dir, f"incr-{inc}"),
                                  ignore_errors=True)

    # -- restore ------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        fulls = self._steps("full")
        return fulls[-1] if fulls else None

    def restore(self, ts_template: TrainState,
                step: Optional[int] = None) -> TrainState:
        """The newest full checkpoint at or before ``step`` plus newer
        incremental ones up to ``step``, into fresh tables on the
        device of ``ts_template``'s params, and into copies of the
        template's optimizer slots (slot rows of keys the checkpoint
        does not hold keep the template's values, as in the JAX
        package). On a mesh, this rank's shards, whatever shard count
        wrote the checkpoint."""
        fulls = self._steps("full")
        if step is not None:
            fulls = [s for s in fulls if s <= step]
        if not fulls:
            raise FileNotFoundError(f"no full checkpoint in {self.dir}")
        base = fulls[-1]
        device = next(iter(ts_template.params.values())).device
        ts = self._apply(ts_template.replace(
            ev=self.group.create_state(device, self.rank)), f"full-{base}",
            full=True)
        incrs = [s for s in self._steps("incr")
                 if s > base and (step is None or s <= step)]
        for s in incrs:
            ts = self._apply(ts, f"incr-{s}", full=False)
        return ts

    def _apply(self, ts: TrainState, name: str, *, full: bool) -> TrainState:
        """Apply one checkpoint directory. A delta applies to a copy of
        the tables, so a state being served never changes under its
        readers."""
        path = os.path.join(self.dir, name)
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        if self._tiered is not None:
            blob: Dict[str, Dict[int, Dict[str, np.ndarray]]] = {}
            for fn in os.listdir(path):
                m = re.match(r"spill-(.+)-s(\d+)\.npz$", fn)
                if m:
                    with np.load(os.path.join(path, fn),
                                 allow_pickle=False) as z:
                        blob.setdefault(m.group(1), {})[int(m.group(2))] = \
                            dict(z)
            if blob:
                self._tiered.import_spill(blob)
        params, dense_opt = ts.params, ts.dense_opt
        dense_path = os.path.join(path, "dense.npz")
        if os.path.exists(dense_path):
            with np.load(dense_path, allow_pickle=False) as z:
                flat = dict(z)
            params = _dense_tree(flat, _PARAMS, ts.params, name)
            dense_opt = {}
            for field, v in ts.dense_opt.items():
                key = f"{_DENSE_OPT}/.{field}"
                if isinstance(v, dict):
                    dense_opt[field] = _dense_tree(flat, key, v, name)
                elif key in flat:
                    dense_opt[field] = torch.from_numpy(
                        np.array(flat[key])).to(v.device, v.dtype)
                else:
                    raise KeyError(f"{name}: no dense leaf {key}")
        aux_path = os.path.join(path, "aux.json")
        if self._aux and os.path.exists(aux_path):
            with open(aux_path) as f:
                aux = json.load(f)
            for n, (_, setter) in self._aux.items():
                if n in aux:
                    setter(aux[n])
        new_ev = dict(ts.ev) if full else {t: _clone_ev(s)
                                           for t, s in ts.ev.items()}
        new_slots = {t: {k: v.clone() for k, v in sl.items()}
                     for t, sl in ts.slots.items()}
        for tname, cfg in self.group.tables.items():
            n_saved = meta.get("table_shards", {}).get(tname,
                                                       meta["num_shards"])
            pid, pnum = ((self.rank, self.group.num_shards)
                         if self.group._is_stacked(tname) else (0, 1))
            slots = new_slots.get(tname, {})
            rows = {f"['{k}']": v for k, v in _row_aligned(cfg, slots).items()}
            wanted = ("keys", "values", "freqs", "versions",
                      *(f"slot/{k}" for k in rows))
            merged: Dict[str, list] = {}
            scalars: Dict[str, np.ndarray] = {}
            bloom = tombs = None
            for si in range(n_saved):
                fn = os.path.join(path, f"table-{tname}-s{si}.npz")
                if not os.path.exists(fn):
                    continue
                with np.load(fn, allow_pickle=False) as z:
                    for k in wanted:
                        merged.setdefault(k, []).append(z[k])
                    for k in z.files:
                        if k.startswith("scalar/"):
                            scalars[k[len("scalar/"):]] = z[k]
                    if "bloom" in z.files and si == pid:
                        bloom = z["bloom"]
                    if "tombstones" in z.files:
                        tombs = z["tombstones"]
            if "keys" not in merged:
                continue
            st = new_ev[tname]
            ev.import_arrays(cfg, st,
                             {k: np.concatenate(v) for k, v in merged.items()},
                             partition_id=pid, partition_num=pnum,
                             extra_targets=rows)
            _set_scalars(slots, scalars)
            if bloom is not None and n_saved == pnum:
                # Counters restore only onto the shard count that saved
                # them, as in the JAX package; each shard its own (the
                # JAX package hands every shard the last file's).
                st.bloom = torch.from_numpy(np.array(bloom, np.int32)).to(
                    st.bloom.device)
            if tombs is not None and tombs.size:
                # After the upserts: an evicted key stays gone, a key
                # inserted again since (absent from the tombstones)
                # stays live.
                ev.delete_keys(cfg, st, tombs)
        return ts.replace(params=params, dense_opt=dense_opt, ev=new_ev,
                          slots=new_slots, step=int(meta["step"]))
