"""Checkpoints in the JAX package's format: full and incremental.

Port of ``CheckpointManager`` from ``deeprec_tpu/train/checkpoint.py``.
A checkpoint is a directory ``full-<step>`` or ``incr-<step>`` holding
``meta.json``, ``dense.npz`` and one ``table-<name>-s<shard>.npz`` per
table shard. ``dense.npz`` keys its leaves by JAX tree-path strings:
``['params']/['deep']/['dense_0']/['kernel']`` for the params and
``['dense_opt']/[0]/.sum_of_squares/['deep']/['dense_0']/['kernel']``
for the dense Adagrad state (optax's ``(ScaleByRssState, EmptyState)``).
A table file holds the 4-tensor EV format (keys/values/freqs/versions)
plus the sparse optimizer's state: its row-aligned slot arrays as
``slot/['<name>']`` (``accum``; ``m`` and ``v``; ``accum`` and
``linear``), one row per key, and its other leaves as
``scalar/['beta1_power']``, ``scalar/['beta2_power']``. A
static hash-bucket table is saved in full on every save, incremental
ones included, keyed by row index. The JAX package and the port read
each other's checkpoints, optimizer state included.

Restore fills what the template state carries: a template without
optimizer state (serving) skips the ``slot/*``, ``scalar/*`` and
``dense_opt`` leaves. Non-empty ``tombstones`` (eviction replay) and
multi-tier spill files raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
from typing import Dict, Optional

import numpy as np
import torch

from deeprec_tpu_torch.convert import (wdl_params_from_numpy,
                                       wdl_params_to_numpy)
from deeprec_tpu_torch.embedding import hash_table as ht
from deeprec_tpu_torch.embedding import variable as ev
from deeprec_tpu_torch.feature_column.feature_column import EmbeddingGroup
from deeprec_tpu_torch.train.loop import TrainState

_PATH_PART = re.compile(r"^\['(.+)'\]$")
_PARAMS = "['params']"
_DENSE_OPT = "['dense_opt']/[0]/.sum_of_squares"


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
    flat = _flatten_params(wdl_params_to_numpy(ts.params), _PARAMS)
    if ts.dense_opt:
        flat.update(_flatten_params(
            wdl_params_to_numpy(ts.dense_opt["sum_of_squares"]), _DENSE_OPT))
    return flat


def _dense_tree(flat, prefix, like: Dict[str, torch.Tensor], name: str):
    """State dict of the leaves under ``prefix``, on the devices and in
    the types of ``like``."""
    loaded = wdl_params_from_numpy(_subtree(flat, prefix))
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
                  min_version: Optional[int]) -> Dict[str, np.ndarray]:
    """Live rows with their slot rows (all, or touched since
    ``min_version`` where the table records versions; otherwise, and
    for a static table always, a delta is a full dump, as in the JAX
    package), and the scalar slots."""
    out = ev.export_arrays(cfg, state)
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
    return out


def _clone_ev(st: ev.EVState) -> ev.EVState:
    return dataclasses.replace(
        st, table=ht.HashTable(st.table.key_rows.clone()),
        values=st.values.clone(), freqs=st.freqs.clone(),
        versions=st.versions.clone())


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

    def __init__(self, directory: str, group: EmbeddingGroup, keep: int = 3):
        self.dir = directory
        self.group = group
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _steps(self, kind: str):
        pat = re.compile(rf"{kind}-(\d+)$")
        return sorted(int(m.group(1)) for m in map(pat.match,
                                                   os.listdir(self.dir)) if m)

    # -- save -------------------------------------------------------------
    def save(self, ts: TrainState, *, incremental: bool = False,
             since_step: Optional[int] = None) -> str:
        """Write a full (default) or incremental checkpoint at the
        state's current step."""
        step = int(ts.step)
        kind = "incr" if incremental else "full"
        path = os.path.join(self.dir, f"{kind}-{step}")
        tmp = path + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "dense.npz"), **_dense_leaves(ts))
        min_version = since_step if incremental else None
        for tname, cfg in self.group.tables.items():
            arrs = _export_table(cfg, ts.ev[tname],
                                 ts.slots.get(tname, {}), min_version)
            if incremental:
                # No eviction in the port: the deletion record is empty.
                arrs["tombstones"] = np.zeros((0,), np.int64)
            np.savez(os.path.join(tmp, f"table-{tname}-s0.npz"), **arrs)
        meta = {
            "step": step,
            "kind": kind,
            "since_step": since_step,
            "num_shards": 1,
            "table_shards": {t: 1 for t in self.group.tables},
            "tables": sorted(self.group.tables),
        }
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)
        self._gc()
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
        package)."""
        fulls = self._steps("full")
        if step is not None:
            fulls = [s for s in fulls if s <= step]
        if not fulls:
            raise FileNotFoundError(f"no full checkpoint in {self.dir}")
        base = fulls[-1]
        device = next(iter(ts_template.params.values())).device
        ts = self._apply(ts_template.replace(
            ev=self.group.create_state(device)), f"full-{base}", full=True)
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
        spills = [fn for fn in os.listdir(path) if fn.startswith("spill-")]
        if spills:
            raise NotImplementedError(
                f"{name}: multi-tier spill rows ({spills[0]}) are not "
                "ported")
        params, dense_opt = ts.params, ts.dense_opt
        dense_path = os.path.join(path, "dense.npz")
        if os.path.exists(dense_path):
            with np.load(dense_path, allow_pickle=False) as z:
                flat = dict(z)
            params = _dense_tree(flat, _PARAMS, ts.params, name)
            if ts.dense_opt:
                dense_opt = {"sum_of_squares": _dense_tree(
                    flat, _DENSE_OPT, ts.dense_opt["sum_of_squares"], name)}
        new_ev = dict(ts.ev) if full else {t: _clone_ev(s)
                                           for t, s in ts.ev.items()}
        new_slots = {t: {k: v.clone() for k, v in sl.items()}
                     for t, sl in ts.slots.items()}
        for tname, cfg in self.group.tables.items():
            n_saved = meta.get("table_shards", {}).get(tname,
                                                       meta["num_shards"])
            slots = new_slots.get(tname, {})
            rows = {f"['{k}']": v for k, v in _row_aligned(cfg, slots).items()}
            wanted = ("keys", "values", "freqs", "versions",
                      *(f"slot/{k}" for k in rows))
            merged: Dict[str, list] = {}
            scalars: Dict[str, np.ndarray] = {}
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
                    if "tombstones" in z.files and z["tombstones"].size:
                        raise NotImplementedError(
                            f"{name}: table {tname} carries eviction "
                            "tombstones; their replay is not ported")
            if "keys" not in merged:
                continue
            ev.import_arrays(cfg, new_ev[tname],
                             {k: np.concatenate(v) for k, v in merged.items()},
                             extra_targets=rows)
            _set_scalars(slots, scalars)
        return ts.replace(params=params, dense_opt=dense_opt, ev=new_ev,
                          slots=new_slots, step=int(meta["step"]))
