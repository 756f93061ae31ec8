"""Training benchmark of the port: the four rows of ``bench.py``.

Port of ``bench.py``: WDL on synthetic Criteo at B = 16,384, towers
1024/512/256 in bfloat16 over float32 params, ``SparseAdagrad(0.05)``
on the tables and Adagrad(0.05) on the towers, in four rows:

* ``headline``: reference shapes (per-column dims 64/128 and hash
  buckets from ``modelzoo/WDL/train.py:40-96``, the wide weight in
  channel 0 of each deep table), EV tables that record no freq or
  version, coalesced into a 129-wide and a 65-wide table; ids of
  ``SyntheticCriteo(vocab=CRITEO_HASH_BUCKETS, seed=0)``.
* ``static``: the same shapes as static hash-bucket columns (the
  reference's default column type): two offset-coalesced matrices,
  1,700,001 x 129 and 94,491 x 65.
* ``dim16``: uniform dim 16 (17 with the wide channel) over ids of a
  200,000 vocabulary, one coalesced EV table of 2**25 rows.
* ``e2e``: the headline model fed from a Kaggle-format TSV on disk
  (written into a new directory under ``$TMPDIR`` from
  ``SyntheticCriteo(vocab=200_000, seed=7)``, removed after the row):
  native parse with 31-bit ids, ``pack_batch_np(compact=
  True)`` on a prefetch thread, pinned host-to-device copies, step.

Run on one CUDA card::

    python3 -m deeprec_tpu_torch.bench [headline|static|dim16|e2e|all]
        [--out PATH]

A device row times 30 warm-up and then 30 measured steps over 8
pre-packed batches, fenced with ``torch.cuda.synchronize()``; the e2e
row times every full batch of the file after one warm-up batch. Each
row prints one JSON line (``metric``, ``value``, ``unit``, ``device``,
``batch``, ``step_ms``); with no argument the headline row prints
``{"metric", "value", "unit", "device"}``. ``all`` runs each row in a
process of its own and prints their lines. ``--out`` also writes the
rows, as JSON, to that path; nothing else is written but the TSV.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from typing import Any, Callable

import numpy as np
import torch

from deeprec_tpu_torch import config as cfglib
from deeprec_tpu_torch.data.criteo import (CRITEO_HASH_BUCKETS,
                                           SyntheticCriteo,
                                           criteo_file_batches)
from deeprec_tpu_torch.data.prefetch import PrefetchIterator
from deeprec_tpu_torch.feature_column.feature_column import EmbeddingGroup
from deeprec_tpu_torch.layers.core import init_dense
from deeprec_tpu_torch.models import wdl
from deeprec_tpu_torch.optimizers import dense as dense_lib
from deeprec_tpu_torch.optimizers import sparse as sparse_lib
from deeprec_tpu_torch.train import loop as trainlib
from deeprec_tpu_torch.train import losses

BATCH = 16384
WARMUP_STEPS = 30
MEASURE_STEPS = 30
PREPACKED = 8


@dataclasses.dataclass
class Trainer:
    """A built model: its group, data stream, state, step and parts."""

    group: EmbeddingGroup
    data: SyntheticCriteo
    ts: trainlib.TrainState
    step: Callable
    sparse_opt: Any
    dense_opt: dense_lib.Adagrad
    model: wdl.WDL  # the towers' module (``ts.params`` hold its weights)
    apply_fn: Callable
    loss_fn: Callable
    device: torch.device
    wide: bool      # whether batches carry C*_wide columns
    metric: str
    mesh: Any = None  # a trainer of one rank of a mesh

    def next_batch(self):
        """The stream's next batch, packed on the trainer's device; on a
        mesh, this rank's rows of the stream's global batch."""
        raw = self.data.next_batch_np(wide=self.wide)
        if self.mesh is not None:
            b = len(raw["label"]) // self.mesh.size
            raw = {k: v[self.mesh.rank * b:(self.mesh.rank + 1) * b]
                   for k, v in raw.items()}
        return self.group.pack_batch_np(raw, self.device)


def _loss(out, batch):
    return losses.bce_with_logits(out, batch["label"])


def _sparse_opt(sparse_opt):
    """An optimizer object as it is; a name through ``make``, "adagrad"
    at the headline's learning rate 0.05, the others at their
    defaults."""
    if not isinstance(sparse_opt, str):
        return sparse_opt
    if sparse_opt == "adagrad":
        return sparse_lib.make("adagrad", learning_rate=0.05)
    return sparse_lib.make(sparse_opt)


def _assemble(cols, hidden, dtype, device, sparse_opt, data, *,
              wide: bool, metric: str, mesh=None,
              group_kw=None) -> Trainer:
    device = torch.device(device)
    group = EmbeddingGroup(cols, coalesce=True, **(group_kw or {}))
    model = wdl.WDL(wdl.input_width(group), hidden=hidden, dtype=dtype,
                    device=device)
    init_dense(model, torch.Generator().manual_seed(0))
    sopt = _sparse_opt(sparse_opt)
    dopt = dense_lib.Adagrad(0.05)
    ts = trainlib.create_train_state(group, model.state_dict(), dopt, sopt,
                                     device, mesh)
    afn = wdl.apply_fn(model, group)
    step = trainlib.make_train_step(group, afn, _loss, sopt, dopt,
                                    mesh=mesh)
    return Trainer(group=group, data=data, ts=ts, step=step,
                   sparse_opt=sopt, dense_opt=dopt, model=model,
                   apply_fn=afn, loss_fn=_loss, device=device, wide=wide,
                   metric=metric, mesh=mesh)


def build_wdl(reference_shapes: bool = True, device="cuda",
              sparse_opt="adagrad", static_buckets: bool = False,
              batch: int = BATCH, mesh=None,
              group_kw=None, storage=None) -> Trainer:
    """The ``bench.py`` WDL at B = ``batch`` (16,384): reference shapes
    (the headline; with ``static_buckets``, the static row), or uniform
    dim 16 over ids of a 200,000 vocabulary. ``sparse_opt``: a name of
    ``optimizers.sparse.BY_NAME`` ("adagrad": lr 0.05, the headline;
    the others at their defaults) or an optimizer object. On a ``mesh``
    (``parallel.mesh.Mesh``) the tables are row-sharded over its ranks
    (``group_kw``: further ``EmbeddingGroup`` arguments, such as a
    ``placement``), the stream's batches are global, ``batch`` rows a
    rank, and the trainer is this rank's; every rank builds the same
    tower weights. ``storage``: the tables' ``config.StorageOption``
    by the deep table's width (a coalesced table holds the columns of
    one width: 129 and 65 at reference shapes), for the multi-tier runs
    (``embedding.multi_tier.TieredGroup``); a tiered table records freq
    and version."""
    if mesh is not None:
        group_kw = dict(axis_name=mesh.axis_name, num_shards=mesh.size,
                        **(group_kw or {}))
    evo = cfglib.EmbeddingVariableOption(record_freq=False,
                                         record_version=False)
    cols = wdl.criteo_columns(embedding_dim=16, capacity=1 << 20,
                              reference_shapes=reference_shapes,
                              wide_in_deep=True, ev_option=evo,
                              static_buckets=static_buckets)
    if storage:
        cols = [dataclasses.replace(c, ev_option=dataclasses.replace(
                    evo, storage_option=storage[c.dim]))
                if getattr(c, "dim", None) in storage else c for c in cols]
    data = SyntheticCriteo(
        batch * (1 if mesh is None else mesh.size),
        vocab=CRITEO_HASH_BUCKETS if reference_shapes else 200_000, seed=0)
    metric = ("wdl_static_bucket_samples_per_sec" if static_buckets
              else "wdl_criteo_samples_per_sec" if reference_shapes
              else "wdl_dim16_samples_per_sec")
    return _assemble(cols, (1024, 512, 256), torch.bfloat16, device,
                     sparse_opt, data, wide=False, metric=metric, mesh=mesh,
                     group_kw=group_kw)


def build_small(device="cuda", sparse_opt: str = "adagrad",
                batch: int = 64, *, capacity: int = 1 << 14,
                hidden=(256, 128, 64), vocab: int = 5000,
                dtype: torch.dtype = torch.float32) -> Trainer:
    """The model of ``__graft_entry__._build``: dim-16 deep and dim-1
    wide columns of ``capacity`` each (coalesced), freq and version
    recorded, ids of a ``vocab`` vocabulary; at its sizes by default
    (towers 256/128/64 in float32). ``tools/train_wdl_torch.py`` builds
    it at its own."""
    cols = wdl.criteo_columns(embedding_dim=16, capacity=capacity)
    data = SyntheticCriteo(batch, vocab=vocab, seed=0)
    return _assemble(cols, tuple(hidden), dtype, device, sparse_opt, data,
                     wide=True, metric="wdl_small_loss")


def bench_device(trainer: Trainer | None = None,
                 warmup: int = WARMUP_STEPS,
                 steps: int = MEASURE_STEPS) -> dict:
    """Time ``steps`` training steps after ``warmup`` ones on the card.
    Returns the JSON fields plus the measured steps' losses and
    ``n_overflow``; ``trainer.ts`` holds the trained state after."""
    if not torch.cuda.is_available():
        raise RuntimeError("bench_device needs a CUDA card")
    tr = trainer if trainer is not None else build_wdl()
    if tr.device.type != "cuda":
        raise ValueError(f"bench_device: trainer on {tr.device}, not cuda")
    batches = [tr.next_batch() for _ in range(PREPACKED)]
    ts = tr.ts
    for i in range(warmup):
        ts, _ = tr.step(ts, batches[i % PREPACKED])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = []
    for i in range(steps):
        ts, m = tr.step(ts, batches[(warmup + i) % PREPACKED])
        metrics.append(m)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    tr.ts = ts
    step_losses = [float(m["loss"]) for m in metrics]
    if not all(math.isfinite(x) for x in step_losses):
        raise FloatingPointError(f"non-finite training loss: {step_losses}")
    batch = batches[0]["label"].shape[0]
    return {"metric": tr.metric, "value": batch * steps / dt,
            "unit": "samples/s", "device": torch.cuda.get_device_name(0),
            "batch": batch, "step_ms": dt / steps * 1e3,
            "losses": step_losses,
            "n_overflow": [int(m["n_overflow"]) for m in metrics]}


def write_tsv(path: str, n_rows: int, data: SyntheticCriteo) -> None:
    """Synthetic Criteo-format TSV (label \\t 13 ints \\t 26 hex ids) of
    ``data``'s draws, as ``bench.py``'s ``_write_tsv`` writes it."""
    with open(path, "w") as f:
        remaining = n_rows
        while remaining > 0:
            B = min(remaining, 65536)
            ints, cats = data._draw(B)
            p = 1.0 / (1.0 + np.exp(-data.logits(ints, cats)))
            labels = (np.random.default_rng(remaining).random(B) < p
                      ).astype(np.int32)
            iv = np.char.mod("%d", (ints * 10).astype(np.int64))
            cv = np.char.mod("%x", cats)
            rows = np.concatenate(
                [labels.astype(str)[:, None], iv, cv], axis=1)
            f.write("\n".join("\t".join(r) for r in rows) + "\n")
            remaining -= B


def e2e_batches(tr: Trainer, path: str):
    """The e2e row's input pipeline up to the card: full batches of the
    file, parsed natively with 31-bit ids (so every id plane ships as
    ``CompactIds``) and no ``C*_wide`` columns, packed compact on the
    host."""
    for b in criteo_file_batches(path, BATCH, as_numpy=True, wide=False,
                                 id_bits=31):
        if b["label"].shape[0] == BATCH:
            yield tr.group.pack_batch_np(b, "cpu", compact=True)


def bench_e2e(trainer: Trainer | None = None, n_rows: int = 600_000,
              path: str | None = None) -> dict:
    """End to end: disk TSV -> native parse -> compact host pack (on a
    prefetch thread) -> pinned, asynchronous host-to-device copy ->
    headline training step. One warm-up batch, then every other full
    batch of the file is timed. Without ``path``, a TSV of ``n_rows``
    rows is written into a new temporary directory and removed after
    the run; a given ``path`` is read as it is."""
    if not torch.cuda.is_available():
        raise RuntimeError("bench_e2e needs a CUDA card")
    tr = trainer if trainer is not None else build_wdl()
    if path is None:
        with tempfile.TemporaryDirectory(prefix="deeprec_torch_e2e_") as d:
            path = os.path.join(d, "criteo.tsv")
            write_tsv(path, n_rows, SyntheticCriteo(BATCH, vocab=200_000,
                                                    seed=7))
            return bench_e2e(tr, path=path)
    it = PrefetchIterator(lambda: e2e_batches(tr, path), buffer_size=4,
                          device=tr.device)
    try:
        ts, m = tr.step(tr.ts, next(it))
        float(m["loss"])
        metrics = []
        t0 = time.perf_counter()
        for b in it:
            ts, m = tr.step(ts, b)
            metrics.append(m)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        it.close()
    tr.ts = ts
    n_steps = len(metrics)
    step_losses = [float(m["loss"]) for m in metrics]
    if not n_steps or not all(math.isfinite(x) for x in step_losses):
        raise FloatingPointError(f"e2e: {n_steps} steps, losses "
                                 f"{step_losses}")
    return {"metric": "wdl_e2e_pipeline_samples_per_sec",
            "value": BATCH * n_steps / dt, "unit": "samples/s",
            "device": torch.cuda.get_device_name(0), "batch": BATCH,
            "step_ms": dt / n_steps * 1e3, "steps": n_steps,
            "losses": step_losses,
            "n_overflow": [int(m["n_overflow"]) for m in metrics]}


ROWS = {
    "headline": lambda: bench_device(build_wdl()),
    "static": lambda: bench_device(build_wdl(static_buckets=True)),
    "dim16": lambda: bench_device(build_wdl(reference_shapes=False)),
    "e2e": bench_e2e,
}
LINE_KEYS = ("metric", "value", "unit", "device", "batch", "step_ms")


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python3 -m deeprec_tpu_torch.bench",
        description="Time the bench.py rows on one CUDA card.")
    ap.add_argument("row", nargs="?", choices=[*ROWS, "all"])
    ap.add_argument("--out", help="also write the rows as JSON here")
    args = ap.parse_args(argv)
    if args.row is None:
        out = bench_device()
        rows = [{k: out[k] for k in LINE_KEYS[:4]}]
        print(json.dumps(rows[0]), flush=True)
    elif args.row != "all":
        out = ROWS[args.row]()
        rows = [{k: out[k] for k in LINE_KEYS}]
        print(json.dumps(rows[0]), flush=True)
    else:
        # One process per row: each row's tables are gigabytes, and a
        # fresh process starts each from an empty card.
        rows = []
        for row in ROWS:
            r = subprocess.run(
                [sys.executable, "-m", "deeprec_tpu_torch.bench", row],
                capture_output=True, text=True,
                cwd=os.path.dirname(os.path.dirname(os.path.abspath(
                    __file__))))
            lines = [ln for ln in r.stdout.splitlines()
                     if ln.startswith("{")]
            if r.returncode != 0 or not lines:
                raise RuntimeError(f"row {row} failed ({r.returncode}):\n"
                                   f"{r.stderr[-2000:]}")
            rows.append(json.loads(lines[-1]))
            print(lines[-1], flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
