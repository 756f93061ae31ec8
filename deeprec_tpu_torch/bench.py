"""Headline training benchmark of the port: WDL on synthetic Criteo.

Port of the headline row of ``bench.py`` (``bench.py:39-117``): the
reference-shape WDL (per-column dims 64/128 and hash buckets from
``modelzoo/WDL/train.py:40-96``, the wide weight in channel 0 of each
deep table, EV tables that record no freq or version, coalesced into a
129-wide and a 65-wide table), towers 1024/512/256 in bfloat16 over
float32 params, ``SparseAdagrad(0.05)`` on the tables and Adagrad(0.05)
on the towers, trained on ``SyntheticCriteo(16384, vocab=
CRITEO_HASH_BUCKETS, seed=0)``. Run on one CUDA card::

    python3 -m deeprec_tpu_torch.bench

It times 30 warm-up and then 30 measured steps over 8 pre-packed
batches, fenced with ``torch.cuda.synchronize()``, and prints one JSON
line: ``{"metric": "wdl_criteo_samples_per_sec", "value", "unit",
"device"}``. The static-bucket, dim16 and end-to-end rows of
``bench.py`` are not ported yet.
"""

from __future__ import annotations

import dataclasses
import json
import math
import time
from typing import Any, Callable

import torch

from deeprec_tpu_torch import config as cfglib
from deeprec_tpu_torch.data.criteo import CRITEO_HASH_BUCKETS, SyntheticCriteo
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
    apply_fn: Callable
    loss_fn: Callable
    device: torch.device
    wide: bool      # whether batches carry C*_wide columns
    metric: str

    def next_batch(self):
        """The stream's next batch, packed on the trainer's device."""
        return self.group.pack_batch_np(
            self.data.next_batch_np(wide=self.wide), self.device)


def _loss(out, batch):
    return losses.bce_with_logits(out, batch["label"])


def _assemble(cols, hidden, dtype, device, sparse_opt: str, data, *,
              wide: bool, metric: str) -> Trainer:
    device = torch.device(device)
    group = EmbeddingGroup(cols, coalesce=True)
    model = wdl.WDL(wdl.input_width(group), hidden=hidden, dtype=dtype,
                    device=device)
    init_dense(model, torch.Generator().manual_seed(0))
    sopt = (sparse_lib.make("adagrad", learning_rate=0.05)
            if sparse_opt == "adagrad" else sparse_lib.make(sparse_opt))
    dopt = dense_lib.Adagrad(0.05)
    ts = trainlib.create_train_state(group, model.state_dict(), dopt, sopt,
                                     device)
    afn = wdl.apply_fn(model, group)
    step = trainlib.make_train_step(group, afn, _loss, sopt, dopt)
    return Trainer(group=group, data=data, ts=ts, step=step,
                   sparse_opt=sopt, dense_opt=dopt, apply_fn=afn,
                   loss_fn=_loss, device=device, wide=wide, metric=metric)


def build_wdl(reference_shapes: bool = True, device="cuda",
              sparse_opt: str = "adagrad") -> Trainer:
    """The ``bench.py`` WDL at B = 16,384: reference shapes (the
    headline), or uniform dim 16 over ids of a 200,000 vocabulary.
    ``sparse_opt``: "adagrad" (lr 0.05, the headline) or "adam"
    (``SparseAdam`` defaults)."""
    evo = cfglib.EmbeddingVariableOption(record_freq=False,
                                         record_version=False)
    cols = wdl.criteo_columns(embedding_dim=16, capacity=1 << 20,
                              reference_shapes=reference_shapes,
                              wide_in_deep=True, ev_option=evo)
    data = SyntheticCriteo(
        BATCH, vocab=CRITEO_HASH_BUCKETS if reference_shapes else 200_000,
        seed=0)
    metric = ("wdl_criteo_samples_per_sec" if reference_shapes
              else "wdl_dim16_samples_per_sec")
    return _assemble(cols, (1024, 512, 256), torch.bfloat16, device,
                     sparse_opt, data, wide=False, metric=metric)


def build_small(device="cuda", sparse_opt: str = "adagrad",
                batch: int = 64) -> Trainer:
    """The sizes of ``__graft_entry__._build``: dim-16
    deep and dim-1 wide columns of capacity 1 << 14 (coalesced), towers
    256/128/64 in float32, ids of a 5,000 vocabulary, freq and version
    recorded."""
    cols = wdl.criteo_columns(embedding_dim=16, capacity=1 << 14)
    data = SyntheticCriteo(batch, vocab=5000, seed=0)
    return _assemble(cols, (256, 128, 64), torch.float32, device,
                     sparse_opt, data, wide=True, metric="wdl_small_loss")


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
            "step_ms": dt / steps * 1e3, "losses": step_losses,
            "n_overflow": [int(m["n_overflow"]) for m in metrics]}


def main():
    out = bench_device()
    print(json.dumps({k: out[k] for k in ("metric", "value", "unit",
                                          "device")}), flush=True)


if __name__ == "__main__":
    main()
