"""Train WDL end to end and report AUC: the PyTorch port's counterpart of
``tools/train_wdl.py`` (the accuracy half of the reference's benchmark
tables, ``modelzoo/WDL/README.md``), on the synthetic Criteo stream.

The same model: ``__graft_entry__._build``'s columns (dim-16 deep and
dim-1 wide embeddings of every Criteo field, each of capacity ``1 <<
--cap``, coalesced; freq and version recorded), ids of a ``--vocab``
vocabulary, towers ``--hidden`` in bf16 over float32 params (``--fp32``:
float32), SparseAdagrad(0.05) and dense Adagrad(0.05), B = ``--batch``.

The same run shape: the whole training is one
``make_epoch_step(n_epochs=E)`` call over a pool of ``--pool``
pre-packed batches (``steps`` rounded up to whole passes). On the card
that is one eager step, then the step captured in a CUDA graph and
replayed for the others, with no host read between them. Evaluation
scores 20 stacked held-out batches through the eval step into the
streaming AUC. It prints the JSON keys of ``tools/train_wdl.py``, with
``"backend"`` ``"cuda"`` or ``"cpu"``; progress goes to stderr.

Usage: python3 tools/train_wdl_torch.py [steps] [--fp32] [--cpu]
           [--batch N] [--cap LOG2] [--vocab V] [--hidden H1,H2,..]
           [--pool K]

It runs on the CUDA card and fails without one; ``--cpu`` runs on the
CPU (use small sizes there: the defaults hold 4 GB of rows and
accumulators).
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

EVAL_BATCHES = 20


def _arg(argv, flag, default, cast=int):
    if flag in argv:
        return cast(argv[argv.index(flag) + 1])
    return default


def run(steps: int = 288, bf16: bool = True, batch: int = 16384,
        pool: int = 144, cap_log2: int = 20, vocab: int = 200_000,
        hidden=(1024, 512, 256), device="cuda") -> dict:
    import numpy as np
    import torch

    from deeprec_tpu_torch import bench
    from deeprec_tpu_torch.train import loop as trainlib
    from deeprec_tpu_torch.train import metrics as metricslib

    device = torch.device(device)
    tr = bench.build_small(device, batch=batch, capacity=1 << cap_log2,
                           hidden=hidden, vocab=vocab,
                           dtype=torch.bfloat16 if bf16 else torch.float32)
    n_epochs = max(1, -(-steps // pool))
    steps = n_epochs * pool

    t0 = time.perf_counter()
    stacked = trainlib.stack_batches([tr.next_batch() for _ in range(pool)])
    # Held-out batches, stacked as the training pool is.
    eval_stacked = trainlib.stack_batches(
        [tr.next_batch() for _ in range(EVAL_BATCHES)])
    print(f"# pool gen: {time.perf_counter() - t0:.1f}s", file=sys.stderr,
          flush=True)

    run_all = trainlib.make_epoch_step(tr.group, tr.apply_fn, tr.loss_fn,
                                       tr.sparse_opt, tr.dense_opt,
                                       n_epochs=n_epochs)
    eval_step = trainlib.make_eval_step(tr.group, tr.apply_fn)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    ts, ls = run_all(tr.ts, stacked)
    sync()
    train_s = time.perf_counter() - t0
    print(f"# build+capture+train ({steps} steps): {train_s:.1f}s",
          file=sys.stderr, flush=True)

    t0 = time.perf_counter()
    auc = metricslib.auc_init(device=device)
    for k in range(EVAL_BATCHES):
        b = trainlib.batch_at(eval_stacked, k)
        auc = metricslib.auc_update(auc, eval_step(ts, b), b["label"])
    auc = float(metricslib.auc_result(auc))
    print(f"# eval: {time.perf_counter() - t0:.1f}s", file=sys.stderr,
          flush=True)

    ls = ls.reshape(n_epochs, pool).cpu().numpy().astype(np.float64)
    return {
        "metric": "wdl_synthetic_auc",
        "auc": round(auc, 4),
        "mode": "bf16" if bf16 else "fp32",
        "backend": device.type,
        "steps": steps, "batch": batch,
        "loss_first": round(float(ls[0, 0]), 4),
        "loss_last": round(float(ls[-1, -1]), 4),
        "loss_epoch_means": [round(float(m), 4) for m in ls.mean(1)],
        "train_s_incl_compile": round(train_s, 1),
    }


def main(argv=None) -> dict:
    import torch

    argv = sys.argv[1:] if argv is None else list(argv)
    if "--cpu" in argv:
        device = "cpu"
    elif torch.cuda.is_available():
        device = "cuda"
    else:
        raise SystemExit("train_wdl_torch: no CUDA card (torch.cuda."
                         "is_available() is false); pass --cpu")
    steps = int(argv[0]) if argv and argv[0].isdigit() else 288
    out = run(
        steps, bf16="--fp32" not in argv,
        batch=_arg(argv, "--batch", 16384), pool=_arg(argv, "--pool", 144),
        cap_log2=_arg(argv, "--cap", 20),
        vocab=_arg(argv, "--vocab", 200_000),
        hidden=_arg(argv, "--hidden", (1024, 512, 256),
                    lambda s: tuple(int(x) for x in s.split(","))),
        device=device)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
