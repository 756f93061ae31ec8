"""AUC campaign of the model zoo on the CUDA card: the counterpart of
``tools/zoo_auc.py`` for the PyTorch port.

Each model trains with ``make_epoch_step(n_epochs=1)`` (on the card:
step 0 eager, then the step captured in a CUDA graph and replayed) on a
fresh pool of batches every epoch, then reports the held-out streaming
AUC of 10 batches (``train/metrics.py``) and the per-epoch loss means.
Scoring follows the JAX tool: a single logit against ``label``, a
multi-task model's CTR head against ``click``, DSSM's user-item dot
product against ``label``, the logit of a ``(logits, aux)`` pair.

The settings are the JAX tool's: the columns, towers and behavior
stream of ``tools/train_zoo_torch.py`` (its copies of ``COLUMN_KWARGS``,
``MODULE_KWARGS`` and ``SEQ_DATA``: 1,000 categories, sequences of
50), ``CAMPAIGN``'s steps, learning rates, items and
dense optimizer per model, B = 4,096, a pool of 48, bf16 towers.

Usage:
  python3 tools/zoo_auc_torch.py MODEL [steps] [--fp32] [--batch N]
      [--pool K] [--seed S] [--lr X] [--items N] [--dense adam[:lr]]
      [--cpu]
  python3 tools/zoo_auc_torch.py all|a,b [--seeds 0,1,2] [--fp32]
      [--jobs N] [--out FILE]

One model prints its JSON row. ``all`` (the 11 models of the registry
and ``dlrm_cat``, DLRM with the cat interaction), a comma list, or any
model with ``--seeds`` runs a campaign: one subprocess per model and
seed (``--jobs`` of them at a time),
aggregates the seeds as the JAX tool does (``aggregate``) and writes
``ZOO_AUC_H100.json`` (``ZOO_AUC_H100_FP32.json`` with ``--fp32``) at
the repository root, or ``--out``, keeping the rows of other models
already there. It runs on the CUDA card and fails without one; ``--cpu``
runs on the CPU (the row's ``backend`` says which).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402

from train_zoo_torch import (COLUMN_KWARGS, MODULE_KWARGS,  # noqa: E402
                             SEQ_DATA)

# tools/zoo_auc.py:90-102, as they are.
CAMPAIGN = {
    "wdl": dict(steps=384, lr=0.3, dense="adam"),
    "deepfm": dict(steps=384, lr=0.3, dense="adam"),
    "dlrm": dict(steps=576, lr=0.3, dense="adam"),
    "esmm": dict(steps=384, lr=0.3, dense="adam"),
    "mmoe": dict(steps=384, lr=0.3, dense="adam"),
    "dbmtl": dict(steps=384, lr=0.3, dense="adam"),
    "simple_multitask": dict(steps=384, lr=0.3, dense="adam"),
    "din": dict(steps=384, lr=0.3, items=20_000),
    "dien": dict(steps=288, lr=0.3, dense="adam", items=20_000),
    "bst": dict(steps=384, lr=0.3, dense="adam", items=20_000),
    "dssm": dict(steps=288, lr=0.1, items=20_000),
}
EVAL_BATCHES = 10
NOTE = (
    "Per-model end-to-end accuracy of the PyTorch port on the CUDA card "
    "named in each row's backend (tools/zoo_auc_torch.py): the JAX "
    "tool's settings (tools/zoo_auc.py CAMPAIGN, reference-shaped "
    "columns and towers, B = 4,096, a fresh pool of 48 batches every "
    "epoch through make_epoch_step captured in a CUDA graph), held-out "
    "streaming AUC of 10 batches. The dense weights are drawn by "
    "torch.Generator, not jax.random, so single seeds differ from "
    "ZOO_AUC.json's; compare seed means and spreads.")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("model", help="a model, a,b,... or all")
    p.add_argument("steps", nargs="?", type=int, default=288)
    p.add_argument("--fp32", action="store_true", help="float32 towers")
    p.add_argument("--batch", type=int, default=4096)
    p.add_argument("--pool", type=int, default=48)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seeds", default=None, help="a,b,c: one run each")
    # Unset, a campaign takes CAMPAIGN's value and one run the default.
    p.add_argument("--lr", type=float, default=None,
                   help="sparse Adagrad lr (and dense Adagrad's); 0.05")
    p.add_argument("--items", type=int, default=None,
                   help="sequence models' item vocabulary; 100,000")
    p.add_argument("--dense", default=None,
                   help="dense optimizer: adagrad (default) | adam[:lr]")
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    p.add_argument("--jobs", type=int, default=1,
                   help="campaign: subprocesses at a time")
    p.add_argument("--out", default=None, help="campaign: output file")
    return p.parse_args(argv)


def device_of(cpu: bool):
    import torch

    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("zoo_auc_torch: no CUDA card (torch.cuda."
                         "is_available() is false); pass --cpu")
    return torch.device("cuda")


def score_and_label(out, batch):
    """The scored logit and its label, by the JAX tool's head rules."""
    import torch

    if isinstance(out, dict) and "ctr" in out:
        return out["ctr"], batch["click"]
    if isinstance(out, tuple) and len(out) == 2:
        u, v = out
        if u.dim() == 2 and v.dim() == 2:
            return (u * v).sum(dim=1), batch["label"]   # DSSM towers
        return u.reshape(-1), batch["label"]          # (logits, aux)
    if isinstance(out, torch.Tensor) and out.dim() == 1:
        return out, batch["label"]
    return None, None


def run(name: str, steps: int = 288, bf16: bool = True, batch: int = 4096,
        pool: int = 48, seed: int = 0, lr: float = 0.05,
        items: int = 100_000, dense: str = "adagrad", cpu: bool = False):
    """One model trained and scored; returns its row."""
    import torch

    from deeprec_tpu_torch.data.criteo import CRITEO_HASH_BUCKETS
    from deeprec_tpu_torch.feature_column.feature_column import \
        EmbeddingGroup
    from deeprec_tpu_torch.layers.core import init_dense
    from deeprec_tpu_torch.models.registry import SEQUENCE_MODELS, ZOO
    from deeprec_tpu_torch.optimizers import dense as dense_lib
    from deeprec_tpu_torch.optimizers import sparse as sopt
    from deeprec_tpu_torch.train import loop as trainlib
    from deeprec_tpu_torch.train import metrics as metricslib

    dev = device_of(cpu)
    metric_name = name
    model = "dlrm" if name == "dlrm_cat" else name
    entry = ZOO[model]
    is_seq = model in SEQUENCE_MODELS
    group = EmbeddingGroup(entry.columns(**COLUMN_KWARGS[model]),
                           coalesce=True)
    mk = dict(MODULE_KWARGS[model])
    if name == "dlrm_cat":
        mk["interaction_op"] = "cat"
    if model == "bst":
        mk["seq_len"] = SEQ_DATA["seq_len"]
    module = entry.make_module(
        group, dtype=torch.bfloat16 if bf16 else torch.float32, device=dev,
        **mk)
    init_dense(module, torch.Generator().manual_seed(seed))
    if is_seq:
        data = entry.make_data(batch_size=batch, num_items=items,
                               num_cats=SEQ_DATA["num_cats"],
                               seq_len=SEQ_DATA["seq_len"], seed=seed)

        def pack():
            return group.pack_batch_np(data.next_batch_np(), dev)
    else:
        wide = any(c.name.endswith("_wide") for c in group.embedding)
        data = entry.make_data(batch_size=batch, vocab=CRITEO_HASH_BUCKETS,
                               seed=seed)

        def pack():
            return group.pack_batch_np(data.next_batch_np(wide=wide), dev)

    # The JAX tool draws its init batch first: drawn and dropped here, so
    # the held-out and training batches are the same in both tools.
    pack()
    opt = sopt.SparseAdagrad(learning_rate=lr)
    if dense.startswith("adam"):
        tx = dense_lib.Adam(float(dense.split(":", 1)[1]) if ":" in dense
                            else 2e-3)
    else:
        tx = dense_lib.Adagrad(lr)
    ts = trainlib.create_train_state(group, module.state_dict(), tx, opt,
                                     dev)
    afn = entry.make_apply(module, group)

    n_epochs = max(1, -(-steps // pool))
    steps = n_epochs * pool
    eval_batches = [pack() for _ in range(EVAL_BATCHES)]

    # One pool-sized epoch step fed fresh batches every epoch: the stream
    # is endless, and a recycled pool lets the rows memorize it.
    run_pool = trainlib.make_epoch_step(group, afn, entry.loss, opt, tx,
                                        n_epochs=1)
    t0 = time.perf_counter()
    epoch_losses, step_ms, reserved = [], [], []
    for _ in range(n_epochs):
        stacked = trainlib.stack_batches([pack() for _ in range(pool)])
        ts, ls = run_pool(ts, stacked)
        epoch_losses.append(ls.cpu().numpy().reshape(-1))
        if dev.type == "cuda" and run_pool.last_run["replays"]:
            step_ms.append(run_pool.replay_ms()
                           / run_pool.last_run["replays"])
            reserved.append(torch.cuda.memory_reserved(dev))
        del stacked
    if dev.type == "cuda":
        run_pool.release()
    train_s = time.perf_counter() - t0

    out = {"metric": f"{metric_name}_synthetic_accuracy",
           "mode": "bf16" if bf16 else "fp32",
           "backend": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
           "steps": steps, "batch": batch, "seed": seed,
           "train_s_incl_compile": round(train_s, 1)}
    ls = np.stack(epoch_losses)
    out["loss_epoch_means"] = [round(float(m), 4) for m in ls.mean(1)]
    out["loss_drops"] = bool(ls.mean(1)[-1] < ls.mean(1)[0])
    if step_ms:
        out["replay_ms_per_step"] = round(float(np.median(step_ms)), 3)
        out["memory_reserved_mib"] = [round(r / 2**20, 1) for r in reserved]

    eval_step = trainlib.make_eval_step(group, afn)
    logits, _ = score_and_label(eval_step(ts, eval_batches[0]),
                                eval_batches[0])
    if logits is not None:
        auc = metricslib.auc_init(device=dev)
        for b in eval_batches:
            auc = metricslib.auc_update(
                auc, *score_and_label(eval_step(ts, b), b))
        out["auc"] = round(float(metricslib.auc_result(auc)), 4)
    return out


def aggregate(per_seed, seeds):
    """One campaign row from the per-seed rows, as ``tools/zoo_auc.py``'s
    ``_campaign``: the first seed's row, and with several seeds the AUC's
    mean, spread (max - min) and per-seed values, ``loss_drops`` over all
    seeds, no ``seed``."""
    row = dict(per_seed[0])
    aucs = [r.get("auc") for r in per_seed if r.get("auc") is not None]
    if len(per_seed) > 1:
        row["n_seeds"] = len(per_seed)
        row["seeds"] = list(seeds)
        if aucs:
            row["auc_seeds"] = aucs
            row["auc"] = round(float(np.mean(aucs)), 4)
            row["auc_spread"] = round(max(aucs) - min(aucs), 4)
        row["loss_drops"] = all(r.get("loss_drops") for r in per_seed
                                if "loss_drops" in r)
        row.pop("seed", None)
    return row


def _one(cmd, name):
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=7200)
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
    if lines:
        return json.loads(lines[-1])
    return {"metric": f"{name}_synthetic_accuracy",
            "error": (r.stderr.strip() or "no output")[-400:]}


def campaign(names, args):
    """One subprocess per model and seed; writes the aggregated rows."""
    out_path = args.out or os.path.join(
        ROOT, "ZOO_AUC_H100_FP32.json" if args.fp32 else "ZOO_AUC_H100.json")
    rows = []
    if os.path.exists(out_path):
        with open(out_path) as f:
            rows = [r for r in json.load(f).get("models", [])
                    if r.get("metric", "").rsplit("_synthetic", 1)[0]
                    not in names]
    seeds = ([int(s) for s in args.seeds.split(",")] if args.seeds
             else [args.seed])
    jobs = {}
    for name in names:
        cfg = CAMPAIGN["dlrm" if name == "dlrm_cat" else name]
        cmd = [sys.executable, os.path.abspath(__file__), name,
               str(cfg["steps"]), "--batch", str(args.batch), "--pool",
               str(args.pool)] + [f"--{flag}" for flag in ("fp32", "cpu")
                                  if getattr(args, flag)]
        for flag in ("lr", "items", "dense"):
            value = getattr(args, flag)
            value = cfg.get(flag) if value is None else value
            if value is not None:
                cmd += [f"--{flag}", str(value)]
        jobs[name] = [cmd + ["--seed", str(s)] for s in seeds]
    with ThreadPoolExecutor(max(1, args.jobs)) as pool:
        futures = {name: [pool.submit(_one, c, name) for c in cmds]
                   for name, cmds in jobs.items()}
        for name in names:
            row = aggregate([f.result() for f in futures[name]], seeds)
            if args.jobs > 1:
                row["concurrent_runs"] = args.jobs  # shared the card
            rows.append(row)
            print(json.dumps(row), flush=True)
            with open(out_path, "w") as f:
                json.dump({"note": NOTE, "models": rows}, f, indent=1)
    return rows


def main(argv=None):
    args = parse_args(argv)
    if args.model == "all" or "," in args.model or args.seeds:
        from deeprec_tpu_torch.models.registry import ZOO
        names = (sorted(ZOO) + ["dlrm_cat"] if args.model == "all"
                 else [n for n in args.model.split(",") if n])
        return campaign(names, args)
    row = run(args.model, args.steps, bf16=not args.fp32, batch=args.batch,
              pool=args.pool, seed=args.seed,
              lr=0.05 if args.lr is None else args.lr,
              items=100_000 if args.items is None else args.items,
              dense=args.dense or "adagrad", cpu=args.cpu)
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
