"""Model-zoo training benchmark on the CUDA card: the counterpart of
``tools/model_benchmark.py`` for the PyTorch port.

Every model of the registry trains at the JAX tool's sizes
(``COLUMN_KWARGS``, ``MODULE_KWARGS``, ``data_kwargs``; B = 16,384,
8,192 for the sequence models; bf16 towers; sparse and dense Adagrad at
0.05; LightHeader EV tables) over 8 pre-packed batches. The steps run
through ``make_epoch_step``, the counterpart of the JAX tool's one
jitted program a step: on the card step 0 runs eagerly and the step is
captured in a CUDA graph and replayed. ``WARMUP`` steps (one call) come
first; the measured call then trains ``MEASURE + 2`` steps, and
samples/s is B over the device time of one replayed step (CUDA events
around its ``MEASURE + 1`` replays). ``--eager`` times the eager loop
instead (host clock between two synchronizations, ``MEASURE`` steps
after ``WARMUP``); the row's ``method`` says which ran.

``flops_per_step`` counts one eager step's operations under
``torch.utils.flop_counter.FlopCounterMode`` (matrix products forward
and backward; the kernels' gathers and applies count none), never
inside a capture. ``mfu`` divides the achieved rate by the card's bf16
dense peak (``CHIP_PEAKS``). Each row names the card and its power
limit.

Usage:  python3 tools/model_benchmark_torch.py [model ...] [--eager]
            [--cpu]
One model runs in this process; several run one process each. Each
prints one JSON line; ``tools/write_bench_zoo_torch.py`` assembles them
into ``BENCH_ZOO_H100.json``. It runs on the CUDA card and fails without
one; ``--cpu`` runs on the CPU (no ``mfu``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

WARMUP = 100
MEASURE = 30
PREPACKED = 8

# DeepRec's best published samples/s per model (BASELINE.md), as the
# JAX tool has them.
BASELINES = {
    "wdl": 22788.93,
    "dlrm": 60907.11,
    "deepfm": 34627.46,
    "dssm": 129099.08,
    "din": 22299.68,
    "dien": 3862.06,
}

_BEHAVIOR_VOCABS = dict(num_items=200_000, num_cats=100, num_users=1000)

# tools/model_benchmark.py's columns, as they are (every EV table in the
# LightHeader mode: no freq, no version).
COLUMN_KWARGS = {
    "wdl": dict(reference_shapes=True, capacity=1 << 20,
                wide_in_deep=True),
    "deepfm": dict(embedding_dim=16, reference_shapes=True,
                   capacity=1 << 20, wide_in_deep=True),
    "dlrm": dict(embedding_dim=16, reference_shapes=True,
                 capacity=1 << 20),
    "esmm": dict(embedding_dim=16, reference_shapes=True,
                 capacity=1 << 20),
    "mmoe": dict(embedding_dim=16, reference_shapes=True,
                 capacity=1 << 20),
    "dbmtl": dict(embedding_dim=16, reference_shapes=True,
                  capacity=1 << 20),
    "simple_multitask": dict(embedding_dim=16, reference_shapes=True,
                             capacity=1 << 20),
    "din": dict(embedding_dim=18, capacity=1 << 20, **_BEHAVIOR_VOCABS),
    "dien": dict(embedding_dim=18, capacity=1 << 20, **_BEHAVIOR_VOCABS),
    "bst": dict(embedding_dim=16, capacity=1 << 20, **_BEHAVIOR_VOCABS),
    "dssm": dict(embedding_dim=16, capacity=1 << 20, **_BEHAVIOR_VOCABS),
}

# tools/model_benchmark.py's towers (bf16 compute, fp32 params).
MODULE_KWARGS = {
    "wdl": dict(hidden=(1024, 512, 256)),
    "deepfm": dict(hidden=(1024, 256, 32)),
    "dlrm": dict(embedding_dim=16, bottom=(512, 256, 16),
                 top=(1024, 1024, 512, 256)),
    "din": dict(hidden=(200, 80), att_hidden=(80, 40)),
    "dien": dict(gru_hidden=36, hidden=(200, 80)),
    "bst": dict(hidden=(1024, 512, 256), num_blocks=1, num_heads=8,
                seq_len=50),
    "dssm": dict(tower=(256, 128, 64)),
    "esmm": dict(tower=(256, 128)),
    "mmoe": dict(num_experts=4, expert=(256,), tower=(128,)),
    "dbmtl": dict(bottom=(512, 256), tower=(128,)),
    "simple_multitask": dict(tower=(256, 128)),
}

ROW_NOTES = {
    "dssm": ("synthetic config carries a T=50 behavior sequence per "
             "sample; the reference's published 129k-samples/s Taobao "
             "config consumes short tag lists + scalar features, a "
             "much lighter per-sample feature set - vs_baseline "
             "understates accordingly"),
    "din": "T=50 behavior sequences (103 ids/sample)",
    "dien": "T=50 behavior sequences through a GRU/AUGRU of explicit steps",
    "bst": "T=50 behavior sequences through a transformer block",
}

# bf16 dense peak FLOP/s by the card's name (torch.cuda.get_device_name):
# NVIDIA H100 Tensor Core GPU datasheet, SXM part, dense (without
# sparsity), at the 700 W power limit.
CHIP_PEAKS = {
    "NVIDIA H100 80GB HBM3": 989.4e12,
}


def data_kwargs(name: str, batch: int) -> dict:
    """The JAX tool's streams: the sequence models over 200,000 items,
    DLRM over a uniform 10,000-id vocabulary a column, the other Criteo
    models over the reference's bucket counts."""
    if name in ("din", "dien", "bst", "dssm"):
        return dict(batch_size=batch, num_items=200_000, seq_len=50)
    from deeprec_tpu_torch.data.criteo import CRITEO_HASH_BUCKETS
    vocab = 10_000 if name == "dlrm" else CRITEO_HASH_BUCKETS
    return dict(batch_size=batch, vocab=vocab)


def card_facts(device) -> dict:
    """The card's name and power limit (nvidia-smi), or the CPU."""
    import torch

    if device.type != "cuda":
        return {"device_kind": "cpu", "power_limit": None}
    try:
        q = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader", "-i", str(device.index or 0)],
            capture_output=True, text=True, timeout=30)
        limit = q.stdout.strip() or None
    except (OSError, subprocess.TimeoutExpired):
        limit = None
    return {"device_kind": torch.cuda.get_device_name(device),
            "power_limit": limit}


def step_flops(step, ts, batch) -> int:
    """Operations of one eager training step (it trains ``ts``)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        step(ts, batch)
    return int(fc.get_total_flops())


def build(name: str, batch: int, device):
    """(group, state, apply, loss, sparse opt, dense opt, pre-packed
    batches) of one model at the tool's sizes."""
    import torch

    from deeprec_tpu_torch import config as cfglib
    from deeprec_tpu_torch.feature_column.feature_column import \
        EmbeddingGroup
    from deeprec_tpu_torch.layers.core import init_dense
    from deeprec_tpu_torch.models.registry import SEQUENCE_MODELS, ZOO
    from deeprec_tpu_torch.optimizers import dense as dense_lib
    from deeprec_tpu_torch.optimizers import sparse as sopt
    from deeprec_tpu_torch.train import loop as trainlib

    entry = ZOO[name]
    light = cfglib.EmbeddingVariableOption(record_freq=False,
                                           record_version=False)
    group = EmbeddingGroup(entry.columns(ev_option=light,
                                         **COLUMN_KWARGS[name]),
                           coalesce=True)
    module = entry.make_module(group, dtype=torch.bfloat16, device=device,
                               **MODULE_KWARGS[name])
    init_dense(module, torch.Generator().manual_seed(0))
    data = entry.make_data(seed=0, **data_kwargs(name, batch))
    if name in SEQUENCE_MODELS:
        batches = [group.pack_batch_np(data.next_batch_np(), device)
                   for _ in range(PREPACKED)]
    else:
        wide = any(c.name.endswith("_wide") for c in group.embedding)
        batches = [group.pack_batch_np(data.next_batch_np(wide=wide),
                                       device) for _ in range(PREPACKED)]
    opt = sopt.SparseAdagrad(learning_rate=0.05)
    tx = dense_lib.Adagrad(0.05)
    ts = trainlib.create_train_state(group, module.state_dict(), tx, opt,
                                     device)
    return (group, ts, entry.make_apply(module, group), entry.loss, opt, tx,
            batches)


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench_model(name: str, batch: int = 16384, *, eager: bool = False,
                device="cuda", warmup: int = WARMUP,
                measure: int = MEASURE) -> dict:
    """One model's row: samples/s, loss, FLOPs a step and their rate."""
    import torch

    from deeprec_tpu_torch.models.registry import SEQUENCE_MODELS
    from deeprec_tpu_torch.train import loop as trainlib

    device = torch.device(device)
    if name in SEQUENCE_MODELS:
        batch = min(batch, 8192)  # sequence models: [B, T] activations
    group, ts, afn, loss_fn, opt, tx, batches = build(name, batch, device)
    step = trainlib.make_train_step(group, afn, loss_fn, opt, tx)
    flops = step_flops(step, ts, batches[0])      # the first warm-up step
    K = len(batches)
    if eager:
        for i in range(1, warmup):
            ts, m = step(ts, batches[i % K])
        _sync(device)
        t0 = time.perf_counter()
        for i in range(measure):
            ts, m = step(ts, batches[i % K])
        loss = float(m["loss"])
        dt = (time.perf_counter() - t0) / measure
        method = (f"eager loop: steps {warmup}..{warmup + measure} timed by "
                  f"the host clock between two synchronizations; "
                  f"{K} pre-packed batches")
    else:
        stacked = trainlib.stack_batches(batches)
        warm = trainlib.make_epoch_step(group, afn, loss_fn, opt, tx,
                                        n_epochs=-(-warmup // K))
        ts, _ = warm(ts, stacked)
        if device.type == "cuda":
            warm.release()
        timed = trainlib.make_epoch_step(group, afn, loss_fn, opt, tx,
                                         n_epochs=-(-(measure + 2) // K))
        _sync(device)
        t0 = time.perf_counter()
        ts, losses = timed(ts, stacked)
        loss = float(losses.reshape(-1)[-1])
        if device.type == "cuda":
            replays = timed.last_run["replays"]
            dt = timed.replay_ms() / 1e3 / replays
            timed.release()
            method = (f"make_epoch_step over {K} pre-packed batches, "
                      f"captured in a CUDA graph: {warm.last_run['steps']} "
                      f"warm-up steps in one call, then one call of "
                      f"{timed.last_run['steps']} steps (step 0 eager, the "
                      f"capture, {replays} replays); a step's time is the "
                      f"replays' device time (CUDA events) over {replays}")
        else:
            dt = (time.perf_counter() - t0) / timed.last_run["steps"]
            method = (f"make_epoch_step on the CPU (a loop over {K} "
                      f"pre-packed batches), host clock")
    sps = batch / dt
    out = {"metric": f"{name}_samples_per_sec", "value": round(sps, 2),
           "unit": "samples/s", "batch": batch, "loss": round(loss, 4),
           **card_facts(device), "method": method,
           "step_ms": round(dt * 1e3, 4)}
    if name in BASELINES:
        out["vs_baseline"] = round(sps / BASELINES[name], 3)
    if name in ROW_NOTES:
        out["note"] = ROW_NOTES[name]
    if flops:
        out["flops_per_step"] = flops
        out["tflops_per_s"] = round(flops / dt / 1e12, 3)
        peak = CHIP_PEAKS.get(out["device_kind"])
        if peak:
            out["mfu"] = round(flops / dt / peak, 4)
            out["mfu_note"] = ("FlopCounterMode operations of one eager "
                               "step over the card's bf16 dense peak "
                               f"{peak:.4g} FLOP/s")
    return out


def main(argv=None):
    from deeprec_tpu_torch.models.registry import ZOO

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("models", nargs="*")
    p.add_argument("--eager", action="store_true",
                   help="time the eager loop, not the captured epoch")
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = p.parse_args(argv)
    names = args.models or sorted(ZOO)
    if len(names) > 1:
        # One process per model: a clean card for each.
        flags = [a for a in (argv if argv is not None else sys.argv[1:])
                 if a not in names]
        for name in names:
            try:
                r = subprocess.run([sys.executable, os.path.abspath(__file__),
                                    name] + flags, capture_output=True,
                                   text=True, timeout=2400)
                out, err, rc = r.stdout, r.stderr, r.returncode
            except subprocess.TimeoutExpired as e:
                out, err, rc = "", f"timeout after {e.timeout}s", 1
            for line in out.splitlines():
                if line.startswith("{"):
                    print(line, flush=True)
            if rc != 0:
                print(json.dumps({"metric": f"{name}_samples_per_sec",
                                  "error": (err.strip()
                                            or "nonzero exit")[-300:]}),
                      flush=True)
        return
    import torch

    if args.cpu:
        device = torch.device("cpu")
    elif not torch.cuda.is_available():
        raise SystemExit("model_benchmark_torch: no CUDA card (torch.cuda."
                         "is_available() is false); pass --cpu")
    else:
        device = torch.device("cuda")
    print(json.dumps(bench_model(names[0], eager=args.eager,
                                 device=device)), flush=True)


if __name__ == "__main__":
    main()
