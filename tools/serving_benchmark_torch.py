"""Serving latency benchmark of the device path on the CUDA card: the
counterpart of ``tools/serving_benchmark.py``'s ``bench_device``.

The model is the one ``__graft_entry__._build(max(B), capacity=1 << 20,
dim=16, hidden=(1024, 512, 256), vocab=200_000)`` builds, rebuilt from
the port's own modules (``deeprec_tpu_torch.bench.build_small``): dim-16
deep and dim-1 wide columns of 2**20 rows each (coalesced), float32
towers 1024/512/256, fresh tables. For each batch size B the eval step
scores the first B rows of one synthetic batch, packed on the card
beforehand, 50 times; each request's latency runs from the call to the
scores' arrival on the host (the copy belongs to serving). A row gives
the median and 99th percentile in ms and B over the mean latency in
samples/s, with the card's name and power limit.

``--abi-only`` is the counterpart of the JAX tool's ``bench_abi``: the
C ABI processor (``deeprec_tpu_torch/serving/native``, built with
``g++``) spawns the serving worker on the card over a checkpoint the
port trained (``serving/wdl_entry.py``'s WDL at ``ABI_MODEL``: dim-16
columns of 2**16 rows, 1024/512/256 bf16 towers, 4 steps of B = 1,024
on ``SyntheticCriteo``), and each ``process()`` call goes through the
ABI, a loopback HTTP hop, JSON and the worker's eval step. Its rows
(``"path": "c_abi"``, 1 and 64 instances a request) replace the file's
earlier ``c_abi`` rows and keep the others; each row also gives the
seconds ``initialize`` took (the worker's start, restore and first
kernel load).

Usage: python3 tools/serving_benchmark_torch.py [batch ...] [--abi-only]
           [--cpu] [--out FILE]
Rows go to ``SERVING_BENCH_H100.json`` at the repository root (or
``--out``). It runs on the CUDA card and fails without one; ``--cpu``
runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import numpy as np  # noqa: E402

BATCH_SIZES = (1, 64, 512, 4096)
REQUESTS = 50
MODEL = dict(capacity=1 << 20, hidden=(1024, 512, 256), vocab=200_000)
NOTE = (
    "Device-path serving latency of the PyTorch port "
    "(tools/serving_benchmark_torch.py): the reference-shaped WDL of "
    "__graft_entry__._build built from the port's modules, the eval step "
    "on a batch already on the card, latency from the call to the scores "
    "on the host, 50 requests a batch size. The c_abi rows (--abi-only): "
    "the port's C ABI processor over a port-trained WDL checkpoint, "
    "process() through a spawned worker on the card, loopback HTTP and "
    "JSON included.")
ABI_SIZES = (1, 64)
ABI_MODEL = dict(dim=16, capacity=1 << 16, hidden=[1024, 512, 256],
                 dtype="bfloat16")
ABI_TRAIN = dict(steps=4, batch=1024, vocab=100_000)


def bench_device(batch_sizes=BATCH_SIZES, device="cuda",
                 requests: int = REQUESTS, model=None) -> list:
    """One row a batch size; see the module's docstring."""
    import torch

    from deeprec_tpu_torch import bench
    from deeprec_tpu_torch.train import loop as trainlib
    from model_benchmark_torch import card_facts

    device = torch.device(device)
    tr = bench.build_small(device, batch=max(batch_sizes),
                           **(model or MODEL))
    eval_fn = trainlib.make_eval_step(tr.group, tr.apply_fn)
    full = tr.data.next_batch_np(wide=tr.wide)
    facts = card_facts(device)
    rows = []
    for B in batch_sizes:
        batch = tr.group.pack_batch_np({k: v[:B] for k, v in full.items()},
                                       device)
        eval_fn(tr.ts, batch).cpu()                # first call: warm-up
        lat = []
        for _ in range(requests):
            t0 = time.perf_counter()
            scores = eval_fn(tr.ts, batch).cpu()
            lat.append(time.perf_counter() - t0)
        if scores.shape != (B,) or not bool(torch.isfinite(scores).all()):
            raise AssertionError(f"batch {B}: scores {scores.shape}, "
                                 f"finite {torch.isfinite(scores).all()}")
        lat_ms = np.array(lat) * 1e3
        rows.append({
            "metric": "serving_latency_ms", "path": "device",
            "model": "reference-shaped WDL", "batch": B,
            "p50": round(float(np.percentile(lat_ms, 50)), 3),
            "p99": round(float(np.percentile(lat_ms, 99)), 3),
            "samples_per_sec": round(float(B / np.mean(lat)), 1),
            "requests": requests, **facts})
        print(json.dumps(rows[-1]), flush=True)
    return rows


def abi_checkpoint(ckpt_dir: str, config: dict, steps: int, batch: int,
                   vocab: int, seed: int = 1):
    """Train ``serving/wdl_entry.py``'s model of ``config`` for
    ``steps`` steps (``SparseAdagrad(0.05)``, dense Adagrad(0.05)) on
    ``SyntheticCriteo`` and save a full checkpoint in ``ckpt_dir``.
    Returns ``(parts, state, data)``: the entry's parts, the trained
    state and the stream, whose next batches are unseen rows."""
    from deeprec_tpu_torch.data.criteo import SyntheticCriteo
    from deeprec_tpu_torch.optimizers import dense as dense_lib
    from deeprec_tpu_torch.optimizers import sparse as sparse_lib
    from deeprec_tpu_torch.serving import wdl_entry
    from deeprec_tpu_torch.train import loop as trainlib
    from deeprec_tpu_torch.train import losses
    from deeprec_tpu_torch.train.checkpoint import CheckpointManager

    parts = wdl_entry.build(config)
    group, device = parts["group"], config.get("device", "cuda")
    sopt, dopt = sparse_lib.SparseAdagrad(0.05), dense_lib.Adagrad(0.05)
    ts = trainlib.create_train_state(group, parts["ts_template"].params,
                                     dopt, sopt, device)
    step = trainlib.make_train_step(
        group, parts["apply_fn"],
        lambda out, b: losses.bce_with_logits(out, b["label"]), sopt, dopt)
    data = SyntheticCriteo(batch, vocab=vocab, seed=seed)
    for _ in range(steps):
        ts, _ = step(ts, group.pack_batch_np(data.next_batch_np(wide=False),
                                             device))
    CheckpointManager(ckpt_dir, group).save(ts)
    return parts, ts, data


def instances(raw: dict, rows) -> list:
    """The worker's request instances of rows ``rows`` of a raw batch."""
    return [{**{f"I{i}": float(raw[f"I{i}"][r]) for i in range(1, 14)},
             **{f"C{i}": int(raw[f"C{i}"][r, 0]) for i in range(1, 27)}}
            for r in rows]


def bench_abi(device="cuda", sizes=ABI_SIZES) -> list:
    """One ``c_abi`` row a request size (``REQUESTS`` timed calls each);
    see the module's docstring."""
    import tempfile

    import torch

    from deeprec_tpu_torch.serving import native as proc_native
    from model_benchmark_torch import card_facts

    device = torch.device(device)
    config = {"device": device.type, **ABI_MODEL}
    env_pp = os.environ.get("PYTHONPATH", "")
    os.environ["PYTHONPATH"] = os.pathsep.join([ROOT] + ([env_pp] if env_pp
                                                         else []))
    facts = card_facts(device)
    rows = []
    with tempfile.TemporaryDirectory(prefix="serving_abi_") as tmp:
        _, _, data = abi_checkpoint(tmp, config, **ABI_TRAIN)
        raw = data.next_batch_np(wide=False)
        t0 = time.perf_counter()
        proc = proc_native.Processor("deeprec_tpu_torch.serving.wdl_entry",
                                     {"checkpoint_dir": tmp, **config})
        init_s = time.perf_counter() - t0
        try:
            for n in sizes:
                req = {"instances": instances(raw, range(n))}
                proc.process(req)                   # first call: warm-up
                lat = []
                for _ in range(REQUESTS):
                    t1 = time.perf_counter()
                    preds = proc.process(req)["predictions"]
                    lat.append(time.perf_counter() - t1)
                p = np.asarray(preds)
                if p.shape != (n,) or not ((p > 0) & (p < 1)).all():
                    raise AssertionError(f"c_abi {n} rows: predictions "
                                         f"{p.shape} out of (0, 1)")
                lat_ms = np.array(lat) * 1e3
                rows.append({
                    "metric": "serving_latency_ms", "path": "c_abi",
                    "model": "WDL of serving/wdl_entry.py "
                             f"{json.dumps(config, sort_keys=True)}",
                    "batch": n,
                    "p50": round(float(np.percentile(lat_ms, 50)), 3),
                    "p99": round(float(np.percentile(lat_ms, 99)), 3),
                    "samples_per_sec": round(float(n / np.mean(lat)), 1),
                    "requests": REQUESTS,
                    "initialize_s": round(init_s, 3), **facts})
                print(json.dumps(rows[-1]), flush=True)
        finally:
            proc.close()
            os.environ["PYTHONPATH"] = env_pp
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("batches", nargs="*", type=int)
    p.add_argument("--abi-only", action="store_true",
                   help="the C ABI processor path only")
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    p.add_argument("--out", default=os.path.join(ROOT,
                                                 "SERVING_BENCH_H100.json"))
    args = p.parse_args(argv)
    import torch

    if args.cpu:
        device = "cpu"
    elif not torch.cuda.is_available():
        raise SystemExit("serving_benchmark_torch: no CUDA card (torch.cuda."
                         "is_available() is false); pass --cpu")
    else:
        device = "cuda"
    if args.abi_only:
        rows = bench_abi(device, tuple(args.batches) or ABI_SIZES)
        if os.path.exists(args.out):
            with open(args.out) as f:
                old = json.load(f)["rows"]
            rows = [r for r in old if r.get("path") != "c_abi"] + rows
    else:
        rows = bench_device(tuple(args.batches) or BATCH_SIZES, device)
    with open(args.out, "w") as f:
        json.dump({"note": NOTE, "rows": rows}, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
