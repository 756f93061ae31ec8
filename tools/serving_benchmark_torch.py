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

The C-ABI and remote-store paths of the JAX tool wait for ROADMAP item
16: ``--abi-only`` raises ``NotImplementedError``.

Usage: python3 tools/serving_benchmark_torch.py [batch ...] [--cpu]
           [--out FILE]
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
    "on the host, 50 requests a batch size.")


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


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("batches", nargs="*", type=int)
    p.add_argument("--abi-only", action="store_true",
                   help="the C-ABI path (not ported)")
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    p.add_argument("--out", default=os.path.join(ROOT,
                                                 "SERVING_BENCH_H100.json"))
    args = p.parse_args(argv)
    if args.abi_only:
        raise NotImplementedError(
            "the C-ABI and remote-store serving paths are not ported "
            "(ROADMAP queue 1 item 16)")
    import torch

    if args.cpu:
        device = "cpu"
    elif not torch.cuda.is_available():
        raise SystemExit("serving_benchmark_torch: no CUDA card (torch.cuda."
                         "is_available() is false); pass --cpu")
    else:
        device = "cuda"
    rows = bench_device(tuple(args.batches) or BATCH_SIZES, device)
    with open(args.out, "w") as f:
        json.dump({"note": NOTE, "rows": rows}, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
