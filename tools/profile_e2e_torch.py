#!/usr/bin/env python3
"""Where the time of the port's e2e row goes: the input pipeline's
stages on their own, and the training step they feed.

Run from the repository root on one CUDA card:

    python3 tools/profile_e2e_torch.py [--rows 262144]
        [--out build/profile_e2e.json]

It writes a Kaggle-format TSV of ``--rows`` rows into a new directory
under ``$TMPDIR``, removed at the end (``bench.write_tsv`` from ``SyntheticCriteo(vocab=200_000,
seed=7)``, as the e2e row of ``deeprec_tpu_torch.bench`` does),
builds the headline model, and times, per 16,384-row batch over every
full batch of the file:

1. parse: ``criteo_file_batches`` (native parser, 31-bit ids, no
   ``C*_wide`` columns), on the host;
2. parse and compact pack (``pack_batch_np(compact=True)``), on the
   host, in this thread;
3. the prefetch pipeline alone, consumed without training: (a) parse
   and pack on the worker thread, handed over on the host; (b) batches
   packed beforehand, staged by the worker (pinned copies,
   host-to-device copies on its stream); (c) both;
4. the training step on the batches of 3 (c), staged on the card
   beforehand, from empty tables: with its ``n_overflow`` per step and
   the tables' live keys after it (the file's ids come from a
   200,000-id vocabulary in every field, more than the 65-wide table,
   sized from the reference bucket counts, holds);
5. the e2e row itself (``bench.bench_e2e``, continuing from the tables
   of 4): the pipeline feeding the step.

Each stage prints one line; the last line is a JSON object with the
card's name and every stage's ms per batch.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def per_batch(label: str, fn) -> float:
    """Run ``fn`` (returns the batch count), print and return ms per
    batch."""
    t0 = time.perf_counter()
    n = fn()
    ms = (time.perf_counter() - t0) / n * 1e3
    print(f"{label}: {n} batches, {ms:.3f} ms per batch", flush=True)
    return ms


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=16 * 16384)
    ap.add_argument("--out")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory(prefix="deeprec_torch_e2e_") as d:
        profile(args, os.path.join(d, "criteo.tsv"))


def profile(args, path: str):
    sys.path.insert(0, ROOT)
    import chip_smoke
    from deeprec_tpu_torch import bench
    from deeprec_tpu_torch.data.criteo import (SyntheticCriteo,
                                               criteo_file_batches)
    from deeprec_tpu_torch.data.prefetch import PrefetchIterator
    from deeprec_tpu_torch.embedding import variable as ev

    kind = chip_smoke.phase_device()
    t0 = time.perf_counter()
    bench.write_tsv(path, args.rows, SyntheticCriteo(bench.BATCH,
                                                     vocab=200_000, seed=7))
    print(f"tsv: {args.rows} rows, {os.path.getsize(path)} bytes, written "
          f"in {time.perf_counter() - t0:.3f} s", flush=True)
    tr = bench.build_wdl(device="cuda")
    out = {"device": kind, "rows": args.rows, "batch": bench.BATCH}

    def parse_only():
        return sum(1 for b in criteo_file_batches(
            path, bench.BATCH, as_numpy=True, wide=False, id_bits=31)
            if b["label"].shape[0] == bench.BATCH)

    next(criteo_file_batches(path, bench.BATCH, as_numpy=True))  # builds it
    out["parse_ms"] = per_batch("1 parse", parse_only)
    out["parse_pack_ms"] = per_batch(
        "2 parse + compact pack",
        lambda: sum(1 for _ in bench.e2e_batches(tr, path)))

    staged = []

    def drain(make_iter, device, keep=None):
        it = PrefetchIterator(make_iter, buffer_size=4, device=device)
        try:
            got = list(it)
        finally:
            it.close()
        torch.cuda.synchronize()
        if keep is not None:
            keep.extend(got)
        return len(got)

    packed = list(bench.e2e_batches(tr, path))
    out["pipeline_host_ms"] = per_batch(
        "3a pipeline: parse + pack on the worker, no card",
        lambda: drain(lambda: bench.e2e_batches(tr, path), None))
    out["pipeline_stage_ms"] = per_batch(
        "3b pipeline: packed batches staged to the card by the worker",
        lambda: drain(lambda: iter(packed), tr.device))
    del packed
    out["pipeline_ms"] = per_batch(
        "3c pipeline: parse + pack + staging, no step",
        lambda: drain(lambda: bench.e2e_batches(tr, path), tr.device,
                      staged))
    ts, m = tr.step(tr.ts, staged[0])
    float(m["loss"])

    overflow = []

    def steps_only():
        nonlocal ts
        for b in staged[1:]:
            ts, m = tr.step(ts, b)
            overflow.append(m["n_overflow"])
        torch.cuda.synchronize()
        return len(staged) - 1

    out["step_ms"] = per_batch("4 step on staged batches", steps_only)
    tr.ts = ts
    out["n_overflow"] = [int(x) for x in overflow]
    out["live_keys"] = {t: int(ev.num_live(st)) for t, st in ts.ev.items()}
    out["capacity"] = {t: c.capacity for t, c in tr.group.tables.items()}
    print(f"4 n_overflow per step {out['n_overflow']}; live keys "
          f"{out['live_keys']} of capacity {out['capacity']}", flush=True)
    staged.clear()
    row = bench.bench_e2e(tr, n_rows=args.rows, path=path)
    out["e2e_ms"] = row["step_ms"]
    out["e2e_samples_per_sec"] = row["value"]
    print(f"5 e2e row: {row['steps']} steps, {row['step_ms']:.3f} ms per "
          f"batch, {row['value']:.1f} samples/s", flush=True)
    # Bytes one compact batch moves from the host to the card.
    first = next(bench.e2e_batches(tr, path))
    out["compact_bytes_per_batch"] = sum(
        (v.ids if hasattr(v, "ids") else v).numel()
        * (v.ids if hasattr(v, "ids") else v).element_size()
        for v in first.values())
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
