"""Assemble ``BENCH_ZOO_H100.json`` from the JSON lines of
``tools/model_benchmark_torch.py``: the counterpart of
``tools/write_bench_zoo.py``. The last valid row of a model wins (a
rerun supersedes an error row; an error row never replaces a valid one).

Usage: python3 tools/write_bench_zoo_torch.py RUN.jsonl [RUN2.jsonl ...]
           [--out FILE]
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)

from model_benchmark_torch import MEASURE, ROW_NOTES, WARMUP  # noqa: E402

NOTE = (
    "Per-model training throughput of the PyTorch port on one CUDA card "
    "(each row's device_kind and power_limit), from "
    "tools/model_benchmark_torch.py: the JAX tool's model sizes and "
    "batches, 8 pre-packed batches, bf16 towers, sparse and dense "
    f"Adagrad, LightHeader EV tables; {WARMUP} warm-up steps, then a "
    f"call of make_epoch_step whose {MEASURE + 1} CUDA-graph replays "
    "are timed on the device clock (each row's method). flops_per_step "
    "is FlopCounterMode's count of one eager step; mfu divides the "
    "achieved FLOP/s by the card's bf16 dense peak. vs_baseline divides "
    "by DeepRec's best published CPU number (BASELINE.md) where one "
    "exists.")


def rows_of(paths) -> list:
    """The last valid row per model from JSON-lines files, by metric."""
    by_metric = {}
    for src in paths:
        with open(src) as f:
            for line in f:
                line = line.strip()
                if not line.startswith("{"):
                    continue
                r = json.loads(line)
                if "metric" not in r:
                    continue
                if r["metric"] not in by_metric or "value" in r:
                    by_metric[r["metric"]] = r
    rows = sorted(by_metric.values(), key=lambda r: r["metric"])
    for r in rows:
        name = r["metric"].rsplit("_samples_per_sec", 1)[0]
        if name in ROW_NOTES and "note" not in r:
            r["note"] = ROW_NOTES[name]
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("runs", nargs="+")
    p.add_argument("--out", default=os.path.join(ROOT, "BENCH_ZOO_H100.json"))
    args = p.parse_args(argv)
    rows = rows_of(args.runs)
    with open(args.out, "w") as f:
        json.dump({"note": NOTE, "rows": rows}, f, indent=1)
    print(f"wrote {len(rows)} rows to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
