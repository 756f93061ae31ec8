#!/usr/bin/env python3
"""Latency and device-time profile of the PyTorch port's serving path.

Run from the repository root on one CUDA card:

    python3 tools/profile_serving_torch.py [--reps 100]
        [--trace chiprun_out/serving_trace_torch.json]

It builds and checkpoints the state of ``chip_smoke.py``'s phase 4 (the
reference-shape WDL holding the distinct ids of 32 synthetic Criteo
batches of 16,384), restores it with ``ServingModel.full_update``, and
scores rows of the next batch of the same stream:

1. latency of ``ServingModel.predict`` at 1 to 16,384 rows per request:
   host clock around synchronized calls, after 3 warm-up calls; median,
   p10, p90 and p99 over ``--reps`` calls, and rows/s at the median;
2. ``torch.profiler`` over 5 predicts of 16,384 rows, with spans around
   the layers (h2d, probe, fetch, combine, towers). Each device event
   (kernel, memcpy, memset) is charged to the span whose host interval
   holds its launch, found through the trace's correlation ids; launches
   outside every span are charged to "other". It prints the wall time,
   the device's busy share (union of device intervals over the wall
   time), device time per request by layer, and the kernels that take
   the most device time. The Chrome trace goes to ``--trace``.

The spans are added here by rebinding the functions the eval step calls
through their modules, and by wrapping the model's ``apply_fn`` (so the
latency table pays for one idle span per call); the package itself
carries no spans.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import contextlib
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = (1, 64, 512, 4096, 16384)
PROFILED_CALLS = 5
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _spanned(name, fn):
    def wrapped(*args, **kwargs):
        with torch.profiler.record_function("stage:" + name):
            return fn(*args, **kwargs)
    return wrapped


@contextlib.contextmanager
def stage_spans():
    """Rebind the serving path's layer functions to spanned versions."""
    from deeprec_tpu_torch.embedding import hash_table, lookup
    from deeprec_tpu_torch.ops.kernels import gather
    from deeprec_tpu_torch.serving import processor
    targets = [(processor, "batch_to", "h2d"), (hash_table, "find", "probe"),
               (gather, "gather_rows", "fetch"),
               (lookup, "combine_bags", "combine")]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in targets]
    for mod, attr, name in targets:
        setattr(mod, attr, _spanned(name, getattr(mod, attr)))
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def latency_table(serving, group, raw, reps):
    for n in SIZES:
        batch = group.pack_batch_np({k: v[:n] for k, v in raw.items()},
                                    "cpu")
        lat = []
        for i in range(3 + reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            serving.predict(batch)
            torch.cuda.synchronize()
            if i >= 3:
                lat.append((time.perf_counter() - t0) * 1e3)
        p10, p50, p90, p99 = np.percentile(lat, [10, 50, 90, 99])
        print(f"latency {n} rows: median {p50:.3f} ms, p10 {p10:.3f}, "
              f"p90 {p90:.3f}, p99 {p99:.3f} ({reps} calls); "
              f"{n / (p50 * 1e-3):.0f} rows/s", flush=True)


def device_split(trace_path: str, calls: int):
    """Charge device events to the host span that launched them."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"][len("stage:"):])
                   for e in events if e.get("cat") == "user_annotation"
                   and e["name"].startswith("stage:"))
    starts = [s[0] for s in spans]
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    predicts = [e for e in events if e.get("cat") == "user_annotation"
                and e["name"] == "predict"]
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    by_stage = collections.Counter()
    by_kernel = collections.Counter()
    for e in device:
        stage = "other"
        ts = launch_ts.get(e.get("args", {}).get("correlation"))
        if ts is not None:
            i = bisect.bisect_right(starts, ts) - 1
            if i >= 0 and spans[i][0] <= ts <= spans[i][1]:
                stage = spans[i][2]
        by_stage[stage] += e["dur"]
        by_kernel[e["name"][:90]] += e["dur"]
    # Busy share: union of device intervals over the profiled wall time.
    t0 = min(e["ts"] for e in predicts)
    t1 = max(max(e["ts"] + e["dur"] for e in predicts),
             max(e["ts"] + e["dur"] for e in device))
    busy, end = 0.0, t0
    for s, d in sorted((e["ts"], e["ts"] + e["dur"]) for e in device):
        if d > end:
            busy += d - max(s, end)
            end = d
    total = sum(by_stage.values())
    print(f"profile: {calls} predicts of {SIZES[-1]} rows, wall "
          f"{(t1 - t0) / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms "
          f"({100 * busy / (t1 - t0):.1f} %), device events {len(device)}",
          flush=True)
    for stage, us in by_stage.most_common():
        print(f"profile: {stage}: {us / calls / 1e3:.3f} ms device time per "
              f"request ({100 * us / total:.1f} %)", flush=True)
    for name, us in by_kernel.most_common(10):
        print(f"profile kernel: {us / calls / 1e3:.3f} ms per request: "
              f"{name}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--trace",
                    default=os.path.join("chiprun_out",
                                         "serving_trace_torch.json"))
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke
    from deeprec_tpu_torch.serving.processor import ServingModel

    chip_smoke.phase_device()
    with tempfile.TemporaryDirectory(prefix="profile_serving_") as ckpt_dir:
        parts, raw = chip_smoke.phase_state(ckpt_dir)
        group = parts["group"]
        apply_fn = _spanned("towers", parts["apply_fn"])
        serving = ServingModel(group, apply_fn, parts["ts_template"],
                               ckpt_dir)
        t0 = time.perf_counter()
        serving.full_update()
        print(f"restore: {time.perf_counter() - t0:.3f} s", flush=True)
    latency_table(serving, group, raw, args.reps)

    batch = group.pack_batch_np(raw, "cpu")
    with stage_spans():
        for _ in range(3):
            serving.predict(batch)
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(PROFILED_CALLS):
                with torch.profiler.record_function("predict"):
                    serving.predict(batch)
            torch.cuda.synchronize()
    os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
    prof.export_chrome_trace(args.trace)
    device_split(args.trace, PROFILED_CALLS)


if __name__ == "__main__":
    main()
