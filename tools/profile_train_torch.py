#!/usr/bin/env python3
"""Step time, host syncs and device-time split of the port's training
step.

Run from the repository root on one CUDA card:

    python3 tools/profile_train_torch.py [--steps 20] [--opt adagrad]
        [--row headline|static|dim16|e2e] [--fresh] [--warmup 10]
        [--trace build/train_trace_torch.json] [--graph]
    python3 tools/profile_train_torch.py --zoo din [--steps 20] ...
    python3 tools/profile_train_torch.py --zoo wdl --zoo_flags=--adaptive_emb
    python3 tools/profile_train_torch.py --sharded [--steps 20] ...

It builds a WDL row of ``deeprec_tpu_torch.bench`` (by default the
headline: reference shapes, B = 16,384, ``SparseAdagrad`` or
``SparseAdam``; ``static``: the same shapes as static hash-bucket
columns; ``dim16``; ``e2e``: the headline model on the e2e row's
batches, read from a TSV of ``SyntheticCriteo(vocab=200_000, seed=7)``
written into a new directory under ``$TMPDIR``, parsed natively with
31-bit ids and packed compact as ``bench.e2e_batches`` does, then staged
on the card before the first step). The steps cycle over 8 pre-packed
batches, as the rows of ``bench`` do; with ``--fresh`` every step takes
a batch no step has seen, as the e2e row's steps do. ``--zoo MODEL``
takes a model of ``tools/train_zoo_torch.py`` instead (its full-width
columns and towers, bf16, B = 4,096, its sparse Adagrad and dense
Adam, the batches of its synthetic stream; the step is the Estimator's;
``--zoo_flags`` adds the tool's flags, e.g. ``--adaptive_emb``).
``--sharded`` takes the headline with its tables row-sharded over a
one-rank NCCL mesh (``embedding/sharded.py``; the exchange sends to
itself), its step ``make_train_step(..., mesh=)``.
After ``--warmup`` steps it:

1. times ``--steps`` steps with the host clock, fenced by
   ``torch.cuda.synchronize()``: median step time and samples/s, and
   each step's time and ``n_overflow``;
2. counts the host syncs of one step: ``torch.cuda.set_sync_debug_mode``
   warns at every operation that waits for the card, and the warnings
   are counted by the operation that raised them; with cycled batches,
   it also prints, for each batch and table, how many ids the probe's
   fast round left pending, how many straggler rounds they took and
   how many found no slot (the plain version's rounds, counted on a
   copy of the table);
3. runs ``torch.profiler`` over 5 steps with spans around the layers:
   probe (``hash_table.find_or_insert``), fetch (K1, ``gather_rows``),
   lookup (the rest of ``lookup_train_occ``: first-occurrence dedup,
   compaction, row init, metadata; for a static table
   ``lookup_train_static``), combine, towers forward (the model's
   ``apply_fn``), backward (``torch.autograd.grad``), dense Adagrad and
   the sparse apply (K2 or K3); on a mesh also exchange (``Mesh.
   all_to_all``), all-reduce and the owner side's lookup
   (``lookup_train``). Each device event is charged to the
   innermost span whose host interval holds its launch (the backward's
   launches come from autograd's own thread while the step waits inside
   its span); launches outside every span go to "other". It prints the
   profiled wall time, the device's busy share (union of device
   intervals over the wall time), device time per step by layer, the
   host's wall time inside each span, the kernels that take the most
   device time, then the profiled steps'
   ``n_overflow`` and each table's live keys. The Chrome trace goes to
   ``--trace``.

With ``--graph`` it times and profiles the step as
``train.loop.make_epoch_step`` runs it on the card instead (step 0
eager, then the step captured once in a CUDA graph and replayed): one
call over the batches as a pool, enough epochs for ``--warmup`` +
``--steps`` steps, timed on the device clock around the replays (ms a
step, samples/s) and on the host (the enqueue of a replay); then
``torch.profiler`` over a call on the first 6 batches, whose 5 replays
are the profiled steps: busy share, device time a step and the kernels
that take the most. Inside a replay there are no layer spans: its
device time is charged to "other".

The spans are added here by rebinding the functions the step calls
through their modules; the package itself carries no spans.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import statistics
import sys
import tempfile
import time
import warnings

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROFILED_STEPS = 5
WARMUP = 10
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_WARMUP = 3
ROW_KW = {"headline": {}, "static": {"static_buckets": True},
          "dim16": {"reference_shapes": False}, "e2e": {}}


def _spanned(name, fn):
    def wrapped(*args, **kwargs):
        with torch.profiler.record_function("stage:" + name):
            return fn(*args, **kwargs)
    return wrapped


@contextlib.contextmanager
def stage_spans(opt_name: str):
    """Rebind the training step's layer functions to spanned versions."""
    from deeprec_tpu_torch.embedding import hash_table, variable
    from deeprec_tpu_torch.feature_column import feature_column
    from deeprec_tpu_torch.ops.kernels import gather, sparse_apply
    from deeprec_tpu_torch.optimizers import dense
    from deeprec_tpu_torch.parallel import mesh
    targets = [(hash_table, "find_or_insert", "probe"),
               (gather, "gather_rows", "fetch"),
               (variable, "lookup_train_occ", "lookup"),
               (variable, "lookup_train", "lookup"),
               (mesh.Mesh, "all_to_all", "exchange"),
               (mesh.Mesh, "all_reduce_", "all_reduce"),
               (variable, "lookup_train_static", "lookup"),
               (feature_column.EmbeddingGroup, "combine", "combine"),
               (torch.autograd, "grad", "backward"),
               (dense.Adagrad, "apply", "dense_adagrad"),
               (dense.Adam, "apply", "dense_adam"),
               (sparse_apply, f"{opt_name}_apply_rows", "sparse_apply")]
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in targets]
    for obj, attr, name in targets:
        setattr(obj, attr, _spanned(name, getattr(obj, attr)))
    try:
        yield
    finally:
        for obj, attr, fn in saved:
            setattr(obj, attr, fn)


def device_split(trace_path: str, steps: int):
    """Charge device events to the innermost host span that launched
    them; print busy share, per-layer and per-kernel device time."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"][len("stage:"):])
                   for e in events if e.get("cat") == "user_annotation"
                   and e["name"].startswith("stage:"))
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    marks = [e for e in events if e.get("cat") == "user_annotation"
             and e["name"] == "train_step"]
    t0 = min(e["ts"] for e in marks)
    # Only what the profiled steps ran (a captured epoch's eager step 0
    # and its capture come before its first replay).
    device = [e for e in events if e.get("cat") in DEVICE_CATS
              and e["ts"] >= t0]
    by_stage = collections.Counter()
    by_kernel = collections.Counter()
    for e in device:
        stage = "other"
        ts = launch_ts.get(e.get("args", {}).get("correlation"))
        if ts is not None:
            best = None
            for s0, s1, name in spans:
                if s0 > ts:
                    break
                if ts <= s1 and (best is None or s0 >= best[0]):
                    best = (s0, name)
            if best is not None:
                stage = best[1]
        by_stage[stage] += e["dur"]
        by_kernel[e["name"][:90]] += e["dur"]
    t1 = max(max(e["ts"] + e["dur"] for e in marks),
             max(e["ts"] + e["dur"] for e in device))
    busy, end = 0.0, t0
    for s, d in sorted((e["ts"], e["ts"] + e["dur"]) for e in device):
        if d > end:
            busy += d - max(s, end)
            end = d
    total = sum(by_stage.values())
    print(f"profile: {steps} steps, wall {(t1 - t0) / 1e3:.3f} ms, device "
          f"busy {busy / 1e3:.3f} ms ({100 * busy / (t1 - t0):.1f} %), "
          f"device events {len(device)} ({len(device) / steps:.0f} per "
          f"step)", flush=True)
    for stage, us in by_stage.most_common():
        print(f"profile: {stage}: {us / steps / 1e3:.3f} ms device time per "
              f"step ({100 * us / total:.1f} %)", flush=True)
    host = collections.Counter()
    for s0, s1, name in spans:
        host[name] += s1 - s0
    for stage, us in host.most_common():
        print(f"profile host: {stage}: {us / steps / 1e3:.3f} ms of wall "
              f"time per step inside the span (nested spans included)",
              flush=True)
    for name, us in by_kernel.most_common(12):
        print(f"profile kernel: {us / steps / 1e3:.3f} ms per step: {name}",
              flush=True)


def count_syncs(step, ts, batch):
    """Run one step with sync warnings on; returns (state, counts by
    the line of the port that waited)."""
    counts = collections.Counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            ts, _ = step(ts, batch)
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    for w in caught:
        # Skip the notice that the sync debug mode is a prototype, which
        # setting the mode itself raises.
        msg = str(w.message)
        if "synchroniz" not in msg or "prototype" in msg:
            continue
        counts[f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"] += 1
    return ts, counts


def probe_report(tr, batches) -> None:
    """Per cycled batch and table: ids pending after the probe's fast
    round, straggler rounds, ids without a slot. Every key the tables
    can hold is in after the warm-up, so the lookups change nothing."""
    import chip_smoke
    from deeprec_tpu_torch.embedding import hash_table as ht
    from deeprec_tpu_torch.utils import keys as keylib
    for i, b in enumerate(batches):
        with chip_smoke.captured_probes() as calls:
            tr.group.lookup_train(tr.ts.ev, b, tr.ts.step)
        for _, rows0, qhi, qlo, mask, max_probes in calls:
            table = ht.HashTable(rows0.clone())
            (_, slots, _), rounds = chip_smoke._plain_rounds(
                lambda: ht.find_or_insert_reference(table, qhi, qlo, mask,
                                                    max_probes))
            unplaced = int(((qhi != keylib.EMPTY_HI)
                            & (slots >= table.capacity)).sum())
            print(f"probe: batch {i}, table of {table.capacity} slots: "
                  f"{rounds} straggler rounds, {unplaced} ids without a "
                  f"slot", flush=True)


def e2e_batches(tr, n: int) -> list:
    """``n`` batches of the e2e row, staged on the card."""
    from deeprec_tpu_torch import bench
    from deeprec_tpu_torch.data.criteo import SyntheticCriteo
    from deeprec_tpu_torch.feature_column.feature_column import batch_to
    with tempfile.TemporaryDirectory(prefix="deeprec_torch_e2e_") as d:
        path = os.path.join(d, "criteo.tsv")
        bench.write_tsv(path, n * bench.BATCH,
                        SyntheticCriteo(bench.BATCH, vocab=200_000, seed=7))
        return [batch_to(b, tr.device) for b in bench.e2e_batches(tr, path)]


def profile_graph(tr, batches, args, batch_size: int) -> None:
    """``--graph``: the captured epoch step over ``batches`` as its
    pool, timed, then profiled over 5 replays."""
    from deeprec_tpu_torch.train.loop import make_epoch_step, stack_batches

    def epoch_step(n_epochs):
        return make_epoch_step(tr.group, tr.apply_fn, tr.loss_fn,
                               tr.sparse_opt, tr.dense_opt,
                               n_epochs=n_epochs)

    K = len(batches)
    E = max(1, -(-(args.warmup + args.steps) // K))
    epoch = epoch_step(E)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ts, losses = epoch(tr.ts, stack_batches(batches))
    replays = epoch.last_run["replays"]
    ms = epoch.replay_ms() / replays
    wall = time.perf_counter() - t0
    print(f"graph: {E * K} steps in one call, {wall:.3f} s (step 0 eager, "
          f"the capture, {replays} replays); replays {ms:.3f} ms a step "
          f"on the device clock (CUDA events), "
          f"{batch_size / (ms * 1e-3):.0f} samples/s; host enqueue "
          f"{epoch.last_run['enqueue_s'] / replays * 1e3:.4f} ms a step; "
          f"host syncs between the first and the last replay: "
          f"0 (set_sync_debug_mode('error')); last loss "
          f"{float(losses.reshape(-1)[-1]):.6f}", flush=True)
    replay = torch.cuda.CUDAGraph.replay

    def marked(graph):
        with torch.profiler.record_function("train_step"):
            return replay(graph)

    torch.cuda.CUDAGraph.replay = marked
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    try:
        with torch.profiler.profile(activities=acts) as prof:
            ts, _ = epoch_step(1)(ts, stack_batches(
                batches[:PROFILED_STEPS + 1]))
            torch.cuda.synchronize()
    finally:
        torch.cuda.CUDAGraph.replay = replay
    os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
    prof.export_chrome_trace(args.trace)
    device_split(args.trace, PROFILED_STEPS)
    tr.ts = ts


ZOO_BATCH = 4096


def zoo_trainer(name: str, flags=()):
    """A zoo model of ``tools/train_zoo_torch.py`` (with its ``flags``)
    on the card, with the fields of a ``bench`` trainer that this tool
    reads."""
    import types
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import train_zoo_torch as tz
    args = tz.parse_args([name, "--bf16", "--batch_size", str(ZOO_BATCH),
                          *flags])
    est, make_data, pack, _ = tz.build(args, torch.device("cuda"))
    data = make_data(args.seed)
    return types.SimpleNamespace(
        ts=est.ts, group=est.group, step=est._step_fn, apply_fn=est.apply_fn,
        loss_fn=est.loss_fn, sparse_opt=est.sparse_opt,
        dense_opt=est.dense_opt, next_batch=lambda: pack(data))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--opt", default="adagrad", choices=("adagrad", "adam"))
    ap.add_argument("--row", default="headline",
                    choices=tuple(ROW_KW))
    ap.add_argument("--fresh", action="store_true")
    ap.add_argument("--warmup", type=int, default=WARMUP)
    ap.add_argument("--trace", default=os.path.join(
        "build", "train_trace_torch.json"))
    ap.add_argument("--graph", action="store_true",
                    help="the step captured in a CUDA graph "
                         "(train.loop.make_epoch_step)")
    ap.add_argument("--zoo", default=None,
                    help="a model of tools/train_zoo_torch.py instead of "
                         "a bench row")
    ap.add_argument("--zoo_flags", default="",
                    help="flags of tools/train_zoo_torch.py for --zoo, "
                         "space-separated (e.g. --adaptive_emb)")
    ap.add_argument("--sharded", action="store_true",
                    help="the headline's tables row-sharded over a "
                         "one-rank NCCL mesh")
    args = ap.parse_args()
    if args.sharded and (args.zoo or args.graph or args.row != "headline"):
        ap.error("--sharded takes the headline row, eager")
    sys.path.insert(0, ROOT)
    import chip_smoke
    from deeprec_tpu_torch import bench
    from deeprec_tpu_torch.embedding import variable as ev

    chip_smoke.phase_device()
    mesh = None
    if args.sharded:
        from deeprec_tpu_torch.parallel import mesh as meshlib
        from deeprec_tpu_torch.parallel import multihost
        store = os.path.join(tempfile.mkdtemp(), "store")
        multihost.initialize(init_method="file://" + store, rank=0,
                             world_size=1)
        mesh = meshlib.data_mesh(1)
    if args.zoo:
        tr, batch_size = zoo_trainer(args.zoo,
                                     args.zoo_flags.split()), ZOO_BATCH
        args.opt = "adagrad"
    else:
        tr = bench.build_wdl(device="cuda", sparse_opt=args.opt, mesh=mesh,
                             **ROW_KW[args.row])
        batch_size = bench.BATCH
    # warm-up, timed steps, the sync count, the spanned step's warm-up
    # and the profiled steps each take their batches in turn.
    n = (args.warmup + args.steps + 1 + SPAN_WARMUP + PROFILED_STEPS
         if args.fresh else bench.PREPACKED)
    if args.row == "e2e":
        batches = e2e_batches(tr, n)
    else:
        batches = [tr.next_batch() for _ in range(n)]
    if args.graph:
        profile_graph(tr, batches, args, batch_size)
        return
    order = iter(range(1 << 30))

    def batch():
        return batches[next(order) % len(batches)]

    ts = tr.ts
    for _ in range(args.warmup):
        ts, _ = tr.step(ts, batch())
    torch.cuda.synchronize()
    times, overflow = [], []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        ts, m = tr.step(ts, batch())
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        overflow.append(int(m["n_overflow"]))
    med = statistics.median(times)
    print(f"step: median {med:.3f} ms, min {min(times):.3f}, max "
          f"{max(times):.3f} over {args.steps} synchronized steps; "
          f"{batch_size / (med * 1e-3):.0f} samples/s; loss "
          f"{float(m['loss']):.6f}", flush=True)
    print(f"step ms {[round(t, 3) for t in times]}; n_overflow {overflow}",
          flush=True)

    ts, syncs = count_syncs(tr.step, ts, batch())
    print(f"host syncs in one step: {sum(syncs.values())}", flush=True)
    for where, n in syncs.most_common():
        print(f"host syncs: {n} at {where}", flush=True)
    if not (args.fresh or args.zoo or args.sharded):
        tr.ts = ts
        probe_report(tr, batches)

    # Spans need the model's apply_fn wrapped, which the step captured
    # when it was made: make a step of the same parts around it.
    from deeprec_tpu_torch.train.loop import make_train_step
    step = make_train_step(tr.group, _spanned("towers_fwd", tr.apply_fn),
                           tr.loss_fn, tr.sparse_opt, tr.dense_opt,
                           mesh=mesh)
    with stage_spans(args.opt):
        for _ in range(SPAN_WARMUP):
            ts, _ = step(ts, batch())
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        metrics = []
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(PROFILED_STEPS):
                with torch.profiler.record_function("train_step"):
                    ts, m = step(ts, batch())
                metrics.append(m)
            torch.cuda.synchronize()
    os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
    prof.export_chrome_trace(args.trace)
    device_split(args.trace, PROFILED_STEPS)
    print(f"profiled steps: n_overflow "
          f"{[int(m['n_overflow']) for m in metrics]}; live keys "
          f"{ {t: int(ev.num_live(st)) for t, st in ts.ev.items()} }", flush=True)
    if mesh is not None:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
