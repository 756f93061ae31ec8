#!/usr/bin/env python3
"""Time this checkout's K1 (``gather_rows``), K2 (``adagrad_apply_rows``),
K3 (``adam_apply_rows``), P1 (the hash probe's insert) and P2 (the fresh
rows' draw) kernels against other versions of their CUDA sources, in
turns, in one process on one CUDA card.

Run from the repository root:

    mkdir -p build/ab/parent
    for f in gather_rows sparse_apply hash_probe init_rows; do
      git show REV:deeprec_tpu_torch/csrc/$f.cu > build/ab/parent/$f.cu; done
    python3 tools/ab_kernels_torch.py --other build/ab/parent [--other DIR ...] \
        [--cases gather,apply,step,probe,draw]

Each other version (named by its directory) builds with this checkout's
flags (``build.NVCC_FLAGS`` plus ``build.KERNEL_FLAGS``) and must export
the same C entries; a kernel whose source the directory lacks runs this
checkout's. All versions launch through the same wrappers
(``gather.gather_rows``, ``sparse_apply.adagrad_apply_rows``,
``sparse_apply.adam_apply_rows``, ``hash_probe.find_or_insert``,
``init_rows.init_fresh``), pointed at one library or another; an insert
takes this checkout's scratch size, at least what an older probe needs.
Every case first checks that the versions give equal results, then
times them in turns, the others in the order given, this checkout
twice, the others in reverse (each ``chip_smoke.median_ms``, device
time), and reports the mean of each version's two times. Cases, at
the main path's shapes:

- K1 at ``chip_smoke.py`` phase 3's serving shapes (uniform slots, 90 %
  admitted, one default row), both tables, with and without the select;
- K1 on one headline training step's own lookup operands, both tables,
  after TRAIN_STEPS training steps;
- K2 on that step's own row gradients, both tables, and at phase 7's
  synthetic shape (129 wide, about 87 % of rows updated, 20 % of them
  fresh);
- K3 at phase 7's synthetic shape, and on the row gradients of one
  ``sparse_opt="adam"`` training step after phase 10's warm-up
  (``chip_smoke.ADAM_STEPS``), both tables;
- P1 on a headline training step's probes (the stream's next batch,
  partly new keys, both tables), on those of an unseen batch (every id
  new), on the unseen batch's probes again (every key present), and on
  the next batch of 294,912 unseen ids into a 65-wide table of 2**19
  slots fed such batches until full (almost no id finds a slot): the
  whole insert, its fast round alone (``max_rounds`` 1) and the
  straggler part (their difference); the rounds this checkout ran; the
  host's time to queue an insert (with its copy of the key rows), the
  mean over HOST_CALLS calls in turns;
- P2 on the draws of a headline step (the stream's next batch) and of
  an unseen batch (every row fresh).

Bounds are ``chip_smoke.py``'s: an apply's from its applied and fresh
rows (``chip_smoke._apply_bytes``), P1's from the key rows its ids'
windows touch (``chip_smoke.compare_probe``), P2's the larger of its
byte and arithmetic bounds (``chip_smoke.compare_init``).

One line per case goes to stdout, all of them as JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import gc
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("gather_rows", "sparse_apply", "hash_probe", "init_rows")
CASES = ("gather", "apply", "step", "probe", "draw")
TRAIN_STEPS = 10  # steps before the main-path cases: tables part filled
FULL_TABLE = (1 << 19, 294912)  # slots and batch of the full-table case
HOST_CALLS = 20  # inserts a version queues for its host time


def build_other(src_dir: str) -> dict:
    """Build ``src_dir``'s sources into ``build/kernels-other/<name>/``;
    a kernel without a source there maps to None (this checkout's)."""
    from deeprec_tpu_torch.ops.kernels import build
    out_dir = os.path.join(ROOT, "build", "kernels-other",
                           os.path.basename(src_dir))
    os.makedirs(out_dir, exist_ok=True)

    def one(name):
        if not os.path.exists(os.path.join(src_dir, f"{name}.cu")):
            return None
        so = os.path.join(out_dir, f"{name}.so")
        flags = build.NVCC_FLAGS + build.KERNEL_FLAGS.get(name, ())
        proc = subprocess.run(
            [build._nvcc(), *flags, "-o", so,
             os.path.join(src_dir, f"{name}.cu")],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src_dir}/{name}.cu:\n"
                               f"{proc.stderr}")
        return ctypes.CDLL(so)

    with ThreadPoolExecutor(len(NAMES)) as pool:
        libs = dict(zip(NAMES, pool.map(one, NAMES)))
    return libs


def _bound(fn, mine):
    fn.argtypes, fn.restype = mine.argtypes, mine.restype
    return fn


@contextlib.contextmanager
def using(libs):
    """Point the K1, K2, K3, P1 and P2 wrappers at ``libs``' C entries;
    None (or a kernel missing from ``libs``) keeps this checkout's."""
    from deeprec_tpu_torch.ops.kernels import gather, hash_probe, init_rows
    from deeprec_tpu_torch.ops.kernels import sparse_apply as sa
    apply_syms = ("deeprec_adagrad_apply_rows", "deeprec_adam_apply_rows")
    probe_syms = ("deeprec_probe_find", "deeprec_probe_insert")
    mine_g, mine_i = gather._kernel(), init_rows._kernel()
    mine_a = {sym: sa._kernel(sym) for sym in apply_syms}
    mine_p = {sym: hash_probe._kernel(sym) for sym in probe_syms}
    libs = libs or {}
    if libs.get("gather_rows") is not None:
        gather._fn = _bound(libs["gather_rows"].deeprec_gather_rows, mine_g)
    if libs.get("sparse_apply") is not None:
        for sym in apply_syms:
            sa._fns[sym] = _bound(getattr(libs["sparse_apply"], sym),
                                  mine_a[sym])
    if libs.get("hash_probe") is not None:
        for sym in probe_syms:
            hash_probe._fns[sym] = _bound(getattr(libs["hash_probe"], sym),
                                          mine_p[sym])
    if libs.get("init_rows") is not None:
        init_rows._fn = _bound(libs["init_rows"].deeprec_init_fresh, mine_i)
    try:
        yield
    finally:
        gather._fn, init_rows._fn = mine_g, mine_i
        sa._fns.update(mine_a)
        hash_probe._fns.update(mine_p)


def in_turns(versions, fn) -> dict:
    """Median times of ``fn`` with each version's kernels, in the order
    of ``versions`` (label, libs) and back; libs None is this checkout."""
    import chip_smoke
    runs = {label: [] for label, _ in versions}
    for label, libs in versions + versions[::-1]:
        with using(libs):
            runs[label].append(chip_smoke.median_ms(fn))
    return {"ms": {k: float(np.mean(v)) for k, v in runs.items()},
            "runs": runs}


def ab_gather(versions, label, values, slots, admitted=None, bank=None,
              sel=None, bound_bytes=None) -> dict:
    import chip_smoke
    from deeprec_tpu_torch.ops.kernels import gather
    args = (values, slots, admitted, bank, sel)
    outs = []
    for _, libs in versions:
        with using(libs):
            outs.append(gather.gather_rows(*args))
    torch.cuda.synchronize()
    if not all(torch.equal(outs[0], o) for o in outs[1:]):
        raise AssertionError(f"{label}: the versions differ")
    del outs
    C1 = values.shape[0]
    clamped = torch.clamp(slots.long(), 0, C1 - 1)
    rec = {"case": label, "shape": list(values.shape), "n": slots.numel(),
           **in_turns(versions, lambda: gather.gather_rows(*args)),
           "library_ms": chip_smoke.median_ms(
               lambda: torch.nn.functional.embedding(clamped, values))}
    nbytes = (bound_bytes if bound_bytes is not None
              else chip_smoke._gather_bytes(*args))
    rec["bound_ms"] = chip_smoke.bound_ms(nbytes)
    return rec


def ab_apply(versions, kind, label, values, tables, slots, grads, upd,
             is_new, args) -> dict:
    """K2 (``kind`` "adagrad") or K3 ("adam") of every version on copies
    of the same inputs: equal results, then times in turns."""
    import chip_smoke
    first = None
    for _, libs in versions:
        out = [values.clone()] + [t.clone() for t in tables]
        with using(libs):
            chip_smoke._apply(kind, out[0], slots, grads, upd, is_new,
                              out[1:], args, plain=False)
        torch.cuda.synchronize()
        if first is None:
            first = out
        elif not all(torch.equal(a, b) for a, b in zip(out, first)):
            raise AssertionError(f"{label}: the versions differ")
        del out
    C, D = values.shape[0] - 1, values.shape[1]
    applied, fresh = chip_smoke._applied(C, slots, upd, is_new)
    rec = {"case": label, "shape": list(values.shape), "n": slots.numel(),
           "updated": int(applied.sum()), "fresh": int(fresh.sum()),
           **in_turns(versions, lambda: chip_smoke._apply(
               kind, first[0], slots, grads, upd, is_new, first[1:], args,
               plain=False)),
           "library_ms": None,
           "bound_ms": chip_smoke.bound_ms(chip_smoke._apply_bytes(
               kind, C, D, slots, upd, is_new))}
    del first
    return rec


def ab_probe(versions, label, rows0, qhi, qlo, mask, max_probes) -> dict:
    """P1's insert of every version on copies of the key rows ``rows0``:
    equal slots, ``is_new`` and key rows, then in turns the whole insert
    and its fast round alone (each restores the key rows first; that
    copy's time is taken off)."""
    import chip_smoke
    from deeprec_tpu_torch.embedding import hash_table as ht
    from deeprec_tpu_torch.ops.kernels import hash_probe
    from deeprec_tpu_torch.utils import trace
    n = qhi.numel()
    R, M = ht._wide_rows(rows0, max_probes), ht._straggler_budget(n)
    claim = hash_probe.claim_buffer(rows0.shape[0] * rows0.shape[1] // 2,
                                    rows0.device)
    work = rows0.clone()

    def run(max_rounds):
        work.copy_(rows0)
        return hash_probe.find_or_insert(work, qhi, qlo, mask, claim, R, M,
                                         max_rounds)

    first = None
    for _, libs in versions:
        with using(libs):
            out = [t.clone() for t in run(128)] + [work.clone()]
        if first is None:
            first = out
        elif not all(torch.equal(a, b) for a, b in zip(out, first)):
            raise AssertionError(f"{label}: the versions differ")
    with using(None):
        _, counters = trace.counted(lambda: run(128))
        rounds = int(counters["probe_rounds"])
    del first
    host = {name: [] for name, _ in versions}
    for name, libs in versions + versions[::-1]:
        with using(libs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(HOST_CALLS):
                run(128)
            host[name].append((time.perf_counter() - t0) / HOST_CALLS * 1e3)
            torch.cuda.synchronize()
    checked = chip_smoke.compare_probe(label, "insert", rows0, qhi, qlo, mask,
                                       max_probes, time_it=False)
    copy = chip_smoke.median_ms(lambda: work.copy_(rows0))
    whole = in_turns(versions, lambda: run(128))
    fast = in_turns(versions, lambda: run(1))
    ms = {k: v - copy for k, v in whole["ms"].items()}
    fast_ms = {k: v - copy for k, v in fast["ms"].items()}
    return {"case": label, "shape": list(rows0.shape), "n": n, "ms": ms,
            "runs": {k: [t - copy for t in v]
                     for k, v in whole["runs"].items()},
            "fast_ms": fast_ms,
            "straggler_ms": {k: ms[k] - fast_ms[k] for k in ms},
            "copy_ms": copy, "rounds": rounds,
            "host_ms": {k: float(np.mean(v)) for k, v in host.items()},
            "plain_rounds": checked["plain_rounds"],
            "pending_after_fast": checked["pending_after_fast"],
            "library_ms": None, "bound_ms": checked["bound_ms"]}


def ab_draw(versions, label, values0, *args) -> dict:
    """P2 of every version on copies of ``values0``: equal tables, then
    times in turns (repeated calls write the same rows)."""
    import chip_smoke
    from deeprec_tpu_torch.ops.kernels import init_rows
    first = None
    for _, libs in versions:
        out = values0.clone()
        with using(libs):
            init_rows.init_fresh(out, *args)
        torch.cuda.synchronize()
        if first is None:
            first = out
        elif not torch.equal(out, first):
            raise AssertionError(f"{label}: the versions differ")
        del out
    checked = chip_smoke.compare_init(label, values0, *args)
    rec = {"case": label, "shape": list(values0.shape), "n": args[0].numel(),
           "rows": checked["rows"],
           **in_turns(versions, lambda: init_rows.init_fresh(first, *args)),
           "library_ms": None, "bound_ms": checked["bound_ms"],
           "bytes_bound_ms": checked["bytes_bound_ms"],
           "ops_bound_ms": checked["ops_bound_ms"]}
    del first
    return rec


def report(rec):
    lib = rec["library_ms"]
    times = "; ".join(
        f"{k} {ms:.4f} ms ({100 * rec['bound_ms'] / ms:.0f} % of bound; "
        f"runs {', '.join(f'{x:.4f}' for x in rec['runs'][k])})"
        for k, ms in rec["ms"].items())
    print(f"{rec['case']}: {rec['shape']}, n={rec['n']}"
          + (f", {rec['updated']} updated ({rec['fresh']} fresh)"
             if "updated" in rec else "")
          + (f", {rec['admitted']} admitted" if "admitted" in rec else "")
          + (f", {rec['rows']} fresh rows" if "rows" in rec else "")
          + (f", {rec['pending_after_fast']} pending after the fast round, "
             f"{rec['rounds']} rounds here ({rec['plain_rounds']} plain)"
             if "rounds" in rec else "")
          + f": {times}; bound {rec['bound_ms']:.4f} ms"
          + ("; fast round " + ", ".join(
              f"{k} {v:.4f}" for k, v in rec["fast_ms"].items())
             + "; straggler part " + ", ".join(
              f"{k} {v:.4f}" for k, v in rec["straggler_ms"].items())
             + "; host ms a call " + ", ".join(
              f"{k} {v:.4f}" for k, v in rec["host_ms"].items())
             if "fast_ms" in rec else "")
          + (f" (bytes {rec['bytes_bound_ms']:.4f}, arithmetic "
             f"{rec['ops_bound_ms']:.4f})" if "ops_bound_ms" in rec else "")
          + (f"; F.embedding {lib:.4f} ms" if lib is not None else ""),
          flush=True)


def synthetic_gathers(versions, recs):
    """Phase 3's serving shapes: uniform slots, 90 % admitted."""
    import chip_smoke
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for C1, D, n in ((4194305, 129, chip_smoke.BATCH * 8),
                     (524289, 65, chip_smoke.BATCH * 18)):
        values = torch.randn(C1, D, generator=gen, device=dev)
        slots = torch.randint(0, C1, (n,), generator=gen, device=dev,
                              dtype=torch.int32)
        admitted = torch.rand(n, generator=gen, device=dev) < 0.9
        bank = torch.randn(1, D, generator=gen, device=dev)
        nbytes = 2 * n * D * 4 + 5 * n   # chip_smoke.py phase 3's bound
        for label, args in (("K1 uniform, no select", (slots,)),
                            ("K1 uniform, select", (slots, admitted, bank))):
            recs.append(ab_gather(versions, label, values, *args,
                                  bound_bytes=nbytes))
            report(recs[-1])
        del values, slots, admitted, bank
        torch.cuda.empty_cache()


def synthetic_apply(versions, recs):
    """Phase 7's headline shape for K2 and K3: 129 wide, 90 % of rows
    marked for update, 20 % fresh, 3 % of slots dropped."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    C1, D, n = 4194305, 129, 131073
    C = C1 - 1
    values = torch.randn(C1, D, generator=gen, device=dev)
    slots = torch.randperm(C, generator=gen, device=dev)[:n].to(torch.int32)
    k = n // 100
    slots[:k], slots[k:2 * k], slots[2 * k:3 * k] = C, C + 17, -5
    grads = torch.randn(n, D, generator=gen, device=dev)
    upd = torch.rand(n, generator=gen, device=dev) < 0.9
    is_new = torch.rand(n, generator=gen, device=dev) < 0.2
    accum = torch.rand(C1, D, generator=gen, device=dev) + 0.1
    recs.append(ab_apply(versions, "adagrad", "K2 synthetic", values, [accum],
                         slots, grads, upd, is_new, (0.05, 0.1)))
    report(recs[-1])
    del accum
    moments = [torch.randn(C1, D, generator=gen, device=dev) * 0.1,
               torch.rand(C1, D, generator=gen, device=dev) * 0.1]
    alpha = torch.tensor([0.01], device=dev)
    recs.append(ab_apply(versions, "adam", "K3 synthetic", values, moments,
                         slots, grads, upd, is_new, (alpha, 0.9, 0.999, 1e-8)))
    report(recs[-1])
    del values, moments
    torch.cuda.empty_cache()


def main_path(versions, recs):
    """K1 on one headline training step's own lookup operands, K2 on its
    row gradients; K3 on the row gradients of a ``sparse_opt="adam"``
    step, warmed as phase 10 is."""
    import chip_smoke
    from deeprec_tpu_torch import bench
    for kind, (warmup, steps) in (("adagrad", (TRAIN_STEPS, 1)),
                                  ("adam", chip_smoke.ADAM_STEPS)):
        tr = bench.build_wdl(reference_shapes=True, device="cuda",
                             sparse_opt=kind)
        bench.bench_device(tr, warmup=warmup, steps=steps)
        with chip_smoke.captured_gathers() as calls:
            gl, grads = chip_smoke._step_grads(tr, tr.next_batch())
        if kind == "adagrad":
            for args in calls:
                recs.append(ab_gather(versions, "K1 training lookup", *args))
                recs[-1]["admitted"] = int(args[2].sum())
                report(recs[-1])
        label = "K2" if kind == "adagrad" else "K3"
        for *ops, _ in chip_smoke._step_applies(tr, kind, gl, grads):
            recs.append(ab_apply(versions, kind, f"{label} training step",
                                 *ops))
            report(recs[-1])
        del tr, gl, grads, calls
        gc.collect()
        torch.cuda.empty_cache()


def probes_and_draws(versions, recs, cases):
    """P1 and P2 on a headline step's probes and draws: the stream's next
    batch, an unseen batch (every id new; its draws every row fresh),
    and the unseen batch's probes again (every key present); then P1 on
    the full 65-wide table."""
    import chip_smoke
    from deeprec_tpu_torch import bench
    from deeprec_tpu_torch.embedding import hash_table as ht
    from deeprec_tpu_torch.utils import keys as keylib
    tr = bench.build_wdl(reference_shapes=True, device="cuda")
    bench.bench_device(tr, warmup=TRAIN_STEPS, steps=1)
    batch = chip_smoke.unseen_batch(tr, 1)
    with chip_smoke.captured_probes() as probes, \
            chip_smoke.captured_inits() as inits:
        tr.group.lookup_train(tr.ts.ev, batch, tr.ts.step)
    with chip_smoke.captured_probes() as again:
        tr.group.lookup_train(tr.ts.ev, batch, tr.ts.step)
    with chip_smoke.captured_probes() as step_probes, \
            chip_smoke.captured_inits() as step_inits:
        tr.group.lookup_train(tr.ts.ev, tr.next_batch(), tr.ts.step)
    if "probe" in cases:
        for label, calls in (("P1 step's probe", step_probes),
                             ("P1 unseen batch", probes),
                             ("P1 every key present", again)):
            for kind, rows0, qhi, qlo, mask, max_probes in calls:
                recs.append(ab_probe(versions, label, rows0, qhi, qlo, mask,
                                     max_probes))
                report(recs[-1])
    if "draw" in cases:
        for label, calls in (("P2 step's draw", step_inits),
                             ("P2 unseen batch's draw", inits)):
            for args in calls:
                recs.append(ab_draw(versions, label, *args))
                report(recs[-1])
    del tr, probes, again, inits, step_probes, step_inits
    gc.collect()
    torch.cuda.empty_cache()
    if "probe" not in cases:
        return
    capacity, n = FULL_TABLE
    rng = np.random.default_rng(11)
    table = ht.create(capacity, "cuda")
    mask = torch.ones(n, dtype=torch.bool, device="cuda")
    for b in range(chip_smoke.FULL_TABLE_BATCHES + 1):  # as phase 15 fills
        hi, lo = (torch.from_numpy(a).cuda() for a in keylib.split_ids(
            rng.integers(1, 2**62, size=n)))
        if (int(ht.live_mask(table).sum()) == capacity
                or b == chip_smoke.FULL_TABLE_BATCHES):
            break
        ht.find_or_insert(table, hi, lo, mask)
    recs.append(ab_probe(versions, "P1 full 65-wide table",
                         table.key_rows.clone(), hi, lo, mask, 64))
    report(recs[-1])
    del table


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True, action="append",
                    help="directory with other versions of the kernels' "
                         "sources (gather_rows.cu, sparse_apply.cu, "
                         "hash_probe.cu, init_rows.cu); repeatable")
    ap.add_argument("--cases", default=",".join(CASES),
                    help="comma-separated groups of cases among "
                         + ", ".join(CASES))
    ap.add_argument("--out", default=os.path.join("build",
                                                  "ab_kernels.json"))
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke
    card = chip_smoke.phase_device()
    chip_smoke.phase_build()
    dirs = [os.path.abspath(d) for d in args.other]
    with ThreadPoolExecutor(len(dirs)) as pool:
        libs = list(pool.map(build_other, dirs))
    versions = [(os.path.basename(d), lib) for d, lib in zip(dirs, libs)]
    versions.append(("this", None))
    cases = set(args.cases.split(","))
    if not cases <= set(CASES):
        raise SystemExit(f"--cases: unknown {sorted(cases - set(CASES))}")
    recs = []
    if "gather" in cases:
        synthetic_gathers(versions, recs)
    if "apply" in cases:
        synthetic_apply(versions, recs)
    if "step" in cases:
        main_path(versions, recs)
    if cases & {"probe", "draw"}:
        probes_and_draws(versions, recs, cases)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"device": card, "versions": [v for v, _ in versions],
                   "cases": recs}, f, indent=1)


if __name__ == "__main__":
    main()
