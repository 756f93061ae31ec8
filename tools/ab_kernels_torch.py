#!/usr/bin/env python3
"""Time this checkout's K1 (``gather_rows``), K2 (``adagrad_apply_rows``)
and K3 (``adam_apply_rows``) kernels against other versions of their
CUDA sources, in turns, in one process on one CUDA card.

Run from the repository root:

    mkdir -p build/ab/parent
    git show REV:deeprec_tpu_torch/csrc/gather_rows.cu > build/ab/parent/gather_rows.cu
    git show REV:deeprec_tpu_torch/csrc/sparse_apply.cu > build/ab/parent/sparse_apply.cu
    python3 tools/ab_kernels_torch.py --other build/ab/parent [--other DIR ...]

Each other version (named by its directory) builds with this checkout's
flags (``build.NVCC_FLAGS`` plus ``build.KERNEL_FLAGS``) and must export
the same C entries. All versions launch through the same wrappers
(``gather.gather_rows``, ``sparse_apply.adagrad_apply_rows``,
``sparse_apply.adam_apply_rows``), pointed at one library or another.
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
  (``chip_smoke.ADAM_STEPS``), both tables.

Bounds are ``chip_smoke.py``'s: an apply's from its applied and fresh
rows (``chip_smoke._apply_bytes``).

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
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("gather_rows", "sparse_apply")
TRAIN_STEPS = 10  # steps before the main-path cases: tables part filled


def build_other(src_dir: str) -> dict:
    """Build ``src_dir``'s sources into ``build/kernels-other/<name>/``."""
    from deeprec_tpu_torch.ops.kernels import build
    out_dir = os.path.join(ROOT, "build", "kernels-other",
                           os.path.basename(src_dir))
    os.makedirs(out_dir, exist_ok=True)

    def one(name):
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


@contextlib.contextmanager
def using(libs):
    """Point the K1, K2 and K3 wrappers at ``libs``' C entries; None
    keeps this checkout's."""
    from deeprec_tpu_torch.ops.kernels import gather
    from deeprec_tpu_torch.ops.kernels import sparse_apply as sa
    symbols = ("deeprec_adagrad_apply_rows", "deeprec_adam_apply_rows")
    mine_g = gather._kernel()
    mine = {sym: sa._kernel(sym) for sym in symbols}
    if libs is not None:
        g = libs["gather_rows"].deeprec_gather_rows
        g.argtypes, g.restype = mine_g.argtypes, mine_g.restype
        gather._fn = g
        for sym in symbols:
            fn = getattr(libs["sparse_apply"], sym)
            fn.argtypes, fn.restype = mine[sym].argtypes, mine[sym].restype
            sa._fns[sym] = fn
    try:
        yield
    finally:
        gather._fn = mine_g
        sa._fns.update(mine)


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
          + f": {times}; bound {rec['bound_ms']:.4f} ms"
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
        for ops in chip_smoke._step_applies(tr, kind, gl, grads):
            recs.append(ab_apply(versions, kind, f"{label} training step",
                                 *ops))
            report(recs[-1])
        del tr, gl, grads, calls
        gc.collect()
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True, action="append",
                    help="directory with another gather_rows.cu and "
                         "sparse_apply.cu; repeatable")
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
    recs = []
    synthetic_gathers(versions, recs)
    synthetic_apply(versions, recs)
    main_path(versions, recs)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"device": card, "versions": [v for v, _ in versions],
                   "cases": recs}, f, indent=1)


if __name__ == "__main__":
    main()
