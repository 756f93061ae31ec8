"""Readings the limits of the correctness check are set from.

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3
        [--modes program,control,half_batch,no_update] [--device cuda]

For each seed it runs the cell's set-up as far as the checked steps
(``harness.start``: the cell's own sizes, pool and calls; no window) and
prints one JSON line a seed and mode with the four numbers of
``check.compare``:

* ``program``: the program against the reference (sound runs: the lower
  readings);
* ``control``: the reference with its table rows in bfloat16, the next
  precision below the configuration's float32 tables, in the program's
  place;
* ``half_batch``: the program with the loss taken over half of each
  batch (the mean then over that half);
* ``no_update``: the program with every gradient zero, a step that
  leaves the state as it was.

The benchmark's runs do not run it.
"""

import argparse
import gc
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def readings(cell, seed: int, modes, device):
    """``{mode: numbers}`` of one seed."""
    import torch
    from benchmark import check, harness
    out = {}
    builds = [(None, [m for m in modes if m in ("program", "control")])]
    builds += [(m, [m]) for m in modes if m in ("half_batch", "no_update")]
    for fault, names in builds:
        if not names:
            continue
        rn, snap, pool = harness.start(cell, seed, device, fault)
        rn.tr.epoch.release()
        del rn, pool
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        ref = check.reference_readings(cell, snap, device)
        for m in names:
            if m == "control":
                prog = check.as_program(check.reference_readings(
                    cell, snap, device, torch.bfloat16))
            else:
                prog = check.program_readings(snap, cell, device)
            out[m] = check.compare(prog, ref)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 benchmark/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--modes", default="program,control,half_batch")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if sys.path and os.path.abspath(sys.path[0]) == HERE:
        sys.path[0] = ROOT
    from benchmark import manifest
    cell = manifest.cell(ROOT, args.workload)
    modes = args.modes.split(",")
    for seed in (int(s) for s in args.seeds.split(",")):
        for m, numbers in readings(cell, seed, modes, args.device).items():
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "mode": m, **numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
