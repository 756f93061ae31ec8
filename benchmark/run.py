"""Run one cell of the benchmark of ``deeprec_tpu_torch`` once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell
asks for. It prints, as the last line of standard output, one JSON
object: ``correct``, ``attempted`` and ``failed`` (the window's steps and
those with a non-finite loss), ``metrics`` (with ``--trace 0`` the cell's
end-to-end metrics, with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` a ``breakdown`` of the trace, and last ``check``: each
number the correctness check compared, beside its limit (also the last
lines of standard error). Earlier lines of standard error record the
card's power limit and clocks, the set-up, the window's calls, the new
rows a step at the window's start and end, each table's live rows after
it, ``n_overflow`` and the peak device memory.

It exits with another code than 0, and prints no result, where no CUDA
card (or too few) is visible, where the port is not in the checkout, or
where JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# Modules that must never load: JAX and the JAX package, by top-level name.
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "deeprec_tpu")


def forbidden_loaded():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _caches() -> None:
    """Kernel caches at fixed paths inside the checkout (the port's nvcc
    builds go to ``build/kernels`` there already)."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                      "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 benchmark/run.py",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    if sys.path and os.path.abspath(sys.path[0]) == HERE:
        sys.path[0] = ROOT
    elif ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch
    from benchmark import harness, manifest
    cell = manifest.cell(ROOT, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card is visible", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    import deeprec_tpu_torch
    if not os.path.abspath(deeprec_tpu_torch.__file__).startswith(
            ROOT + os.sep):
        print(f"deeprec_tpu_torch loaded from {deeprec_tpu_torch.__file__}, "
              f"not from the checkout {ROOT}", file=sys.stderr)
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              "cuda", T_START)
    bad = forbidden_loaded()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    harness.print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
