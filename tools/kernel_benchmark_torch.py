"""Kernel microbenchmarks on the CUDA card: the counterpart of
``tools/kernel_benchmark.py``, at its jobs and shapes. Where the JAX
tool set a Pallas kernel against its XLA lowering, each line here sets a
kernel of the port against its plain PyTorch version and against the
one PyTorch call that computes the same function, where there is one,
beside its bound: the bytes the call must move (PERF.md §6's counts,
``chip_smoke._apply_bytes``, ``_gather_bytes`` and ``compare_probe``)
over the card's 3.35 TB/s. Every kernel is first checked against its
plain version on the same operands.

Jobs, one process each (seeded operands):

  apply [n]   K2 (sparse Adagrad) at C = 2**17, D = 128, n = 65,536
              distinct rows; library: ``torch.optim.Adagrad`` on a
              sparse COO gradient (eps 0)
  adam [n]    K3 (lazy Adam) at the same shapes; library:
              ``torch.optim.SparseAdam`` (lr = alpha, bias corrections 1)
  lookup      P1's insert into an empty table of C = 2**20 slots and
              find of the same n = 2**17 ids (of [1, C/2)), then K1's
              fetch of their D = 16 rows; the library call of the fetch
              is ``F.embedding``, none probes a table. The JAX tool's
              ``max_probes`` argument has no meaning for P1, whose probe
              window is its key row and the rows after it, so it is gone.
  gather [D]  K1 at C = 2**20, n = 2**18 uniform slots, D = 128;
              library: ``F.embedding``

Times are device time (``chip_smoke.median_ms``: calls captured in a
CUDA graph); the plain probe and the library applies, which read the
card from the host, are timed between CUDA events with those reads in.

Usage: python3 tools/kernel_benchmark_torch.py [job [arg]]
Each job prints one JSON line a kernel, with the card's name and power
limit. It needs the CUDA card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import numpy as np  # noqa: E402

JOBS = (("apply", "65536"), ("adam", "65536"), ("lookup",),
        ("gather", "128"))
APPLY_SHAPE = dict(C=1 << 17, D=128)
LOOKUP_SHAPE = dict(C=1 << 20, n=1 << 17, D=16)
GATHER_SHAPE = dict(C=1 << 20, n=1 << 18)
ADAGRAD_ARGS = (0.1, 0.1)                     # lr, initial accumulator
ADAM_ARGS = (0.01, 0.9, 0.999, 1e-8)          # alpha, beta1, beta2, eps


def apply_operands(kind: str, n: int, device, C: int = APPLY_SHAPE["C"],
                   D: int = APPLY_SHAPE["D"]):
    """The JAX tool's apply operands: values, the slot tables, n
    distinct slots and their gradients (seed 0)."""
    import torch

    rng = np.random.default_rng(0)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    values = t(rng.normal(size=(C + 1, D)).astype(np.float32))
    if kind == "adagrad":
        tables = [t(rng.uniform(0.1, 1.0, size=(C + 1, D)).astype(
            np.float32))]
    else:
        tables = [t(rng.normal(0, 0.1, size=(C + 1, D)).astype(np.float32)),
                  t(rng.uniform(0, 0.1, size=(C + 1, D)).astype(np.float32))]
    slots = t(rng.choice(C, size=n, replace=False).astype(np.int32))
    grads = t(rng.normal(size=(n, D)).astype(np.float32))
    return values, tables, slots, grads


def gather_operands(device, D: int, C: int = GATHER_SHAPE["C"],
                    n: int = GATHER_SHAPE["n"]):
    import torch

    rng = np.random.default_rng(0)
    values = torch.from_numpy(
        rng.normal(size=(C + 1, D)).astype(np.float32)).to(device)
    slots = torch.from_numpy(
        rng.integers(0, C, size=n).astype(np.int32)).to(device)
    return values, slots


def lookup_operands(device, C: int = LOOKUP_SHAPE["C"],
                    n: int = LOOKUP_SHAPE["n"]):
    """An empty table of C slots and n ids of [1, C/2) (seed 0)."""
    import torch

    from deeprec_tpu_torch.embedding import hash_table as ht
    from deeprec_tpu_torch.utils import keys as keylib

    rng = np.random.default_rng(0)
    ids = rng.integers(1, C // 2, size=n).astype(np.int64)
    hi, lo = keylib.split_ids(ids)
    return (ht.create(C, device).key_rows,
            torch.from_numpy(hi).to(device), torch.from_numpy(lo).to(device))


def _line(job, kernel, rec, facts, **shape) -> dict:
    row = {"metric": "kernel_benchmark", "job": job, "kernel": kernel,
           **shape, "ms": rec["ms"], "plain_ms": rec["plain_ms"],
           "library_ms": rec.get("library_ms"), "bound_ms": rec["bound_ms"],
           "bound_by": "bytes",
           "pct_of_bound": round(100 * rec["bound_ms"] / rec["ms"], 1),
           "max_abs_err": rec["max_abs_err"], **facts}
    print(json.dumps(row), flush=True)
    return row


def run_job(job: str, arg=None) -> list:
    import torch

    import chip_smoke
    from model_benchmark_torch import card_facts

    dev = torch.device("cuda")
    facts = card_facts(dev)
    if job in ("apply", "adam"):
        kind = "adagrad" if job == "apply" else "adam"
        n = int(arg or 65536)
        values, tables, slots, grads = apply_operands(kind, n, dev)
        args = (ADAGRAD_ARGS if kind == "adagrad" else
                (torch.tensor([ADAM_ARGS[0]], device=dev),) + ADAM_ARGS[1:])
        rec = chip_smoke.compare_apply(kind, values, tables, slots, grads,
                                       None, None, args, f"kernel {job}",
                                       time_it=True, library=True)
        return [_line(job, f"{kind}_apply_rows", rec, facts,
                      C=values.shape[0] - 1, D=values.shape[1], n=n)]
    if job == "lookup":
        from deeprec_tpu_torch.embedding import hash_table as ht
        rows0, qhi, qlo = lookup_operands(dev)
        mask = torch.ones_like(qhi, dtype=torch.bool)
        ins = chip_smoke.compare_probe("kernel lookup", "insert", rows0, qhi,
                                       qlo, mask, 64)
        table = ht.HashTable(rows0.clone())
        _, slots, _ = ht.find_or_insert(table, qhi, qlo, mask)
        find = chip_smoke.compare_probe("kernel lookup", "find",
                                        table.key_rows, qhi, qlo, None, 64)
        C, n, D = LOOKUP_SHAPE["C"], qhi.numel(), LOOKUP_SHAPE["D"]
        values = torch.randn(C + 1, D, device=dev)
        fetch = chip_smoke.compare_gather("kernel lookup", values, slots)
        return [_line(job, "hash_probe_insert", ins, facts, C=C, n=n,
                      rounds=ins["rounds"]),
                _line(job, "hash_probe_find", find, facts, C=C, n=n),
                _line(job, "gather_rows", fetch, facts, C=C, n=n, D=D)]
    if job == "gather":
        D = int(arg or 128)
        values, slots = gather_operands(dev, D)
        rec = chip_smoke.compare_gather("kernel gather", values, slots)
        return [_line(job, "gather_rows", rec, facts, C=values.shape[0] - 1,
                      n=slots.numel(), D=D)]
    raise SystemExit(f"unknown job {job!r}; choose from "
                     f"{[j[0] for j in JOBS]}")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_benchmark_torch: no CUDA card (torch.cuda."
                         "is_available() is false); the kernels run only "
                         "there")
    if argv:
        return run_job(argv[0], argv[1] if len(argv) > 1 else None)
    # Each job in its own process: a clean card for each.
    for job in JOBS:
        r = subprocess.run([sys.executable, os.path.abspath(__file__), *job],
                           capture_output=True, text=True, timeout=900)
        for line in r.stdout.splitlines():
            if line.startswith("{"):
                print(line, flush=True)
        if r.returncode != 0:
            print(json.dumps({"metric": "kernel_benchmark", "job": job[0],
                              "error": (r.stderr.strip()
                                        or "nonzero exit")[-300:]}),
                  flush=True)


if __name__ == "__main__":
    main()
