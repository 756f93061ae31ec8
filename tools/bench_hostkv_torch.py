"""Throughput of the port's host spill tier: ``HostKV`` put, get,
contains and delete in ids/s.

The port's copy of ``tools/bench_hostkv.py``, on
``deeprec_tpu_torch.embedding.multi_tier.HostKV``: ``n_ids`` distinct
ids below 2**40 (an ``accum`` slot row of the same width beside each
value row) put, got, asked about (half of the ids present, half absent:
the promotion's membership test) and deleted, in batches of 65,536 (a
promotion payload's size). Host code only: it runs on any machine and
touches no device.

Usage: python3 tools/bench_hostkv_torch.py [n_ids] [dim]
Prints one JSON line per operation, the host's CPU and core count in
the first.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

CHUNK = 65536


def run(n: int, dim: int) -> list:
    """The four operations' rows, each a dict with ``metric``, ``value``
    (ids/s) and ``unit``."""
    from deeprec_tpu_torch.embedding.multi_tier import HostKV

    kv = HostKV(dim, {"accum": (dim,)}, {"accum": np.float32})
    rng = np.random.default_rng(0)
    ids = rng.choice(np.int64(1) << 40, size=n, replace=False)
    vals = rng.normal(size=(n, dim)).astype(np.float32)
    ones = np.ones(n, np.int32)
    probe = np.concatenate([ids[: n // 2],
                            rng.integers(1 << 41, 1 << 42, n - n // 2)])

    def timed(fn, arr):
        t0 = time.perf_counter()
        for s in range(0, n, CHUNK):
            fn(arr[s:s + CHUNK], s)
        return n / (time.perf_counter() - t0)

    def put(part, s):
        sl = slice(s, s + CHUNK)
        kv.put_batch(part, vals[sl], ones[sl], ones[sl],
                     {"accum": vals[sl]})

    rows = [{"metric": "hostkv_put_ids_per_sec",
             "value": timed(put, ids), "unit": "ids/s", "n": n,
             "dim": dim, "host": platform.processor() or platform.machine(),
             "cpu_count": os.cpu_count()},
            {"metric": "hostkv_get_ids_per_sec",
             "value": timed(lambda p, s: kv.get_batch(p), ids),
             "unit": "ids/s"},
            {"metric": "hostkv_contains_ids_per_sec",
             "value": timed(lambda p, s: kv.contains_batch(p), probe),
             "unit": "ids/s"}]
    rows.append({"metric": "hostkv_delete_ids_per_sec",
                 "value": timed(lambda p, s: kv.delete_batch(p), ids),
                 "unit": "ids/s", "len_after": len(kv)})
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_ids", nargs="?", type=int, default=2_000_000)
    ap.add_argument("dim", nargs="?", type=int, default=16)
    args = ap.parse_args(argv)
    for row in run(args.n_ids, args.dim):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
