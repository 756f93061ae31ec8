"""The harness's per-column forms leave the accepted cells as they were:
the tiny WDL and DLRM pools (every tensor of ``Feed.next(keep=3)``) and
their reference readings hash to the digests recorded on the commit
before the forms came in, when ``keep`` gave the ids as one [3, B, 26]
matrix (here: the columns' [3, B, 1] matrices side by side, the same
bytes). One thread, since a CPU reduction's order follows the thread
count."""

import hashlib
import json
import os

import pytest
import torch

from benchmark import check, harness, manifest
from benchmark.tests.conftest import SEED
from deeprec_tpu_torch.feature_column.feature_column import SparseIds

DIGESTS = {
    "dlrm_train_stream": (
        "4fc26a7041a2bcc47a5864db33bec5d929d57dc12f6209e97c7c1b00d808c919",
        "0000d5bfaa6786892e671aeb633e0e348785a8bfac762688414721444107e6da"),
    "wdl_train_epochs": (
        "d83e14ca64038eaef92340a56d48a16c7b51d8f30d854103a917b10b2f4cd052",
        "bd66edf5f2b72bab80669b3296b01573412a177844904c18e435f8ac3c2252ca"),
}


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sha(tensors) -> str:
    h = hashlib.sha256()
    for name, t in tensors:
        h.update(name.encode())
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("workload", sorted(DIGESTS))
def test_pools_and_readings_as_before(tiny_root, workload, one_thread):
    cell = manifest.cell(tiny_root, workload,
                         bench_dir=os.path.join(tiny_root, "benchmark"))
    rn = harness.Runner(cell, SEED, "cpu")
    pool, raw = rn.feed.next(keep=3)
    tensors = [(k, t) for k in sorted(pool)
               for t in (pool[k] if isinstance(pool[k], SparseIds)
                         else (pool[k],))]
    tensors += [("", torch.cat([raw["ids"][c.name] for c in rn.tr.columns],
                               dim=2)),
                ("", raw["ints"]), ("", raw["labels"])]
    readings = check.reference_readings(
        cell, {"first": raw, "dense0": rn.tr.dense0}, torch.device("cpu"))
    got = (_sha(tensors), hashlib.sha256(
        json.dumps(readings, sort_keys=True).encode()).hexdigest())
    assert got == DIGESTS[workload]
