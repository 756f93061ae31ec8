"""Fixtures of the benchmark's own tests: a copy of the benchmark with
its configurations and mixes cut to a size the CPU runs in seconds.

Run them from the root of the repository:

    python -m pytest benchmark/tests -q
    python -m pytest benchmark/tests -m cuda -q     # on a CUDA card
"""

import json
import os
import shutil

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SEED = 2 ** 31 + 12345


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skipped where there is none")


def _edit(path, **changes):
    with open(path) as f:
        d = json.load(f)
    for k, v in changes.items():
        if isinstance(v, dict):
            d[k].update(v)
        else:
            d[k] = v
    with open(path, "w") as f:
        json.dump(d, f)


def make_tiny(dst: str) -> str:
    """A copy of ``BENCHMARK.json`` and ``benchmark/`` under ``dst`` at
    tiny sizes: batches of 64, pools of 5, small vocabularies, tables and
    towers (every width of the JSON is cut, which the real cells never
    do), with the test cell ``TOY`` added. Returns the copy's root."""
    shutil.copytree(os.path.join(REPO, "benchmark"),
                    os.path.join(dst, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), dst)
    b = os.path.join(dst, "benchmark")
    _edit(os.path.join(b, "configs", "wdl_criteo.json"),
          hash_bucket_sizes=[50 + 7 * i for i in range(26)],
          dnn_hidden_units=[32, 16], batch_size=64,
          table={"capacity_ceiling": 1024})
    _edit(os.path.join(b, "configs", "dlrm_mlperf.json"),
          num_embeddings_per_feature=[3 + 11 * i for i in range(26)],
          arch_sparse_feature_size=16, arch_mlp_bot=[13, 32, 16],
          arch_mlp_top=[32, 16, 1], batch_size=64)
    for t in ("stream", "epochs"):
        _edit(os.path.join(b, "traffic", t + ".json"), pool_batches=5)
    add_toy(dst)
    return dst


TOY = "toy_seq_train"


def add_toy(root: str) -> None:
    """Enter the test configuration ``toy_seq`` and its cell ``TOY``
    (``benchmark/tests/toy/``: sequence, shared-table and padded-bag
    columns over behavior traffic) into the copy at ``root``."""
    toy = os.path.join(REPO, "benchmark", "tests", "toy")
    for sub in os.listdir(toy):
        for f in os.listdir(os.path.join(toy, sub)):
            shutil.copy(os.path.join(toy, sub, f),
                        os.path.join(root, "benchmark", sub, f))
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        m = json.load(f)
    m["configs"].append({
        "name": "toy_seq", "source": "benchmark/tests/toy",
        "file": "benchmark/configs/toy_seq.json", "reduced": [],
        "why": "the harness's sequence, shared-table and padded-bag forms"})
    m["workloads"].append({
        "name": TOY, "config": "toy_seq", "traffic": "toy_behavior",
        "chips": 1, "why": "a test cell: histories of 1-5 items"})
    for e in m["per_layer"] + m["end_to_end"]:
        if "workloads" in e:
            e["workloads"].append(TOY)
    with open(path, "w") as f:
        json.dump(m, f)


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny(str(tmp_path))


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
