"""Each cell runs at a tiny size on the CPU, prints a line of the
contract's shape, and loads neither JAX nor the JAX package."""

import json
import os
import subprocess
import sys
import time

import pytest

from benchmark import harness, manifest
from benchmark.tests.conftest import REPO, SEED, TOY

WORKLOADS = [w["name"] for w in manifest.manifest(REPO)["workloads"]]
# The repository's cells and the test cell of sequence columns.
TINY = WORKLOADS + [TOY]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", TINY)
def test_tiny_run_prints_contract_line(tiny_root, workload, trace, capsys):
    cell = manifest.cell(tiny_root, workload,
                         bench_dir=os.path.join(tiny_root, "benchmark"))
    result = harness.run_cell(cell, SEED, 0.3, bool(trace), "cpu",
                              time.perf_counter())
    harness.print_result(result)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[-1] == "check"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 5
    for v in line["check"].values():
        assert set(v) == {"value", "limit"} and v["value"] <= v["limit"]
    assert err.strip().splitlines()[-1].startswith("check keys_gap")
    want = {e["name"] for e, _ in (cell.metrics_layer if trace
                                   else cell.metrics_e2e)}
    # The CPU has no device trace, peaks or kernels: those readers find
    # nothing and their metrics are left out.
    cpu_layer = {"recapture_ms"}
    assert set(line["metrics"]) == (want & cpu_layer if trace else want)
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    assert line["device"]["count"] == 1
    if trace:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


SCRIPT = """
import sys, time
sys.path.insert(0, {repo!r})
sys.path.insert(0, {tiny!r})
from benchmark import harness, manifest
from benchmark.run import forbidden_loaded
for w in {workloads!r}:
    cell = manifest.cell({tiny!r}, w, bench_dir={bench!r})
    harness.run_cell(cell, 7, 0.1, True, "cpu", time.perf_counter())
print(forbidden_loaded())
"""


def test_no_jax_after_a_run(tiny_root):
    code = SCRIPT.format(repo=REPO, tiny=tiny_root, workloads=TINY,
                         bench=os.path.join(tiny_root, "benchmark"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=tiny_root)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"


def test_no_result_without_a_card():
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        WORKLOADS[0], "--seed", "1", "--seconds", "1"],
                       capture_output=True, text=True, timeout=300,
                       cwd=REPO, env={**os.environ,
                                      "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0 and r.stdout.strip() == ""
