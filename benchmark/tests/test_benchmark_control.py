"""The correctness check fails what it must: the control (the reference
with its table rows in bfloat16, in the program's place) and a broken
timed path (half of each batch left out; a step that moves no
parameter) come out not correct against each cell's limits, and a sound
run comes out correct. On the CPU at a tiny size; the cuda test reads
the same on the card, through the port's kernels."""

import os
import time

import pytest

from benchmark import calibrate, check, harness, manifest
from benchmark.tests.conftest import REPO, SEED, TOY

WORKLOADS = [w["name"] for w in manifest.manifest(REPO)["workloads"]]
# The repository's cells and the test cell of sequence columns.
TINY = WORKLOADS + [TOY]
MODES = ["program", "control", "half_batch", "no_update"]


def _cell(root, workload):
    return manifest.cell(root, workload,
                         bench_dir=os.path.join(root, "benchmark"))


def _verdicts(cell, device):
    got = calibrate.readings(cell, SEED, MODES, device)
    return {m: check.passes(n, cell.limits) for m, n in got.items()}


@pytest.mark.parametrize("workload", TINY)
def test_control_and_faults_fail(tiny_root, workload):
    assert _verdicts(_cell(tiny_root, workload), "cpu") == {
        "program": True, "control": False, "half_batch": False,
        "no_update": False}


@pytest.mark.parametrize("workload", TINY)
def test_broken_timed_path_is_not_correct(tiny_root, workload, monkeypatch):
    """A whole run, the look for a card skipped, with the step's loss
    taken over half of each batch."""
    loss = harness._loss
    monkeypatch.setattr(harness, "_loss", lambda fault: loss("half_batch"))
    r = harness.run_cell(_cell(tiny_root, workload), SEED, 0.2, False,
                         "cpu", time.perf_counter())
    assert r["correct"] is False
    assert r["check"]["grad_gap"]["value"] > r["check"]["grad_gap"]["limit"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", TINY)
def test_control_and_faults_fail_on_the_card(cuda_device, tiny_root,
                                             workload):
    assert _verdicts(_cell(tiny_root, workload), "cuda") == {
        "program": True, "control": False, "half_batch": False,
        "no_update": False}
