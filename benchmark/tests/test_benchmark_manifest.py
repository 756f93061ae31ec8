"""``BENCHMARK.json`` loads, every file it names is found by name, and a
configuration, a mix, a metric and a cell are added with new files only."""

import hashlib
import json
import math
import os
import re
import time

import pytest

from benchmark import harness, manifest
from benchmark.tests.conftest import REPO, SEED

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    return manifest.manifest(REPO)


def test_manifest_shape():
    m = _bench()
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert m["command"][:2] == ["python3", "benchmark/run.py"]
    assert m["paths"] == ["benchmark"]
    assert 1 <= m["run_seconds"] <= 51
    n = 24
    assert (2 + 14 * n) * (m["run_seconds"] + 60) + n * 180 + 1200 <= 43200
    names = set()
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/configs/")
        assert not any(k.endswith(("_dim", "_rank", "_size")) and k !=
                       "batch_size" for k in c["reduced"])
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in m[group]:
            assert NAME.match(e["name"]) and e["name"] not in names
            names.add(e["name"])
            if "why" in e:
                assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]
    e2e = {e["name"] for e in m["end_to_end"]}
    assert "setup_s" in e2e
    for e in m["end_to_end"]:
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        assert 0.01 <= e["bound"] <= 0.25
        assert e["source"] in ("host_clock", "device_trace")
    for e in m["per_layer"]:
        assert UNIT.match(e["unit"]) and e["moves"] in e2e
        assert set(e) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)


@pytest.mark.parametrize("workload", [w["name"] for w in
                                      manifest.manifest(REPO)["workloads"]])
def test_every_file_found_by_name(workload):
    cell = manifest.cell(REPO, workload)
    assert callable(cell.cfg_mod.columns) and callable(cell.ref_mod.forward)
    assert cell.traffic["mode"] in ("stream", "epochs")
    assert {e["name"] for e, _ in cell.metrics_e2e} == {
        "train_samples_per_s", "setup_s"}
    assert all(callable(mod.read) for _, mod in cell.metrics_layer)
    assert set(cell.limits) == set(harness.check.ORDER)


def _digests(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_added_by_new_files_only(tiny_root):
    """A new mix, a new metric and a new cell: new files and entries, no
    file of the copy edited, and the new cell runs with the new metric."""
    b = os.path.join(tiny_root, "benchmark")
    before = _digests(b)
    with open(os.path.join(b, "traffic", "stream.json")) as f:
        mix = json.load(f)
    mix["zipf_a"] = 1.05
    with open(os.path.join(b, "traffic", "stream_flat.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(b, "metrics", "steps_per_s.py"), "w") as f:
        f.write("def read(ctx):\n"
                "    return ctx.samples / ctx.batch / ctx.window_s\n")
    with open(os.path.join(b, "limits", "wdl_train_flat.json"), "w") as f:
        json.dump({"loss_gap": 1e-3, "grad_gap": 1e-2, "change_gap": 1e-2,
                   "keys_gap": 0}, f)
    path = os.path.join(tiny_root, "BENCHMARK.json")
    with open(path) as f:
        m = json.load(f)
    m["workloads"].append({"name": "wdl_train_flat", "config": "wdl_criteo",
                           "traffic": "stream_flat", "chips": 1,
                           "why": "flatter ids"})
    m["end_to_end"].append({"name": "steps_per_s", "unit": "steps/s",
                            "better": "higher", "bound": 0.05,
                            "source": "host_clock",
                            "workloads": ["wdl_train_flat"]})
    with open(path, "w") as f:
        json.dump(m, f)
    after = _digests(b)
    assert all(after[k] == v for k, v in before.items())
    cell = manifest.cell(tiny_root, "wdl_train_flat", bench_dir=b)
    r = harness.run_cell(cell, SEED, 0.2, False, "cpu", time.perf_counter())
    assert r["correct"]
    assert math.isfinite(r["metrics"]["steps_per_s"]["value"])
