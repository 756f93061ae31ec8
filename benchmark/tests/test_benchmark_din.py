"""The DIN configuration (``configs/din_amazon_books.*``,
``reference/din_amazon_books.py``) and the readers of its cell.

* The cell at a test's size (``benchmark/tests/toy/``'s
  ``din_amazon_books.json`` and ``behavior_stream.json``, which the
  tests' tiny copy takes in place of the cell's: dim 18 and the
  published MLPs, histories of up to 5 items, small vocabularies) runs
  on the CPU to ``correct``, traced or not, and the bf16-row control and
  both faults fail it.
* The readers written for the cell, and the accepted ones it reads, on
  hand-made runs; the new ones None where a run holds nothing for them.
* The byte model of the combine (``combine_bytes``) on a hand-counted
  batch: padding appended to a sequence changes only its output term.
* On the card (``-m cuda``): the cell's pools drawn twice from one seed
  are equal bit for bit.
"""

import json
import os
import time
from types import SimpleNamespace

import pytest
import torch

from benchmark import calibrate, check, combine_bytes, devtrace, harness
from benchmark import manifest, roofline
from benchmark.reference import keys as keylib
from benchmark.tests.conftest import REPO, SEED
from deeprec_tpu_torch.utils import trace

CELL = "din_train_stream"
# The readers written for the DIN cell, and accepted ones it reads too.
NEW = ("combine_roofline_pct", "att_real_pct")
READERS = NEW + ("replay_step_ms", "combine_kernels_ms", "train_mfu")


def _cell(root, workload=CELL):
    return manifest.cell(root, workload,
                         bench_dir=os.path.join(root, "benchmark"))


@pytest.mark.parametrize("trace_on", [0, 1])
def test_toy_din_runs_correct(tiny_root, trace_on):
    """The cell at a test's size (``benchmark/tests/toy/``'s
    ``din_amazon_books.json`` and ``behavior_stream.json`` in the tiny
    copy) against the cell's own limits."""
    cell = _cell(tiny_root)
    assert cell.cfg["max_seq_len"] == 5
    assert set(READERS) <= {e["name"] for e, _ in cell.metrics_layer}
    assert "rows_backward_ms" not in {e["name"] for e, _ in
                                      cell.metrics_layer}
    r = harness.run_cell(cell, SEED, 0.3, bool(trace_on), "cpu",
                         time.perf_counter())
    assert r["correct"] is True and r["failed"] == 0
    assert r["attempted"] >= 5
    # On the CPU no per-layer reader but the host's finds a device trace,
    # a captured call or peaks.
    want = {"recapture_ms"} if trace_on else {"train_samples_per_s",
                                              "setup_s"}
    assert set(r["metrics"]) == want


def test_toy_din_control_and_faults_fail(tiny_root):
    cell = _cell(tiny_root)
    got = calibrate.readings(cell, SEED, ["program", "control", "half_batch",
                                          "no_update"], "cpu")
    assert {m: check.passes(n, cell.limits) for m, n in got.items()} == {
        "program": True, "control": False, "half_batch": False,
        "no_update": False}


def _reader(name):
    return manifest.load_module(
        os.path.join(REPO, "benchmark", "metrics", name + ".py"),
        "benchmark_metric_" + name)


def _din_cfg():
    with open(os.path.join(REPO, "benchmark", "configs",
                           "din_amazon_books.json")) as f:
        return json.load(f)


def _din_mod():
    return manifest.load_module(
        os.path.join(REPO, "benchmark", "configs", "din_amazon_books.py"),
        "benchmark_config_din_amazon_books")


def _trace(kernels):
    ev = [{"cat": "user_annotation", "name": "traced_window", "ph": "X",
           "ts": 0.0, "dur": 1000.0}]
    t = 0.0
    for name, dur in kernels:
        ev.append({"cat": "kernel", "name": name, "ph": "X", "ts": t,
                   "dur": dur})
        t += dur
    return devtrace.Trace(ev, ())


@pytest.fixture
def recorder(monkeypatch):
    rec = trace.Recorder()
    monkeypatch.setattr(trace, "recorder", rec)
    return rec


def test_readers_on_a_hand_made_run(recorder):
    ns = "void (anonymous namespace)::"
    tr = _trace([(ns + "occ_combine_fwd_kernel<false>(float const*)", 6.0),
                 (ns + "occ_long_kernel(int const*, long const*)", 4.0),
                 ("void at::native::indexing_backward_kernel<float>", 50.0),
                 ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n", 30.0)])
    tables = [{"dim": 18, "capacity": 1 << 22, "ids": 1000, "applied": 300,
               "key_rows": 0, "fresh": 0}]
    ctx = SimpleNamespace(
        cfg=_din_cfg(), cfg_mod=_din_mod(), batch=4, setup_s=1.0,
        samples=8000, window_s=2.0, trace=tr, traced_steps=2, tables=tables,
        peaks=roofline.PEAKS["NVIDIA H100 80GB HBM3"],
        calls=[{"replays_ms": 30.0, "steps": 4},
               {"replays_ms": 50.0, "steps": 6}])
    recorder.calls.extend([
        {"counters": {"din.attention/positions": 400,
                      "din.attention/real_positions": 204,
                      "t/probe_rounds": 3, "t/steps": 4}},
        {"counters": None}])
    got = {n: _reader(n).read(ctx) for n in READERS}
    assert got["replay_step_ms"] == (10.0 + 10.0) / 2
    assert got["combine_kernels_ms"] == pytest.approx(10.0 / 1e3 / 2)
    assert got["att_real_pct"] == 51.0
    # 6 x 788,280 MACs a sample x 8,000 samples over 2 s, of 989 TFLOP/s.
    assert got["train_mfu"] == pytest.approx(
        100 * 6 * 788_280 * 8000 / 2.0 / 989e12)
    # Bytes: 2 steps x 4 samples x (3 bags x 18 + 2 sequences x 50 x 18)
    # outputs x 4 B; 1,000 occurrences x (2 x 72 + 17 + 16) B; 300
    # distinct rows x 72 B. Over 10 us of occ_ kernels at 3.35 TB/s.
    nbytes = 4 * 8 * (3 * 18 + 100 * 18) + 1000 * 177 + 300 * 72
    assert got["combine_roofline_pct"] == pytest.approx(
        100 * nbytes / 3.35e12 / 10e-6)


def test_readers_find_nothing(recorder):
    ctx = SimpleNamespace(
        cfg=_din_cfg(), cfg_mod=_din_mod(), batch=4, setup_s=1.0,
        samples=0, window_s=2.0, trace=None, traced_steps=0, tables=None,
        peaks=None, calls=[])
    recorder.calls.append({"counters": {"t/probe_rounds": 3}})
    got = {n: _reader(n).read(ctx) for n in NEW}
    assert got == dict.fromkeys(NEW)
    # A trace without the occ_ kernels, as a program without them.
    ctx.trace = _trace([("indexing_backward_kernel", 5.0)])
    ctx.traced_steps, ctx.tables = 2, [{"dim": 18, "ids": 1, "applied": 1}]
    ctx.peaks = roofline.PEAKS["NVIDIA H100 80GB HBM3"]
    assert _reader("combine_roofline_pct").read(ctx) is None
    assert _reader("combine_kernels_ms").read(ctx) is None


def test_combine_bytes_hand_counted():
    """Two samples of a user bag and a 3-position history over one
    table of dim 4: keys 11 | 22 22 - and 33 | 22 - - (``-`` padding):
    5 occurrences, 3 distinct rows, 2 x (4 + 3 x 4) output elements."""
    E, dim = keylib.EMPTY_KEY, 4

    def count(width):
        keys = torch.tensor([[11] + [22, 22] + [E] * (width - 2),
                             [33] + [22] + [E] * (width - 1)])
        c = roofline.step_counts(keys.view(1, -1), 1 << 10)
        return combine_bytes.combine_bytes(
            [(dim, c["ids"], c["applied"])],
            combine_bytes.out_elements([(dim, 1), (dim, width)], 2))

    assert count(3) == 4 * 2 * 16 + 5 * (2 * 16 + 17 + 16) + 3 * 16
    # Two more padded positions a sample: only the outputs' zeros.
    assert count(5) - count(3) == 4 * dim * 2 * 2


@pytest.mark.cuda
def test_pools_drawn_twice_are_equal(cuda_device):
    cell = manifest.cell(REPO, CELL)
    rn = harness.Runner(cell, SEED, cuda_device)
    pools = [harness.Feed(cell, rn.tr, SEED, cuda_device, rn.K, 1).next()[0]
             for _ in range(2)]
    assert set(pools[0]) == set(pools[1])
    for k, v in pools[0].items():
        w = pools[1][k]
        pairs = zip(v, w) if isinstance(v, tuple) else [(v, w)]
        assert all(torch.equal(a, b) for a, b in pairs), k
