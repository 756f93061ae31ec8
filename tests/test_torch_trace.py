"""Spans and counters inside the port (``utils/trace.py``), on the CPU.

* With no profiler, ``make_train_step`` and a CPU ``make_epoch_step``
  call record no span and no counter, and give the bits they give under
  ``torch.profiler.profile(activities=[CPU])``.
* Under the profiler every layer span of the step is kept with its
  parent, and the profiler's events hold each by the same name.
* The counters equal counts made apart from them over the same batches:
  each table's fresh rows its live keys' growth, its dropped ids the
  steps' ``n_overflow`` (a vocabulary past the unique budget), its P1
  rounds those ``hash_table.find_or_insert_reference(..., stats=)``
  reports on a copy of the table.
* The card's path of the epoch step, with the capture replaced by a
  direct call: each call keeps a record of its phases, the next call's
  record holds the release between them, and only a call made with
  tracing on carries counters, which cover all of its steps.

The ``cuda`` test of a real capture is ``tests/test_torch_trace_cuda.py``.
"""

import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from deeprec_tpu_torch import config as tcfg
from deeprec_tpu_torch.embedding import hash_table as ht
from deeprec_tpu_torch.feature_column import feature_column as tfc
from deeprec_tpu_torch.optimizers import dense as tdense
from deeprec_tpu_torch.optimizers import sparse as tsopt
from deeprec_tpu_torch.train import loop as tloop
from deeprec_tpu_torch.train import losses as tlosses
from deeprec_tpu_torch.utils import keys as keylib
from deeprec_tpu_torch.utils import trace

torch.set_num_threads(1)

B = 64
LIGHT = tcfg.EmbeddingVariableOption(record_freq=False,
                                     record_version=False)


def _group():
    """``a``: a 64-slot EV table, so inserts take straggler rounds;
    ``b``: a LightHeader EV table whose column declares 8 buckets, so
    its unique budget (64 of 128 ids a step) drops ids."""
    return tfc.EmbeddingGroup([
        tfc.NumericColumn("x"),
        tfc.EmbeddingColumn("a", dim=4, capacity=64),
        tfc.EmbeddingColumn("b", dim=4, capacity=256, num_buckets=8,
                            ev_option=LIGHT)])


def _apply(params, embs, batch):
    x = torch.cat([embs["a"], embs["b"], batch["x"][:, None]], dim=1)
    return x @ params["w"] + params["b"]


def _loss(out, batch):
    return tlosses.bce_with_logits(out, batch["label"])


def _batches(group, n, seed=0):
    r = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        raw = {"x": r.normal(size=B).astype(np.float32),
               "label": (r.random(B) < 0.5).astype(np.float32),
               "a": r.integers(0, 40, size=(B, 1)).astype(np.int64),
               "b": r.integers(0, 200, size=(B, 2)).astype(np.int64)}
        raw["b"][r.random((B, 2)) < 0.1] = -(2**63)  # EMPTY padding
        out.append(group.pack_batch_np(raw, "cpu"))
    return out


def _trainer():
    group = _group()
    params = {"w": torch.from_numpy(np.random.default_rng(1).normal(
        size=9).astype(np.float32)), "b": torch.zeros(())}
    sopt, dopt = tsopt.SparseAdagrad(0.05), tdense.Adagrad(0.05)
    ts = tloop.create_train_state(group, params, dopt, sopt, device="cpu")
    return group, ts, sopt, dopt


def _leaves(x, path=""):
    if isinstance(x, torch.Tensor):
        yield path, x
    elif isinstance(x, dict):
        for k, v in x.items():
            yield from _leaves(v, f"{path}/{k}")
    elif hasattr(x, "__dataclass_fields__"):
        for k in x.__dataclass_fields__:
            yield from _leaves(getattr(x, k), f"{path}.{k}")


def _run(kind, traced):
    """Three steps from a fresh state: ``make_train_step`` or one CPU
    ``make_epoch_step`` call; returns (losses, state, counters, spans
    kept, profiler or None)."""
    group, ts, sopt, dopt = _trainer()
    batches = _batches(group, 3)
    trace.recorder.take_counters()
    n_spans = len(trace.recorder.spans)
    prof = profile(activities=[ProfilerActivity.CPU]) if traced else None
    with prof if traced else contextlib.nullcontext():
        if kind == "train_step":
            step = tloop.make_train_step(group, _apply, _loss, sopt, dopt)
            losses = []
            for b in batches:
                ts, m = step(ts, b)
                losses.append(m["loss"])
            losses = torch.stack(losses)
        else:
            epoch = tloop.make_epoch_step(group, _apply, _loss, sopt, dopt)
            ts, losses = epoch(ts, tloop.stack_batches(batches))
    spans = list(trace.recorder.spans)[n_spans:]
    return losses, ts, trace.recorder.take_counters(), spans, prof


@pytest.mark.parametrize("kind", ["train_step", "epoch"])
def test_off_records_nothing_and_on_changes_no_bits(kind):
    calls = len(trace.recorder.calls)
    l_off, ts_off, c_off, s_off, _ = _run(kind, traced=False)
    assert c_off == {} and s_off == []
    assert len(trace.recorder.calls) == calls
    l_on, ts_on, c_on, s_on, _ = _run(kind, traced=True)
    assert c_on and s_on
    assert torch.equal(l_off, l_on)
    a, b = dict(_leaves(ts_off)), dict(_leaves(ts_on))
    assert set(a) == set(b)
    for p, t in a.items():
        assert torch.equal(t, b[p]), p


def test_layer_spans_under_the_profiler():
    _, _, _, spans, prof = _run("train_step", traced=True)
    want = {("lookup/a", None), ("lookup/b", None), ("forward", None),
            ("backward", None), ("dense_apply", None),
            ("sparse_apply/a", None), ("sparse_apply/b", None)}
    want |= {(child, f"lookup/{t}") for t in "ab"
             for child in ("probe", "draw", "fetch")}
    kept = {(s.name, s.parent) for s in spans}
    assert want <= kept
    assert all(s.start_ns <= s.end_ns and s.call is None for s in spans)
    assert sum(s.name == "forward" for s in spans) == 3
    events = {e.name for e in prof.events()}
    assert {name for name, _ in want} <= events


def test_counters_equal_independent_counts():
    group, ts, sopt, dopt = _trainer()
    step = tloop.make_train_step(group, _apply, _loss, sopt, dopt)
    cols = group._columns_by_table()
    fresh = {t: 0 for t in cols}
    rounds = {t: [] for t in cols}
    overflow = 0
    trace.recorder.take_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        for b in _batches(group, 4, seed=3):
            before = {t: int(ht.num_live(st.table))
                      for t, st in ts.ev.items()}
            for t, tcols in cols.items():
                hi, lo, _ = group._packed_view(b, t, tcols)
                hi, lo = hi.reshape(-1), lo.reshape(-1)
                stats = {}
                ht.find_or_insert_reference(
                    ht.HashTable(ts.ev[t].table.key_rows.clone()), hi, lo,
                    hi != keylib.EMPTY_HI, group.tables[t].max_probes,
                    stats=stats)
                rounds[t].append(stats["first_dead_round"]
                                 or stats["rounds"])
            ts, m = step(ts, b)
            overflow += int(m["n_overflow"])
            for t, st in ts.ev.items():
                fresh[t] += int(ht.num_live(st.table)) - before[t]
    got = {k: int(v) for k, v in trace.recorder.take_counters().items()}
    assert overflow > 0 and max(rounds["a"]) > 1
    for t in cols:
        assert got[f"{t}/steps"] == 4
        assert got[f"{t}/fresh_rows"] == fresh[t] > 0
        assert got[f"{t}/probe_rounds"] == sum(rounds[t])
        assert got[f"{t}/probe_rounds_max"] == max(rounds[t])
    assert got["a/dropped_ids"] + got["b/dropped_ids"] == overflow
    assert got["a/dropped_ids"] == 0


class _Event:
    def record(self):
        pass

    def synchronize(self):
        pass


def test_captured_path_records_each_call(monkeypatch):
    """``EpochStep``'s card path with the capture replaced by a direct
    call (as ``tests/test_torch_epoch.py`` runs it): a record a call, in
    ``last_run`` and in the recorder's history; counters only on the
    call made with tracing on, covering its E * K steps and equal to the
    eager loop's."""
    monkeypatch.setattr(tloop, "_capture", lambda fn, mesh=None: fn)
    monkeypatch.setattr(tloop, "_no_host_sync", contextlib.nullcontext)
    monkeypatch.setattr(torch.cuda, "Event", lambda **kw: _Event())
    group, ts, sopt, dopt = _trainer()
    pool = tloop.stack_batches(_batches(group, 3))
    epoch = tloop.make_epoch_step(group, _apply, _loss, sopt, dopt,
                                  n_epochs=2)
    first = epoch._captured(ts, pool, 3, 2, torch.device("cpu"))
    rec0 = epoch.last_run
    loop_ts = tloop.clone_state(ts)
    trace.recorder.take_counters()
    loop = tloop.make_epoch_step(group, _apply, _loss, sopt, dopt,
                                 n_epochs=2)
    with profile(activities=[ProfilerActivity.CPU]):
        loop(loop_ts, pool)
    want = {k: int(v) for k, v in trace.recorder.take_counters().items()}
    assert loop.last_run["captured"] is False
    assert rec0["counters"] is None and rec0["release_events"] is None
    assert {"epoch.step0", "epoch.capture.enter", "epoch.capture.record",
            "epoch.capture.instantiate"} <= set(rec0["host_ns"])
    with profile(activities=[ProfilerActivity.CPU]):
        second = epoch._captured(ts, pool, 3, 2, torch.device("cpu"))
    rec1 = epoch.last_run
    assert list(trace.recorder.calls)[-2:] == [rec0, rec1]
    assert rec1["call"] == rec0["call"] + 1 and rec1["replays"] == 5
    assert {"epoch.release.wait", "epoch.release.free"} <= set(
        rec1["host_ns"])
    assert len(rec1["release_events"]) == 2
    assert set(rec1["memory"]) == {"num_device_alloc", "num_device_free",
                                   "num_sync_all_streams"}
    assert {k: int(v) for k, v in rec1["counters"].items()} == want
    assert want["a/steps"] == 6
    assert torch.isfinite(first).all() and torch.isfinite(second).all()
