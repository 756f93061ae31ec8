"""The readers of the port's pool-call records (``release_ms``,
``step0_ms``, ``capture_ms``, ``device_mallocs``, ``probe_rounds``) on
hand-made records: which records they match, the rule that leaves out
the window's first call, their arithmetic, and None where nothing
matches or the program keeps no records."""

import os
import sys
from types import SimpleNamespace

import pytest

from benchmark import manifest
from benchmark.tests.conftest import REPO
from deeprec_tpu_torch import utils
from deeprec_tpu_torch.utils import trace

NAMES = ("release_ms", "step0_ms", "capture_ms", "device_mallocs",
         "probe_rounds")


def _reader(name):
    return manifest.load_module(
        os.path.join(REPO, "benchmark", "metrics", name + ".py"),
        "benchmark_metric_" + name)


class Ev:
    """A CUDA event's stand-in: a time in ms."""

    def __init__(self, t):
        self.t = t

    def elapsed_time(self, other):
        return other.t - self.t


def _record(t, release, step0, capture, mallocs, counters=None):
    """A call whose release starts at ``t`` and lasts ``release`` ms,
    then ``step0`` and ``capture`` ms, then 100 ms of replays."""
    top, end = Ev(t), Ev(t + release)
    s0 = Ev(end.t + step0)
    e0 = Ev(s0.t + capture)
    return {"release_events": (top, end), "step0_event": s0,
            "events": (e0, Ev(e0.t + 100)), "counters": counters,
            "memory": {"num_device_alloc": mallocs, "num_device_free": 0,
                       "num_sync_all_streams": 0}}


@pytest.fixture
def recorder(monkeypatch):
    rec = trace.Recorder()
    monkeypatch.setattr(trace, "recorder", rec)
    return rec


def test_window_calls_but_the_first(recorder):
    recs = [_record(0, 500, 50, 60, 90), _record(300, 10, 20, 30, 7),
            _record(600, 30, 40, 50, 9)]
    other = _record(900, 1, 1, 1, 1)   # a call outside the window
    recorder.calls.extend(recs + [other])
    ctx = SimpleNamespace(calls=[{"end": r["events"][1]} for r in recs])
    got = {n: _reader(n).read(ctx) for n in NAMES}
    assert got == {"release_ms": 20.0, "step0_ms": 30.0, "capture_ms": 40.0,
                   "device_mallocs": 8.0, "probe_rounds": None}


def test_a_release_before_the_call_only(recorder):
    """A call after a call of one step (no graph to release) has no
    release: ``release_ms`` and ``step0_ms`` leave it out."""
    recs = [_record(0, 5, 5, 5, 1), _record(200, 10, 20, 30, 7),
            _record(400, 1, 1, 1, 3)]
    recs[2]["release_events"] = None
    recorder.calls.extend(recs)
    ctx = SimpleNamespace(calls=[{"end": r["events"][1]} for r in recs])
    assert _reader("release_ms").read(ctx) == 10.0
    assert _reader("step0_ms").read(ctx) == 20.0
    assert _reader("capture_ms").read(ctx) == 15.5
    assert _reader("device_mallocs").read(ctx) == 5.0


def test_none_where_nothing_matches(recorder):
    recorder.calls.extend([_record(0, 1, 1, 1, 1), _record(9, 1, 1, 1, 1)])
    ctx = SimpleNamespace(calls=[{"end": Ev(5)}, {"end": Ev(6)},
                                 {"end": None}])
    assert all(_reader(n).read(ctx) is None for n in NAMES)
    one = _record(20, 1, 1, 1, 1)
    recorder.calls.append(one)
    ctx = SimpleNamespace(calls=[{"end": one["events"][1]}])
    assert all(_reader(n).read(ctx) is None for n in NAMES)


def test_probe_rounds_from_the_counted_calls(recorder):
    counted = {"t1/probe_rounds": 10, "t1/probe_rounds_max": 4,
               "t1/steps": 5, "t1/fresh_rows": 3, "t2/probe_rounds": 6,
               "t2/steps": 5, "s/steps": 5, "probe_rounds": 99}
    recorder.calls.extend([_record(0, 1, 1, 1, 1, counters=counted),
                           _record(9, 1, 1, 1, 1)])
    ctx = SimpleNamespace(calls=[])
    assert _reader("probe_rounds").read(ctx) == 16 / 10


def test_none_without_the_recorder(monkeypatch, recorder):
    recorder.calls.append(_record(0, 1, 1, 1, 1, counters={
        "t/probe_rounds": 1, "t/steps": 1}))
    # As on a program without the module: the import fails.
    monkeypatch.delattr(utils, "trace")
    monkeypatch.setitem(sys.modules, "deeprec_tpu_torch.utils.trace", None)
    ctx = SimpleNamespace(calls=[{"end": recorder.calls[0]["events"][1]}])
    assert all(_reader(n).read(ctx) is None for n in NAMES)
