"""Spans and counters of the captured epoch step, on a card.

A captured call of K steps made with tracing on (a CPU-only
``torch.profiler`` session) counts, in its CUDA graph, what the same K
steps count run eagerly from a copy of the state; a call made with
tracing off keeps no counters and gives the traced call's bits; and for
each call after the first, the release, step 0 and the capture, each
between two CUDA events of the call's record, add up to no more than
the device's gap since the previous call's last replay.

It imports no JAX: ``python -m pytest --noconftest
tests/test_torch_trace_cuda.py -m cuda``. Without a card it skips.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from deeprec_tpu_torch.train import loop as tloop
from deeprec_tpu_torch.utils import trace

K = 4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _leaves(x, path=""):
    if isinstance(x, torch.Tensor):
        yield path, x
    elif isinstance(x, dict):
        for k, v in x.items():
            yield from _leaves(v, f"{path}/{k}")
    elif hasattr(x, "__dataclass_fields__"):
        for k in x.__dataclass_fields__:
            yield from _leaves(getattr(x, k), f"{path}.{k}")


def _ints(counters):
    return {k: int(v) for k, v in counters.items()}


@pytest.mark.cuda
def test_captured_counters_and_the_call_split(cuda_device):
    from deeprec_tpu_torch import bench

    tr = bench.build_small(cuda_device, batch=256)
    pool = [tr.next_batch() for _ in range(K)]
    stacked = tloop.stack_batches(pool)
    base = tloop.clone_state(tr.ts)

    eager = tloop.clone_state(base)
    step = tloop.make_train_step(tr.group, tr.apply_fn, tr.loss_fn,
                                 tr.sparse_opt, tr.dense_opt)
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.recorder.call_counters() as eager_counts:
            for b in pool:
                eager, _ = step(eager, b)
    want = _ints(eager_counts)
    assert want and all(v == K for k, v in want.items()
                        if k.endswith("/steps"))

    epoch = tloop.make_epoch_step(tr.group, tr.apply_fn, tr.loss_fn,
                                  tr.sparse_opt, tr.dense_opt)
    on = tloop.clone_state(base)
    with profile(activities=[ProfilerActivity.CPU]):
        on, l_on = epoch(on, stacked)
    rec_on = epoch.last_run
    off = tloop.clone_state(base)
    off, l_off = epoch(off, stacked)
    rec_off = epoch.last_run
    again = tloop.clone_state(base)
    again, _ = epoch(again, stacked)
    rec_again = epoch.last_run
    epoch.release()
    torch.cuda.synchronize()

    assert rec_on["replays"] == K - 1
    assert _ints(rec_on["counters"]) == want
    assert rec_off["counters"] is None and rec_again["counters"] is None
    assert torch.equal(l_on, l_off)
    a, b = dict(_leaves(on)), dict(_leaves(off))
    for p, t in a.items():
        assert torch.equal(t, b[p]), p
    assert list(trace.recorder.calls)[-3:] == [rec_on, rec_off, rec_again]

    for prev, rec in ((rec_on, rec_off), (rec_off, rec_again)):
        top, end = rec["release_events"]
        parts = (top.elapsed_time(end)
                 + end.elapsed_time(rec["step0_event"])
                 + rec["step0_event"].elapsed_time(rec["events"][0]))
        gap = prev["events"][1].elapsed_time(rec["events"][0])
        assert 0 < parts <= gap + 1e-3, (parts, gap)
        assert rec["memory"]["num_device_alloc"] >= 0
        assert {"epoch.release.wait", "epoch.release.free", "epoch.step0",
                "epoch.capture.enter", "epoch.capture.record",
                "epoch.capture.instantiate", "epoch.enqueue"} <= set(
                    rec["host_ns"])
