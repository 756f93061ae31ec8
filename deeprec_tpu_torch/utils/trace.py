"""Spans and counters inside the port: the program side of the profiler.

The port's own module, with no counterpart in the JAX package. It adds
named host spans and device counters to what ``torch.profiler`` records
(``train/estimator.ProfilerHook``'s Chrome trace, or any other session),
and keeps the records of the captured epoch's pool calls
(``train/loop.EpochStep``).

* :func:`span` ``(name, table=None)``: a context. While tracing is on it
  keeps ``(name, parent, call, start_ns, end_ns)`` in
  ``recorder.spans`` (host ``time.perf_counter_ns()``; ``call`` is the
  sequence number of the pool call it ran in, or None) and enters
  ``torch.profiler.record_function(name)``, so the span lies in the
  profiler's trace on the clock of the device operations it launched.
  A span given a ``table`` files the counters counted inside it under
  ``<table>/<name>``.
* :func:`count` ``(name, value, reduce="sum")``: adds a 0-dim tensor or
  an int into a 0-dim int64 accumulator of ``recorder.counters`` in
  place (``reduce="max"``: keeps the larger). The accumulator is made on
  first use, which must not be inside a CUDA graph capture; then a
  captured step's counts are kernels of the graph, and every replay
  adds. Read the counters only after the call that counts.
* The switch, :func:`on`: tracing is on while a ``torch.profiler``
  session records in this process. Off, ``span`` returns one shared
  no-op context after that check and ``count`` returns at once, so a
  step counts nothing and a graph captured then holds no counter op.
* :class:`Phases`: back-to-back host phases of a pool call, always
  timed; while tracing is on each is also a span.

``recorder.calls`` keeps the records of the last 1,024 captured pool
calls (``EpochStep.last_run``); a reader finds a call's record by the
identity of its ``events[1]``.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Any, Dict, NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler

MAX_SPANS = 1 << 16
MAX_CALLS = 1024

_OFF = contextlib.nullcontext()


def on() -> bool:
    """Whether tracing is on: a ``torch.profiler`` session is recording
    in this process."""
    return _profiler._is_profiler_enabled


class Span(NamedTuple):
    name: str
    parent: Optional[str]
    call: Optional[int]
    start_ns: int
    end_ns: int


class Recorder:
    """What tracing keeps: ``spans`` (the last ``MAX_SPANS``),
    ``counters`` (name -> 0-dim int64 tensor), ``calls`` (the last
    ``MAX_CALLS`` pool-call records) and ``call``, the sequence number
    of the pool call in progress (None between calls)."""

    def __init__(self):
        self.spans = collections.deque(maxlen=MAX_SPANS)
        self.calls = collections.deque(maxlen=MAX_CALLS)
        self.counters: Dict[str, torch.Tensor] = {}
        self.call: Optional[int] = None
        self._calls_begun = 0
        self._open: list = []   # (name, table) of the open spans

    def next_call(self) -> int:
        """The sequence number of a pool call that begins now."""
        self._calls_begun += 1
        return self._calls_begun

    def take_counters(self) -> Dict[str, torch.Tensor]:
        """The counters counted so far; counting starts anew."""
        out, self.counters = self.counters, {}
        return out

    @contextlib.contextmanager
    def call_counters(self):
        """A fresh counter set for the body, yielded (None while tracing
        is off); the counters outside it are kept apart and restored."""
        if not on():
            yield None
            return
        outer, self.counters = self.counters, {}
        try:
            yield self.counters
        finally:
            self.counters = outer

    @contextlib.contextmanager
    def span(self, name: str, table: Optional[str] = None):
        parent = self._open[-1] if self._open else (None, None)
        self._open.append((name, table if table is not None else parent[1]))
        t0 = time.perf_counter_ns()
        try:
            with torch.profiler.record_function(name):
                yield
        finally:
            self._open.pop()
            self.spans.append(Span(name, parent[0], self.call, t0,
                                   time.perf_counter_ns()))

    def count(self, name: str, value, reduce: str, device,
              table: Optional[str] = None) -> None:
        if table is None and self._open:
            table = self._open[-1][1]
        key = f"{table}/{name}" if table is not None else name
        acc = self.counters.get(key)
        if acc is None:
            dev = value.device if isinstance(value, torch.Tensor) else device
            if dev is not None and torch.device(dev).type == "cuda" and \
                    torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    f"counter {key!r} first counted inside a CUDA graph "
                    "capture: count it once eagerly before capturing")
            acc = torch.zeros((), dtype=torch.int64, device=dev)
            self.counters[key] = acc
        if reduce == "sum":
            acc.add_(value)
        elif reduce == "max":
            if isinstance(value, torch.Tensor):
                torch.maximum(acc, value.reshape(()), out=acc)
            else:
                acc.clamp_(min=value)
        else:
            raise ValueError(f"reduce {reduce!r}: sum | max")


recorder = Recorder()


def span(name: str, table: Optional[str] = None):
    """A host span named ``name`` while tracing is on; a no-op context
    otherwise. See the module docstring."""
    if not on():
        return _OFF
    return recorder.span(name, table)


def count(name: str, value, reduce: str = "sum", device=None,
          table: Optional[str] = None) -> None:
    """Add ``value`` (a tensor of one element or an int; an int's
    accumulator lives on ``device``, the CPU by default) into the counter
    ``name`` while tracing is on; ``table`` files it under
    ``<table>/<name>`` outside that table's span. See the module
    docstring."""
    if not on():
        return
    recorder.count(name, value, reduce, device, table)


def counted(fn):
    """``(fn(), counters)``: ``fn`` run under a CPU-only
    ``torch.profiler`` session, so with tracing on, and the counters it
    counted (a set of its own). For checks and tools."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts):
        with recorder.call_counters() as counters:
            out = fn()
    return out, counters


class Phases:
    """Back-to-back host phases of one pool call. ``next(name)`` ends the
    phase running, adds its ``time.perf_counter_ns()`` to
    ``ns[phase]``, and starts ``name``; ``stop()`` ends the last one.
    While tracing is on each phase is also a span of pool call
    ``call``."""

    def __init__(self, ns: Dict[str, int], call: Optional[int]):
        self.ns = ns
        self.call = call
        self._name: Optional[str] = None
        self._t = 0
        self._span: Any = None

    def next(self, name: Optional[str]) -> None:
        t = time.perf_counter_ns()
        if self._name is not None:
            self.ns[self._name] = self.ns.get(self._name, 0) + t - self._t
            if self._span is not None:
                self._span.__exit__(None, None, None)
                self._span = None
            recorder.call = None
        self._name = name
        if name is not None:
            recorder.call = self.call
            if on():
                self._span = recorder.span(name)
                self._span.__enter__()
            self._t = time.perf_counter_ns()

    def stop(self) -> None:
        self.next(None)
