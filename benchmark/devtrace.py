"""Device trace of a window: kernels, busy time and idle gaps.

Frozen yardstick. ``torch.profiler`` records the traced calls (host and
CUDA activity); the trace is exported as Chrome JSON into a new
directory under ``$TMPDIR``, read back and removed. Device operations
are the trace's ``kernel``, ``gpu_memcpy`` and ``gpu_memset`` events that
start inside the traced window, which opens at the benchmark's
``traced_window`` span and closes at the later of its end and the last
device operation's. Busy time is the length of the union of their
intervals (the arithmetic of ``tools/profile_train_torch.py``'s
``device_split``); an idle gap is a stretch of the window that no device
operation covers, named by the innermost benchmark span the host was in
when it began.
"""

from __future__ import annotations

import collections
import json
import os
import re
import shutil
import tempfile
from typing import Callable, Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_SPAN = "traced_window"
TOP = 10


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merged, sorted intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class Trace:
    """The reduced trace: ``ops`` (name, start us, duration us) of the
    device operations in the window, ``window_us``, ``busy_us``,
    ``gaps`` (label, us) longest first."""

    def __init__(self, events: List[Dict], spans: Tuple[str, ...]):
        win = [e for e in events if e.get("cat") == "user_annotation"
               and e.get("name") == WINDOW_SPAN]
        if not win:
            raise ValueError(f"the trace holds no {WINDOW_SPAN!r} span")
        t0 = win[0]["ts"]
        self.ops = [(e["name"], float(e["ts"]), float(e["dur"]))
                    for e in events if e.get("cat") in DEVICE_CATS
                    and e.get("ph") == "X" and e["ts"] >= t0]
        t1 = max([win[0]["ts"] + win[0]["dur"]]
                 + [s + d for _, s, d in self.ops])
        self.window_us = t1 - t0
        busy = union([(s, s + d) for _, s, d in self.ops])
        self.busy_us = sum(e - s for s, e in busy)
        host = sorted((e["ts"], e["ts"] + e["dur"], e["name"])
                      for e in events if e.get("cat") == "user_annotation"
                      and e.get("name") in spans)
        edges = [t0] + [x for se in busy for x in se] + [t1]
        self.gaps = sorted(
            ((self._label(host, s), e - s)
             for s, e in zip(edges[::2], edges[1::2]) if e > s),
            key=lambda g: -g[1])

    @staticmethod
    def _label(host, t: float) -> str:
        best = None
        for s, e, name in host:
            if s > t:
                break
            if t <= e and (best is None or s >= best[0]):
                best = (s, name)
        return best[1] if best else "outside spans"

    def device_us(self, patterns) -> float:
        """Device microseconds of the operations whose name matches any
        of the regular expressions ``patterns``."""
        rxs = [re.compile(p) for p in patterns]
        return sum(d for name, _, d in self.ops
                   if any(r.search(name) for r in rxs))

    def by_name(self) -> Dict[str, float]:
        """Device microseconds by operation name."""
        c: Dict[str, float] = collections.Counter()
        for name, _, d in self.ops:
            c[name] += d
        return dict(c)

    def breakdown(self) -> Dict[str, list]:
        ops = sorted(self.by_name().items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n, d / 1e6] for n, d in ops],
                "idle_gaps": [[n, d / 1e6] for n, d in self.gaps[:TOP]]}


def record(fn: Callable[[], None], spans: Tuple[str, ...]) -> Trace:
    """Run ``fn`` under the profiler inside the window span and return
    its reduced trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(WINDOW_SPAN):
            fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    d = tempfile.mkdtemp(prefix="bench_trace_")
    try:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return Trace(events, spans)
