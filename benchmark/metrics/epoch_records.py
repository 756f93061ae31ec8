"""Shared reading of the port's pool-call records (not a metric itself:
no entry of ``BENCHMARK.json`` names it).

``deeprec_tpu_torch.utils.trace.recorder.calls`` keeps the record of
each captured call of ``EpochStep`` (its docstring lists the fields). A
window call's record is the one whose ``events[1]`` is the call's
``end`` event. A program without the recorder, or a run on the CPU,
gives no records, and the readers then return None."""


def _recorder():
    try:
        from deeprec_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.recorder


def window_records(ctx):
    """The records of the window's calls but the first, whose release
    ran before the window opened; [] where none matches."""
    rec = _recorder()
    if rec is None:
        return []
    by_end = {id(r["events"][1]): r for r in rec.calls if r.get("events")}
    out = []
    for c in ctx.calls[1:]:
        r = by_end.get(id(c.get("end")))
        if r is not None and r["events"][1] is c["end"]:
            out.append(r)
    return out


def mean_device_ms(ctx, interval):
    """Mean device ms, over :func:`window_records`, between the two CUDA
    events ``interval(record)`` gives (None: the record has no such
    interval); None where no record has one."""
    ms = []
    for r in window_records(ctx):
        pair = interval(r)
        if pair is not None:
            ms.append(pair[0].elapsed_time(pair[1]))
    return sum(ms) / len(ms) if ms else None


def counted_records():
    """The records that carry counters: calls made while tracing was on
    (a traced run's traced call)."""
    rec = _recorder()
    return [] if rec is None else [r for r in rec.calls if r.get("counters")]
