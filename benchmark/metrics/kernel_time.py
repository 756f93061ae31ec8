"""Shared arithmetic of the per-kernel metrics (not a metric itself: no
entry of ``BENCHMARK.json`` names it)."""


def ms_a_step(ctx, patterns):
    """Device ms a traced step of the kernels matching ``patterns``, or
    None where the trace holds none of them."""
    if ctx.trace is None or not ctx.traced_steps:
        return None
    us = ctx.trace.device_us(patterns)
    return us / 1e3 / ctx.traced_steps if us > 0 else None
