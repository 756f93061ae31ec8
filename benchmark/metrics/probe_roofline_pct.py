"""P1's least time over its measured time, in %: the bytes the traced
steps' probes need (``roofline.probe_bytes``: a 512-byte key row for
each distinct row where a probe starts, 14 bytes an id, counted from
the traced pools' own keys) at the card's peak memory rate, over the
device time of P1's kernels (``csrc/hash_probe.cu``) in the trace."""

from benchmark import roofline

PATTERNS = (r"\bfast_kernel\b", r"\bround_kernel\b", r"\bresolve_kernel\b")


def read(ctx):
    if ctx.trace is None or not ctx.tables or ctx.peaks is None:
        return None
    us = ctx.trace.device_us(PATTERNS)
    if us <= 0:
        return None
    nbytes = sum(roofline.probe_bytes(t["key_rows"], t["ids"])
                 for t in ctx.tables)
    return 100.0 * nbytes / ctx.peaks["hbm_bytes"] / (us / 1e6)
