"""K2's least time over its measured time, in %: the bytes the traced
steps' sparse Adagrad applies need (``roofline.apply_bytes``: 20 bytes
an element of an applied row that held a value, 16 of a new one, 6 an
applied row; applied rows are each step's distinct keys, new ones the
keys the tables gained over the traced calls) at the card's peak memory
rate, over the device time of K2's kernel in the trace."""

from benchmark import roofline

PATTERNS = (r"apply_kernel<.*AdagradOp",)


def read(ctx):
    if ctx.trace is None or not ctx.tables or ctx.peaks is None:
        return None
    us = ctx.trace.device_us(PATTERNS)
    if us <= 0:
        return None
    nbytes = sum(roofline.apply_bytes(t["dim"], t["applied"], t["fresh"])
                 for t in ctx.tables)
    return 100.0 * nbytes / ctx.peaks["hbm_bytes"] / (us / 1e6)
