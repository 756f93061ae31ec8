"""The share of the traced window, in %, in which no device operation
ran: 100 less the union of the device operations' intervals over the
window's length (``devtrace``)."""


def read(ctx):
    if ctx.trace is None or ctx.trace.busy_us <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_us / ctx.trace.window_us)
