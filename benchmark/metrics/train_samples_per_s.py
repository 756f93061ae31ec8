"""Samples of every step completed in the window over the window's
seconds (from a CUDA event before the first pool call to the end of the
last call's replays)."""


def read(ctx):
    return ctx.samples / ctx.window_s
