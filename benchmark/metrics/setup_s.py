"""Seconds from the start of the process to the window's first call:
imports, kernel loads (built into the checkout's ``build/kernels`` on a
first run), tables, weights and the first pool made on the card from the
seed, the checked steps and the warm-up call."""


def read(ctx):
    return ctx.setup_s
