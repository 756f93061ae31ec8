"""The share of DIN's attention positions that hold a history item, in
%: the device counters ``din.attention/real_positions`` (the mask's sum)
over ``din.attention/positions`` (B x T, every position the attention
scores, padding included) of the calls made while tracing was on (a
traced run's traced call; eager step 0 and every replay add). A program
that scores only the real positions reads 100. None where no call
counted them, as in a program without the counters."""

from benchmark.metrics.epoch_records import counted_records

POSITIONS = "din.attention/positions"
REAL = "din.attention/real_positions"


def read(ctx):
    pos = real = 0
    for r in counted_records():
        c = r["counters"]
        if POSITIONS in c and REAL in c:
            pos += int(c[POSITIONS])
            real += int(c[REAL])
    return 100.0 * real / pos if pos else None
