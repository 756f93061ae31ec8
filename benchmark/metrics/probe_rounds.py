"""P1's rounds a step (the fast round counts 1), from the device counters
a call made while tracing was on (a traced run's traced call) keeps:
each table's ``<table>/probe_rounds``, which the insert kernel adds into
at eager step 0 and at every replay of the captured step, over the
table's ``<table>/steps``; the mean over those calls' steps and the
tables that probe."""

from benchmark.metrics.epoch_records import counted_records


def read(ctx):
    rounds = steps = 0
    for r in counted_records():
        c = r["counters"]
        for key, v in c.items():
            table, _, name = key.rpartition("/")
            if name == "probe_rounds" and table:
                rounds += int(v)
                steps += int(c[table + "/steps"])
    return rounds / steps if steps else None
