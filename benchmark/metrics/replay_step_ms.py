"""Device ms a replayed step: the captured step's replays of each call
of the window, between the CUDA events ``EpochStep`` records around them,
over the replays, the mean over the calls. Steadier than the window's
rate, which also holds each call's re-capture and the host's stalls."""


def read(ctx):
    calls = [c for c in ctx.calls if "replays_ms" in c and c["steps"] > 1]
    if not calls:
        return None
    return sum(c["replays_ms"] / (c["steps"] - 1) for c in calls) / len(calls)
