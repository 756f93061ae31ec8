"""Host ms a pool call of the window spends on eager step 0 and the
capture: the call's wall time less its wait for the previous call's
replays (``EpochStep.release()``, timed by the harness) and less the
replays' enqueue (``EpochStep.last_run["enqueue_s"]``), the mean over
the window's calls."""

from benchmark.harness import recapture_s


def read(ctx):
    if not ctx.calls:
        return None
    return 1e3 * sum(recapture_s(c) for c in ctx.calls) / len(ctx.calls)
