"""Device ms of ``EpochStep.release()`` a window call: from the CUDA
event at the top of the release that ran before the call (the wait for
the previous call's replays, then dropping its graph and emptying the
allocator's cache) to the event at its end, the mean over the window's
calls but the first (``epoch_records``). The device idles from the
previous call's last replay until the host has freed the graph."""

from benchmark.metrics.epoch_records import mean_device_ms


def read(ctx):
    return mean_device_ms(ctx, lambda r: r["release_events"])
