"""Device ms of a window call's eager step 0: from the CUDA event at the
end of the release before it to the event at step 0's end (the call's
own set-up and anything the caller ran after the release included), the
mean over the window's calls but the first (``epoch_records``)."""

from benchmark.metrics.epoch_records import mean_device_ms


def read(ctx):
    return mean_device_ms(ctx, lambda r: None if r["release_events"] is None
                          else (r["release_events"][1], r["step0_event"]))
