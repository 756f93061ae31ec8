"""Device ms of a window call's capture: from the CUDA event at eager
step 0's end to the one before the first replay (``events[0]``), while
the host enters ``torch.cuda.graph``, records the step and instantiates
the graph; the mean over the window's calls but the first
(``epoch_records``)."""

from benchmark.metrics.epoch_records import mean_device_ms


def read(ctx):
    return mean_device_ms(ctx, lambda r: (r["step0_event"], r["events"][0]))
