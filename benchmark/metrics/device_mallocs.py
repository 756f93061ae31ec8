"""``cudaMalloc`` calls of the caching allocator a window call adds: the
growth of ``torch.cuda.memory_stats()["num_device_alloc"]`` from the
release before the call to the call's end (``EpochStep``'s record), the
mean over the window's calls but the first (``epoch_records``). Each
release empties the allocator's cache, so step 0 and the capture
allocate anew."""

from benchmark.metrics.epoch_records import window_records


def read(ctx):
    recs = window_records(ctx)
    if not recs:
        return None
    return sum(r["memory"]["num_device_alloc"] for r in recs) / len(recs)
