"""Host-side staged prefetch: the ``tf.staged`` / SmartStage role.

Port of ``deeprec_tpu/data/prefetch.py``. Worker threads run an input
pipeline (parse, pack) ahead of the training step behind a bounded
queue, and land each batch on the card before the step asks for it.
The JAX worker's ``jax.device_put`` becomes, per batch: a copy of each
tensor into pinned host memory (a small ring of buffers, reused once
the copy out of them has finished), a ``non_blocking`` host-to-device
copy on a side CUDA stream, and an event. The consumer's stream waits
on that event before the batch is used, and each device tensor is
marked with ``Tensor.record_stream`` so the caching allocator does not
reuse its memory while the consumer's stream may still read it.

Unlike the JAX package, a worker's exception is re-raised in the
consumer (after the items the worker produced before it).
"""

from __future__ import annotations

import itertools
import queue
import threading
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

_DONE = object()
_RING = 2  # pinned buffer sets per worker


class _Failure:
    def __init__(self, exc: BaseException):
        self.exc = exc


def _map(fn, item):
    """Apply ``fn`` to every tensor leaf of a batch (dicts, tuples and
    NamedTuples such as ``SparseIds``; numpy leaves become tensors)."""
    if isinstance(item, dict):
        return {k: _map(fn, v) for k, v in item.items()}
    if isinstance(item, tuple):
        vals = [_map(fn, v) for v in item]
        return type(item)(*vals) if hasattr(item, "_fields") else tuple(vals)
    if isinstance(item, np.ndarray):
        item = torch.from_numpy(item)
    return fn(item) if isinstance(item, torch.Tensor) else item


class _CudaStager:
    """One worker's side stream and ring of pinned buffers."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.ring = [({}, None) for _ in range(_RING)]
        self.turn = 0

    def put(self, item):
        """Start the copy of ``item`` to the card; returns the device
        batch and the event that marks the copy's end."""
        bufs, last = self.ring[self.turn]
        if last is not None:
            last.synchronize()  # the ring slot's previous copy has ended
        leaf = itertools.count()

        def pin(t: torch.Tensor):
            key = next(leaf)
            buf = bufs.get(key)
            if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
                buf = bufs[key] = torch.empty(t.shape, dtype=t.dtype,
                                              pin_memory=True)
            buf.copy_(t)
            return buf.to(self.device, non_blocking=True)

        with torch.cuda.stream(self.stream):
            out = _map(pin, item)
            done = torch.cuda.Event()
            done.record(self.stream)
        self.ring[self.turn] = (bufs, done)
        self.turn = (self.turn + 1) % _RING
        return out, done


class PrefetchIterator:
    """Wrap a batch iterator with background worker threads.

    ``num_threads > 1`` requires ``make_iter`` to be safe to call per
    thread (each worker gets its own iterator); with one thread any
    iterator works. ``device``: where batches land ("cuda" by default;
    None leaves them as the iterator and ``transform`` made them).
    """

    def __init__(self, make_iter: Callable[[], Iterator[Any]],
                 buffer_size: int = 4, num_threads: int = 1,
                 transform: Optional[Callable[[Any], Any]] = None,
                 device="cuda"):
        self._q: "queue.Queue" = queue.Queue(maxsize=buffer_size)
        self._stop = threading.Event()
        self._transform = transform
        self._device = None if device is None else torch.device(device)
        self._num_threads = num_threads
        self._done = 0
        self._threads = []
        for _ in range(num_threads):
            t = threading.Thread(target=self._worker, args=(make_iter,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def _put(self, entry) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(entry, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self, make_iter):
        dev = self._device
        stager = (_CudaStager(dev) if dev is not None and dev.type == "cuda"
                  else None)
        try:
            for item in make_iter():
                if self._stop.is_set():
                    return
                if self._transform is not None:
                    item = self._transform(item)
                event = None
                if stager is not None:
                    item, event = stager.put(item)
                elif dev is not None:
                    item = _map(lambda t: t.to(dev), item)
                if not self._put((item, event)):
                    return
        except Exception as e:  # handed to the consumer, which re-raises
            self._put(_Failure(e))
        finally:
            self._put(_DONE)

    def __iter__(self):
        return self

    def __next__(self):
        while self._done < self._num_threads:
            if self._stop.is_set():
                raise StopIteration
            try:
                entry = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            if entry is _DONE:
                self._done += 1
                continue
            if isinstance(entry, _Failure):
                raise entry.exc
            item, event = entry
            if event is None:
                return item
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(event)

            def mark(t: torch.Tensor):
                t.record_stream(stream)
                return t

            return _map(mark, item)
        raise StopIteration

    def close(self):
        """Stop the workers and wait for them (up to 1 s each)."""
        self._stop.set()
        for t in self._threads:
            t.join(timeout=1.0)


def staged(iterator_factory, buffer_size: int = 4, num_threads: int = 1,
           transform=None, device="cuda") -> PrefetchIterator:
    """``tf.staged`` analog: stage an input pipeline behind the step."""
    return PrefetchIterator(iterator_factory, buffer_size=buffer_size,
                            num_threads=num_threads, transform=transform,
                            device=device)
