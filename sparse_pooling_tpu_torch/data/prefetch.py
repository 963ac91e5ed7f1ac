"""Double-buffered host -> device input pipeline.

Port of ``sparse_pooling_tpu.data.prefetch``: a worker thread pulls batch
n+1..n+depth from the host iterator and starts their copies to the card
while the card runs batch n.

On a CUDA device each batch's arrays go into pinned host buffers, one set
per slot of a ring of ``depth + 1``, and from there to the card with
``non_blocking`` copies on the prefetcher's own stream; an event recorded
after the copies travels with the batch. The consumer makes its current
stream wait on that event before the step reads the batch, and marks each
device tensor as used by that stream (``record_stream``), so the caching
allocator does not hand the memory to the copy stream while the step still
reads it. A slot's pinned buffers are refilled only once the event of its
last copy has completed. On the CPU the arrays become tensors, with no
stream.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Iterator, Optional

import numpy as np
import torch


class DevicePrefetcher:
    """Wrap a host iterator of ``(arrays, meta)`` items, ``arrays`` a tuple
    (or NamedTuple) of numpy arrays and Nones, and yield ``(tensors,
    meta)`` on ``device``, with the tuple's type kept.

    Consumers that stop early must call :meth:`close` (or use the context
    manager): otherwise the worker stays blocked on the full queue, holding
    ``depth`` batches on the card. A loader exception reaches the consumer
    at the batch where it happened.

    ``timings`` (seconds, read after :meth:`close`): ``load``, the worker's
    pulls from the host iterator; ``put``, its pinned copies and copy
    enqueues; ``wait``, the consumer blocked on an empty queue (``waits``
    counts those batches).
    """

    def __init__(self, host_iter: Iterator, depth: int = 2, device="cuda",
                 transform: Optional[Callable] = None):
        self._iter = host_iter
        self._transform = transform
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        if self._cuda and self.device.index is None:  # the worker sets it as its thread's device
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.timings = {"load": 0.0, "put": 0.0, "wait": 0.0}
        self.waits = 0
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._done = object()
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        if self._cuda:
            self._stream = torch.cuda.Stream(self.device)
            # ring of depth + 1 slots: the queue holds depth batches, the
            # worker fills one more; each slot keeps pinned buffers per array
            # position and the event of its last copy
            self._slots = [{"bufs": {}, "event": None} for _ in range(depth + 1)]
            self._next_slot = 0
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Enqueue unless closed; returns False once the consumer is gone."""

        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        try:
            if self._cuda:
                torch.cuda.set_device(self.device)
            it = iter(self._iter)
            while True:
                t0 = time.perf_counter()
                try:
                    item = next(it)
                except StopIteration:
                    break
                self.timings["load"] += time.perf_counter() - t0
                if self._stop.is_set():
                    return
                if self._transform is not None:
                    item = self._transform(item)
                arrays, meta = item
                t0 = time.perf_counter()
                placed = self._place(arrays)
                self.timings["put"] += time.perf_counter() - t0
                if not self._put((placed, meta)):
                    return
        except BaseException as e:  # surface loader errors to the consumer
            self._err = e
        finally:
            self._put(self._done)

    def _place(self, arrays):
        """(tensors on the device, the copies' event or None)."""

        if not self._cuda:
            return self._rebuild(arrays, [None if a is None else torch.from_numpy(np.asarray(a))
                                          for a in arrays]), None
        slot = self._slots[self._next_slot]
        self._next_slot = (self._next_slot + 1) % len(self._slots)
        if slot["event"] is not None:
            slot["event"].synchronize()  # its pinned buffers are free again
        out = []
        with torch.cuda.stream(self._stream):
            for i, a in enumerate(arrays):
                if a is None:
                    out.append(None)
                    continue
                src = torch.from_numpy(np.ascontiguousarray(a))
                buf = slot["bufs"].get(i)
                if buf is None or buf.numel() < src.numel() or buf.dtype != src.dtype:
                    # sized for the largest batch seen: a point bucket grows to the cap
                    buf = torch.empty(src.numel(), dtype=src.dtype, pin_memory=True)
                    slot["bufs"][i] = buf
                pinned = buf[: src.numel()].view(src.shape)
                pinned.copy_(src)
                out.append(pinned.to(self.device, non_blocking=True))
            event = torch.cuda.Event()
            event.record(self._stream)
        slot["event"] = event
        return self._rebuild(arrays, out), event

    @staticmethod
    def _rebuild(arrays, values):
        return type(arrays)(*values) if hasattr(arrays, "_fields") else type(arrays)(values)

    def close(self, timeout: float = 5.0):
        """Stop the worker and release its queued batches. Idempotent; safe
        mid-iteration or after exhaustion. Drains the queue so a worker
        blocked on ``put`` sees the stop flag."""

        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __iter__(self):
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        try:
            item = self._q.get_nowait()
        except queue.Empty:
            t0 = time.perf_counter()
            item = self._q.get()
            self.timings["wait"] += time.perf_counter() - t0
            self.waits += 1
        if item is self._done:
            if self._err is not None:
                raise self._err
            raise StopIteration
        (tensors, event), meta = item
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for t in tensors:
                if t is not None:
                    t.record_stream(stream)
        return tensors, meta
