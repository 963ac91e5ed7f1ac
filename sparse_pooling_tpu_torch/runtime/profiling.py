"""Profiling: a ``torch.profiler`` trace and a device timer.

Port of ``sparse_pooling_tpu.runtime.profiling``. :func:`trace` records the
host and, on a card, its kernels around a block and writes a Chrome trace
(Perfetto reads it) into ``logdir``. :func:`timed_device_loop` times ``n``
calls of a function on the card with CUDA events after a warm-up call.
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable

import torch

from sparse_pooling_tpu_torch import resolve_device


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block and write ``<logdir>/trace.json`` (Chrome trace);
    yields the ``torch.profiler.profile`` object."""

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def timed_device_loop(body: Callable[[], object], n: int = 10, device="cuda") -> float:
    """Seconds of device time a call of ``body()``: one warm-up call, then
    ``n`` calls between two CUDA events on ``device``'s current stream
    (the host's enqueue included where it outlasts the device). Raises on a
    device that is not a card: a host clock is no device time."""

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"timed_device_loop times a CUDA device, not {dev}")
    with torch.cuda.device(dev):
        body()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            body()
        end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / n
