"""The program's own spans in a serving cell
(``sparse_pooling_tpu_torch.runtime.profiling``), read in a ``--trace 1``
run.

After a cell's window, :func:`collected` serves ``SPAN_REQUESTS`` more
requests of the schedule with the port's spans collected and no profiler:
each span's host, device-stream and self milliseconds, the greedy NMS
rounds a request (the family file's ``nms_rounds``) and the family's NMS
spans. It runs before any ``torch.profiler`` session of the process: after
one, requests on an H100 ran 16-41% slower (PERF.md, section 6).
:func:`profiled` serves a few under ``torch.profiler`` with the spans on as
``spt.<name>`` ranges: each device row's launch, and each idle gap of the
device, is put down to the innermost span open when it began. On the CPU of
the tests' rehearsal the ops' own intervals stand for the device rows.
``run["spans"]`` holds both. :func:`reading` gives a span's number by its
name, so that a metric file for a span is two lines; :func:`nms_round_us`
and :func:`nms_idle_share` read the NMS spans together. A program without
``profiling.span`` gives no numbers.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .devtrace import _union

SPAN_REQUESTS = 48
STRETCH = "bench.spans"
RANGE_PREFIX = "spt."
OUTSIDE = "none"  # no span open


def _rows(events, on_card: bool) -> List[Tuple[float, float, float, bool]]:
    """(start, end, launched at, launch found) of each device row: on a card
    the launch is its runtime call (``cudaLaunchKernel``, ``cudaMemcpyAsync``
    and the like: the CPU row of the same correlation id), else its own
    start; off a card every CPU op is a row, launched where it starts."""

    cpu = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]

    def marked(e):
        return getattr(e, "is_user_annotation", False) or e.name.startswith((RANGE_PREFIX, "bench."))

    if not on_card:
        return [(e.time_range.start, e.time_range.end, e.time_range.start, True) for e in cpu if not marked(e)]
    runtime = {e.id: e.time_range.start for e in cpu if e.name.startswith("cu")}
    return [(e.time_range.start, e.time_range.end, runtime.get(e.id, e.time_range.start), e.id in runtime)
            for e in events if e.device_type == torch.autograd.DeviceType.CUDA and not marked(e)]


def attribute(events, on_card: bool) -> Dict:
    """From ``prof.events()`` of the profiled span stretch: the device's
    launches and idle seconds by the innermost span open at each launch and
    at the start of each idle gap, and how many rows' launches were found."""

    window = [e for e in events if e.name == STRETCH and e.device_type == torch.autograd.DeviceType.CPU]
    if not window:
        return {}
    w0, w1 = window[0].time_range.start, window[0].time_range.end
    ranges = sorted((e.time_range.start, e.time_range.end, e.name[len(RANGE_PREFIX):]) for e in events
                    if e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith(RANGE_PREFIX))
    starts = [r[0] for r in ranges]

    def innermost(t: float) -> str:
        for j in range(bisect.bisect_right(starts, t) - 1, -1, -1):
            s, e, name = ranges[j]
            if s <= t <= e:
                return name
        return OUTSIDE

    rows = [r for r in _rows(events, on_card) if w0 <= r[2] <= w1]
    launches: Dict[str, int] = defaultdict(int)
    for row in rows:
        launches[innermost(row[2])] += 1
    busy = _union([(max(r[0], w0), min(r[1], w1)) for r in rows if r[1] > w0 and r[0] < w1])
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    idle: Dict[str, float] = defaultdict(float)
    for i in range(0, len(edges), 2):
        if edges[i + 1] > edges[i]:
            idle[innermost(edges[i])] += (edges[i + 1] - edges[i]) / 1e6
    return {"window_s": (w1 - w0) / 1e6, "busy_s": sum(t - s for s, t in busy) / 1e6,
            "launches": dict(launches), "idle_s": dict(idle), "launch_found": sum(r[3] for r in rows)}


def collected(srv, first: int, n: int = SPAN_REQUESTS) -> Optional[Dict]:
    """``n`` requests of the schedule from request ``first`` on with the
    port's spans collected: the collection's summary, each request's
    latency, its NMS rounds and the family's NMS spans. ``None`` for a
    program without spans."""

    from sparse_pooling_tpu_torch.runtime import profiling

    if not hasattr(profiling, "span"):
        return None
    lat = []
    with profiling.collect(srv.device) as col:
        for k in range(n):
            col.next_request()
            s = time.perf_counter()
            srv.request(srv.schedule.request(first + k))
            lat.append((time.perf_counter() - s) * 1e3)
        summary = col.summary()
    return dict(summary, requests=n, latency_ms=lat, rounds=srv.nms_rounds, nms_spans=list(srv.family.NMS_SPANS))


def profiled(srv, first: int, n: int) -> Dict:
    """``n`` requests from request ``first`` on under ``torch.profiler``
    with the spans on as ranges: :func:`attribute`'s numbers, and
    ``requests``. Empty for a program without spans."""

    from sparse_pooling_tpu_torch.runtime import profiling

    if not hasattr(profiling, "span"):
        return {}
    from torch.profiler import ProfilerActivity, profile

    on_card = srv.device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    if on_card:
        torch.cuda.synchronize(srv.device)
    with profile(activities=activities) as prof, profiling.collect() as col:
        with torch.profiler.record_function(STRETCH):
            for k in range(n):
                col.next_request()
                srv.request(srv.schedule.request(first + k))
            if on_card:
                torch.cuda.synchronize(srv.device)
    return dict(attribute(prof.events(), on_card), requests=n)


def _median(values) -> Optional[float]:
    return float(np.median(values)) if len(values) else None


def reading(run: Dict, name: str, what: str) -> Optional[float]:
    """Span ``name``'s number in a traced run, ``None`` where it has none:
    ``host_ms``, ``device_ms`` (the device stream's time between its
    events; host ms off a card) or ``self_ms`` (``device_ms`` less its
    child spans'), each the median over the collected requests;
    ``launches`` and ``idle_ms``, a request's over the profiled requests
    (the device rows launched, and the idle gaps that began, with the span
    innermost)."""

    data = run.get("spans") or {}
    if what in ("launches", "idle_ms"):
        prof = data.get("profiled") or {}
        if not prof.get("requests"):
            return None
        if what == "launches":
            return prof["launches"].get(name, 0) / prof["requests"] if prof["launches"] else None
        return 1e3 * prof["idle_s"].get(name, 0.0) / prof["requests"] if prof["idle_s"] else None
    span = ((data.get("collected") or {}).get("spans") or {}).get(name)
    return _median(span[what]) if span else None


def nms_round_us(run: Dict) -> Optional[float]:
    """The median over the collected requests of the NMS spans' host us
    over the request's greedy rounds."""

    data = (run.get("spans") or {}).get("collected")
    if not data:
        return None
    host_us: Dict[int, float] = defaultdict(float)
    for name in data["nms_spans"]:
        span = data["spans"].get(name, {})
        for r, ms in zip(span.get("request", []), span.get("host_ms", [])):
            host_us[r] += 1e3 * ms
    return _median([us / data["rounds"] for us in host_us.values()])


def nms_idle_share(run: Dict) -> Optional[float]:
    """The % of the profiled requests' idle device time whose gap began
    inside an NMS span."""

    data = run.get("spans") or {}
    if not data.get("collected"):
        return None
    idle = (data.get("profiled") or {}).get("idle_s", {})
    if sum(idle.values()) <= 0:
        return None
    return 100.0 * sum(idle.get(n, 0.0) for n in data["collected"]["nms_spans"]) / sum(idle.values())
