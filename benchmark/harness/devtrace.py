"""Reading a ``torch.profiler`` trace of the profiled stretch of a run.

The stretch is marked by a ``bench.window`` range and each request's stages
by ``bench.<stage>`` ranges, recorded from the benchmark's own files. From the
device rows: the launches, the union of the device's busy intervals over the
window, each operator's device time (``torch.ops.spt.*`` and every other
CPU op with device work under it), the kernels that took most time, and the
idle gaps labelled with what the host was doing when each began.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

WINDOW = "bench.window"
STAGE_PREFIX = "bench."


def _is_device(e) -> bool:
    """A device row: a kernel, copy or fill, not a range that newer PyTorch
    mirrors onto the device's timeline (the ``bench.*`` ranges)."""

    if e.device_type != torch.autograd.DeviceType.CUDA:
        return False
    flag = getattr(e, "is_user_annotation", None)
    return not flag and not e.name.startswith(STAGE_PREFIX)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], t))
        else:
            out.append((s, t))
    return out


def reduce(events) -> Dict:
    """The profile's numbers (times in seconds) from ``prof.events()``."""

    window = [e for e in events if e.name == WINDOW and e.device_type == torch.autograd.DeviceType.CPU]
    if not window:
        return {}
    w0, w1 = window[0].time_range.start, window[0].time_range.end
    kernels = [(e.time_range.start, e.time_range.end, e.name) for e in events if _is_device(e)]
    cpu = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                 if e.device_type == torch.autograd.DeviceType.CPU and e.name != WINDOW)
    stages = [c for c in cpu if c[2].startswith(STAGE_PREFIX)]
    ops = [c for c in cpu if not c[2].startswith(STAGE_PREFIX)]
    busy = _union([(max(s, w0), min(t, w1)) for s, t, _ in kernels if t > w0 and s < w1])
    busy_us = sum(t - s for s, t in busy)

    by_kernel: Dict[str, float] = defaultdict(float)
    for s, t, name in kernels:
        by_kernel[name] += t - s
    op_device: Dict[str, float] = defaultdict(float)
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith("spt::"):
            op_device[e.name] += e.device_time_total

    starts = [o[0] for o in ops]

    def host_at(t: float) -> str:
        stage = next((n[len(STAGE_PREFIX):] for s, e, n in reversed(stages) if s <= t <= e), "between")
        i = bisect.bisect_right(starts, t) - 1
        for j in range(i, max(i - 400, -1), -1):
            s, e, name = ops[j]
            if s <= t <= e:
                return f"{stage}/{name}"
        return f"{stage}/python"

    gaps: Dict[str, float] = defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    spans = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)
                    if edges[i + 1] > edges[i]), reverse=True)
    for length, start in spans[:5000]:
        gaps[host_at(start)] += length
    top = lambda d: [[k[:160], v / 1e6] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": busy_us / 1e6,
        "launches": len(kernels),
        "op_device_s": {k: v / 1e6 for k, v in op_device.items()},
        "kernel_s": {k: v / 1e6 for k, v in by_kernel.items()},
        "device_ops": top(by_kernel),
        "idle_gaps": top(gaps),
    }
