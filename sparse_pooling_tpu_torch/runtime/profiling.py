"""Profiling: a ``torch.profiler`` trace, and spans inside the serving
path.

Port of ``sparse_pooling_tpu.runtime.profiling``, with spans the JAX package
does not have.

* :func:`trace` records the host and, on a card, its kernels around a block
  and writes a Chrome trace (Perfetto reads it) into ``logdir``; spans are on
  inside it, so the trace shows each as an ``spt.<name>`` range.
* :func:`span` names a stretch of the program (``with span("decode.nms"):``).
  It is off unless a :func:`collect` (or :func:`trace`) block is open: it
  then returns one shared no-op context, after one check of a module
  global.
* :func:`collect` turns them on for its block and keeps, for each span, its
  name, its parent's, its request, its host start and end
  (``time.perf_counter_ns``) and on a card two CUDA events on the current
  stream, read only when :meth:`Collection.summary` is asked for. While a
  ``torch.profiler`` records, each span is also an ``spt.<name>`` range on
  the profiler's clock.

The serving path's spans: ``upload`` (``pipeline.stack_frames``: each field
stacked into a page-locked host tensor and copied to the card without a
wait, or stacked plainly off a card; ``pipeline.upload_counts`` counts the
fields and bytes staged each way), ``inputs``
(``build_model_inputs_batch``; MV3D's front view and BEV intensity in
``inputs.front_view`` inside it, ContFuse's points' canvas coordinates,
lattice centres and KNN tables in ``inputs.knn``), ``detector`` (the
detector's forward) with ``detector.encode`` (each view's encoder: two,
MV3D's three; ContFuse's image stream, its BEV stream's groups and top-down
path, opened once a stretch), ``detector.fusion`` (both SHPL layers;
ContFuse's four continuous-fusion layers and the points' image features),
``detector.rpn_nms``,
``detector.decode_maps`` (the AVOD and rcnn families' decoders) and
``detector.stage2`` inside it (MV3D's with ``detector.stage2.crops``, the
three views' crops, and ``detector.stage2.head``, the deep-fusion head,
inside it), ``decode`` (``decode_batch``) with ``decode.nms`` inside it.

Where the input build replays CUDA graphs (``pipeline.build_model_inputs_batch``
on a card, autograd off, a family whose ``frame_inputs`` wait on nothing), a
captured call's graphs are split at its spans (``runtime/graphs.py``), so
``inputs`` times the copies in, the replay and the copies out, and
``inputs.front_view`` and ``inputs.knn`` their own graphs; ``pipeline.input_graph_counts``
counts the captures, the replays and the calls built eagerly.
:func:`routed` sends a block's spans elsewhere: nowhere, or to a capture.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch

RANGE_PREFIX = "spt."

_NOOP = contextlib.nullcontext()
# the open Collection, or None: spans off
_active: Optional["Collection"] = None


class _Span:
    __slots__ = ("col", "name", "parent", "request", "t0", "t1", "events", "range", "children")

    def __init__(self, col: "Collection", name: str):
        self.col, self.name = col, name

    def __enter__(self):
        col = self.col
        self.parent = col.stack[-1] if col.stack else None
        self.request, self.children = col.request, []
        self.range = None
        if torch.autograd._profiler_enabled():
            self.range = torch.profiler.record_function(RANGE_PREFIX + self.name)
            self.range.__enter__()
        self.events = None
        if col.stream is not None:
            self.events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            self.events[0].record(col.stream)
        col.stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        col = self.col
        col.stack.pop()
        if self.events is not None:
            self.events[1].record(col.stream)
        if self.range is not None:
            self.range.__exit__(*exc)
        if self.parent is not None:
            self.parent.children.append(self)
        col.spans.append(self)
        return False


class Collection:
    """The spans recorded while a :func:`collect` block is open. Spans opened on another thread than the block's are not
    recorded."""

    def __init__(self, device=None):
        dev = torch.device(device) if device is not None else None
        self.device = dev
        self.stream = torch.cuda.current_stream(dev) if dev is not None and dev.type == "cuda" else None
        self.thread = threading.get_ident()
        self.request = 0
        self.stack: List[_Span] = []
        self.spans: List[_Span] = []

    def span(self, name: str) -> _Span:
        return _Span(self, name)

    def next_request(self) -> int:
        """Starts a new request: the spans that follow belong to it. Returns its id."""

        self.request += 1
        return self.request

    def summary(self) -> Dict:
        """After a device synchronise, per span name: its parent's name and,
        per request that opened it, ``request``, ``host_ms``, ``device_ms``
        (the device stream's time between its events; the host ms off a
        card) and ``self_ms`` (``device_ms`` less its child spans'), the
        times of a request's spans of one name summed."""

        if self.stream is not None:
            torch.cuda.synchronize(self.device)

        def device_ms(s: _Span) -> float:
            if s.events is None:
                return (s.t1 - s.t0) / 1e6
            return s.events[0].elapsed_time(s.events[1])

        per: Dict[str, Dict[int, List[float]]] = defaultdict(dict)
        parents: Dict[str, Optional[str]] = {}
        for s in self.spans:
            dev = device_ms(s)
            row = per[s.name].setdefault(s.request, [0.0, 0.0, 0.0])
            row[0] += (s.t1 - s.t0) / 1e6
            row[1] += dev
            row[2] += dev - sum(device_ms(c) for c in s.children)
            parents[s.name] = s.parent.name if s.parent is not None else None
        spans = {}
        for name, rows in per.items():
            reqs = sorted(rows)
            spans[name] = {"parent": parents[name], "request": reqs,
                           "host_ms": [rows[r][0] for r in reqs], "device_ms": [rows[r][1] for r in reqs],
                           "self_ms": [rows[r][2] for r in reqs]}
        return {"spans": spans}


def span(name: str):
    """A context naming a stretch of the program ``name``; the shared no-op
    context while tracing is off."""

    col = _active
    if col is None or col.thread != threading.get_ident():
        return _NOOP
    return col.span(name)


@contextlib.contextmanager
def routed(target):
    """Sends the spans of the block to ``target``: ``None`` turns them off,
    else anything with a ``thread`` (the ident whose spans it takes) and a
    ``span(name)`` that returns a context, as a :class:`Collection` has."""

    global _active
    outer, _active = _active, target
    try:
        yield target
    finally:
        _active = outer


@contextlib.contextmanager
def collect(device=None):
    """Turns spans on for the block and yields the
    :class:`Collection` that keeps them; CUDA events time the spans on
    ``device``'s current stream where it is a card."""

    with routed(Collection(device)) as col:
        yield col


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block, spans on, and write ``<logdir>/trace.json``
    (Chrome trace); yields the ``torch.profiler.profile`` object."""

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof, collect():
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
