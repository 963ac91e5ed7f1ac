"""A function's device work captured once as CUDA graphs and replayed.

:class:`GraphedCall` wraps a function of tensors whose device work has
static shapes and waits on nothing on the host (no ``.item()``, no tensor
made from host data, no size that depends on values). Its first call runs
the function once eagerly on a side stream with the spans off (lazy set-up
such as cuBLAS's workspace), then captures a second run into graphs that
share one private memory pool. Every call, the first included, copies its
inputs into the captured inputs on the current stream, replays, and returns
the captured outputs copied into fresh tensors (dense ones keep their
strides), so that a caller owns what it gets as from the eager function and
no later call overwrites it; an output that is one of the inputs is returned
as the caller's own tensor. The same kernels run in the same order as in the
eager function, so the outputs are its bits.

The program's spans (``runtime/profiling.py``) split the capture: each span
boundary ends the graph being captured and begins the next, and a replay
opens each span around its own graphs, so a span inside the function times
the same work on the device stream as it does eagerly.

The caller serialises the calls of one ``GraphedCall`` (``lock``); replays
on different streams wait for each other on the device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import warnings
from typing import Any, Callable, Dict, List, Sequence, Union

import torch

from sparse_pooling_tpu_torch.runtime import profiling

# a captured call's steps: a graph to replay, a span to open (its name), or the innermost open span to close
Step = Union[torch.cuda.CUDAGraph, str, None]


class _Splitter:
    """Takes the spans' place while a call is captured: each span boundary
    ends the graph being captured and begins the next."""

    def __init__(self, pool):
        self.thread = threading.get_ident()
        self.pool = pool
        self.steps: List[Step] = []
        self.graph = None

    def begin(self) -> None:
        self.graph = torch.cuda.CUDAGraph()
        # thread_local: another thread's work on its own stream (a prefetcher's copies) does not
        # break the capture
        self.graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")

    def end(self) -> None:
        graph, self.graph = self.graph, None
        if graph is None:
            return
        with warnings.catch_warnings():
            # a span that closes the function leaves an empty last graph; replaying it is a no-op
            warnings.filterwarnings("ignore", message="The CUDA Graph is empty")
            graph.capture_end()
        self.steps.append(graph)

    @contextlib.contextmanager
    def span(self, name: str):
        self.end()
        self.steps.append(name)
        self.begin()
        try:
            yield
        finally:
            self.end()
            self.steps.append(None)
            self.begin()


def _fresh(obj, own: Dict[int, torch.Tensor]):
    """``obj`` with each tensor copied into a fresh one, or the caller's
    where it is a captured input (``own``: id of the captured input ->
    the caller's), through dicts, lists, tuples and dataclasses."""

    if isinstance(obj, torch.Tensor):
        return own[id(obj)] if id(obj) in own else obj.clone()
    if isinstance(obj, dict):
        return {k: _fresh(v, own) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_fresh(v, own) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: _fresh(getattr(obj, f.name), own)
                                           for f in dataclasses.fields(obj) if f.init})
    return obj


class GraphedCall:
    """``fn(*tensors)``'s device work for one signature of its inputs
    (the caller keys it: devices, shapes, dtypes, strides), captured at the
    first call and replayed at every call."""

    def __init__(self, fn: Callable[..., Any]):
        self.fn = fn
        self.lock = threading.Lock()
        self.steps: List[Step] = []
        self.captured = False

    def _capture(self, inputs: Sequence[torch.Tensor]) -> None:
        dev = inputs[0].device
        self.inputs = [t.clone() for t in inputs]
        current, side = torch.cuda.current_stream(dev), torch.cuda.Stream(dev)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            with profiling.routed(None):
                self.fn(*self.inputs)
            splitter = _Splitter(torch.cuda.graph_pool_handle())
            with profiling.routed(splitter):
                splitter.begin()
                try:
                    self.outputs = self.fn(*self.inputs)
                except BaseException:
                    with contextlib.suppress(RuntimeError):
                        splitter.end()
                    raise
                splitter.end()
        current.wait_stream(side)
        self.steps, self.captured = splitter.steps, True
        self.done = torch.cuda.Event()

    def __call__(self, inputs: Sequence[torch.Tensor]):
        """The function's outputs for ``inputs`` (tensors of the captured
        signature, on one card); the caller holds ``lock``."""

        dev = inputs[0].device
        with torch.cuda.device(dev):
            if not self.captured:
                self._capture(inputs)
            stream = torch.cuda.current_stream(dev)
            stream.wait_event(self.done)
            for mine, theirs in zip(self.inputs, inputs):
                mine.copy_(theirs)
            opened = []
            for step in self.steps:
                if isinstance(step, str):
                    opened.append(profiling.span(step))
                    opened[-1].__enter__()
                elif step is None:
                    opened.pop().__exit__(None, None, None)
                else:
                    step.replay()
            out = _fresh(self.outputs, {id(mine): theirs for mine, theirs in zip(self.inputs, inputs)})
            self.done.record(stream)
        return out
