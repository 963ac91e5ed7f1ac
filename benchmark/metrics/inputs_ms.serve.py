"""Median device-stream time of a request's input build (the port's
``models/pipeline.build_model_inputs_batch``: ``ops/bev_device``,
``ops/sparse_build``, ``ops/anchors``), CUDA events around the call over the
traced run's window."""

import statistics


def read(run):
    ms = run["window"]["stage_ms"].get("inputs")
    return statistics.median(ms) if ms else None
