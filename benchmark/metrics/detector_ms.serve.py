"""Median device-stream time of a request's detector call (``models/detector``
or ``models/fusion_rcnn``: backbones, SHPL fusion, RPN with its top-k NMS,
stage 2), CUDA events around ``model(inputs)`` over the traced run's window."""

import statistics


def read(run):
    ms = run["window"]["stage_ms"].get("detector")
    return statistics.median(ms) if ms else None
