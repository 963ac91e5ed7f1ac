"""Median device-stream time of a request's ``decode_batch`` (box decode and
the final per-class NMS), CUDA events around the call over the traced run's
window."""

import statistics


def read(run):
    ms = run["window"]["stage_ms"].get("decode")
    return statistics.median(ms) if ms else None
