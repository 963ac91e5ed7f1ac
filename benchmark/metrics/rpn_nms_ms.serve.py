"""Median device-stream time of the program's ``detector.rpn_nms`` span (the
RPN's ``top_k_nms_batch``: top-k, sort and the greedy NMS kernel) over the
traced run's collected requests."""


def read(run):
    from harness.spans import reading

    return reading(run, "detector.rpn_nms", "device_ms")
