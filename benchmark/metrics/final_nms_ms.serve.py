"""Median device-stream time of the program's ``decode.nms`` span (the final
per-class ``nms_batch``) over the traced run's collected requests."""


def read(run):
    from harness.spans import reading

    return reading(run, "decode.nms", "device_ms")
