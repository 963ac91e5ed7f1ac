"""Median device-stream time of the program's ``detector.fusion`` span (the
SHPL fusion layers, kernel A) over the traced run's collected requests."""


def read(run):
    from harness.spans import reading

    return reading(run, "detector.fusion", "device_ms")
