"""Median device-stream time of the program's ``detector.encode`` span (both
views' ``extractor.encode``) over the traced run's collected requests."""


def read(run):
    from harness.spans import reading

    return reading(run, "detector.encode", "device_ms")
