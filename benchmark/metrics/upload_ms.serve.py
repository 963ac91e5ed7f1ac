"""Median host time of the program's ``upload`` span (``models/pipeline.stack_frames``:
the frames' stacking and host-to-device copies) over the traced run's
collected requests."""


def read(run):
    from harness.spans import reading

    return reading(run, "upload", "host_ms")
