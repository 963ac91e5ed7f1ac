"""Median device-stream time of the program's ``detector.stage2`` span
(``stage2_rois`` and ``Stage2Head``) over the traced run's collected requests."""


def read(run):
    from harness.spans import reading

    return reading(run, "detector.stage2", "device_ms")
