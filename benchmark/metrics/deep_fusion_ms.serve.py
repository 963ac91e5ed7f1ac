"""Median device-stream time of the program's ``detector.stage2.head`` span
(MV3D's deep-fusion head over three views) over the traced run's collected
requests."""


def read(run):
    from harness.spans import reading

    return reading(run, "detector.stage2.head", "device_ms")
