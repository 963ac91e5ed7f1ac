"""Median device-stream time of the program's ``detector.stage2.crops`` span
(MV3D's three views' 7x7 crops at every proposal) over the traced run's
collected requests."""


def read(run):
    from harness.spans import reading

    return reading(run, "detector.stage2.crops", "device_ms")
