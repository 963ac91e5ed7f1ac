"""Median device-stream time of the program's ``inputs.front_view`` span
(MV3D's front-view map and BEV intensity) over the traced run's collected
requests."""


def read(run):
    from harness.spans import reading

    return reading(run, "inputs.front_view", "device_ms")
