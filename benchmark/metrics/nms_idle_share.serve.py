"""Share of the device's idle time whose gap began inside one of the family's
NMS spans, over the requests profiled with the spans as ranges."""


def read(run):
    from harness.spans import nms_idle_share

    return nms_idle_share(run)
