"""Host microseconds a greedy NMS round: the median over the traced run's
collected requests of the family's NMS spans' host time over the request's
rounds (the family file's ``nms_rounds``)."""


def read(run):
    from harness.spans import nms_round_us

    return nms_round_us(run)
