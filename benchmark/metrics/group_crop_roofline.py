"""Kernel C (``torch.ops.spt.group_crop``): the least time of its calls in the
profiled requests (``harness/roofline.py``, from each call's inputs) over
their device time (the operator's device rows)."""


def read(run):
    from harness.roofline_share import share

    return share(run, "group_crop", "group_crop")
