"""Kernel A (``torch.ops.spt.sparse_pool_patch``): the least time of its calls
in the profiled requests (``harness/roofline.py``, from each call's inputs)
over their device time (the operator's device rows)."""


def read(run):
    from harness.roofline_share import share

    return share(run, "sparse_pool_patch", "patch_pool")
