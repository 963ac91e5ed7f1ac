"""ContFuse's KNN kernel (``torch.ops.spt.bev_knn``): the least time of its
calls in the profiled requests (``kernels/bev_knn.py``, from each call's
shapes) over their device time. The call is replayed inside the input
build's CUDA graph, which has no operator row, so the device time is that of
its two kernels (``knn_bin``, ``knn_query``)."""


def read(run):
    from harness.roofline_share import share

    return share(run, "bev_knn", "knn_")
