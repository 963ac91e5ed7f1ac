"""ContFuse's KNN (``torch.ops.spt.bev_knn``, ``csrc/bev_knn.cu``): each BEV
lattice pixel's nearest LiDAR points, a call a request for the four fused
lattices.

The call runs inside the input build's CUDA graphs, whose replays call no
Python, so ``PORT`` is the input build itself (``build_model_inputs_batch``,
called once a request around the replay); its arguments give the KNN call's
shapes. A configuration without a ``contfuse`` section makes no KNN call:
its bound is 0."""

from __future__ import annotations

from typing import Dict

from harness.roofline import least_time

PORT = ("sparse_pooling_tpu_torch.models.pipeline", "build_model_inputs_batch")
GROUPS = 4  # the fused lattices: 1/2 .. 1/16 of the BEV


def bound(batch, anchors_static, path_keep, cfg, extents, *_) -> Dict[str, float]:
    """The KNN's bytes: each point slot's x and z (f32) and validity (one
    byte), each query point's x and z, and the [B, Q, K] int64 tables; no
    operation counted (the search's distances depend on the data)."""

    section = getattr(cfg, "contfuse", None)
    if section is None:
        return least_time(0, 0)
    b, p = batch.points.shape[:2]
    h, w = cfg.bev.padded_hw(extents)
    q = sum((h >> g) * (w >> g) for g in range(1, GROUPS + 1))
    return least_time(b * p * (2 * 4 + 1) + q * 2 * 4 + b * q * section.neighbours * 8, 0)
