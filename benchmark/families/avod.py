"""The AVOD family (arXiv:1712.02294) with SHPL fusion (arXiv:1805.00715):
crops of both views at every anchor slot feed an FC RPN head; the port's
``models/detector.py`` (``SparsePoolingDetector``), the presets ``cars``,
``people`` and the options P1-P5."""

from __future__ import annotations

import numpy as np

from families import last_numbered
from harness.flops import _conv, _dense, branches_flops, fusion_flops, stage2_flops
from reference import anchors as anchor_ops
from reference.detector import SparsePoolingDetector, decode_detections

MODEL = SparsePoolingDetector
PORT_NMS_MODULES = ("sparse_pooling_tpu_torch.models.detector",)
FUSION_LAYERS = ("bev_fusion", "img_fusion")
NMS_SPANS = ("detector.rpn_nms", "decode.nms")


def feature_layers(names):
    return {"rpn": "rpn_head.fc2", "s2": last_numbered(names, "stage2_head.fc")}


def anchor_grid(cfg, extents) -> np.ndarray:
    """The z-major position grid."""

    plane0 = np.array([0.0, -1.0, 0.0, 0.0])
    return anchor_ops.generate_anchors_np(cfg.anchors, extents, plane0).astype(np.float32)


def frame_anchors(anchors_frame, occupancy, cfg, extents):
    """Every grid anchor with occupancy as a mask (the dense grid), else the
    occupied quads or positions up to ``max_anchors``."""

    thr = cfg.anchors.density_threshold
    if cfg.rpn.dense_grid:
        fp_counts = anchor_ops.grid_occupancy_counts(occupancy, extents, cfg.bev, cfg.anchors)
        return anchors_frame, (fp_counts >= thr).reshape(fp_counts.shape[0], -1)
    if anchor_ops.quad_supported(cfg.anchors, cfg.bev, extents, cfg.anchors.max_anchors, cfg.rpn.roi_quad):
        return anchor_ops.filter_anchor_quads_grid(
            anchors_frame, occupancy, extents, cfg.bev, cfg.anchors,
            max_anchors=cfg.anchors.max_anchors, quad=cfg.rpn.roi_quad, density_threshold=thr,
        )
    return anchor_ops.filter_anchor_positions_grid(
        anchors_frame, occupancy, extents, cfg.bev, cfg.anchors,
        max_anchors=cfg.anchors.max_anchors, density_threshold=thr,
    )


def decode(outputs, ground_plane, cfg, extents, picks=None):
    return decode_detections(outputs, ground_plane, cfg, extents, picks)


def flops(cfg, extents) -> int:
    """Both branches, the BEV fusion (and the image one with ``bev_to_img``),
    the ROI projections of strided crops, the RPN's FCs over every anchor
    slot, and stage 2 over both views' crops."""

    total, bev_mid, img_mid, mid = branches_flops(cfg, extents)
    directions = [(bev_mid, img_mid)] + ([(img_mid, bev_mid)] if cfg.sparse_pool.bev_to_img else [])
    total += fusion_flops(cfg, mid, directions)
    out_c = cfg.backbone.out_channels
    roi_c = out_c
    if cfg.rpn.roi_channels and out_c > cfg.rpn.roi_channels:
        lattices = {"bev": cfg.bev.padded_hw(extents), "img": (cfg.image.height, cfg.image.width)}
        for view, stride in (("bev", cfg.rpn.bev_roi_stride), ("img", cfg.rpn.img_roi_stride)):
            if stride > 1:
                roi_c = cfg.rpn.roi_channels
                h, w = lattices[view]
                total += _conv(1, out_c, roi_c, h // stride, w // stride)
    s = cfg.rpn.proposal_roi_size
    fc = cfg.rpn.fusion_channels
    per_anchor = _dense(s * s * roi_c, fc) + _dense(fc, fc) + _dense(fc, 2) + _dense(fc, 6)
    total += cfg.anchors.max_anchors * per_anchor
    box_dim = {"box_4c": 10, "box_8c": 24}[cfg.avod.box_rep]
    return total + stage2_flops(cfg, 2, cfg.avod.roi_size ** 2 * out_c, cfg.avod.fusion_type, box_dim)


def nms_rounds(cfg) -> int:
    """The RPN's ``eval_nms_size`` picks and ``nms_size`` a class."""

    return cfg.rpn.eval_nms_size + cfg.num_classes * cfg.avod.nms_size
