"""The MV3D-style fusion R-CNN (arXiv:1611.07759) with SHPL fusion in both
directions: a dense conv RPN over every fusion-lattice cell, stage 2 over
the BEV view's crops; the port's ``models/fusion_rcnn.py`` (``FusionRcnn``),
the preset ``rcnn_cars``."""

from __future__ import annotations

import numpy as np
import torch

from families import last_numbered
from harness.flops import _conv, branches_flops, fusion_flops, stage2_flops
from reference.fusion_rcnn import FusionRcnn, decode_rcnn_detections, rcnn_anchor_grid

MODEL = FusionRcnn
# the RPN's NMS in fusion_rcnn, the final per-class NMS in detector's per_class_nms
PORT_NMS_MODULES = ("sparse_pooling_tpu_torch.models.fusion_rcnn", "sparse_pooling_tpu_torch.models.detector")
FUSION_LAYERS = ("bev_fusion", "img_fusion")
NMS_SPANS = ("detector.rpn_nms", "decode.nms")


def feature_layers(names):
    return {"rpn": "rpn_head.rpn_conv", "s2": last_numbered(names, "stage2_head.fc")}


def anchor_grid(cfg, extents) -> np.ndarray:
    """The dense fusion lattice, one anchor a cell a (size, rotation)."""

    return rcnn_anchor_grid(cfg, extents)


def frame_anchors(anchors_frame, occupancy, cfg, extents):
    """The whole lattice, every anchor valid."""

    return anchors_frame, torch.ones(anchors_frame.shape[:2], dtype=torch.bool, device=anchors_frame.device)


def decode(outputs, ground_plane, cfg, extents, picks=None):
    return decode_rcnn_detections(outputs, cfg, extents, ground_plane=ground_plane, picks=picks)


def flops(cfg, extents) -> int:
    """Both branches, both fusion directions, the conv RPN head over the BEV
    mid lattice, and stage 2 over the BEV view's crops."""

    total, bev_mid, img_mid, mid = branches_flops(cfg, extents)
    total += fusion_flops(cfg, mid, [(bev_mid, img_mid), (img_mid, bev_mid)])
    n_var = len(cfg.anchors.sizes) * len(cfg.anchors.rotations)
    fc = cfg.rpn.fusion_channels
    h, w = bev_mid
    total += _conv(3, mid, fc, h, w) + _conv(1, fc, 2 * n_var, h, w) + _conv(1, fc, 6 * n_var, h, w)
    box_dim = {"offsets": 6, "box_4c": 10, "box_8c": 24}[cfg.avod.box_rep]
    return total + stage2_flops(cfg, 1, cfg.avod.roi_size ** 2 * cfg.backbone.out_channels, "early", box_dim)


def nms_rounds(cfg) -> int:
    """The RPN's ``eval_nms_size`` picks and ``nms_size`` a class."""

    return cfg.rpn.eval_nms_size + cfg.num_classes * cfg.avod.nms_size
