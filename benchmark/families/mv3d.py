"""MV3D as published (Chen et al., CVPR 2017, arXiv:1611.07759) with SHPL
fusion (arXiv:1805.00715): BEV, LiDAR front view and image encoders
without decoders, the proposal head on the 2x upsampled fused BEV map over a
stride-4 lattice with its empty anchors masked, 7x7 crops of the three
stride-8 maps, deep fusion by the mean, box_8c; the port's
``models/mv3d.py`` (``Mv3d``), the preset ``mv3d_cars``."""

from __future__ import annotations

import numpy as np

from harness.flops import _conv, fusion_flops, stage2_flops
from reference.config import from_dict
from reference.detector import decode_detections
from reference.mv3d import FV_CHANNELS, N_VIEWS, Mv3d, Mv3dSettings, anchor_grid, anchor_valid, extra_inputs
from reference.mv3d import proposal_stride, settings

MODEL = Mv3d
# the RPN's NMS in mv3d, the final per-class NMS in detector's per_class_nms
PORT_NMS_MODULES = ("sparse_pooling_tpu_torch.models.mv3d", "sparse_pooling_tpu_torch.models.detector")
FUSION_LAYERS = ("bev_fusion", "img_fusion")
NMS_SPANS = ("detector.rpn_nms", "decode.nms")
MODEL_KEYS = {"mv3d": lambda value: from_dict(Mv3dSettings, value)}
INPUTS = ("fv_input", "bev_intensity")
# anchor_grid(cfg, extents) and extra_inputs(batch, cfg, extents) are the reference's (reference/mv3d.py)


def feature_layers(names):
    """The proposal conv, and the deep join f3 that feeds the output heads."""

    return {"rpn": "rpn_head.rpn_conv", "s2": "stage2_head.join"}


def frame_anchors(anchors_frame, occupancy, cfg, extents):
    """The whole lattice; an anchor is valid where its footprint is not
    empty."""

    return anchors_frame, anchor_valid(occupancy, cfg, extents)


def decode(outputs, ground_plane, cfg, extents, picks=None):
    return decode_detections(outputs, ground_plane, cfg, extents, picks)


def _encoder_flops(cfg, in_ch: int, h: int, w: int) -> int:
    """One VGG encoder, no decoder (``harness.flops.branch_flops``' encoder
    part)."""

    bb = cfg.backbone
    if bb.space_to_depth:
        h, w, in_ch = h // 2, w // 2, 4 * in_ch
    total, cin = 0, in_ch
    for stage, (ch, nb) in enumerate(zip(bb.channels, bb.blocks)):
        if stage > 0 and not (stage == 1 and bb.space_to_depth):
            h, w = h // 2, w // 2
        for _ in range(nb):
            total += _conv(3, cin, ch, h, w)
            cin = ch
    return total


def flops(cfg, extents) -> int:
    """The three encoders, both SHPL directions, the proposal conv head over
    the upsampled lattice, and the deep-fusion head over three views' crops."""

    s = settings(cfg)
    bh, bw = cfg.bev.padded_hw(extents)
    stride = cfg.sparse_pool.fusion_stride
    total = (_encoder_flops(cfg, cfg.bev.num_channels + 1, bh, bw)
             + _encoder_flops(cfg, FV_CHANNELS, s.fv_height, s.fv_width)
             + _encoder_flops(cfg, cfg.image.channels, cfg.image.height, cfg.image.width))
    mid = cfg.backbone.channels[-1]
    bev_mid, img_mid = (bh // stride, bw // stride), (cfg.image.height // stride, cfg.image.width // stride)
    total += fusion_flops(cfg, mid, [(bev_mid, img_mid), (img_mid, bev_mid)])
    n_var = len(cfg.anchors.sizes) * len(cfg.anchors.rotations)
    fc = cfg.rpn.fusion_channels
    h, w = bh // proposal_stride(cfg), bw // proposal_stride(cfg)
    total += _conv(3, mid, fc, h, w) + _conv(1, fc, 2 * n_var, h, w) + _conv(1, fc, 6 * n_var, h, w)
    box_dim = {"box_4c": 10, "box_8c": 24}[cfg.avod.box_rep]
    return total + stage2_flops(cfg, N_VIEWS, cfg.avod.roi_size ** 2 * mid, "deep", box_dim)


def nms_rounds(cfg) -> int:
    """The RPN's ``eval_nms_size`` picks and ``nms_size`` a class."""

    return cfg.rpn.eval_nms_size + cfg.num_classes * cfg.avod.nms_size


def frame(frame, seed):
    """The frame's points with an intensity in [0, 1) each as a fourth
    column (0 on padding), drawn from the frame's own seed."""

    pts, mask = frame["points"], frame["points_mask"]
    intensity = np.random.default_rng([int(seed), 4]).random(pts.shape[0], dtype=np.float32) * mask
    return dict(frame, points=np.concatenate([pts, intensity[:, None]], axis=1))
