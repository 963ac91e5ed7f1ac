"""ContFuse (Liang, Yang, Wang, Urtasun, ECCV 2018): one stage, continuous
fusion. PIXOR's BEV occupancy through a residual BEV stream whose four
groups each take the ResNet-18 image stream's features at every pixel's 3
nearest LiDAR points (an MLP over the features and the 3D offsets, summed),
a top-down path to 1/4 resolution, and a 1x1 header over 70,400 anchors a
frame decoded at every anchor through the per-class NMS; the port's
``models/contfuse.py`` (``ContFuse``), the preset ``contfuse_cars``. Its
reference model is ``reference/contfuse.py``; it reads no SHPL table."""

from __future__ import annotations

import numpy as np
import torch

from harness.flops import _conv, _dense
from reference import encoders, projection
from reference.config import from_dict
from reference.contfuse import BOX_DELTAS, HEADER_STRIDE, ContFuse, ContFuseSettings, anchor_grid, decode_boxes
from reference.contfuse import extra_inputs, lattices, padded_hw
from reference.detector import per_class_nms

MODEL = ContFuse
STAGES = 1
SHARED_INPUTS = ("image", "anchors", "anchor_valid")
# the final per-class NMS in detector's per_class_nms; no RPN
PORT_NMS_MODULES = ("sparse_pooling_tpu_torch.models.detector",)
FUSION_LAYERS = ("fusion1", "fusion2", "fusion3", "fusion4")
NMS_SPANS = ("decode.nms",)
MODEL_KEYS = {"contfuse": lambda value: from_dict(ContFuseSettings, value)}
INPUTS = ("bev_occupancy", "points_uv", "knn_centres", "knn")
# anchor_grid(cfg, extents) and extra_inputs(batch, cfg, extents) are the reference's (reference/contfuse.py)


def feature_layers(names):
    """The header's input, the top-down path's last conv after its ReLU."""

    return {"rpn": "head_input"}


def frame_anchors(anchors_frame, occupancy, cfg, extents):
    """The whole lattice, every anchor valid."""

    return anchors_frame, torch.ones(anchors_frame.shape[:2], dtype=torch.bool, device=anchors_frame.device)


def decode(outputs, ground_plane, cfg, extents, picks=None):
    boxes = decode_boxes(outputs["anchors"], outputs["box_deltas"], cfg.anchors.rotations)
    head = {"cls_logits": outputs["cls_logits"], "proposal_valid": outputs["anchor_valid"]}
    return per_class_nms(boxes, projection.project_to_bev(encoders.box_3d_to_anchor(boxes), extents), head, cfg,
                         picks)


def _group_flops(cin: int, cout: int, convs: int, h: int, w: int) -> int:
    """A residual group at its output lattice h x w (its first block at
    stride 2): the first conv and the 1x1 shortcut from cin, then 3x3 convs
    at cout."""

    return _conv(3, cin, cout, h, w) + _conv(3, cout, cout, h, w) * (convs - 1) + _conv(1, cin, cout, h, w)


def flops(cfg, extents) -> int:
    """Both streams (every conv, the shortcuts, the laterals), the four
    fusion MLPs at each lattice pixel's K neighbour slots, the top-down
    path's 3x3 conv and the 1x1 header."""

    s = cfg.contfuse
    bh, bw = padded_hw(cfg.bev, extents)
    n_in = int(round((s.height_hi - s.height_lo) / cfg.bev.voxel_size)) + 1
    widths, layers = s.bev_channels, s.bev_layers
    total = sum(_conv(3, n_in if i == 0 else widths[0], widths[0], bh, bw) for i in range(layers[0]))
    for g, (h, w) in enumerate(lattices(cfg, extents), start=1):
        total += _group_flops(widths[g - 1], widths[g], layers[g], h, w)
        mlp = _dense(s.image_feature_channels + 3, widths[g]) + _dense(widths[g], widths[g])
        total += h * w * s.neighbours * mlp
    fh, fw = bh // HEADER_STRIDE, bw // HEADER_STRIDE
    total += sum(_conv(1, c, s.fpn_channels, h, w) for c, (h, w) in zip(widths[2:], lattices(cfg, extents)[1:]))
    total += _conv(3, s.fpn_channels, s.fpn_channels, fh, fw)
    anchors = len(cfg.anchors.sizes) * len(cfg.anchors.rotations)
    total += _conv(1, s.fpn_channels, anchors * (2 + BOX_DELTAS), fh, fw)
    ih, iw = cfg.image.height // 2, cfg.image.width // 2
    total += _conv(7, cfg.image.channels, s.image_channels[0], ih, iw)
    prev = s.image_channels[0]
    for g, (c, nb) in enumerate(zip(s.image_channels, s.image_blocks)):
        h, w = cfg.image.height >> (g + 2), cfg.image.width >> (g + 2)
        total += _conv(3, prev, c, h, w) + _conv(3, c, c, h, w) * (2 * nb - 1)
        if prev != c or g > 0:
            total += _conv(1, prev, c, h, w)
        total += _conv(1, c, s.image_feature_channels, h, w)
        prev = c
    return total


def nms_rounds(cfg) -> int:
    """``nms_size`` a class: the one NMS."""

    return cfg.num_classes * cfg.avod.nms_size


def frame(frame, seed):
    """The frame's points with an intensity in [0, 1) each as a fourth
    column (0 on padding), drawn from the frame's own seed (as MV3D's)."""

    pts, mask = frame["points"], frame["points_mask"]
    intensity = np.random.default_rng([int(seed), 4]).random(pts.shape[0], dtype=np.float32) * mask
    return dict(frame, points=np.concatenate([pts, intensity[:, None]], axis=1))
