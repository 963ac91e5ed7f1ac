"""The model's FLOPs a frame, counted from the configuration's shapes.

Counts the multiply-adds (2 FLOPs each) of every conv, transposed conv and
dense layer of a serving forward: both branches' encoders and decoders, both
SHPL fusion layers' 1x1 convs, the RPN (the AVOD family's ROI head over every
anchor slot and its ROI projections; the rcnn family's dense conv head), and
the stage-2 FC stack and heads over every proposal slot. A transposed conv
counts its input pixels, as PyTorch's flop counter does. The count depends on
the shapes alone, so it is the same whatever implements them; the crops and
the SHPL pool's own arithmetic are not model FLOPs and are not counted.
"""

from __future__ import annotations

import math


def _conv(k: int, cin: int, cout: int, h: int, w: int) -> int:
    return 2 * k * k * cin * cout * h * w


def _dense(cin: int, cout: int) -> int:
    return 2 * cin * cout


def branch_flops(cfg, in_ch: int, h: int, w: int) -> tuple:
    """(FLOPs of one VGG-pyramid branch, its mid lattice (h, w), its mid
    channels) for an input of ``in_ch`` channels at h x w."""

    bb = cfg.backbone
    s2d = bb.space_to_depth
    if s2d:
        h, w, in_ch = h // 2, w // 2, 4 * in_ch
    total, cin, sizes = 0, in_ch, []
    for stage, (ch, nb) in enumerate(zip(bb.channels, bb.blocks)):
        if stage > 0 and not (stage == 1 and s2d):
            h, w = h // 2, w // 2
        for _ in range(nb):
            total += _conv(3, cin, ch, h, w)
            cin = ch
        sizes.append((h, w))
    mid_hw = sizes[-1]
    stop = int(math.log2(bb.decode_stride))
    hin, win = mid_hw
    for level in range(len(bb.channels) - 2, stop - 1, -1):
        ch = bb.channels[level]
        total += _conv(3, cin, ch, hin, win)  # transposed: by its input pixels
        hs, ws = sizes[level]
        total += _conv(3, 2 * ch, ch, hs, ws)
        cin, (hin, win) = ch, (hs, ws)
    total += _conv(1, cin, bb.out_channels, hin, win)
    return total, mid_hw, bb.channels[-1]


def forward_flops(cfg, extents) -> int:
    """FLOPs of one frame's serving forward (``cfg``: a ModelConfig)."""

    bh, bw = cfg.bev.padded_hw(extents)
    bev, bev_mid, mid = branch_flops(cfg, cfg.bev.num_channels, bh, bw)
    img, img_mid, _ = branch_flops(cfg, cfg.image.channels, cfg.image.height, cfg.image.width)
    total = bev + img
    sp = cfg.sparse_pool
    pooled = sp.pool_channels if sp.pool_channels and mid > sp.pool_channels else mid
    directions = [(bev_mid, img_mid)]
    if cfg.architecture == "rcnn" or sp.bev_to_img:
        directions.append((img_mid, bev_mid))
    for (th, tw), (sh, sw) in directions:
        if pooled != mid:
            total += _conv(1, mid, pooled, sh, sw)
        total += _conv(1, mid + pooled, mid, th, tw)

    ds, out_c = cfg.backbone.decode_stride, cfg.backbone.out_channels
    n_var = len(cfg.anchors.sizes) * len(cfg.anchors.rotations)
    if cfg.architecture == "rcnn":
        fc = cfg.rpn.fusion_channels
        h, w = bev_mid
        total += _conv(3, mid, fc, h, w) + _conv(1, fc, 2 * n_var, h, w) + _conv(1, fc, 6 * n_var, h, w)
        box_dim = {"offsets": 6, "box_4c": 10, "box_8c": 24}[cfg.avod.box_rep]
        s2_views, s2_in = 1, cfg.avod.roi_size ** 2 * out_c
    else:
        roi_c = out_c
        if cfg.rpn.roi_channels and out_c > cfg.rpn.roi_channels:
            lattices = {"bev": (bh, bw), "img": (cfg.image.height, cfg.image.width)}
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
        s2_views, s2_in = 2, cfg.avod.roi_size ** 2 * out_c

    widths = [s2_in, *cfg.avod.fc_layers]
    fusion_type = cfg.avod.fusion_type if cfg.architecture != "rcnn" else "early"
    mult = 2 if s2_views > 1 and cfg.avod.fusion_method == "concat" else 1
    stack = 0
    if fusion_type not in ("late", "deep"):
        widths[0] *= mult
        stack = sum(_dense(widths[i], widths[i + 1]) for i in range(len(widths) - 1))
        out = widths[-1]
    else:
        for i in range(len(widths) - 1):
            cin = widths[i] * (mult if fusion_type == "deep" else 1)
            stack += s2_views * _dense(cin, widths[i + 1])
        out = widths[-1] * mult
    heads = cfg.num_classes + 1 + box_dim + 2 + (2 if cfg.avod.explicit_flip_head else 0)
    total += cfg.rpn.eval_nms_size * (stack + _dense(out, heads))
    return int(total)
