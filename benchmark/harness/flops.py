"""The model's FLOPs a frame, counted from the configuration's shapes.

Counts the multiply-adds (2 FLOPs each) of every conv, transposed conv and
dense layer of a serving forward: both branches' encoders and decoders, the
SHPL fusion layers' 1x1 convs, the RPN, and the stage-2 FC stack and heads
over every proposal slot. The counts the families share are here; each
family file (``families/<architecture>.py``) adds its RPN's and sums them. A
transposed conv counts its input pixels, as PyTorch's flop counter does. The
count depends on the shapes alone, so it is the same whatever implements
them; the crops and the SHPL pool's own arithmetic are not model FLOPs and
are not counted.
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


def branches_flops(cfg, extents) -> tuple:
    """(FLOPs of the BEV and image branches, the BEV branch's mid lattice,
    the image branch's, the mid channels)."""

    bh, bw = cfg.bev.padded_hw(extents)
    bev, bev_mid, mid = branch_flops(cfg, cfg.bev.num_channels, bh, bw)
    img, img_mid, _ = branch_flops(cfg, cfg.image.channels, cfg.image.height, cfg.image.width)
    return bev + img, bev_mid, img_mid, mid


def fusion_flops(cfg, mid: int, directions) -> int:
    """The SHPL fusion layers' 1x1 convs: one a direction ((target h, w),
    (source h, w)), the source's projection to ``pool_channels`` where it is
    narrower than ``mid``, then the mix of target and pooled channels."""

    sp = cfg.sparse_pool
    pooled = sp.pool_channels if sp.pool_channels and mid > sp.pool_channels else mid
    total = 0
    for (th, tw), (sh, sw) in directions:
        if pooled != mid:
            total += _conv(1, mid, pooled, sh, sw)
        total += _conv(1, mid + pooled, mid, th, tw)
    return total


def stage2_flops(cfg, views: int, in_features: int, fusion_type: str, box_dim: int) -> int:
    """The stage-2 FC stack and heads over every proposal slot
    (``rpn.eval_nms_size``): ``views`` crops of ``in_features`` each, fused
    ``early`` (one stack), ``late`` or ``deep`` (a stack a view)."""

    widths = [in_features, *cfg.avod.fc_layers]
    mult = 2 if views > 1 and cfg.avod.fusion_method == "concat" else 1
    stack = 0
    if fusion_type not in ("late", "deep"):
        widths[0] *= mult
        stack = sum(_dense(widths[i], widths[i + 1]) for i in range(len(widths) - 1))
        out = widths[-1]
    else:
        for i in range(len(widths) - 1):
            cin = widths[i] * (mult if fusion_type == "deep" else 1)
            stack += views * _dense(cin, widths[i + 1])
        out = widths[-1] * mult
    heads = cfg.num_classes + 1 + box_dim + 2 + (2 if cfg.avod.explicit_flip_head else 0)
    return cfg.rpn.eval_nms_size * (stack + _dense(out, heads))


def forward_flops(cfg, extents, family=None) -> int:
    """FLOPs of one frame's serving forward (``cfg``: a ModelConfig), as
    its family file counts them (``families/<architecture>.py``)."""

    if family is None:
        from families import load

        family = load(cfg.architecture)
    return int(family.flops(cfg, extents))
