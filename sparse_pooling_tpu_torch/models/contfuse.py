"""ContFuse (Liang, Yang, Wang, Urtasun, "Deep Continuous Fusion for
Multi-Sensor 3D Object Detection", ECCV 2018): a one-stage LiDAR-camera
detector whose image features reach the BEV by continuous fusion; serving
only.

* The BEV input is PIXOR's: occupancy voxels of ``bev.voxel_size`` over
  ``contfuse.height_lo..height_hi`` above the ground plane, and the
  reflectance (``ops.bev_device``).
* The BEV stream: a plain group of convs, then four residual groups of
  basic blocks (two 3x3 convs and a shortcut), each group's first conv at
  stride 2 (1/2 .. 1/16), and a top-down path that merges groups 2-4 at 1/4
  resolution (1x1 laterals, nearest 2x upsampling, a 3x3 conv).
* The image stream: ResNet-18 (a 7x7 stride-2 stem, a 3x3 stride-2 max
  pool, four groups of basic blocks), its groups' outputs combined at
  stride 4 by 1x1 laterals and nearest upsampling.
* Continuous fusion before each residual group's output leaves it: for
  every pixel i of the group's lattice, its K nearest valid LiDAR points j
  in the BEV plane (``ops.knn``, within ``contfuse.max_distance``), each
  with the image features f_j sampled bilinearly at its projection and its
  offset x_j - x_i from the pixel's centre on the ground plane:
  h_i = sum_j MLP([f_j, (x_j - x_i) / contfuse.max_distance]) (two dense
  layers, ReLU between), added to the group's output.
* The header: a 1x1 conv over the final map, for each of its cells' two
  anchors (0 and 90 deg) two class logits and seven box deltas (times
  ``DELTA_STD``), decoded at every anchor (``decode_boxes``) and
  kept by the per-class NMS; no
  proposals and no second stage.

No batch norm (a served network folds it into the convs' biases). The
input build makes the image, the occupancy map, the points' image
coordinates and the KNN tables of the four lattices
(``contfuse_frame_inputs``, the ``inputs.knn`` span), and nothing of SHPL:
no height-slice maps, no occupancy raster, no SHPL table.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sparse_pooling_tpu_torch.configs.config import AreaExtents, ModelConfig
from sparse_pooling_tpu_torch.models.detector import Family, compute_dtype, per_class_nms
from sparse_pooling_tpu_torch.models.layers import Conv, Dense, to_nchw, to_nhwc
from sparse_pooling_tpu_torch.ops import anchors as anchor_ops
from sparse_pooling_tpu_torch.ops import bev_device, encoders, projection
from sparse_pooling_tpu_torch.ops import knn as knn_ops
from sparse_pooling_tpu_torch.runtime.profiling import span

GROUPS = 4  # residual groups, each fed by a fusion layer
HEADER_STRIDE = 4  # the header's lattice, in BEV cells
IMAGE_STRIDE = 4  # the combined image features' lattice, in canvas pixels
BOX_DELTAS = 7  # x, y, z, l, w, h, ry
# each sum of two branches (a residual merge, a top-down merge, a fusion layer's addition) is scaled by
# this: with seeded weights and no batch norm the activations then keep their scale through the streams.
# It costs no pass over the activations: the sum's add takes it as alpha on one branch, and the other
# branch's last conv carries it in its weights (scaled), or the block before it in its output
MERGE = 0.5 ** 0.5
# the header's outputs times these are its deltas (tx, ty, tz, tl, tw, th, tr): regression targets
# normalised as Faster R-CNN's, so that deltas stay small where the features are of unit scale
DELTA_STD = (0.1, 0.1, 0.1, 0.2, 0.2, 0.2, 0.1)


class StridedConv(Conv):
    """A k x k conv at ``stride`` with k // 2 zero padding on each side (the
    stride-1 conv's output at every ``stride``-th pixel), NHWC."""

    def __init__(self, cin: int, cout: int, k: int, stride: int, dtype):
        super().__init__(cin, cout, k, dtype)
        self.stride = (stride, stride)


def scaled(conv: Conv, x: torch.Tensor, scale: float) -> torch.Tensor:
    """``conv(x) * scale``, the scale folded into the conv's weights and
    bias (a pass over the weights, not over the output)."""

    cdt = conv.compute_dtype
    return to_nhwc(conv._conv_forward(to_nchw(x.to(cdt)), conv.weight.to(cdt) * scale, conv.bias.to(cdt) * scale))


class BasicBlock(nn.Module):
    """relu((conv_b(relu(conv_a(x))) + shortcut(x)) * scale), ``scale``
    ``MERGE`` or, where the caller wants the output scaled, a multiple of it
    (a positive scale passes the ReLU); the shortcut is a 1x1 conv at the
    block's stride where the width or the stride changes."""

    def __init__(self, cin: int, cout: int, stride: int, dtype):
        super().__init__()
        self.conv_a = StridedConv(cin, cout, 3, stride, dtype)
        self.conv_b = Conv(cout, cout, 3, dtype)
        if stride != 1 or cin != cout:
            self.shortcut = StridedConv(cin, cout, 1, stride, dtype)

    def forward(self, x: torch.Tensor, scale: float = MERGE) -> torch.Tensor:
        skip = self.shortcut(x) if hasattr(self, "shortcut") else x
        return torch.relu_(torch.add(scaled(self.conv_b, torch.relu(self.conv_a(x)), scale), skip, alpha=scale))


class ResidualGroup(nn.Sequential):
    """``blocks`` basic blocks, the first at ``stride``; the output times
    ``out_scale`` (> 0), which the last block takes into its own scale."""

    def __init__(self, cin: int, cout: int, blocks: int, stride: int, dtype):
        super().__init__(*[BasicBlock(cin if b == 0 else cout, cout, stride if b == 0 else 1, dtype)
                           for b in range(blocks)])

    def forward(self, x: torch.Tensor, out_scale: float = 1.0) -> torch.Tensor:
        for i, block in enumerate(self):
            x = block(x, MERGE * out_scale if i == len(self) - 1 else MERGE)
        return x


def upsample2(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, 2H, 2W, C], nearest."""

    return to_nhwc(F.interpolate(to_nchw(x), scale_factor=2, mode="nearest"))


class TopDown(nn.Module):
    """1x1 laterals of maps at strides doubling from the first, merged from
    the coarsest down by nearest 2x upsampling and addition."""

    def __init__(self, channels: Sequence[int], width: int, dtype):
        super().__init__()
        for i, c in enumerate(channels):
            self.add_module(f"lateral{i + 1}", Conv(c, width, 1, dtype))
        self.n = len(channels)

    def forward(self, maps: Sequence[torch.Tensor]) -> torch.Tensor:
        x = getattr(self, f"lateral{self.n}")(maps[-1])
        for i in range(self.n - 2, -1, -1):
            x = torch.add(scaled(getattr(self, f"lateral{i + 1}"), maps[i], MERGE), upsample2(x), alpha=MERGE)
        return x


class ImageStream(nn.Module):
    """ResNet-18 and its groups' outputs combined at stride 4."""

    def __init__(self, cin: int, channels: Sequence[int], blocks: Sequence[int], width: int, dtype):
        super().__init__()
        self.stem = StridedConv(cin, channels[0], 7, 2, dtype)
        prev = channels[0]
        for g, (c, nb) in enumerate(zip(channels, blocks)):
            self.add_module(f"group{g + 1}", ResidualGroup(prev, c, nb, 1 if g == 0 else 2, dtype))
            prev = c
        self.combine = TopDown(channels, width, dtype)
        self.n = len(channels)

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.stem(image))
        x = to_nhwc(F.max_pool2d(to_nchw(x), 3, 2, 1))
        maps = []
        for g in range(self.n):
            x = getattr(self, f"group{g + 1}")(x)
            maps.append(x)
        return self.combine(maps)


class ContinuousFusion(nn.Module):
    """h_i = sum over pixel i's neighbours j of fc2(relu(fc1([f_j, x_j - x_i]))),
    a neighbour slot without a point adding nothing."""

    def __init__(self, image_width: int, width: int, offset_unit: float, dtype):
        """``offset_unit``: the offsets' unit (m), the neighbours' distance limit."""

        super().__init__()
        self.offset_unit = offset_unit
        self.fc1 = Dense(image_width + 3, width, dtype)
        self.fc2 = Dense(width, width, dtype)

    def forward(self, features: torch.Tensor, points: torch.Tensor, knn: torch.Tensor, centres: torch.Tensor,
                hw) -> torch.Tensor:
        """features [B, P, Ci] (each point's image features), points [B, P,
        3], knn [B, Q, K] (P: no point), centres [B, Q, 3] -> [B, H, W, C]
        with H x W = Q."""

        b, q, k = knn.shape
        flat = knn.reshape(b, q * k)
        f = bev_device.gather_points(features, flat)
        offset = (bev_device.gather_points(points, flat) - centres.repeat_interleave(k, dim=1)) / self.offset_unit
        m = self.fc2(torch.relu(self.fc1(torch.cat([f, offset.to(f.dtype)], dim=-1))))
        m = torch.where((flat < points.shape[1])[..., None], m, 0.0)
        return m.reshape(b, q, k, -1).sum(dim=2).reshape(b, *hw, -1)


def sample_bilinear(feat: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """feat [B, H, W, C] at continuous pixel coordinates xy [B, P, 2] (x, y;
    pixel i's centre at i) -> [B, P, C] f32: the four neighbours' bilinear
    weights, a neighbour off the map counting 0."""

    b, h, w, c = feat.shape
    x, y = xy[..., 0], xy[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    flat = feat.reshape(b, h * w, c)
    out = torch.zeros(xy.shape[:2] + (c,), dtype=torch.float32, device=feat.device)
    for dy in (0, 1):
        for dx in (0, 1):
            xi, yi = x0 + dx, y0 + dy
            weight = (1.0 - torch.abs(x - xi)) * (1.0 - torch.abs(y - yi))
            inside = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
            idx = (torch.clamp(yi, 0, h - 1) * w + torch.clamp(xi, 0, w - 1)).to(torch.int64)
            tap = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c)).to(torch.float32)
            out = out + tap * torch.where(inside, weight, 0.0)[..., None]
    return out


def lattice_sizes(cfg: ModelConfig, extents: AreaExtents) -> List[tuple]:
    """(rows, columns) of the four fused lattices, 1/2 .. 1/16 of the BEV."""

    bh, bw = cfg.bev.padded_hw(extents)
    return [(bh >> g, bw >> g) for g in range(1, GROUPS + 1)]


def lattice_centres(rows: int, cols: int, cell: float, extents: AreaExtents, device) -> torch.Tensor:
    """The centres (x, z) [rows * cols, 2] f32 of a lattice of ``cell``-metre
    pixels from the BEV's corner, row-major: origin + (index + 0.5) x cell."""

    zs = (torch.arange(rows, dtype=torch.float32, device=device) + 0.5) * cell + extents.z_min
    xs = (torch.arange(cols, dtype=torch.float32, device=device) + 0.5) * cell + extents.x_min
    return torch.stack([xs[None, :].expand(rows, cols), zs[:, None].expand(rows, cols)], dim=-1).reshape(-1, 2)


def knn_centres(ground_plane: torch.Tensor, cfg: ModelConfig, extents: AreaExtents) -> torch.Tensor:
    """Every pixel centre of the four lattices, in order, on each frame's
    ground plane: [B, Q, 3] (x, y, z)."""

    xz = torch.cat([lattice_centres(h, w, cfg.bev.voxel_size * 2 ** g, extents, ground_plane.device)
                    for g, (h, w) in enumerate(lattice_sizes(cfg, extents), start=1)])
    a, b, c, d = (ground_plane[:, i:i + 1] for i in range(4))
    x, z = xz[None, :, 0], xz[None, :, 1]
    y = -(a * x + c * z + d) / b
    return torch.stack([x.expand_as(y), y, z.expand_as(y)], dim=-1)


def point_image_coords(points: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Each point's projection onto the canvas: [B, P, 2] (u, v) pixels,
    elementwise in f32, the depth kept at 1e-3 or more (as
    ``projection.project_to_image_space``)."""

    x, y, z = points[..., 0], points[..., 1], points[..., 2]

    def p(i, j):
        return p2[:, i, j][:, None]

    u = p(0, 0) * x + p(0, 1) * y + p(0, 2) * z + p(0, 3)
    v = p(1, 0) * x + p(1, 1) * y + p(1, 2) * z + p(1, 3)
    depth = torch.clamp_min(p(2, 0) * x + p(2, 1) * y + p(2, 2) * z + p(2, 3), 1e-3)
    return torch.stack([u / depth, v / depth], dim=-1)


class ContFuse(nn.Module):
    """ContFuse's serving forward, batch-native, NHWC."""

    def __init__(self, cfg: ModelConfig, extents: AreaExtents = AreaExtents()):
        super().__init__()
        cf = cfg.contfuse
        self.cfg, self.extents = cfg, extents
        self.dtype = dt = compute_dtype(cfg)
        widths, layers = cf.bev_channels, cf.bev_layers
        cin = int(round((cf.height_hi - cf.height_lo) / cfg.bev.voxel_size)) + 1
        for i in range(layers[0]):
            self.add_module(f"bev_conv{i + 1}", Conv(cin if i == 0 else widths[0], widths[0], 3, dt))
        for g in range(1, GROUPS + 1):
            self.add_module(f"bev_group{g}", ResidualGroup(widths[g - 1], widths[g], layers[g] // 2, 2, dt))
            self.add_module(f"fusion{g}", ContinuousFusion(cf.image_feature_channels, widths[g], cf.max_distance, dt))
        self.bev_fpn = TopDown(widths[2:], cf.fpn_channels, dt)
        self.bev_smooth = Conv(cf.fpn_channels, cf.fpn_channels, 3, dt)
        self.image_stream = ImageStream(cfg.image.channels, cf.image_channels, cf.image_blocks,
                                        cf.image_feature_channels, dt)
        self.head_input = nn.Identity()  # passes the header's input, so that a hook reads it
        anchors_per_cell = len(cfg.anchors.sizes) * len(cfg.anchors.rotations)
        self.header = Conv(cf.fpn_channels, anchors_per_cell * (2 + BOX_DELTAS), 1)
        self.lattices = lattice_sizes(cfg, extents)

    def forward(self, inputs: Dict[str, Any], train: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """inputs (leading batch dim B): bev_occupancy [B, H+pad, W, N+1],
        image, points [B, P, 3], points_uv [B, P, 2], knn [B, Q, K] and
        knn_centres [B, Q, 3] over the four lattices in order, anchors
        [B, A, 8] (the header's lattice) and anchor_valid [B, A]."""

        if train:
            raise NotImplementedError("the contfuse family serves; it has no training path")
        with span("detector"):
            with span("detector.encode"):
                image = self.image_stream(inputs["image"])
                x = inputs["bev_occupancy"]
                for i in range(self.cfg.contfuse.bev_layers[0]):
                    x = torch.relu(getattr(self, f"bev_conv{i + 1}")(x))
            groups, start = [], 0
            for g, hw in enumerate(self.lattices, start=1):
                with span("detector.encode"):  # x * MERGE, the fusion's addition's scale on this branch
                    x = getattr(self, f"bev_group{g}")(x, MERGE)
                with span("detector.fusion"):
                    if g == 1:  # each point's image features, sampled once
                        features = sample_bilinear(image, (inputs["points_uv"] - (IMAGE_STRIDE - 1) / 2)
                                                   / IMAGE_STRIDE).to(self.dtype)
                    q = hw[0] * hw[1]
                    fused = getattr(self, f"fusion{g}")(features, inputs["points"], inputs["knn"][:, start:start + q],
                                                       inputs["knn_centres"][:, start:start + q], hw)
                    x = torch.add(x, fused.to(x.dtype), alpha=MERGE)
                    start += q
                groups.append(x)
            with span("detector.encode"):
                feat = self.head_input(torch.relu(self.bev_smooth(self.bev_fpn(groups[1:]))))
            out = self.header(feat)
            b = out.shape[0]
            out = out.reshape(b, -1, 2 + BOX_DELTAS).float()
            return {"anchors": inputs["anchors"], "anchor_valid": inputs["anchor_valid"],
                    "cls_logits": out[..., :2], "box_deltas": out[..., 2:]}


def decode_boxes(anchors: torch.Tensor, deltas: torch.Tensor, rotations: Sequence[float]) -> torch.Tensor:
    """The boxes [..., 7] (x, y, z, l, w, h, ry) of the header's outputs
    [..., 7] times ``DELTA_STD`` (tx, ty, tz, tl, tw, th, tr) at its anchors
    [..., 8]: the
    centre moved by (tx, tz) anchor diagonals in the BEV and ty anchor
    heights, the sizes scaled by exp(t), the anchor's rotation turned by tr.
    An anchor of an even rotation index lies with its length along x
    (``ops.anchors.lattice_anchor_grid``)."""

    x, y, z, dim_x, h, dim_z, rot = anchors[..., :7].unbind(-1)
    odd = torch.remainder(rot, 2) == 1
    la, wa = torch.where(odd, dim_z, dim_x), torch.where(odd, dim_x, dim_z)
    ry = torch.zeros_like(x)
    for i, r in enumerate(rotations):
        ry = torch.where(rot == i, r, ry)
    diag = torch.sqrt(la * la + wa * wa)
    tx, ty, tz, tl, tw, th, tr = (t * std for t, std in zip(deltas.unbind(-1), DELTA_STD))
    return torch.stack([x + tx * diag, y + ty * h, z + tz * diag, la * torch.exp(tl), wa * torch.exp(tw),
                        h * torch.exp(th), ry + tr], dim=-1)


def contfuse_decode(outputs: Dict[str, torch.Tensor], ground_plane: torch.Tensor, cfg: ModelConfig,
                    extents: AreaExtents) -> Dict[str, torch.Tensor]:
    """Every anchor's box and class scores through the per-class BEV NMS ->
    boxes_3d [B, C, K, 7], scores [B, C, K], valid [B, C, K]."""

    boxes = decode_boxes(outputs["anchors"], outputs["box_deltas"], cfg.anchors.rotations)
    bev = projection.project_to_bev(encoders.box_3d_to_anchor(boxes), extents)
    head = {"cls_logits": outputs["cls_logits"], "proposal_valid": outputs["anchor_valid"]}
    return per_class_nms(boxes, bev, head, cfg)


def contfuse_check(cfg: ModelConfig) -> None:
    """The contfuse section is there; the BEV and the canvas halve evenly to
    the last residual group's lattice; the anchors sit on the header's."""

    if not hasattr(cfg, "contfuse"):
        raise ValueError("architecture 'contfuse' needs its contfuse section: a ContfuseModelConfig")
    cf = cfg.contfuse
    if not 0 < cf.max_distance < math.inf:
        raise ValueError(f"contfuse.max_distance ({cf.max_distance}) must be finite: it is the offsets' unit")
    if cf.neighbours != knn_ops.K:
        raise ValueError(f"contfuse.neighbours ({cf.neighbours}): the KNN operator takes {knn_ops.K}")
    if len(cf.bev_layers) != GROUPS + 1 or len(cf.bev_channels) != GROUPS + 1 or any(n % 2 for n in cf.bev_layers[1:]):
        raise ValueError(f"contfuse.bev_layers {cf.bev_layers} and bev_channels {cf.bev_channels} need a plain "
                         f"group and {GROUPS} residual groups of whole basic blocks (an even count of convs)")
    if abs(cfg.anchors.stride - cfg.bev.voxel_size * HEADER_STRIDE) > 1e-6:
        raise ValueError(f"anchors.stride ({cfg.anchors.stride}) must be the header lattice's spacing, "
                         f"bev.voxel_size x {HEADER_STRIDE}")
    s = 2 ** (len(cf.image_channels) + 1)
    if cfg.image.height % s or cfg.image.width % s:
        raise ValueError(f"the canvas {cfg.image.height}x{cfg.image.width} must divide by the image stream's "
                         f"stride {s}")


def contfuse_anchor_grid(cfg: ModelConfig, extents: AreaExtents) -> np.ndarray:
    """The header's lattice [N, 8] f32 with y = 0, every size a car anchor
    (class 0)."""

    s = 2 ** GROUPS
    bh, bw = cfg.bev.padded_hw(extents)
    if bh % s or bw % s:
        raise ValueError(f"the BEV lattice {bh}x{bw} must divide by the last residual group's stride {s}")
    return anchor_ops.lattice_anchor_grid(cfg.anchors, cfg.bev, extents, HEADER_STRIDE, [0] * len(cfg.anchors.sizes))


def knn_area(cfg: ModelConfig, extents: AreaExtents) -> tuple:
    """(x_min, x_max, z_min, z_max) of the padded BEV, which the KNN's bins
    cover."""

    bh, _ = cfg.bev.padded_hw(extents)
    return extents.x_min, extents.x_max, extents.z_min, extents.z_min + bh * cfg.bev.voxel_size


def contfuse_frame_inputs(batch, anchors_frame: torch.Tensor, cfg: ModelConfig, extents: AreaExtents) -> Dict[str, torch.Tensor]:
    """The header's lattice, every anchor valid; the BEV occupancy and
    reflectance; the points (x, y, z) and their canvas coordinates, each
    lattice pixel's centre and its K nearest valid points (``inputs.knn``)."""

    cf = cfg.contfuse
    occ = bev_device.bev_occupancy_batch(batch.points, batch.points_mask, batch.ground_plane, extents, cfg.bev,
                                         cf.height_lo, cf.height_hi)
    intensity = bev_device.bev_intensity_batch(batch.points, batch.points_mask, batch.ground_plane, extents, cfg.bev)
    with span("inputs.knn"):
        centres = knn_centres(batch.ground_plane, cfg, extents)
        valid = bev_device.points_in_extents(batch.points, batch.points_mask, extents)
        knn = knn_ops.bev_knn(batch.points, valid, centres[0, :, 0::2], cf.neighbours, cf.max_distance,
                      knn_area(cfg, extents))
        uv = point_image_coords(batch.points, batch.p2)
    return {
        "anchors": anchors_frame,
        "anchor_valid": torch.ones(anchors_frame.shape[:2], dtype=torch.bool, device=anchors_frame.device),
        "bev_occupancy": torch.cat([occ, intensity], dim=-1),
        "points": batch.points[..., :3],
        "points_uv": uv,
        "knn_centres": centres,
        "knn": knn,
    }


FAMILY = Family(ContFuse, contfuse_anchor_grid, contfuse_frame_inputs, contfuse_decode, contfuse_check,
                frame_inputs_wait_free=True)
