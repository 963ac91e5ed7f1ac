"""A plain per-frame reference of MV3D's serving path (Chen et al., CVPR
2017, arXiv:1611.07759) as the port builds it (``models/mv3d.py``), for
``tests/test_torch_mv3d.py``. Not a test module.

One frame at a time, float32, plain ``torch``; it imports no JAX and no
kernel of the port. What MV3D adds is written out here: the front view and
the BEV intensity as loops over the points, the front-view box projection
over the corners, the proposal lattice and its empty-anchor mask as loops
over the anchors and their footprints, the encoders, the upsampled proposal
head, the greedy NMS, the three views' bilinear crops and the deep fusion by
its equations,

    f0 = mean(f_BV, f_FV, f_RGB),
    f_l = mean(H_l^BV(f_(l-1)), H_l^FV(f_(l-1)), H_l^RGB(f_(l-1))), l = 1..3,

with H_l^v(x) = relu(W_l^v x + b_l^v). What MV3D shares with the rcnn
family, and what the port's other tests hold against the JAX package, is
taken from the port's plain code: the SHPL pool's plain form
(``ops.sparse_pool.sparse_pool_patch_plain``, its COO tables from
``ops.sparse_build``) and the box geometry of ``ops.encoders`` and
``ops.projection.project_to_bev``.

A point's cell on the cylinder and in the BEV is computed by the documented
formula in float32, as the port does (a point within float32's rounding of
a cell edge may fall either side; the test holds the formula to float64
geometry apart from such points).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from sparse_pooling_tpu_torch.ops import encoders
from sparse_pooling_tpu_torch.ops.projection import project_to_bev, project_to_image_space
from sparse_pooling_tpu_torch.ops.sparse_pool import sparse_pool_patch_plain


# ------------------------------------------------------------------ inputs

def fv_cells(points: torch.Tensor, fv) -> tuple:
    """[P, >=3] camera-frame points -> (row, col, rho) [P] each: the LiDAR
    axes about the camera origin (x forward = z_cam, y left = -x_cam, z up =
    -y_cam), c = floor(atan2(y, x) / dtheta) drawn at column W/2 - 1 - c,
    r = floor(atan2(z, rho) / dphi) at row fv_top - 1 - r, in float32."""

    lx, ly, lz = points[:, 2], -points[:, 0], -points[:, 1]
    rho = torch.sqrt(lx * lx + ly * ly)
    dtheta, dphi = fv.fv_steps
    col = fv.fv_width // 2 - 1 - torch.floor(torch.atan2(ly, lx) / dtheta).to(torch.int64)
    row = fv.fv_top - 1 - torch.floor(torch.atan2(lz, rho) / dphi).to(torch.int64)
    return row, col, rho


def height_above(point: Sequence[float], plane: Sequence[float]) -> float:
    return point[0] * plane[0] + point[1] * plane[1] + point[2] * plane[2] + plane[3]


def front_view(points: torch.Tensor, mask: torch.Tensor, plane: torch.Tensor, fv) -> torch.Tensor:
    """One frame's front view [H, W, 3]: each cell holds the height above
    the plane, the distance and the intensity of its nearest point (the
    first such point in index order), 0 where empty."""

    row, col, rho = fv_cells(points, fv)
    out = torch.zeros(fv.fv_height, fv.fv_width, 3)
    best: Dict[tuple, float] = {}
    gp = plane.tolist()
    for i in range(points.shape[0]):
        r, c = int(row[i]), int(col[i])
        if not mask[i] or not (0 <= r < fv.fv_height and 0 <= c < fv.fv_width):
            continue
        d = float(rho[i])
        if (r, c) in best and best[(r, c)] <= d:
            continue
        best[(r, c)] = d
        p = points[i].tolist()
        out[r, c] = torch.tensor([height_above(p, gp), d, p[3]])
    return out


def bev_cells(points: torch.Tensor, extents, bev) -> tuple:
    """(row, col, inside) [P] each: the BEV cell of each point as the BEV
    maps count it, in float32."""

    h, w = bev.grid_hw(extents)
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    inside = ((x >= extents.x_min) & (x < extents.x_max) & (y >= extents.y_min) & (y < extents.y_max)
              & (z >= extents.z_min) & (z < extents.z_max))
    col = torch.clamp(torch.floor((x - extents.x_min) / bev.voxel_size).to(torch.int64), 0, w - 1)
    row = torch.clamp(torch.floor((z - extents.z_min) / bev.voxel_size).to(torch.int64), 0, h - 1)
    return row, col, inside


def bev_intensity(points: torch.Tensor, mask: torch.Tensor, plane: torch.Tensor, extents, bev) -> torch.Tensor:
    """One frame's intensity raster [H + pad_h, W, 1]: the intensity of each
    cell's highest point above the plane (the first such point in index
    order), 0 where empty."""

    h, w = bev.grid_hw(extents)
    row, col, inside = bev_cells(points, extents, bev)
    out = torch.zeros(h + bev.pad_h, w, 1)
    best: Dict[tuple, float] = {}
    heights = (points[:, 0] * plane[0] + points[:, 1] * plane[1] + points[:, 2] * plane[2] + plane[3]).tolist()
    for i in range(points.shape[0]):
        if not (mask[i] and inside[i]):
            continue
        key = (int(row[i]), int(col[i]))
        if key in best and best[key] >= heights[i]:
            continue
        best[key] = heights[i]
        out[key[0], key[1], 0] = float(points[i, 3])
    return out


def fv_box(anchor: Sequence[float], fv) -> List[float]:
    """One anchor (x, y at the bottom, z, dim_x, h, dim_z) -> its front-view
    pixel box [r1, c1, r2, c2]: the rectangle bounding its 8 corners on the
    cylinder (pixel i's centre at i), clipped to the map; float64."""

    x, y, z, dx, h, dz = anchor
    dtheta, dphi = fv.fv_steps
    rows, cols = [], []
    for sx in (1, -1):
        for sy in (0, 1):
            for sz in (1, -1):
                cx, cy, cz = x + sx * dx / 2, y - sy * h, z + sz * dz / 2
                lx, ly, lz = cz, -cx, -cy
                cols.append(fv.fv_width / 2 - 0.5 - math.atan2(ly, lx) / dtheta)
                rows.append(fv.fv_top - 0.5 - math.atan2(lz, math.hypot(lx, ly)) / dphi)

    def clip(v, hi):
        return min(max(v, 0.0), hi - 1.0)
    return [clip(min(rows), fv.fv_height), clip(min(cols), fv.fv_width), clip(max(rows), fv.fv_height),
            clip(max(cols), fv.fv_width)]


def anchor_lattice(cfg, extents, stride: int) -> np.ndarray:
    """The proposal lattice [Hl*Wl*V, 8]: for each cell (row-major over the
    padded BEV map at ``stride`` cells), each size, each rotation: centre,
    y = 0, dims (swapped at odd rotations), rotation index, class 0."""

    bh, bw = cfg.bev.padded_hw(extents)
    cell = cfg.bev.voxel_size * stride
    rows = []
    for i in range(bh // stride):
        for j in range(bw // stride):
            x, z = extents.x_min + (j + 0.5) * cell, extents.z_min + (i + 0.5) * cell
            for length, width, height in cfg.anchors.sizes:
                for rot in range(len(cfg.anchors.rotations)):
                    dim_x, dim_z = (length, width) if rot % 2 == 0 else (width, length)
                    rows.append([x, 0.0, z, dim_x, height, dim_z, rot, 0])
    return np.asarray(rows, np.float32)


def anchor_mask(occupied: np.ndarray, cfg, extents, stride: int) -> np.ndarray:
    """[Hl*Wl*V] bool: an anchor is kept where at least
    ``density_threshold`` occupied BEV cells lie in its footprint. On each
    axis its centre lies h = half the lattice spacing (m) from its lattice
    cell's corner, and the footprint of extent d spans the BEV cells
    floor((h - d/2) / voxel) to ceil((h + d/2) / voxel) - 1 from that
    corner."""

    vs = cfg.bev.voxel_size
    step = cfg.anchors.stride
    bh, bw = cfg.bev.padded_hw(extents)
    h, w = occupied.shape
    out = []
    for i in range(bh // stride):
        for j in range(bw // stride):
            for length, width, _ in cfg.anchors.sizes:
                for rot in range(len(cfg.anchors.rotations)):
                    dim_x, dim_z = (length, width) if rot % 2 == 0 else (width, length)
                    r0 = i * stride + int(np.floor((step / 2 - dim_z / 2) / vs))
                    r1 = i * stride + int(np.ceil((step / 2 + dim_z / 2) / vs))
                    c0 = j * stride + int(np.floor((step / 2 - dim_x / 2) / vs))
                    c1 = j * stride + int(np.ceil((step / 2 + dim_x / 2) / vs))
                    count = occupied[max(r0, 0):min(r1, h), max(c0, 0):min(c1, w)].sum()
                    out.append(count >= cfg.anchors.density_threshold)
    return np.asarray(out, bool)


# ------------------------------------------------------------------ model

def conv(x: torch.Tensor, state: Dict[str, torch.Tensor], name: str, relu: bool = True) -> torch.Tensor:
    """[H, W, C] -> [H, W, C'] through ``name``'s weights, SAME padding."""

    w = state[f"{name}.weight"].float()
    y = F.conv2d(x.permute(2, 0, 1)[None], w, state[f"{name}.bias"].float(), padding=w.shape[-1] // 2)
    y = y[0].permute(1, 2, 0)
    return torch.relu(y) if relu else y


def dense(x: torch.Tensor, state: Dict[str, torch.Tensor], name: str) -> torch.Tensor:
    return x @ state[f"{name}.weight"].float().T + state[f"{name}.bias"].float()


def pack2x2(x: torch.Tensor) -> torch.Tensor:
    """[H, W, C] -> [H/2, W/2, 4C], channel ((row%2)*2 + col%2)*C + c."""

    h, w, c = x.shape
    out = torch.zeros(h // 2, w // 2, 4 * c)
    for dy in range(2):
        for dx in range(2):
            sub = dy * 2 + dx
            out[:, :, sub * c:(sub + 1) * c] = x[dy::2, dx::2]
    return out


def encoder(x: torch.Tensor, state, prefix: str, backbone) -> torch.Tensor:
    """The VGG encoder's last stage: 3x3 convs and ReLU, a 2x max-pool
    before each stage but the first (and the second, where the input was
    packed 2x2)."""

    if backbone.space_to_depth:
        x = pack2x2(x)
    for stage, nb in enumerate(backbone.blocks):
        if stage > 0 and not (stage == 1 and backbone.space_to_depth):
            x = F.max_pool2d(x.permute(2, 0, 1)[None], 2)[0].permute(1, 2, 0)
        for b in range(nb):
            x = conv(x, state, f"{prefix}.conv{stage + 1}_{b + 1}")
    return x


def shpl(native, source, coo, state, prefix: str) -> torch.Tensor:
    """SHPL fusion of one frame: the source map projected, pooled onto the
    native lattice by the COO table, joined, mixed by a 1x1 conv."""

    if f"{prefix}.pool_proj.weight" in state:
        source = conv(source, state, f"{prefix}.pool_proj", relu=False)
    ht, wt = coo.target_hw
    pooled = sparse_pool_patch_plain(source[None].contiguous(), coo.rows, coo.cols, coo.vals, ht * wt,
                                      coo.defer_row_norm, "float32")
    pooled = pooled[0] if isinstance(pooled, tuple) else pooled
    pooled = pooled.reshape(ht, wt, -1)
    return conv(torch.cat([native, pooled], dim=-1), state, f"{prefix}.mix1x1")


def greedy_nms(boxes: torch.Tensor, scores: torch.Tensor, k: int, threshold: float,
               pre_top_k: int = None) -> List[int]:
    """Greedy NMS of one frame's [N, 4] boxes over its ``pre_top_k`` best
    scores: the best live score (the lowest index among equals) is kept and
    every live box whose IoU with it exceeds ``threshold`` dropped, up to
    ``k`` picks; -inf is never kept."""

    s = scores.tolist()
    live = sorted(range(len(s)), key=lambda i: (-s[i], i))[:pre_top_k]
    live = [i for i in live if s[i] > -math.inf]
    b = boxes.double().tolist()

    def iou(i, j):
        iy = max(0.0, min(b[i][2], b[j][2]) - max(b[i][0], b[j][0]))
        ix = max(0.0, min(b[i][3], b[j][3]) - max(b[i][1], b[j][1]))
        inter = iy * ix
        area = lambda q: max(b[q][2] - b[q][0], 0.0) * max(b[q][3] - b[q][1], 0.0)  # noqa: E731
        union = area(i) + area(j) - inter
        return inter / union if union > 0 else 0.0

    picks: List[int] = []
    while live and len(picks) < k:
        i = live.pop(0)
        picks.append(i)
        live = [j for j in live if iou(i, j) <= threshold]
    return picks


def crop(feat: torch.Tensor, box: Sequence[float], size: int) -> torch.Tensor:
    """Bilinear crop of [H, W, C] at the pixel box [y1, x1, y2, x2] onto a
    size x size grid (y = y1 + i (y2 - y1) / (size - 1), clipped to the
    map): [size, size, C]."""

    h, w, _ = feat.shape
    out = torch.zeros(size, size, feat.shape[-1])
    for i in range(size):
        y = min(max(box[0] + i * (box[2] - box[0]) / (size - 1), 0.0), h - 1.0)
        y0 = int(math.floor(y))
        y1, dy = min(y0 + 1, h - 1), y - y0
        for j in range(size):
            x = min(max(box[1] + j * (box[3] - box[1]) / (size - 1), 0.0), w - 1.0)
            x0 = int(math.floor(x))
            x1, dx = min(x0 + 1, w - 1), x - x0
            top = feat[y0, x0] * (1 - dx) + feat[y0, x1] * dx
            bot = feat[y1, x0] * (1 - dx) + feat[y1, x1] * dx
            out[i, j] = top * (1 - dy) + bot * dy
    return out


def deep_fusion(views: Sequence[torch.Tensor], state, n_fc: int, prefix: str = "stage2_head") -> torch.Tensor:
    """The paper's join: f0 the mean of the views, f_l the mean over the
    views v of relu(fc_l^v(f_(l-1)))."""

    f = sum(views) / len(views)
    for layer in range(1, n_fc + 1):
        f = sum(torch.relu(dense(f, state, f"{prefix}.fc{layer}_v{v}")) for v in range(len(views))) / len(views)
    return f


def stage2(views: Sequence[torch.Tensor], state, n_fc: int) -> Dict[str, torch.Tensor]:
    f = deep_fusion([v.reshape(v.shape[0], -1) for v in views], state, n_fc)
    out = {"join": f, "cls_logits": dense(f, state, "stage2_head.cls"),
           "box_offsets": dense(f, state, "stage2_head.box_reg"),
           "orientation": dense(f, state, "stage2_head.orientation")}
    if "stage2_head.flip.weight" in state:
        out["flip_logits"] = dense(f, state, "stage2_head.flip")
    return out


def forward(frame: Dict[str, torch.Tensor], state: Dict[str, torch.Tensor], cfg, extents,
            picks: Sequence[int]) -> Dict[str, torch.Tensor]:
    """One frame's serving forward: ``frame`` holds its inputs (``bev``,
    the unpacked BEV maps [H, W, C]; ``intensity``; ``fv``; ``image``;
    ``m_bev``, ``m_fv`` its COO tables; ``anchors`` [A, 8] on its ground
    plane; ``anchor_valid``; ``p2``); stage 2 runs at the proposals of
    ``picks`` (the port's RPN picks, teacher-forced)."""

    bb, s2 = cfg.backbone, cfg.avod.roi_size
    stride = cfg.sparse_pool.fusion_stride
    bev_mid = encoder(torch.cat([frame["bev"], frame["intensity"]], dim=-1), state, "bev_encoder", bb)
    fv_mid = encoder(frame["fv"], state, "fv_encoder", bb)
    img_mid = encoder(frame["image"], state, "img_encoder", bb)
    bev_f = shpl(bev_mid, img_mid, frame["m_bev"], state, "bev_fusion")
    img_f = shpl(img_mid, bev_mid, frame["m_fv"], state, "img_fusion")

    up = F.interpolate(bev_f.permute(2, 0, 1)[None], scale_factor=cfg.mv3d.proposal_upsample, mode="bilinear",
                       align_corners=False)[0].permute(1, 2, 0)
    hidden = conv(up, state, "rpn_head.rpn_conv")
    objectness = conv(hidden, state, "rpn_head.objectness", relu=False).reshape(-1, 2)
    offsets = conv(hidden, state, "rpn_head.offsets", relu=False).reshape(-1, 6)
    proposals_all = encoders.offset_to_anchor(frame["anchors"][:, :6], offsets)
    scores = torch.where(frame["anchor_valid"], torch.softmax(objectness, dim=-1)[:, 1], -math.inf)

    proposals = proposals_all[list(picks)]
    grid_h, grid_w = cfg.bev.grid_hw(extents)
    bev_px = project_to_bev(proposals, extents) * torch.tensor([grid_h - 1.0, grid_w - 1.0] * 2)
    img_px = project_to_image_space(proposals, frame["p2"], (cfg.image.height, cfg.image.width)) * torch.tensor(
        [cfg.image.height - 1.0, cfg.image.width - 1.0] * 2)

    def on_map(box):  # pixel box onto the stride-s map, cell centres aligned
        return [(v - (stride - 1) / 2) / stride for v in box]

    views = [torch.stack([crop(bev_f, on_map(b), s2) for b in bev_px.tolist()]),
             torch.stack([crop(fv_mid, on_map(fv_box(a, cfg.mv3d)), s2) for a in proposals.tolist()]),
             torch.stack([crop(img_f, on_map(b), s2) for b in img_px.tolist()])]
    return {"objectness": objectness, "rpn_offsets": offsets, "scores": scores, "proposals_all": proposals_all,
            "prop_bev_all": project_to_bev(proposals_all, extents), "proposals": proposals, "views": views,
            "rpn_hidden": hidden, **stage2(views, state, len(cfg.avod.fc_layers))}
