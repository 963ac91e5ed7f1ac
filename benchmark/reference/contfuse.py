"""ContFuse (Liang, Yang, Wang, Urtasun, "Deep Continuous Fusion for
Multi-Sensor 3D Object Detection", ECCV 2018, sections 3-4) in plain float32
PyTorch: the reference of the port's ``models/contfuse.py``
(``architecture="contfuse"``), a frozen copy of the port's test reference
with this package's layers, which the control lowers. It imports nothing of
the port and no JAX. The runs set ``torch.backends.cuda.matmul.allow_tf32 =
torch.backends.cudnn.allow_tf32 = False``.

The paper's equations, as computed here:

* the BEV input is PIXOR's (the paper adopts it): 0/1 occupancy of voxels of
  ``bev.voxel_size`` in height too, over ``contfuse.height_lo..height_hi``
  above the frame's ground plane, and the reflectance of each cell's highest
  point (ties to the lowest point index);
* continuous fusion: for each pixel i of a residual group's lattice, its K
  nearest valid LiDAR points j in the BEV plane, found by brute force over
  every point (squared distance (px - qx)^2 + (pz - qz)^2, rounded at each
  float32 operation; ties to the lower index; none beyond
  ``contfuse.max_distance``), and h_i = sum_j MLP([f_j, x_j - x_i]), f_j the
  image features sampled bilinearly at point j's projection, x_j - x_i the
  3D offset from the pixel's centre on the ground plane; h is added to the
  group's output;
* the BEV stream: a plain group of 3x3 convs, four residual groups of basic
  blocks (relu(conv_b(relu(conv_a(x))) + shortcut(x))), each group's first
  conv at stride 2; a top-down path merges groups 2-4 at 1/4 resolution;
* the image stream: ResNet-18, its four groups combined at stride 4;
* the header: a 1x1 conv, two anchors (0 and 90 deg) a cell of the 1/4
  lattice, two class logits and seven box deltas an anchor.

Departures from the paper, each a choice the paper leaves open (the
configuration's ``assumed`` gives the reasons): K = 3 and a 10 m limit (the
paper's ablation varies both); a frame with fewer than K points in reach
fuses what it has (an empty slot adds nothing); x_i's height is the ground
plane's under the pixel centre; the MLP is two dense layers of the group's
width, ReLU between; the image groups are combined by 1x1 laterals to 128
channels, nearest 2x upsampling and addition, at stride 4; the top-down
BEV path is 128 wide with a 3x3 conv after the merge; the box coding is
VoxelNet's (centre by anchor diagonals and height, sizes by exp, the
anchor's heading plus a residual), the header's outputs times fixed target
stds; the offsets in units of the 10 m limit; no batch norm (folded at inference).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv, Dense, to_nchw, to_nhwc

GROUPS = 4
HEADER_STRIDE = 4
IMAGE_STRIDE = 4
BOX_DELTAS = 7
MERGE = 0.5 ** 0.5  # each sum of two branches is scaled by this
DELTA_STD = (0.1, 0.1, 0.1, 0.2, 0.2, 0.2, 0.1)  # the header's outputs times these are its deltas
KNN_CHUNK = 1 << 25  # distances a step of the brute force


@dataclasses.dataclass(frozen=True)
class ContFuseSettings:
    """The configuration's ``pipeline.model.contfuse`` section."""

    height_lo: float = -0.8
    height_hi: float = 2.7
    bev_layers: Tuple[int, ...] = (2, 4, 8, 12, 12)
    bev_channels: Tuple[int, ...] = (32, 64, 128, 192, 256)
    fpn_channels: int = 128
    image_blocks: Tuple[int, ...] = (2, 2, 2, 2)
    image_channels: Tuple[int, ...] = (64, 128, 256, 512)
    image_feature_channels: int = 128
    neighbours: int = 3
    max_distance: float = 10.0


def settings(cfg) -> ContFuseSettings:
    return cfg.contfuse


def compute_dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.backbone.compute_dtype == "bfloat16" else torch.float32


# ---------------------------------------------------------------- inputs

def in_extents(points: torch.Tensor, mask: torch.Tensor, extents) -> torch.Tensor:
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    return (mask & (x >= extents.x_min) & (x < extents.x_max) & (y >= extents.y_min) & (y < extents.y_max)
            & (z >= extents.z_min) & (z < extents.z_max))


def padded_hw(bev, extents) -> Tuple[int, int]:
    h = int(round((extents.z_max - extents.z_min) / bev.voxel_size))
    w = int(round((extents.x_max - extents.x_min) / bev.voxel_size))
    return h + bev.pad_h, w


def height_above_ground(points: torch.Tensor, ground_plane: torch.Tensor) -> torch.Tensor:
    gp = ground_plane[:, :, None]
    return points[..., 0] * gp[:, 0] + points[..., 1] * gp[:, 1] + points[..., 2] * gp[:, 2] + gp[:, 3]


def bev_occupancy(points, mask, ground_plane, extents, bev, s: ContFuseSettings) -> torch.Tensor:
    """[B, H+pad, W, N+1]: the occupancy of each cell's N voxels, then the
    reflectance of its highest point (0 where empty)."""

    b, p = mask.shape
    hp, w = padded_hw(bev, extents)
    h = hp - bev.pad_h
    n = int(round((s.height_hi - s.height_lo) / bev.voxel_size))
    valid = in_extents(points, mask, extents)
    col = torch.clamp(torch.floor((points[..., 0] - extents.x_min) / bev.voxel_size).to(torch.int64), 0, w - 1)
    row = torch.clamp(torch.floor((points[..., 2] - extents.z_min) / bev.voxel_size).to(torch.int64), 0, h - 1)
    height = height_above_ground(points, ground_plane)
    level = torch.floor((height - s.height_lo) / bev.voxel_size).to(torch.int64)
    out = torch.zeros((b, hp, w, n + 1), dtype=torch.float32, device=points.device)
    for f in range(b):
        occ = valid[f] & (level[f] >= 0) & (level[f] < n)
        out[f, row[f][occ], col[f][occ], level[f][occ]] = 1.0
        # reflectance: the highest point of each cell, ties to the lowest
        # index: stable sorts by index, then height (descending), then cell
        idx = torch.nonzero(valid[f])[:, 0]
        idx = idx[torch.sort(-height[f][idx], stable=True).indices]
        cell = row[f][idx] * w + col[f][idx]
        order = torch.sort(cell, stable=True).indices
        idx, cell = idx[order], cell[order]
        first = torch.ones_like(cell, dtype=torch.bool)
        first[1:] = cell[1:] != cell[:-1]
        out[f, cell[first] // w, cell[first] % w, n] = points[f, idx[first], 3]
    return out


def lattice_centres(rows: int, cols: int, cell: float, extents, device) -> torch.Tensor:
    """[rows * cols, 2] (x, z): origin + (index + 0.5) x cell, row-major."""

    zs = (torch.arange(rows, dtype=torch.float32, device=device) + 0.5) * cell + extents.z_min
    xs = (torch.arange(cols, dtype=torch.float32, device=device) + 0.5) * cell + extents.x_min
    return torch.stack([xs[None, :].expand(rows, cols), zs[:, None].expand(rows, cols)], dim=-1).reshape(-1, 2)


def lattices(cfg, extents) -> List[Tuple[int, int]]:
    bh, bw = padded_hw(cfg.bev, extents)
    return [(bh >> g, bw >> g) for g in range(1, GROUPS + 1)]


def knn_centres(ground_plane: torch.Tensor, cfg, extents) -> torch.Tensor:
    """Every pixel centre of the four lattices on each frame's ground
    plane: [B, Q, 3]."""

    xz = torch.cat([lattice_centres(h, w, cfg.bev.voxel_size * 2 ** g, extents, ground_plane.device)
                    for g, (h, w) in enumerate(lattices(cfg, extents), start=1)])
    a, b, c, d = (ground_plane[:, i:i + 1] for i in range(4))
    x, z = xz[None, :, 0], xz[None, :, 1]
    y = -(a * x + c * z + d) / b
    return torch.stack([x.expand_as(y), y, z.expand_as(y)], dim=-1)


def knn_brute(points: torch.Tensor, valid: torch.Tensor, queries: torch.Tensor, k: int,
              max_distance: float) -> torch.Tensor:
    """Every distance, then k rounds of the first least: [B, Q, k], P where
    a query has fewer than k points in reach."""

    b, p = valid.shape
    q = queries.shape[0]
    out = torch.full((b, q, k), p, dtype=torch.int64, device=points.device)
    r2 = float(np.float32(float(max_distance) ** 2))
    step = max(1, KNN_CHUNK // max(b * p, 1))
    for s in range(0, q if p else 0, step):
        dx = points[:, None, :, 0] - queries[None, s:s + step, None, 0]
        dz = points[:, None, :, 2] - queries[None, s:s + step, None, 1]
        d2 = dx * dx + dz * dz
        d2 = torch.where(valid[:, None, :] & (d2 <= r2), d2, torch.inf)
        for kk in range(k):
            j = torch.argmin(d2, dim=-1)
            hit = torch.gather(d2, -1, j[..., None])[..., 0] < torch.inf
            out[:, s:s + step, kk] = torch.where(hit, j, p)
            d2.scatter_(-1, j[..., None], torch.inf)
    return out


def point_image_coords(points: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """[B, P, 2] (u, v) canvas pixels; the depth kept at 1e-3 or more."""

    x, y, z = points[..., 0], points[..., 1], points[..., 2]

    def p(i, j):
        return p2[:, i, j][:, None]

    u = p(0, 0) * x + p(0, 1) * y + p(0, 2) * z + p(0, 3)
    v = p(1, 0) * x + p(1, 1) * y + p(1, 2) * z + p(1, 3)
    depth = torch.clamp_min(p(2, 0) * x + p(2, 1) * y + p(2, 2) * z + p(2, 3), 1e-3)
    return torch.stack([u / depth, v / depth], dim=-1)


def extra_inputs(batch, cfg, extents) -> Dict[str, torch.Tensor]:
    """The occupancy map, the points, their canvas coordinates, the lattice
    centres and their K nearest valid points."""

    s = settings(cfg)
    centres = knn_centres(batch.ground_plane, cfg, extents)
    valid = in_extents(batch.points, batch.points_mask, extents)
    return {
        "bev_occupancy": bev_occupancy(batch.points, batch.points_mask, batch.ground_plane, extents, cfg.bev, s),
        "points": batch.points[..., :3],
        "points_uv": point_image_coords(batch.points, batch.p2),
        "knn_centres": centres,
        "knn": knn_brute(batch.points, valid, centres[0, :, 0::2].contiguous(), s.neighbours, s.max_distance),
    }


def anchor_grid(cfg, extents) -> np.ndarray:
    """The header's lattice [N, 8] f32 with y = 0: a cell's anchors
    adjacent, the rotation fastest, (l, w) along (x, z) at an even rotation
    index and (w, l) at an odd one; class 0."""

    bh, bw = padded_hw(cfg.bev, extents)
    hl, wl = bh // HEADER_STRIDE, bw // HEADER_STRIDE
    cell = cfg.bev.voxel_size * HEADER_STRIDE
    zs = extents.z_min + (np.arange(hl) + 0.5) * cell
    xs = extents.x_min + (np.arange(wl) + 0.5) * cell
    gx, gz = np.meshgrid(xs, zs, indexing="xy")
    n = hl * wl
    out = []
    for l, w, h in cfg.anchors.sizes:
        for r in range(len(cfg.anchors.rotations)):
            dim_x, dim_z = (l, w) if r % 2 == 0 else (w, l)
            out.append(np.stack([gx.reshape(-1), np.zeros(n), gz.reshape(-1), np.full(n, dim_x), np.full(n, h),
                                 np.full(n, dim_z), np.full(n, r, np.float64), np.zeros(n)], axis=1))
    return np.stack(out, axis=1).reshape(-1, 8).astype(np.float32)


# ---------------------------------------------------------------- model

class StridedConv(Conv):
    def __init__(self, cin: int, cout: int, k: int, stride: int, dtype):
        super().__init__(cin, cout, k, dtype)
        self.stride = (stride, stride)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, dtype):
        super().__init__()
        self.conv_a = StridedConv(cin, cout, 3, stride, dtype)
        self.conv_b = Conv(cout, cout, 3, dtype)
        if stride != 1 or cin != cout:
            self.shortcut = StridedConv(cin, cout, 1, stride, dtype)

    def forward(self, x):
        skip = self.shortcut(x) if hasattr(self, "shortcut") else x
        return torch.relu((self.conv_b(torch.relu(self.conv_a(x))) + skip) * MERGE)


class ResidualGroup(nn.Sequential):
    def __init__(self, cin: int, cout: int, blocks: int, stride: int, dtype):
        super().__init__(*[BasicBlock(cin if b == 0 else cout, cout, stride if b == 0 else 1, dtype)
                           for b in range(blocks)])


def upsample2(x):
    return to_nhwc(F.interpolate(to_nchw(x), scale_factor=2, mode="nearest"))


class TopDown(nn.Module):
    def __init__(self, channels: Sequence[int], width: int, dtype):
        super().__init__()
        for i, c in enumerate(channels):
            self.add_module(f"lateral{i + 1}", Conv(c, width, 1, dtype))
        self.n = len(channels)

    def forward(self, maps):
        x = getattr(self, f"lateral{self.n}")(maps[-1])
        for i in range(self.n - 2, -1, -1):
            x = (getattr(self, f"lateral{i + 1}")(maps[i]) + upsample2(x)) * MERGE
        return x


class ImageStream(nn.Module):
    def __init__(self, cin: int, channels, blocks, width: int, dtype):
        super().__init__()
        self.stem = StridedConv(cin, channels[0], 7, 2, dtype)
        prev = channels[0]
        for g, (c, nb) in enumerate(zip(channels, blocks)):
            self.add_module(f"group{g + 1}", ResidualGroup(prev, c, nb, 1 if g == 0 else 2, dtype))
            prev = c
        self.combine = TopDown(channels, width, dtype)
        self.n = len(channels)

    def forward(self, image):
        x = to_nhwc(F.max_pool2d(to_nchw(torch.relu(self.stem(image))), 3, 2, 1))
        maps = []
        for g in range(self.n):
            x = getattr(self, f"group{g + 1}")(x)
            maps.append(x)
        return self.combine(maps)


def sample_bilinear(feat: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """feat [B, H, W, C] at pixel coordinates xy [B, P, 2] (centre of pixel
    i at i), zero off the map: [B, P, C]."""

    b, h, w, c = feat.shape
    x, y = xy[..., 0], xy[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    out = torch.zeros(xy.shape[:2] + (c,), dtype=torch.float32, device=feat.device)
    frame = torch.arange(b, device=feat.device)[:, None]
    for dy in (0, 1):
        for dx in (0, 1):
            xi, yi = x0 + dx, y0 + dy
            weight = (1.0 - torch.abs(x - xi)) * (1.0 - torch.abs(y - yi))
            inside = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
            tap = feat[frame, torch.clamp(yi, 0, h - 1).long(), torch.clamp(xi, 0, w - 1).long()].float()
            out = out + tap * torch.where(inside, weight, 0.0)[..., None]
    return out


class ContinuousFusion(nn.Module):
    def __init__(self, image_width: int, width: int, offset_unit: float, dtype):
        super().__init__()
        self.offset_unit = offset_unit
        self.fc1 = Dense(image_width + 3, width, dtype)
        self.fc2 = Dense(width, width, dtype)

    def forward(self, features, points, knn, centres, hw):
        """h_i = sum_j fc2(relu(fc1([f_j, x_j - x_i]))) over pixel i's
        neighbour slots that hold a point."""

        b, q, k = knn.shape
        p = points.shape[1]
        frame = torch.arange(b, device=knn.device)[:, None, None]
        has = knn < p
        j = torch.where(has, knn, 0)
        f = features[frame, j]  # [B, Q, K, Ci]
        offset = (points[frame, j] - centres[:, :, None, :]) / self.offset_unit
        m = self.fc2(torch.relu(self.fc1(torch.cat([f, offset], dim=-1))))
        return torch.where(has[..., None], m, 0.0).sum(dim=2).reshape(b, *hw, -1)


class ContFuse(nn.Module):
    def __init__(self, cfg, extents):
        super().__init__()
        s = settings(cfg)
        self.cfg, self.extents = cfg, extents
        dt = compute_dtype(cfg)
        widths, layers = s.bev_channels, s.bev_layers
        cin = int(round((s.height_hi - s.height_lo) / cfg.bev.voxel_size)) + 1
        for i in range(layers[0]):
            self.add_module(f"bev_conv{i + 1}", Conv(cin if i == 0 else widths[0], widths[0], 3, dt))
        for g in range(1, GROUPS + 1):
            self.add_module(f"bev_group{g}", ResidualGroup(widths[g - 1], widths[g], layers[g] // 2, 2, dt))
            self.add_module(f"fusion{g}", ContinuousFusion(s.image_feature_channels, widths[g], s.max_distance, dt))
        self.bev_fpn = TopDown(widths[2:], s.fpn_channels, dt)
        self.bev_smooth = Conv(s.fpn_channels, s.fpn_channels, 3, dt)
        self.image_stream = ImageStream(cfg.image.channels, s.image_channels, s.image_blocks,
                                        s.image_feature_channels, dt)
        self.head_input = nn.Identity()
        self.header = Conv(s.fpn_channels, len(cfg.anchors.sizes) * len(cfg.anchors.rotations) * (2 + BOX_DELTAS), 1)
        self.lattices = lattices(cfg, extents)

    def forward(self, inputs: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        image = self.image_stream(inputs["image"])
        features = sample_bilinear(image, (inputs["points_uv"] - (IMAGE_STRIDE - 1) / 2) / IMAGE_STRIDE)
        x = inputs["bev_occupancy"]
        for i in range(self.cfg.contfuse.bev_layers[0]):
            x = torch.relu(getattr(self, f"bev_conv{i + 1}")(x))
        groups, start = [], 0
        for g, hw in enumerate(self.lattices, start=1):
            q = hw[0] * hw[1]
            x = getattr(self, f"bev_group{g}")(x)
            x = (x + getattr(self, f"fusion{g}")(features, inputs["points"], inputs["knn"][:, start:start + q],
                                                inputs["knn_centres"][:, start:start + q], hw)) * MERGE
            start += q
            groups.append(x)
        feat = self.head_input(torch.relu(self.bev_smooth(self.bev_fpn(groups[1:]))))
        out = self.header(feat)
        out = out.reshape(out.shape[0], -1, 2 + BOX_DELTAS).float()
        return {"anchors": inputs["anchors"], "anchor_valid": inputs["anchor_valid"],
                "cls_logits": out[..., :2], "box_deltas": out[..., 2:]}


def decode_boxes(anchors: torch.Tensor, deltas: torch.Tensor, rotations: Sequence[float]) -> torch.Tensor:
    """[..., 7] (x, y, z, l, w, h, ry) from the header's outputs times
    ``DELTA_STD`` (tx, ty, tz, tl, tw, th, tr): x = xa + tx d, z = za + tz d
    (d the anchor's BEV diagonal), y = ya + ty ha, l = la exp(tl), w = wa
    exp(tw), h = ha exp(th), ry = ra + tr."""

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
