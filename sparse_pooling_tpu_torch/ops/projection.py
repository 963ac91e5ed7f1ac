"""Anchor/box projection into BEV and image space (elementwise f32), and
into MV3D's LiDAR front view.

Port of ``sparse_pooling_tpu.ops.projection`` (``project_to_front_view`` is
the port's own). Rank-polymorphic: anchors may be [..., N, 6]; ``p2`` may
carry matching leading batch dims ([..., 3, 4]).
"""

from __future__ import annotations

import torch

from sparse_pooling_tpu_torch.configs.config import AreaExtents, Mv3dConfig


def project_to_bev(anchors: torch.Tensor, extents: AreaExtents, normalize: bool = True):
    """[..., 6] anchors -> [..., 4] BEV boxes [y1, x1, y2, x2] (row ~ z,
    col ~ x; normalized by the area extents when ``normalize``)."""

    x, z = anchors[..., 0], anchors[..., 2]
    half_x, half_z = anchors[..., 3] / 2, anchors[..., 5] / 2
    bx1 = x - half_x - extents.x_min
    bx2 = x + half_x - extents.x_min
    bz1 = z - half_z - extents.z_min
    bz2 = z + half_z - extents.z_min
    if normalize:
        w = extents.x_max - extents.x_min
        h = extents.z_max - extents.z_min
        bx1, bx2 = bx1 / w, bx2 / w
        bz1, bz2 = bz1 / h, bz2 / h
    return torch.stack([bz1, bx1, bz2, bx2], dim=-1)


def _corners(anchors: torch.Tensor):
    """[..., 6] anchors (x, y at the bottom, z, dim_x, h, dim_z) -> their
    8 corners' x, y, z, each [..., 8] (x +, +, +, +, -, -, -, -; y at the
    bottom, bottom, top, top, ...; z +, -, +, -, ...). Built from the
    anchors alone: a table of signs made on the device would be a host
    copy that waits for the stream."""

    x, y, z = anchors[..., 0], anchors[..., 1], anchors[..., 2]
    hx, hy, hz = anchors[..., 3] / 2, anchors[..., 4], anchors[..., 5] / 2
    xs, ys, zs = (x + hx, x - hx), (y, y - hy), (z + hz, z - hz)
    return (torch.stack([xs[0]] * 4 + [xs[1]] * 4, dim=-1),
            torch.stack([ys[0], ys[0], ys[1], ys[1]] * 2, dim=-1),
            torch.stack([zs[0], zs[1]] * 4, dim=-1))


def project_to_front_view(anchors: torch.Tensor, cfg: Mv3dConfig) -> torch.Tensor:
    """[..., 6] anchors -> [..., 4] front-view pixel boxes [r1, c1, r2, c2]:
    the bounding rectangle of the 8 corners on the cylinder of
    ``ops.front_view`` (pixel i's centre at i, so a point of column index
    c lies within half a pixel of ``W/2 - 1 - c``), clipped to the map."""

    from sparse_pooling_tpu_torch.ops.front_view import lidar_cylinder

    dtheta, dphi = cfg.fv_steps
    azimuth, elevation, _ = lidar_cylinder(*_corners(anchors))
    cols = cfg.fv_width / 2 - 0.5 - azimuth / dtheta
    rows = cfg.fv_top - 0.5 - elevation / dphi
    r1 = torch.clamp(rows.amin(dim=-1), 0.0, cfg.fv_height - 1.0)
    r2 = torch.clamp(rows.amax(dim=-1), 0.0, cfg.fv_height - 1.0)
    c1 = torch.clamp(cols.amin(dim=-1), 0.0, cfg.fv_width - 1.0)
    c2 = torch.clamp(cols.amax(dim=-1), 0.0, cfg.fv_width - 1.0)
    return torch.stack([r1, c1, r2, c2], dim=-1)


def project_to_image_space(anchors: torch.Tensor, p2: torch.Tensor, image_hw, normalize: bool = True):
    """[..., N, 6] anchors -> [..., N, 4] image boxes [y1, x1, y2, x2]: the
    bounding rectangle of the 8 projected corners. Elementwise (no matmul),
    so the geometry stays true f32 on every device."""

    cx, cy, cz = _corners(anchors)

    def p(i, j):
        return p2[..., i, j][..., None, None]

    u_n = p(0, 0) * cx + p(0, 1) * cy + p(0, 2) * cz + p(0, 3)
    v_n = p(1, 0) * cx + p(1, 1) * cy + p(1, 2) * cz + p(1, 3)
    depth = p(2, 0) * cx + p(2, 1) * cy + p(2, 2) * cz + p(2, 3)
    depth = torch.clamp_min(depth, 1e-3)
    u = u_n / depth
    v = v_n / depth

    h_img, w_img = image_hw
    x1 = torch.clamp(u.amin(dim=-1), 0.0, w_img - 1.0)
    x2 = torch.clamp(u.amax(dim=-1), 0.0, w_img - 1.0)
    y1 = torch.clamp(v.amin(dim=-1), 0.0, h_img - 1.0)
    y2 = torch.clamp(v.amax(dim=-1), 0.0, h_img - 1.0)
    if normalize:
        x1, x2 = x1 / (w_img - 1.0), x2 / (w_img - 1.0)
        y1, y2 = y1 / (h_img - 1.0), y2 / (h_img - 1.0)
    return torch.stack([y1, x1, y2, x2], dim=-1)
