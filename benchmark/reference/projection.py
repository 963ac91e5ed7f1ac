"""Anchor/box projection into BEV and image space (elementwise f32).

Port of ``sparse_pooling_tpu.ops.projection``. Rank-polymorphic: anchors may
be [..., N, 6]; ``p2`` may carry matching leading batch dims ([..., 3, 4]).
"""

from __future__ import annotations

import torch

from .config import AreaExtents


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


def project_to_image_space(anchors: torch.Tensor, p2: torch.Tensor, image_hw, normalize: bool = True):
    """[..., N, 6] anchors -> [..., N, 4] image boxes [y1, x1, y2, x2]: the
    bounding rectangle of the 8 projected corners. Elementwise (no matmul),
    so the geometry stays true f32 on every device."""

    x, y, z = anchors[..., 0], anchors[..., 1], anchors[..., 2]
    hx, hy, hz = anchors[..., 3] / 2, anchors[..., 4], anchors[..., 5] / 2

    kw = dict(dtype=anchors.dtype, device=anchors.device)
    sx = torch.tensor([1, 1, 1, 1, -1, -1, -1, -1], **kw)
    sy = torch.tensor([0, 0, 1, 1, 0, 0, 1, 1], **kw)
    sz = torch.tensor([1, -1, 1, -1, 1, -1, 1, -1], **kw)
    cx = x[..., None] + sx * hx[..., None]
    cy = y[..., None] - sy * hy[..., None]
    cz = z[..., None] + sz * hz[..., None]

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
