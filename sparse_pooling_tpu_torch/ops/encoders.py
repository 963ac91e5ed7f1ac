"""Box and anchor encodings used by inference and the losses (elementwise
f32).

Port of the box_4c and anchor encodings of ``sparse_pooling_tpu.ops.encoders``:
  box_3d   [x, y, z, l, w, h, ry]  (y = bottom centre, ry about y)
  anchor   [x, y, z, dim_x, dim_y, dim_z] (axis-aligned)
  offsets  [(dx)/dim_x, (dy)/dim_y, (dz)/dim_z, log dim ratios]
  box_4c   [x1..x4, z1..z4, h1, h2]
All functions are rank-polymorphic over leading dims.
"""

from __future__ import annotations

import math

import torch


def box_3d_to_anchor(boxes_3d: torch.Tensor) -> torch.Tensor:
    """[..., 7] box_3d -> [..., 6] axis-aligned anchors (nearest 90-degree
    yaw bin decides which of l, w lies along x)."""

    x, y, z, l, w, h, ry = boxes_3d.unbind(-1)
    keep = torch.abs(torch.cos(ry)) >= torch.abs(torch.sin(ry))
    dim_x = torch.where(keep, l, w)
    dim_z = torch.where(keep, w, l)
    return torch.stack([x, y, z, dim_x, h, dim_z], dim=-1)


def anchor_to_box_3d(anchors: torch.Tensor, ry: torch.Tensor = None) -> torch.Tensor:
    """[..., 6] anchors (+ optional ry) -> [..., 7] box_3d."""

    x, y, z, dim_x, dim_y, dim_z = anchors[..., :6].unbind(-1)
    if ry is None:
        ry = torch.zeros_like(x)
    keep = torch.abs(torch.cos(ry)) >= torch.abs(torch.sin(ry))
    l = torch.where(keep, dim_x, dim_z)
    w = torch.where(keep, dim_z, dim_x)
    return torch.stack([x, y, z, l, w, dim_y, ry], dim=-1)


def anchor_to_offset(anchors: torch.Tensor, gt_anchors: torch.Tensor) -> torch.Tensor:
    """RPN regression targets [..., 6]: translation over the anchor's dims,
    dims as log ratios."""

    t_xyz = (gt_anchors[..., :3] - anchors[..., :3]) / anchors[..., 3:6]
    t_dim = torch.log(gt_anchors[..., 3:6] / anchors[..., 3:6])
    return torch.cat([t_xyz, t_dim], dim=-1)


def offset_to_anchor(anchors: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Apply RPN regression offsets to anchors."""

    xyz = anchors[..., :3] + offsets[..., :3] * anchors[..., 3:6]
    dims = anchors[..., 3:6] * torch.exp(offsets[..., 3:6])
    return torch.cat([xyz, dims], dim=-1)


def angle_to_vector(ry: torch.Tensor) -> torch.Tensor:
    """ry [...] -> [..., 2] (cos, sin)."""

    return torch.stack([torch.cos(ry), torch.sin(ry)], dim=-1)


def vector_to_angle(vec: torch.Tensor) -> torch.Tensor:
    return torch.atan2(vec[..., 1], vec[..., 0])


def heading_flip_bit(ry: torch.Tensor) -> torch.Tensor:
    """1 (int64) where ry lies outside the canonical band [-pi/2, pi/2)
    (mod 2 pi): the flip head's target."""

    w = torch.remainder(ry + math.pi / 2, 2 * math.pi)
    return (w >= math.pi).to(torch.int64)


def _mod(a, m):
    """Floor modulo (numpy/jnp.mod sign convention)."""

    return torch.remainder(a, m)


def canonical_heading(ry: torch.Tensor) -> torch.Tensor:
    """Wrap ry into the canonical band [-pi/2, pi/2) (mod pi)."""

    return _mod(ry + math.pi / 2, math.pi) - math.pi / 2


def apply_heading_flip(ry: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """Canonicalize ry (mod pi) then add pi where flip == 1, in (-pi, pi]."""

    out = canonical_heading(ry) + flip.to(torch.float32) * math.pi
    return torch.where(out > math.pi, out - 2 * math.pi, out)


def box_3d_to_corners(boxes_3d: torch.Tensor) -> torch.Tensor:
    """[..., 7] box_3d -> [..., 8, 3] corners: bottom face then top face."""

    x, y, z, l, w, h, ry = boxes_3d.unbind(-1)
    lx = torch.stack([l / 2, l / 2, -l / 2, -l / 2], dim=-1)
    lz = torch.stack([w / 2, -w / 2, -w / 2, w / 2], dim=-1)
    c, s = torch.cos(ry)[..., None], torch.sin(ry)[..., None]
    gx = c * lx + s * lz + x[..., None]
    gz = -s * lx + c * lz + z[..., None]
    gy = y[..., None].expand_as(gx)
    bottom = torch.stack([gx, gy, gz], dim=-1)  # [..., 4, 3]
    top = torch.stack([gx, gy - h[..., None].expand_as(gx), gz], dim=-1)
    return torch.cat([bottom, top], dim=-2)


def _unit_plane(ground_plane: torch.Tensor) -> torch.Tensor:
    norm = torch.sqrt(torch.sum(ground_plane[..., :3] ** 2, dim=-1, keepdim=True))
    return ground_plane / torch.clamp_min(norm, 1e-12)


def box_3d_to_box_4c(boxes_3d: torch.Tensor, ground_plane: torch.Tensor) -> torch.Tensor:
    """[..., 7] box_3d -> [..., 10] box_4c: footprint corners starting at the
    one with the largest (x + z) offset, plus bottom/top heights above the
    (unit-normalized) ground plane."""

    plane = _unit_plane(ground_plane)
    corners = box_3d_to_corners(boxes_3d)
    ground = corners[..., :4, :]
    a, b, c, d = plane.unbind(-1)
    y_bottom = boxes_3d[..., 1]
    y_top = boxes_3d[..., 1] - boxes_3d[..., 5]
    x0, z0 = boxes_3d[..., 0], boxes_3d[..., 2]
    h1 = a * x0 + b * y_bottom + c * z0 + d
    h2 = a * x0 + b * y_top + c * z0 + d

    rel = ground[..., 0] - x0[..., None] + ground[..., 2] - z0[..., None]
    start = torch.argmax(rel, dim=-1)
    idx = (start[..., None] + torch.arange(4, device=rel.device)) % 4
    ordered = torch.take_along_dim(ground, idx[..., None], dim=-2)
    return torch.cat(
        [ordered[..., 0], ordered[..., 2], h1[..., None], h2[..., None]], dim=-1
    )


def box_4c_to_box_3d(box_4c: torch.Tensor, ground_plane: torch.Tensor) -> torch.Tensor:
    """[..., 10] box_4c -> [..., 7] box_3d (best-fit rectangle decode)."""

    plane = _unit_plane(ground_plane)
    xs, zs = box_4c[..., :4], box_4c[..., 4:8]
    h1, h2 = box_4c[..., 8], box_4c[..., 9]
    xc = torch.mean(xs, dim=-1)
    zc = torch.mean(zs, dim=-1)

    ex = (xs[..., 1] - xs[..., 0] + xs[..., 2] - xs[..., 3]) / 2
    ez = (zs[..., 1] - zs[..., 0] + zs[..., 2] - zs[..., 3]) / 2
    fx = (xs[..., 3] - xs[..., 0] + xs[..., 2] - xs[..., 1]) / 2
    fz = (zs[..., 3] - zs[..., 0] + zs[..., 2] - zs[..., 1]) / 2
    len_e = torch.sqrt(ex**2 + ez**2)
    len_f = torch.sqrt(fx**2 + fz**2)
    e_longer = len_e >= len_f
    l = torch.where(e_longer, len_e, len_f)
    w = torch.where(e_longer, len_f, len_e)
    ry = torch.where(e_longer, torch.atan2(-ez, ex), torch.atan2(-fz, fx))
    ry = torch.where(ry > math.pi / 2, ry - math.pi, ry)
    ry = torch.where(ry <= -math.pi / 2, ry + math.pi, ry)

    a, b, c, d = plane.unbind(-1)
    y = (h1 - a * xc - c * zc - d) / b
    h = torch.abs(h2 - h1)
    return torch.stack([xc, y, zc, l, w, h, ry], dim=-1)


def box_4c_to_offsets(box_4c: torch.Tensor, gt_box_4c: torch.Tensor) -> torch.Tensor:
    """Stage-2 regression target: the plain difference."""

    return gt_box_4c - box_4c


def offsets_to_box_4c(box_4c: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    return box_4c + offsets
