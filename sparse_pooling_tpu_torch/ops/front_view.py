"""MV3D's LiDAR front view (Chen et al., arXiv:1611.07759, section 3.1),
built on the device for a batch, with no host sync.

The points arrive in the camera frame (x right, y down, z forward) with the
intensity as a fourth column. Taken into the LiDAR's axes (x forward, y
left, z up) about the camera origin, a point lies on the cylinder at the
column index ``c = floor(atan2(y, x) / dtheta)`` and the row index
``r = floor(atan2(z, sqrt(x^2 + y^2)) / dphi)``; the map, drawn as an image
(left to right, top to bottom), puts it at column ``W/2 - 1 - c`` and row
``fv_top - 1 - r`` (``configs.config.Mv3dConfig``). Points outside the map
are dropped. A cell holds three channels of its nearest point (the least
distance ``sqrt(x^2 + y^2)``, ties to the lowest point index): the height
above the frame's ground plane, that distance, and the intensity; an empty
cell reads 0.
"""

from __future__ import annotations

import torch

from sparse_pooling_tpu_torch.configs.config import Mv3dConfig
from sparse_pooling_tpu_torch.ops.bev_device import cell_winner, gather_points, ground_heights

FV_CHANNELS = 3  # height, distance, intensity


def lidar_cylinder(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor):
    """Camera-frame coordinates -> (azimuth atan2(y, x), elevation
    atan2(z, rho), rho) in the LiDAR's axes about the camera origin."""

    lx, ly, lz = z, -x, -y
    rho = torch.sqrt(lx * lx + ly * ly)
    return torch.atan2(ly, lx), torch.atan2(lz, rho), rho


def front_view_batch(
    points: torch.Tensor,  # [B, P, 4] f32 camera frame, intensity last
    mask: torch.Tensor,  # [B, P] bool
    ground_plane: torch.Tensor,  # [B, 4] f32
    cfg: Mv3dConfig,
) -> torch.Tensor:
    """The front-view map [B, fv_height, fv_width, 3] f32."""

    bsz = points.shape[0]
    h, w = cfg.fv_height, cfg.fv_width
    dtheta, dphi = cfg.fv_steps
    azimuth, elevation, rho = lidar_cylinder(points[..., 0], points[..., 1], points[..., 2])
    col = w // 2 - 1 - torch.floor(azimuth / dtheta).to(torch.int64)
    row = cfg.fv_top - 1 - torch.floor(elevation / dphi).to(torch.int64)
    valid = mask & (row >= 0) & (row < h) & (col >= 0) & (col < w)
    win = cell_winner(row * w + col, rho, valid, h * w, largest=False)
    features = torch.stack([ground_heights(points, ground_plane), rho, points[..., 3]], dim=-1)
    return gather_points(features, win).reshape(bsz, h, w, FV_CHANNELS)
