"""Velodyne point-cloud IO, frustum and area filtering, and the static point
capacities (host, numpy): the port's copy of
``sparse_pooling_tpu.data.pointcloud``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from sparse_pooling_tpu_torch.configs.config import AreaExtents
from sparse_pooling_tpu_torch.data.calib import FrameCalib, lidar_to_cam_frame, project_to_image


def load_velodyne(path: str) -> np.ndarray:
    """Read a KITTI ``velodyne/*.bin`` scan -> (N, 4) [x, y, z, reflectance]."""

    return np.fromfile(path, dtype=np.float32).reshape(-1, 4)


def get_lidar_point_cloud(
    velo_path: str,
    calib: FrameCalib,
    image_shape: Optional[Tuple[int, int]] = None,
) -> np.ndarray:
    """Load a scan and move it to the rectified camera frame (N, 3).

    If ``image_shape`` (h, w) is given, keep only points that project inside
    the image with positive depth — the reference does this so every LiDAR
    point has a valid front-view correspondence.
    """

    velo = load_velodyne(velo_path)
    pts_cam = lidar_to_cam_frame(velo, calib)
    if image_shape is not None:
        pts_cam = filter_to_image_frustum(pts_cam, calib.p2, image_shape)
    return pts_cam


def load_points_filtered(
    velo_path: str,
    calib: FrameCalib,
    image_shape: Tuple[int, int],
    extents: AreaExtents,
) -> np.ndarray:
    """Scan -> cam frame, image-frustum AND area-extents filtered in ONE
    masking pass (N, 3).

    Semantics == ``get_lidar_point_cloud(...)`` then
    ``filter_to_area_extents(...)``, in one mask (each boolean index copies
    the whole array). The native loader's ``load_points`` computes the same.
    """

    pts = lidar_to_cam_frame(load_velodyne(velo_path), calib)
    h, w = image_shape
    uv = project_to_image(pts, calib.p2)
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    m = (
        (z > 0.0)
        & (uv[:, 0] >= 0.0)
        & (uv[:, 0] <= w - 1.0)
        & (uv[:, 1] >= 0.0)
        & (uv[:, 1] <= h - 1.0)
        & (x >= extents.x_min)
        & (x < extents.x_max)
        & (y >= extents.y_min)
        & (y < extents.y_max)
        & (z >= extents.z_min)
        & (z < extents.z_max)
    )
    return pts[np.nan_to_num(m, nan=False)]


def filter_to_image_frustum(
    points_cam: np.ndarray, p2: np.ndarray, image_shape: Tuple[int, int]
) -> np.ndarray:
    """Keep camera-frame points visible in the image (depth > 0, in bounds)."""

    h, w = image_shape
    depth_ok = points_cam[:, 2] > 0.0
    uv = project_to_image(points_cam, p2)
    in_img = (
        (uv[:, 0] >= 0.0)
        & (uv[:, 0] <= w - 1.0)
        & (uv[:, 1] >= 0.0)
        & (uv[:, 1] <= h - 1.0)
    )
    return points_cam[depth_ok & np.nan_to_num(in_img, nan=False)]


def filter_to_area_extents(
    points_cam: np.ndarray, extents: AreaExtents
) -> np.ndarray:
    """Keep points inside the BEV area extents box (cam frame)."""

    m = (
        (points_cam[:, 0] >= extents.x_min)
        & (points_cam[:, 0] < extents.x_max)
        & (points_cam[:, 1] >= extents.y_min)
        & (points_cam[:, 1] < extents.y_max)
        & (points_cam[:, 2] >= extents.z_min)
        & (points_cam[:, 2] < extents.z_max)
    )
    return points_cam[m]


def distance_to_plane(points: np.ndarray, plane: np.ndarray) -> np.ndarray:
    """Signed distance of (N, 3) points to plane [a, b, c, d].

    The plane normal is oriented up (-y); positive distance = above the road.
    """

    return points @ plane[:3] + plane[3]


def filter_ground_offset(
    points_cam: np.ndarray,
    plane: np.ndarray,
    height_lo: float,
    height_hi: float,
) -> np.ndarray:
    """Keep points whose height above the ground plane is in [lo, hi).

    Reference: KittiUtils ground-plane slice filtering for BEV maps.
    """

    d = distance_to_plane(points_cam, plane)
    return points_cam[(d >= height_lo) & (d < height_hi)]


def pad_or_subsample(
    points: np.ndarray, cap: int, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Pad (with zeros) or deterministically subsample to a static cap:
    frames carry (points[cap, 3], valid_mask[cap]), valid points first."""

    n = points.shape[0]
    if n > cap:
        rng = np.random.RandomState(seed)
        idx = rng.choice(n, cap, replace=False)
        idx.sort()
        points = points[idx]
        n = cap
    out = np.zeros((cap, points.shape[1]), dtype=np.float32)
    out[:n] = points
    mask = np.zeros((cap,), dtype=bool)
    mask[:n] = True
    return out, mask


def pick_bucket(n: int, buckets, cap: int) -> int:
    """Smallest configured bucket holding ``n`` valid points (else the cap).

    Shared by the stacked-batch trim below and the prefix-slice stacker
    (``KittiDataset.stack_samples``) so both pick identical shapes."""

    for b in buckets:
        if b >= n:
            return int(b)
    return int(cap)


def trim_points_to_bucket(
    points_b: np.ndarray,  # [B, cap, 3] prefix-packed (pad_or_subsample)
    mask_b: np.ndarray,  # [B, cap] bool
    buckets,  # ascending capacities, last == cap (SparsePoolConfig.buckets)
) -> Tuple[np.ndarray, np.ndarray]:
    """Slice a stacked batch's padded point arrays to the smallest bucket
    holding every frame's valid points (SparsePoolConfig.point_buckets).

    Valid points are a PREFIX of each row (``pad_or_subsample`` packs them
    first), so the slice is lossless; downstream device costs (voxelize,
    COO build, SHPL pooling) then track the true point count instead of the
    cap.
    """

    n = int(mask_b.sum(axis=1).max()) if mask_b.size else 0
    b = min(pick_bucket(n, buckets, points_b.shape[1]), points_b.shape[1])
    return points_b[:, :b], mask_b[:, :b]
