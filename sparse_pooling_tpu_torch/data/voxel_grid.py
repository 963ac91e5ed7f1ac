"""2D/3D voxel grids over point clouds (host, numpy).

Port of ``sparse_pooling_tpu.data.voxel_grid`` (capability parity with
``wavedata/tools/core/voxel_grid_2d.py`` and the 3D variant): bin points into
(x, z) BEV cells (or (x, y, z) voxels), returning unique occupied cells,
per-cell counts, and per-cell height extents. The primitive under host BEV
maps (``data.bev``) and the offline empty-anchor filter
(``runtime.preprocess``); the device voxelizer is ``ops.bev_device``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from sparse_pooling_tpu_torch.configs.config import AreaExtents


@dataclasses.dataclass
class VoxelGrid2D:
    """Occupied-cell summary of a point cloud on the BEV (x, z) lattice.

    rows index z (forward), cols index x (lateral) — matching the BEV image
    layout used by the detector (H = z cells, W = x cells).
    """

    voxel_size: float
    extents: AreaExtents
    grid_hw: tuple
    cell_rc: np.ndarray  # (M, 2) int32 unique occupied (row, col)
    counts: np.ndarray  # (M,) points per occupied cell
    min_y: np.ndarray  # (M,) min camera-y per cell (highest point; y is down)
    max_y: np.ndarray  # (M,) max camera-y per cell

    def occupancy(self) -> np.ndarray:
        """(H, W) bool occupancy raster."""
        h, w = self.grid_hw
        occ = np.zeros((h, w), dtype=bool)
        occ[self.cell_rc[:, 0], self.cell_rc[:, 1]] = True
        return occ

    def count_map(self) -> np.ndarray:
        h, w = self.grid_hw
        cm = np.zeros((h, w), dtype=np.int32)
        cm[self.cell_rc[:, 0], self.cell_rc[:, 1]] = self.counts
        return cm


def point_cell_rc(
    points_cam: np.ndarray, extents: AreaExtents, voxel_size: float
) -> np.ndarray:
    """(N, 2) int32 (row=z cell, col=x cell) for camera-frame points.

    Points must already be inside the extents (see
    ``pointcloud.filter_to_area_extents``).
    """

    col = np.floor((points_cam[:, 0] - extents.x_min) / voxel_size)
    row = np.floor((points_cam[:, 2] - extents.z_min) / voxel_size)
    return np.stack([row, col], axis=1).astype(np.int32)


def voxelize_2d(
    points_cam: np.ndarray, extents: AreaExtents, voxel_size: float
) -> VoxelGrid2D:
    """Bin points into the BEV lattice (reference: ``VoxelGrid2D.voxelize_2d``).

    Sort by linear cell index, take unique cells, reduce per-cell count and
    y extents — exactly the reference's sort/unique algorithm.
    """

    h = int(round((extents.z_max - extents.z_min) / voxel_size))
    w = int(round((extents.x_max - extents.x_min) / voxel_size))
    if points_cam.shape[0] == 0:
        empty = np.zeros((0,), dtype=np.float64)
        return VoxelGrid2D(
            voxel_size, extents, (h, w),
            np.zeros((0, 2), dtype=np.int32),
            np.zeros((0,), dtype=np.int32), empty, empty,
        )

    rc = point_cell_rc(points_cam, extents, voxel_size)
    lin = rc[:, 0].astype(np.int64) * w + rc[:, 1]
    order = np.argsort(lin, kind="stable")
    lin_sorted = lin[order]
    y_sorted = points_cam[order, 1]

    uniq, starts, counts = np.unique(lin_sorted, return_index=True, return_counts=True)
    min_y = np.minimum.reduceat(y_sorted, starts)
    max_y = np.maximum.reduceat(y_sorted, starts)
    cell_rc = np.stack([uniq // w, uniq % w], axis=1).astype(np.int32)
    return VoxelGrid2D(
        voxel_size, extents, (h, w), cell_rc, counts.astype(np.int32), min_y, max_y
    )


def voxelize_3d(
    points_cam: np.ndarray,
    extents: AreaExtents,
    voxel_size: float,
) -> tuple:
    """3D voxel occupancy (reference: ``voxel_grid.py`` 3D variant).

    Returns (occupied_ijk (M, 3) int32 in (x, y, z) cell coords, grid_shape).
    Used by the 3D empty-anchor filter path.
    """

    gx = int(round((extents.x_max - extents.x_min) / voxel_size))
    gy = int(round((extents.y_max - extents.y_min) / voxel_size))
    gz = int(round((extents.z_max - extents.z_min) / voxel_size))
    if points_cam.shape[0] == 0:
        return np.zeros((0, 3), dtype=np.int32), (gx, gy, gz)
    i = np.floor((points_cam[:, 0] - extents.x_min) / voxel_size).astype(np.int64)
    j = np.floor((points_cam[:, 1] - extents.y_min) / voxel_size).astype(np.int64)
    k = np.floor((points_cam[:, 2] - extents.z_min) / voxel_size).astype(np.int64)
    lin = (i * gy + j) * gz + k
    uniq = np.unique(lin)
    k_u = uniq % gz
    j_u = (uniq // gz) % gy
    i_u = uniq // (gy * gz)
    return np.stack([i_u, j_u, k_u], axis=1).astype(np.int32), (gx, gy, gz)
