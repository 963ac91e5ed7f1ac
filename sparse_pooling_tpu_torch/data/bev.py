"""BEV height-slice + density map generation on the host (numpy).

Port of ``sparse_pooling_tpu.data.bev`` (capability parity with
``avod/core/bev_generators/bev_slices.py``): the BEV input tensor is N
height slices (per-cell max height above the ground plane, normalized by
slice thickness) plus one density channel ``min(1, log(n+1)/log(norm))``.
The device voxelizer, ``ops.bev_device``, computes the same maps in the
pipeline; the tests hold the two within 1e-5.
"""

from __future__ import annotations

import numpy as np

from sparse_pooling_tpu_torch.configs.config import AreaExtents, BevConfig
from sparse_pooling_tpu_torch.data.pointcloud import distance_to_plane, filter_to_area_extents
from sparse_pooling_tpu_torch.data.voxel_grid import point_cell_rc


def generate_bev_maps(
    points_cam: np.ndarray,
    ground_plane: np.ndarray,
    extents: AreaExtents,
    cfg: BevConfig,
) -> np.ndarray:
    """Points (already area-filtered or not) -> (H+pad, W, slices+1) float32.

    Matches the reference algorithm:
      * height above the road plane partitions [height_lo, height_hi) into
        ``height_slices`` equal slices;
      * each slice channel holds the per-cell max height within the slice
        (relative to the slice bottom), normalized by the slice thickness;
      * the density channel uses ALL points in the column.
    Row 0 is z = z_min; the ``pad_h`` extra rows are zeros (static-shape
    padding so H is divisible by the backbone stride).
    """

    points_cam = filter_to_area_extents(points_cam, extents)
    h, w = cfg.grid_hw(extents)
    n_slices = cfg.height_slices
    out = np.zeros((h + cfg.pad_h, w, n_slices + 1), dtype=np.float32)
    if points_cam.shape[0] == 0:
        return out

    heights = distance_to_plane(points_cam[:, :3], ground_plane) - cfg.height_lo
    slice_height = (cfg.height_hi - cfg.height_lo) / n_slices

    rc = point_cell_rc(points_cam, extents, cfg.voxel_size)
    lin = rc[:, 0].astype(np.int64) * w + rc[:, 1]

    # height slices: max height-in-slice per cell, normalized
    slice_idx = np.floor(heights / slice_height).astype(np.int64)
    in_range = (slice_idx >= 0) & (slice_idx < n_slices)
    if np.any(in_range):
        lin_s = lin[in_range] * n_slices + slice_idx[in_range]
        rel_h = heights[in_range] - slice_idx[in_range] * slice_height
        flat = np.zeros((h * w * n_slices,), dtype=np.float64)
        np.maximum.at(flat, lin_s, rel_h)
        maps = flat.reshape(h, w, n_slices) / slice_height
        out[:h, :, :n_slices] = maps.astype(np.float32)

    # density channel over all points in the column
    counts = np.zeros((h * w,), dtype=np.int64)
    np.add.at(counts, lin, 1)
    density = np.minimum(
        1.0, np.log(counts.astype(np.float64) + 1.0) / np.log(cfg.density_log_norm)
    ).reshape(h, w)
    out[:h, :, n_slices] = density.astype(np.float32)
    return out
