"""Integral images (summed-area tables) for O(1) occupancy queries.

Port of ``sparse_pooling_tpu.data.integral_image`` (capability parity with
``wavedata/tools/core/integral_image*.py``): the offline empty-anchor filter
(``runtime.preprocess``) counts points inside anchor footprints in O(1).
Numpy for host preprocessing; in the pipeline the anchor filter sums its
occupancy raster on the device (``ops.anchors``).
"""

from __future__ import annotations

import numpy as np


def integral_image_2d(grid: np.ndarray) -> np.ndarray:
    """(H, W) -> (H+1, W+1) summed-area table with a zero border."""

    ii = np.zeros((grid.shape[0] + 1, grid.shape[1] + 1), dtype=np.int64)
    ii[1:, 1:] = grid.astype(np.int64).cumsum(axis=0).cumsum(axis=1)
    return ii


def query_boxes_2d(ii: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """Sum inside half-open cell boxes [r0, c0, r1, c1) — (N,) int64.

    Boxes are integer cell coordinates, clipped to the grid.
    """

    h, w = ii.shape[0] - 1, ii.shape[1] - 1
    r0 = np.clip(boxes[:, 0], 0, h)
    c0 = np.clip(boxes[:, 1], 0, w)
    r1 = np.clip(boxes[:, 2], 0, h)
    c1 = np.clip(boxes[:, 3], 0, w)
    return ii[r1, c1] - ii[r0, c1] - ii[r1, c0] + ii[r0, c0]


def integral_image_3d(grid: np.ndarray) -> np.ndarray:
    """(X, Y, Z) -> (X+1, Y+1, Z+1) 3D summed-volume table."""

    ii = np.zeros(tuple(s + 1 for s in grid.shape), dtype=np.int64)
    ii[1:, 1:, 1:] = (
        grid.astype(np.int64).cumsum(axis=0).cumsum(axis=1).cumsum(axis=2)
    )
    return ii


def query_boxes_3d(ii: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """Sum inside half-open voxel boxes [x0,y0,z0,x1,y1,z1) — (N,) int64."""

    gx, gy, gz = (s - 1 for s in ii.shape)
    x0 = np.clip(boxes[:, 0], 0, gx)
    y0 = np.clip(boxes[:, 1], 0, gy)
    z0 = np.clip(boxes[:, 2], 0, gz)
    x1 = np.clip(boxes[:, 3], 0, gx)
    y1 = np.clip(boxes[:, 4], 0, gy)
    z1 = np.clip(boxes[:, 5], 0, gz)
    return (
        ii[x1, y1, z1] - ii[x0, y1, z1] - ii[x1, y0, z1] - ii[x1, y1, z0]
        + ii[x0, y0, z1] + ii[x0, y1, z0] + ii[x1, y0, z0] - ii[x0, y0, z0]
    )
