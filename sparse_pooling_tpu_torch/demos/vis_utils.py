"""Visualization utilities (host, numpy).

Port of ``sparse_pooling_tpu.demos.vis_utils`` (capability parity with
``wavedata/tools/visualization/vis_utils.py`` and the drawing helpers behind
``demos/show_predictions_2d.py``): draw 2D bounding boxes and projected 3D
wireframes on camera images, and render BEV maps with box footprints. The
JAX package draws with Pillow; the port draws with ``demos.raster``, which
follows Pillow's rasterization pixel for pixel (the score text excepted: the
port's own digit glyphs).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from sparse_pooling_tpu_torch.configs.config import AreaExtents
from sparse_pooling_tpu_torch.data.calib import project_to_image
from sparse_pooling_tpu_torch.data.labels import ObjectLabel
from sparse_pooling_tpu_torch.demos import raster
from sparse_pooling_tpu_torch.ops import encoders

CLASS_COLORS = {
    "Car": (60, 200, 90),
    "Pedestrian": (250, 180, 50),
    "Cyclist": (90, 130, 250),
    "gt": (240, 70, 70),
}
# 3D wireframe edges over the box_3d_to_corners ordering (bottom 0-3, top 4-7)
_BOX_EDGES = [
    (0, 1), (1, 2), (2, 3), (3, 0),
    (4, 5), (5, 6), (6, 7), (7, 4),
    (0, 4), (1, 5), (2, 6), (3, 7),
]


def _corners(box_3d: np.ndarray) -> np.ndarray:
    """[7] box -> [8, 3] f32 corners, as the reference's encoder gives them."""

    return encoders.box_3d_to_corners(torch.from_numpy(np.asarray(box_3d, np.float32)[None]))[0].numpy()


def score_text_origin(ob: ObjectLabel):
    """Where ``draw_boxes_2d`` writes a box's score: above its top left."""

    return ob.x1 + 2, max(ob.y1 - 12, 0)


def draw_boxes_2d(image: np.ndarray, labels: Sequence[ObjectLabel], color_key: Optional[str] = None,
                  width: int = 2) -> np.ndarray:
    """Draw axis-aligned 2D boxes (+score text) on a uint8 image copy."""

    img = np.array(image, dtype=np.uint8)
    for ob in labels:
        color = CLASS_COLORS.get(color_key or ob.type, (255, 255, 255))
        raster.rectangle(img, [ob.x1, ob.y1, ob.x2, ob.y2], color, width)
        if ob.score < 1.0:
            raster.text(img, score_text_origin(ob), f"{ob.score:.2f}", color)
    return img


def draw_boxes_3d(image: np.ndarray, labels: Sequence[ObjectLabel], p2: np.ndarray,
                  color_key: Optional[str] = None, width: int = 2) -> np.ndarray:
    """Draw projected 3D wireframes on a uint8 image copy."""

    img = np.array(image, dtype=np.uint8)
    for ob in labels:
        color = CLASS_COLORS.get(color_key or ob.type, (255, 255, 255))
        corners = _corners(ob.box_3d())
        if (corners[:, 2] <= 0.1).any():
            continue
        uv = project_to_image(corners, p2)
        if not np.isfinite(uv).all():
            continue
        for a, b in _BOX_EDGES:
            raster.line(img, [tuple(uv[a]), tuple(uv[b])], color, width)
    return img


def render_bev(bev_maps: np.ndarray, boxes_3d: Optional[np.ndarray] = None,
               gt_boxes_3d: Optional[np.ndarray] = None, extents: AreaExtents = AreaExtents(),
               voxel_size: float = 0.1) -> np.ndarray:
    """Render the BEV density channel with box footprints -> uint8 RGB.

    Row 0 (z_min) is drawn at the BOTTOM (ego at the bottom of the image).
    """

    density = bev_maps[..., -1]
    base = (np.clip(density, 0, 1) * 255).astype(np.uint8)
    img = np.stack([base] * 3, axis=-1)

    def footprint_px(box):
        corners = _corners(box)[:4]
        cols = (corners[:, 0] - extents.x_min) / voxel_size
        rows = (corners[:, 2] - extents.z_min) / voxel_size
        return list(zip(cols.tolist(), rows.tolist()))

    if gt_boxes_3d is not None:
        for box in np.asarray(gt_boxes_3d):
            raster.polygon(img, footprint_px(box), CLASS_COLORS["gt"])
    if boxes_3d is not None:
        for box in np.asarray(boxes_3d):
            raster.polygon(img, footprint_px(box), CLASS_COLORS["Car"])
    return np.ascontiguousarray(img[::-1])  # flip so z grows upward
