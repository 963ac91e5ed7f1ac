"""KITTI-format prediction writer (host, numpy).

The port's copy of ``sparse_pooling_tpu.runtime.predictions``: one txt per
frame, rows ``type trunc occ alpha x1 y1 x2 y2 h w l x y z ry score`` in RAW
image coordinates, read by the KITTI AP evaluator. ``write_predictions``
formats with the native formatter (``native/pred_format``);
``detections_to_kitti_rows`` is the Python formatter, its byte-identical
twin in the tests. The writer reads numpy arrays only: the evaluator reads
the detections back from the card before it calls it.
"""

from __future__ import annotations

import os
from typing import Dict, Sequence

import numpy as np

from sparse_pooling_tpu_torch.data.calib import project_to_image
from sparse_pooling_tpu_torch.native import pred_format


def _box_3d_to_corners_np(boxes: np.ndarray) -> np.ndarray:
    """[N, 7] box_3d -> [N, 8, 3] corners: numpy twin of
    ``ops.encoders.box_3d_to_corners`` (the same corner order)."""

    x, y, z, l, w, h, ry = [boxes[:, i] for i in range(7)]
    lx = np.stack([l / 2, l / 2, -l / 2, -l / 2], axis=-1)
    lz = np.stack([w / 2, -w / 2, -w / 2, w / 2], axis=-1)
    c, s = np.cos(ry)[:, None], np.sin(ry)[:, None]
    gx = c * lx + s * lz + x[:, None]
    gz = -s * lx + c * lz + z[:, None]
    gy = np.broadcast_to(y[:, None], gx.shape)
    bottom = np.stack([gx, gy, gz], axis=-1)  # [N, 4, 3]
    top = bottom.copy()
    top[..., 1] -= np.broadcast_to(h[:, None], gx.shape)
    return np.concatenate([bottom, top], axis=1)


def _detections_numeric_block(
    det: Dict[str, np.ndarray],
    p2_raw: np.ndarray,
    raw_image_hw,
    score_threshold: float,
):
    """Decoded per-class detections -> (num [N, 13] f64, cls [N] i32).

    Fully vectorized (one corner/projection pass over every kept box),
    survivors in (class, k) order. Column order matches the KITTI row
    ``alpha x1 y1 x2 y2 h w l x y z ry score``.
    """

    boxes = np.asarray(det["boxes_3d"], dtype=np.float64)  # [C, K, 7]
    scores = np.asarray(det["scores"], dtype=np.float64)
    valid = np.asarray(det["valid"])
    h_img, w_img = raw_image_hw
    keep = valid & (scores >= score_threshold)
    ci_idx, k_idx = np.nonzero(keep)  # row-major: class, then k ascending
    if ci_idx.size == 0:
        return np.zeros((0, 13)), np.zeros((0,), np.int32)
    b = boxes[ci_idx, k_idx]  # [N, 7]
    corners = _box_3d_to_corners_np(b)
    uv = project_to_image(corners.reshape(-1, 3), p2_raw).reshape(-1, 8, 2)
    with np.errstate(invalid="ignore"):
        finite = np.isfinite(uv).all(axis=(1, 2))
        x1 = np.clip(np.nanmin(uv[:, :, 0], 1), 0, w_img - 1)
        x2 = np.clip(np.nanmax(uv[:, :, 0], 1), 0, w_img - 1)
        y1 = np.clip(np.nanmin(uv[:, :, 1], 1), 0, h_img - 1)
        y2 = np.clip(np.nanmax(uv[:, :, 1], 1), 0, h_img - 1)
    ok = finite & (x2 > x1) & (y2 > y1)
    alpha = b[:, 6] - np.arctan2(b[:, 0], b[:, 2])
    sc = scores[ci_idx, k_idx]
    num = np.column_stack(
        [alpha, x1, y1, x2, y2, b[:, 5], b[:, 4], b[:, 3],
         b[:, 0], b[:, 1], b[:, 2], b[:, 6], sc]
    )[ok]
    return num, ci_idx[ok].astype(np.int32)


def detections_to_kitti_rows(
    det: Dict[str, np.ndarray],
    class_names: Sequence[str],
    p2_raw: np.ndarray,
    raw_image_hw,
    score_threshold: float = 0.1,
):
    """Decoded per-class detections -> list of KITTI row strings: the
    Python formatter, byte-identical to the native one that
    ``write_predictions`` uses."""

    num, cls = _detections_numeric_block(
        det, p2_raw, raw_image_hw, score_threshold
    )
    fmt = " ".join(["%.6f"] * 13)
    return [
        f"{class_names[c]} -1 -1 " + fmt % tuple(r)
        for c, r in zip(cls, num)
    ]


def write_predictions(
    out_dir: str,
    sample_id: str,
    det: Dict[str, np.ndarray],
    class_names: Sequence[str],
    p2_raw: np.ndarray,
    raw_image_hw,
    score_threshold: float = 0.1,
):
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, sample_id + ".txt")
    num, cls = _detections_numeric_block(
        det, p2_raw, raw_image_hw, score_threshold
    )
    content = pred_format.format_rows(num, cls, class_names)
    with open(path, "wb") as f:
        f.write(content)
