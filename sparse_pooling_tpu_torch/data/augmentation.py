"""Per-sample data augmentation (host, numpy): the port's copy of
``sparse_pooling_tpu.data.augmentation``.

Horizontal flip (image + camera-frame points + P2 principal-point mirror +
label mirror) and PCA-based color jitter, with the same
``np.random.RandomState`` draws in the same order.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from sparse_pooling_tpu_torch.data.calib import FrameCalib
from sparse_pooling_tpu_torch.data.labels import ObjectLabel


def flip_points(points_cam: np.ndarray) -> np.ndarray:
    """Mirror camera-frame points across the x=0 plane."""

    out = points_cam.copy()
    out[:, 0] = -out[:, 0]
    return out


def flip_calib_p2(p2: np.ndarray, image_width: int) -> np.ndarray:
    """Mirror the projection matrix for a horizontally flipped image.

    Derived so that projecting mirrored points (x -> -x) through the flipped
    matrix gives exactly u' = (W-1) - u, including P2's row-2 translation
    term: u' = [fx*(-x) + (W-1-cx)*z + ((W-1)*tz - tx)] / (z + tz).
    (The reference's kitti_aug flips cx only, which is exact when tz = 0.)
    """

    out = p2.copy()
    wm1 = image_width - 1.0
    out[0, 2] = wm1 - p2[0, 2]
    out[0, 3] = wm1 * p2[2, 3] - p2[0, 3]
    return out


def flip_label(ob: ObjectLabel, image_width: int) -> ObjectLabel:
    t = (-ob.t[0], ob.t[1], ob.t[2])
    ry = np.pi - ob.ry
    if ry > np.pi:
        ry -= 2 * np.pi
    return ObjectLabel(
        type=ob.type, truncation=ob.truncation, occlusion=ob.occlusion,
        alpha=-ob.alpha,
        x1=image_width - 1.0 - ob.x2, y1=ob.y1,
        x2=image_width - 1.0 - ob.x1, y2=ob.y2,
        h=ob.h, w=ob.w, l=ob.l, t=t, ry=float(ry), score=ob.score,
    )


def flip_sample(
    image: np.ndarray,
    points_cam: np.ndarray,
    calib: FrameCalib,
    labels: List[ObjectLabel],
) -> Tuple[np.ndarray, np.ndarray, FrameCalib, List[ObjectLabel]]:
    w = image.shape[1]
    flipped = FrameCalib(
        p2=flip_calib_p2(calib.p2, w),
        r0_rect=calib.r0_rect,
        tr_velo_to_cam=calib.tr_velo_to_cam,
    )
    return (
        image[:, ::-1].copy(),
        flip_points(points_cam),
        flipped,
        [flip_label(ob, w) for ob in labels],
    )


def pca_jitter(image: np.ndarray, rng: np.random.RandomState, sigma: float = 0.1) -> np.ndarray:
    """AlexNet-style PCA color jitter (reference: kitti_aug.apply_pca_jitter).

    The covariance comes from a 4x4-strided pixel subsample and the
    per-channel constant offset is applied through a 256-entry LUT, the
    exact per-pixel mapping of the float form.
    """

    flat = image[::4, ::4].reshape(-1, 3).astype(np.float32) / 255.0
    cov = np.cov(flat, rowvar=False)
    eigval, eigvec = np.linalg.eigh(cov)
    alpha = rng.normal(0.0, sigma, size=3)
    noise = eigvec @ (alpha * eigval)
    # LUT[c][v] == trunc(clip(v/255 + noise_c, 0, 1) * 255), the exact
    # per-pixel mapping of the float form
    v = np.arange(256, dtype=np.float32)[None, :] / 255.0
    lut = (np.clip(v + noise[:, None].astype(np.float32), 0.0, 1.0) * 255.0).astype(
        np.uint8
    )
    out = np.empty_like(image)
    for c in range(3):
        out[..., c] = lut[c][image[..., c]]
    return out
