"""Synthetic KITTI-like frames with real-scan statistics (host, numpy).

The same generator as the JAX package's benchmark frames
(``__graft_entry__._synthetic_raw``): ground points from a downward beam
fan, car-sized clusters with 1/r^2 point budgets, and lateral clutter. Given
the same seed it yields the same points, calibration and plane, so a frame
can be fed to both packages. ``image="noise"`` draws a seeded uint8 image
instead of the constant-96 canvas, which would hide image-side indexing bugs.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def synthetic_frame(
    cfg_model, n_points: int = 4096, seed: int = 0, image: str = "constant"
) -> Dict[str, np.ndarray]:
    """One frame as a dict of numpy arrays keyed like ``pipeline.RawSample``."""

    rng = np.random.RandomState(seed)
    p = cfg_model.sparse_pool.max_points
    pts = np.zeros((p, 3), np.float32)
    n = min(n_points, p)
    sensor_h = 1.65  # camera/velodyne height above ground (camera y down)

    n_ground = int(n * 0.62)
    n_obj = int(n * 0.26)
    n_clutter = n - n_ground - n_obj

    # ground: HDL-64-style downward beam fan; r = h / tan(-elev)
    elev = rng.uniform(np.radians(0.8), np.radians(24.0), n_ground)
    r = np.clip(sensor_h / np.tan(elev), 2.0, 68.0)
    az = rng.uniform(np.radians(-42), np.radians(42), n_ground)
    gx = r * np.sin(az)
    gz = r * np.cos(az)
    gy = np.full(n_ground, sensor_h) + rng.normal(0, 0.03, n_ground)

    # objects: car-sized clusters on the facing surfaces, point budget per
    # cluster ~ 1/r^2 (solid angle)
    n_clusters = 12
    cz = rng.uniform(6, 60, n_clusters)
    cx = rng.uniform(-0.45, 0.45, n_clusters) * cz  # inside the frustum
    budget = 1.0 / np.maximum(cz, 4.0) ** 2
    counts = np.maximum((budget / budget.sum() * n_obj).astype(int), 8)
    ox, oy, oz = [], [], []
    for k in range(n_clusters):
        m = counts[k]
        ox.append(cx[k] + rng.uniform(-1.95, 1.95, m))
        oz.append(cz[k] + np.abs(rng.normal(0, 0.35, m)))  # facing side
        oy.append(sensor_h - rng.uniform(0.0, 1.55, m))  # up from ground
    ox = np.concatenate(ox)[:n_obj]
    oy = np.concatenate(oy)[:n_obj]
    oz = np.concatenate(oz)[:n_obj]
    pad = n_obj - len(ox)
    if pad > 0:  # rounding shortfall -> more ground
        extra_az = rng.uniform(np.radians(-42), np.radians(42), pad)
        extra_r = np.clip(sensor_h / np.tan(rng.uniform(0.02, 0.4, pad)), 2, 68)
        ox = np.concatenate([ox, extra_r * np.sin(extra_az)])
        oz = np.concatenate([oz, extra_r * np.cos(extra_az)])
        oy = np.concatenate([oy, np.full(pad, sensor_h)])

    # clutter: vertical structures (walls/poles) at the lateral edges
    wz = rng.uniform(4, 50, n_clutter)
    side = np.sign(rng.randn(n_clutter))
    wx = side * (0.5 * wz + rng.uniform(0, 3, n_clutter))
    wy = sensor_h - rng.uniform(0.0, 2.4, n_clutter)

    pts[:n, 0] = np.concatenate([gx, ox, wx])[:n]
    pts[:n, 1] = np.concatenate([gy, oy, wy])[:n]
    pts[:n, 2] = np.concatenate([gz, oz, wz])[:n]
    mask = np.zeros((p,), bool)
    mask[:n] = True
    ih, iw = cfg_model.image.height, cfg_model.image.width
    fx = 721.0 * iw / 1242.0
    fy = 721.0 * ih / 375.0
    p2 = np.array(
        [[fx, 0.0, iw / 2.0, 0.0], [0.0, fy, ih / 2.0, 0.0], [0.0, 0.0, 1.0, 0.0]],
        np.float32,
    )
    gt = np.zeros((8, 7), np.float32)
    gt[0] = [2.0, 1.65, 22.0, 3.9, 1.6, 1.5, 0.1]
    gt_valid = np.zeros((8,), bool)
    gt_valid[0] = True
    gt_cls = np.zeros((8,), np.int32)
    gt_cls[0] = 1
    if image == "constant":
        img = np.full((ih, iw, 3), 96, np.uint8)
    elif image == "noise":
        img = np.random.RandomState(seed + 7919).randint(
            0, 256, (ih, iw, 3)
        ).astype(np.uint8)
    else:
        raise ValueError(f"image must be 'constant' or 'noise', got {image!r}")
    return {
        "points": pts,
        "points_mask": mask,
        "image": img,
        "p2": p2,
        "ground_plane": np.array([0.0, -1.0, 0.0, 1.65], np.float32),
        "gt_boxes_3d": gt,
        "gt_valid": gt_valid,
        "gt_classes": gt_cls,
        # canvas-sized image: identity in-graph resize
        "image_scale": np.ones((2,), np.float32),
    }


def pick_bucket(n: int, buckets, cap: int) -> int:
    """Smallest configured bucket holding ``n`` valid points (else the cap)."""

    for b in buckets:
        if b >= n:
            return int(b)
    return int(cap)


def trim_points_to_bucket(
    points_b: np.ndarray,  # [B, cap, 3] prefix-packed
    mask_b: np.ndarray,  # [B, cap] bool
    buckets,  # ascending capacities, last == cap (SparsePoolConfig.buckets)
) -> Tuple[np.ndarray, np.ndarray]:
    """Slice a stacked batch's padded point arrays to the smallest bucket
    holding every frame's valid points. Valid points are a prefix of each
    row, so the slice is lossless."""

    n = int(mask_b.sum(axis=1).max()) if mask_b.size else 0
    b = min(pick_bucket(n, buckets, points_b.shape[1]), points_b.shape[1])
    return points_b[:, :b], mask_b[:, :b]
