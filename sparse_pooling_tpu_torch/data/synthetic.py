"""Deterministic synthetic mini-KITTI tree (host, numpy + stdlib): the port's
copy of ``sparse_pooling_tpu.data.synthetic`` for the cars scene.

No KITTI data ships with the repository, so this writes a miniature KITTI
object tree (``calib/ velodyne/ image_2/ label_2/ planes/`` and the split
files) from seeds: a ground plane of LiDAR points plus car-shaped (and the
odd pedestrian) point clusters that project consistently into a synthetic
camera. Given the same arguments it writes the same text and ``.bin`` files
as the JAX package's writer and PNGs that decode to the same pixels; the
PNGs are encoded here with ``zlib`` (filter 0, 8-bit RGB), not PIL. The
hard and people scenes are not ported.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import List, Sequence

import numpy as np

# Canonical KITTI left-color camera intrinsics/extrinsics (typical values).
KITTI_IMAGE_HW = (375, 1242)
_P2 = np.array(
    [
        [721.5377, 0.0, 609.5593, 44.85728],
        [0.0, 721.5377, 172.854, 0.2163791],
        [0.0, 0.0, 1.0, 0.002745884],
    ]
)
_R0 = np.eye(3)
# velodyne frame: x forward, y left, z up  ->  cam frame: x right, y down, z forward
_TR_VELO = np.array(
    [
        [0.0, -1.0, 0.0, 0.0],
        [0.0, 0.0, -1.0, -0.08],
        [1.0, 0.0, 0.0, -0.27],
    ]
)
_PLANE = (0.0, -1.0, 0.0, 1.65)  # flat road 1.65 m below the camera


def _box_points(rng, x, y, z, l, w, h, ry, n, obj_type=None):
    """Sample LiDAR-ish points on the visible surfaces of a 3D box (cam frame).

    (x, y, z) is the bottom-center (KITTI convention); returns (n, 3).
    ``obj_type`` adds the heading-observable geometry real objects carry (a
    car's roof over the rear 60% and a hood-height front wall; a cyclist's
    rider over the rear half; a pedestrian's head slightly back), so the
    box's heading is not symmetric under a pi flip. ``None`` keeps a
    symmetric box.
    """

    face = rng.randint(0, 3, size=n)
    u = rng.uniform(-0.5, 0.5, size=n)
    v = rng.uniform(-0.5, 0.5, size=n)
    top = face == 2
    front_wall = (face == 0) & (u > 0)
    hty = rng.uniform(0.6, 1.0, size=n)  # top-band height fraction
    wty = rng.uniform(0.0, 1.0, size=n)  # wall height fraction
    if obj_type == "Car":
        u = np.where(top, -0.5 + 0.6 * (u + 0.5), u)  # roof: rear 60%
        wty = np.where(front_wall, wty * 0.5, wty)  # hood-height front wall
    elif obj_type == "Cyclist":
        u = np.where(top, -0.5 + 0.5 * (u + 0.5), u)  # rider: rear half
        wty = np.where(front_wall, wty * 0.6, wty)  # front wheel
    elif obj_type == "Pedestrian":
        u = np.where(top, -0.5 + 0.7 * (u + 0.5), u)  # head slightly back
    px = np.where(face == 0, np.sign(u) * 0.5, u) * l
    pz = np.where(face == 1, np.sign(v) * 0.5, v) * w
    py = np.where(top, -hty, -wty) * h
    c, s = np.cos(ry), np.sin(ry)
    rx = c * px + s * pz
    rz = -s * px + c * pz
    return np.stack([x + rx, y + py, z + rz], axis=1)


def _cam_to_velo(points_cam: np.ndarray) -> np.ndarray:
    tr = np.eye(4)
    tr[:3] = _TR_VELO
    inv = np.linalg.inv(tr)
    xyz1 = np.concatenate([points_cam, np.ones((points_cam.shape[0], 1))], axis=1)
    return (xyz1 @ inv.T)[:, :3]


def _project(points_cam: np.ndarray) -> np.ndarray:
    xyz1 = np.concatenate([points_cam, np.ones((points_cam.shape[0], 1))], axis=1)
    uvw = xyz1 @ _P2.T
    return uvw[:, :2] / uvw[:, 2:3]


def _scene_objects(rng, idx: int) -> List[dict]:
    """The cars scene: 2-4 cars, and a pedestrian in every other frame."""

    objs = []
    n_cars = 2 + idx % 3
    for _ in range(n_cars):
        z = rng.uniform(8.0, 45.0)
        # keep the whole object inside the camera frustum (half-FOV ~ 0.4 z)
        x_max = min(12.0, 0.4 * z - 2.5)
        objs.append(
            dict(
                type="Car",
                l=rng.uniform(3.4, 4.4), w=rng.uniform(1.5, 1.8), h=rng.uniform(1.4, 1.7),
                x=rng.uniform(-x_max, x_max), z=z,
                ry=rng.uniform(-np.pi, np.pi),
            )
        )
    if idx % 2 == 0:
        z = rng.uniform(6.0, 25.0)
        x_max = min(8.0, 0.4 * z - 1.0)
        objs.append(
            dict(
                type="Pedestrian",
                l=rng.uniform(0.6, 1.0), w=rng.uniform(0.5, 0.8), h=rng.uniform(1.6, 1.9),
                x=rng.uniform(-x_max, x_max), z=z,
                ry=rng.uniform(-np.pi, np.pi),
            )
        )
    return objs


def make_frame(idx: int, n_ground: int = 16384, n_obj: int = 1024, scene: str = "cars"):
    """Deterministic scene -> (velo (N,4) f32, labels list, image (H,W,3) u8)."""

    if scene != "cars":
        raise NotImplementedError(f"scene {scene!r}: only the cars scene is ported")
    rng = np.random.RandomState(1000 + idx)
    # ground: uniform over the camera-visible road
    gx = rng.uniform(-30.0, 30.0, size=n_ground)
    gz = rng.uniform(2.0, 68.0, size=n_ground)
    gy = np.full_like(gx, 1.65) + rng.normal(0, 0.02, size=n_ground)
    pts = [np.stack([gx, gy, gz], axis=1)]

    labels = []
    for ob in _scene_objects(rng, idx):
        y = 1.65  # on the road
        pts.append(
            _box_points(
                rng, ob["x"], y, ob["z"], ob["l"], ob["w"], ob["h"],
                ob["ry"], n_obj, obj_type=ob["type"],
            )
        )
        corners_uv = _project(
            _box_points(np.random.RandomState(0), ob["x"], y, ob["z"], ob["l"], ob["w"], ob["h"], ob["ry"], 64)
        )
        u1, v1 = corners_uv.min(axis=0)
        u2, v2 = corners_uv.max(axis=0)
        h_img, w_img = KITTI_IMAGE_HW
        u1, u2 = np.clip([u1, u2], 0, w_img - 1)
        v1, v2 = np.clip([v1, v2], 0, h_img - 1)
        alpha = ob["ry"] - np.arctan2(ob["x"], ob["z"])
        labels.append(
            (ob["type"], 0.0, 0, alpha, u1, v1, u2, v2, ob["h"], ob["w"], ob["l"], ob["x"], y, ob["z"], ob["ry"])
        )

    return _finish_frame(rng, pts, labels)


def _finish_frame(rng, pts, labels):
    pts_cam = np.concatenate(pts, axis=0)
    # keep only camera-visible points (KITTI lidar covers the front)
    vis = pts_cam[:, 2] > 1.0
    pts_cam = pts_cam[vis]
    velo = np.concatenate(
        [_cam_to_velo(pts_cam), rng.uniform(0, 1, size=(pts_cam.shape[0], 1))], axis=1
    ).astype(np.float32)

    # image: smooth gradient + per-object bright rectangles, drawn far to
    # near so nearer objects overdraw occluded ones
    h_img, w_img = KITTI_IMAGE_HW
    yy, xx = np.mgrid[0:h_img, 0:w_img]
    img = np.stack(
        [
            (xx * 255 // w_img),
            (yy * 255 // h_img),
            ((xx + yy) * 255 // (w_img + h_img)),
        ],
        axis=-1,
    ).astype(np.uint8)
    for lb in sorted(labels, key=lambda lb: -lb[13]):
        u1, v1, u2, v2 = (int(lb[4]), int(lb[5]), int(lb[6]), int(lb[7]))
        shade = int(np.clip(255 - 3.0 * lb[13], 80, 255))
        img[v1 : v2 + 1, u1 : u2 + 1] = (shade, 80, 40)
    return velo, labels, img


def encode_png(img: np.ndarray) -> bytes:
    """An [H, W, 3] u8 image as PNG bytes: 8-bit RGB, not interlaced, every
    row filter 0 (none), the stream deflated by ``zlib``."""

    h, w, c = img.shape
    if c != 3 or img.dtype != np.uint8:
        raise ValueError("encode_png takes an [H, W, 3] uint8 image")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def write_kitti_tree(root: str, num_frames: int = 4, n_ground: int = 16384, n_obj: int = 1024,
                     val_frames: Sequence[int] = (2, 3), scene: str = "cars") -> None:
    """Write a mini KITTI object tree under ``root`` (training/ layout), with
    ``train.txt``, ``val.txt`` (the frames of ``val_frames``) and
    ``trainval.txt``."""

    base = os.path.join(root, "training")
    for d in ("calib", "velodyne", "image_2", "label_2", "planes"):
        os.makedirs(os.path.join(base, d), exist_ok=True)

    calib_txt = (
        "P0: " + " ".join(f"{v:.12e}" for v in _P2.reshape(-1)) + "\n"
        "P1: " + " ".join(f"{v:.12e}" for v in _P2.reshape(-1)) + "\n"
        "P2: " + " ".join(f"{v:.12e}" for v in _P2.reshape(-1)) + "\n"
        "P3: " + " ".join(f"{v:.12e}" for v in _P2.reshape(-1)) + "\n"
        "R0_rect: " + " ".join(f"{v:.12e}" for v in _R0.reshape(-1)) + "\n"
        "Tr_velo_to_cam: " + " ".join(f"{v:.12e}" for v in _TR_VELO.reshape(-1)) + "\n"
        "Tr_imu_to_velo: " + " ".join(f"{v:.12e}" for v in _TR_VELO.reshape(-1)) + "\n"
    )
    plane_txt = "# Plane\nWidth 4\nHeight 1\n" + " ".join(f"{v:.6e}" for v in _PLANE) + "\n"

    ids = []
    for i in range(num_frames):
        sid = f"{i:06d}"
        ids.append(sid)
        velo, labels, img = make_frame(i, n_ground=n_ground, n_obj=n_obj, scene=scene)
        velo.tofile(os.path.join(base, "velodyne", sid + ".bin"))
        with open(os.path.join(base, "calib", sid + ".txt"), "w") as f:
            f.write(calib_txt)
        with open(os.path.join(base, "planes", sid + ".txt"), "w") as f:
            f.write(plane_txt)
        with open(os.path.join(base, "label_2", sid + ".txt"), "w") as f:
            for lb in labels:
                f.write(
                    f"{lb[0]} {lb[1]:.2f} {lb[2]} " + " ".join(f"{v:.6f}" for v in lb[3:]) + "\n"
                )
        with open(os.path.join(base, "image_2", sid + ".png"), "wb") as f:
            f.write(encode_png(img))

    train_ids = [s for i, s in enumerate(ids) if i not in val_frames]
    val_ids = [s for i, s in enumerate(ids) if i in val_frames]
    with open(os.path.join(root, "train.txt"), "w") as f:
        f.write("\n".join(train_ids) + "\n")
    with open(os.path.join(root, "val.txt"), "w") as f:
        f.write("\n".join(val_ids) + "\n")
    with open(os.path.join(root, "trainval.txt"), "w") as f:
        f.write("\n".join(ids) + "\n")
