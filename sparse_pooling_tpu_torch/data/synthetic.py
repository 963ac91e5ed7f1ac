"""Deterministic synthetic mini-KITTI tree (host, numpy + stdlib): the port's
copy of ``sparse_pooling_tpu.data.synthetic``.

No KITTI data ships with the repository, so this writes a miniature KITTI
object tree (``calib/ velodyne/ image_2/ label_2/ planes/`` and the split
files) from seeds: a ground plane of LiDAR points plus box-shaped object
point clusters that project consistently into a synthetic camera. Scenes:
``cars`` (2-4 cars, the odd pedestrian), ``people`` (pedestrians and
cyclists at nearer ranges), and ``cars_hard`` / ``people_hard`` (15-25
objects over every difficulty band: depth tiers, truncation, occlusion
stacks with LiDAR shadowing, ignored far objects and distractor classes,
unlabeled clutter). Given the same arguments it writes the same text and
``.bin`` files as the JAX package's writer and PNGs that decode to the same
pixels; the PNGs are encoded here with ``zlib`` (filter 0, 8-bit RGB), not
PIL.
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
SCENES = ("cars", "people", "cars_hard", "people_hard")


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


def _scene_objects(rng, idx: int, scene: str = "cars") -> List[dict]:
    """The plain scenes: ``people`` (2-4 pedestrians, 1-2 cyclists, near),
    else cars (2-4 cars, and a pedestrian in every other frame)."""

    objs = []
    if scene == "people":
        # pedestrian/cyclist street scene (for the people-preset proof):
        # small objects, nearer ranges (they carry few LiDAR points far out)
        for _ in range(2 + idx % 3):
            z = rng.uniform(5.0, 30.0)
            x_max = max(0.5, min(8.0, 0.4 * z - 1.0))
            objs.append(
                dict(
                    type="Pedestrian",
                    l=rng.uniform(0.6, 1.0), w=rng.uniform(0.5, 0.8),
                    h=rng.uniform(1.6, 1.9),
                    x=rng.uniform(-x_max, x_max), z=z,
                    ry=rng.uniform(-np.pi, np.pi),
                )
            )
        for _ in range(1 + idx % 2):
            z = rng.uniform(6.0, 35.0)
            x_max = max(0.5, min(10.0, 0.4 * z - 1.5))
            objs.append(
                dict(
                    type="Cyclist",
                    l=rng.uniform(1.5, 2.0), w=rng.uniform(0.4, 0.8),
                    h=rng.uniform(1.6, 1.8),
                    x=rng.uniform(-x_max, x_max), z=z,
                    ry=rng.uniform(-np.pi, np.pi),
                )
            )
        return objs
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


def _hard_scene_objects(rng, idx: int, flavor: str) -> List[dict]:
    """15-25 objects spanning every difficulty band.

    The plain 'cars'/'people' scenes hold 3-5 unoccluded near objects, so
    every difficulty band scores identically and the 11-point AP saturates.
    Hard scenes populate the bands distinctly: a near unoccluded tier
    (easy), a mid tier whose bbox heights fall in [25, 40) px (moderate-
    only), deliberate occlusion stacks and frustum-truncated objects
    (moderate/hard), plus a beyond-band far tier (ignored GT) and unlabeled
    clutter clusters that can draw false positives.
    """

    objs = []
    n = 15 + int(rng.randint(0, 11))  # 15-25
    # KITTI-ish class mix with distractor classes the evaluator must ignore
    for _ in range(n):
        r = rng.rand()
        if flavor == "cars":
            if r < 0.70:
                typ = "Car"
                l, w, h = (rng.uniform(3.4, 4.4), rng.uniform(1.5, 1.8),
                           rng.uniform(1.4, 1.7))
            elif r < 0.80:
                typ = "Van"
                l, w, h = (rng.uniform(4.6, 5.6), rng.uniform(1.7, 2.1),
                           rng.uniform(1.9, 2.3))
            elif r < 0.92:
                typ = "Pedestrian"
                l, w, h = (rng.uniform(0.6, 1.0), rng.uniform(0.5, 0.8),
                           rng.uniform(1.6, 1.9))
            else:
                typ = "Cyclist"
                l, w, h = (rng.uniform(1.5, 2.0), rng.uniform(0.4, 0.8),
                           rng.uniform(1.6, 1.8))
        else:  # people
            if r < 0.45:
                typ = "Pedestrian"
                l, w, h = (rng.uniform(0.6, 1.0), rng.uniform(0.5, 0.8),
                           rng.uniform(1.6, 1.9))
            elif r < 0.75:
                typ = "Cyclist"
                l, w, h = (rng.uniform(1.5, 2.0), rng.uniform(0.4, 0.8),
                           rng.uniform(1.6, 1.8))
            elif r < 0.85:
                typ = "Person_sitting"
                l, w, h = (rng.uniform(0.6, 1.0), rng.uniform(0.5, 0.8),
                           rng.uniform(1.0, 1.4))
            else:
                typ = "Car"
                l, w, h = (rng.uniform(3.4, 4.4), rng.uniform(1.5, 1.8),
                           rng.uniform(1.4, 1.7))
        # depth tiers: pixel height = f * h / z with f ~ 721.5, so for
        # h ~ 1.5 m the 40 px easy bar sits at z ~ 27 m and the 25 px
        # moderate bar at z ~ 43 m
        tier = rng.rand()
        if tier < 0.30:
            z = rng.uniform(8.0, 24.0)     # easy-capable
        elif tier < 0.75:
            z = rng.uniform(24.0, 42.0)    # moderate-height band
        elif tier < 0.92:
            z = rng.uniform(42.0, 55.0)    # below 25 px -> ignored GT
        else:
            z = rng.uniform(6.0, 20.0)     # near (occlusion stack anchors)
        x_max = max(0.5, 0.4 * z - 1.0)
        if rng.rand() < 0.18:
            # truncation candidates: push to (or past) the frustum edge
            x = np.sign(rng.rand() - 0.5) * rng.uniform(x_max, x_max + l)
        else:
            x = rng.uniform(-x_max, x_max)
        objs.append(dict(type=typ, l=l, w=w, h=h, x=float(x), z=float(z),
                         ry=rng.uniform(-np.pi, np.pi)))
    # deliberate occlusion pairs: clone 3-5 objects shifted behind a
    # foreground object so their bboxes overlap heavily
    for _ in range(3 + int(rng.randint(0, 3))):
        base = objs[int(rng.randint(0, len(objs)))]
        dz = rng.uniform(4.0, 12.0)
        z = base["z"] + dz
        # same viewing ray -> scale x with depth to keep image overlap
        x = base["x"] * z / base["z"] + rng.uniform(-0.8, 0.8)
        objs.append(
            dict(
                type=base["type"], l=base["l"], w=base["w"], h=base["h"],
                x=float(x), z=float(z), ry=rng.uniform(-np.pi, np.pi),
            )
        )
    return objs


def _box3d_corners_cam(x, y, z, l, w, h, ry) -> np.ndarray:
    """Exact 8 corners of a KITTI 3D box (cam frame, y = bottom) -> (8, 3)."""

    lx = np.array([1, 1, -1, -1, 1, 1, -1, -1]) * (l / 2)
    lz = np.array([1, -1, -1, 1, 1, -1, -1, 1]) * (w / 2)
    ly = np.array([0, 0, 0, 0, -h, -h, -h, -h])
    c, s = np.cos(ry), np.sin(ry)
    return np.stack(
        [c * lx + s * lz + x, y + ly, -s * lx + c * lz + z], axis=1
    )


def _make_hard_frame(rng, idx: int, n_ground: int, n_obj: int, flavor: str):
    """Hard-scene path: occlusion shadowing, truncation, 1/z^2 density.

    Objects are processed near-to-far; each object's LiDAR points that
    project inside a NEARER object's image bbox are dropped (the sensors
    are nearly co-located, so camera occlusion ~ LiDAR shadowing), the
    occlusion label is the fraction of its bbox covered by nearer bboxes
    (devkit levels: < 0.15 -> 0, < 0.5 -> 1, else 2), and truncation is
    the bbox fraction clipped by the image border. Unlabeled clutter
    clusters (poles/bushes) are added so false positives COST something.
    """

    h_img, w_img = KITTI_IMAGE_HW
    gx = rng.uniform(-30.0, 30.0, size=n_ground)
    gz = rng.uniform(2.0, 68.0, size=n_ground)
    gy = np.full_like(gx, 1.65) + rng.normal(0, 0.02, size=n_ground)
    pts = [np.stack([gx, gy, gz], axis=1)]

    objs = sorted(_hard_scene_objects(rng, idx, flavor), key=lambda o: o["z"])
    labels = []
    nearer_boxes: List[np.ndarray] = []  # clipped (u1, v1, u2, v2), near first
    for ob in objs:
        y = 1.65
        corners_uv = _project(
            _box3d_corners_cam(
                ob["x"], y, ob["z"], ob["l"], ob["w"], ob["h"], ob["ry"]
            )
        )
        u1, v1 = corners_uv.min(axis=0)
        u2, v2 = corners_uv.max(axis=0)
        full_area = max(u2 - u1, 0.0) * max(v2 - v1, 0.0)
        cu1, cu2 = np.clip([u1, u2], 0, w_img - 1)
        cv1, cv2 = np.clip([v1, v2], 0, h_img - 1)
        vis_area = max(cu2 - cu1, 0.0) * max(cv2 - cv1, 0.0)
        if full_area <= 0 or vis_area <= 0:
            continue  # fully outside the image
        trunc = 1.0 - vis_area / full_area
        if trunc > 0.85:
            continue
        # occlusion fraction: sample a grid inside the clipped bbox and
        # count coverage by any nearer object's bbox (union, not pairwise)
        gu = np.linspace(cu1, cu2, 12)
        gv = np.linspace(cv1, cv2, 12)
        uu, vv = np.meshgrid(gu, gv)
        covered = np.zeros(uu.shape, bool)
        for nb in nearer_boxes:
            covered |= (
                (uu >= nb[0]) & (uu <= nb[2]) & (vv >= nb[1]) & (vv <= nb[3])
            )
        occ_frac = float(covered.mean())
        if occ_frac > 0.9:
            continue  # essentially invisible
        occ = 0 if occ_frac < 0.15 else (1 if occ_frac < 0.5 else 2)

        # LiDAR return density falls with range; shadowed points vanish
        n_pts = max(24, int(n_obj * min(1.0, (12.0 / ob["z"]) ** 2)))
        p = _box_points(
            rng, ob["x"], y, ob["z"], ob["l"], ob["w"], ob["h"], ob["ry"],
            n_pts, obj_type=ob["type"],
        )
        if nearer_boxes:
            uv = _project(p)
            shadowed = np.zeros(len(p), bool)
            for nb in nearer_boxes:
                shadowed |= (
                    (uv[:, 0] >= nb[0]) & (uv[:, 0] <= nb[2])
                    & (uv[:, 1] >= nb[1]) & (uv[:, 1] <= nb[3])
                )
            # keep a sliver of leakage (beam divergence at box edges)
            keep = ~shadowed | (rng.rand(len(p)) < 0.08)
            p = p[keep]
        pts.append(p)
        nearer_boxes.append(np.array([cu1, cv1, cu2, cv2]))
        alpha = ob["ry"] - np.arctan2(ob["x"], ob["z"])
        labels.append(
            (ob["type"], round(trunc, 2), occ, alpha, cu1, cv1, cu2, cv2,
             ob["h"], ob["w"], ob["l"], ob["x"], y, ob["z"], ob["ry"])
        )

    # unlabeled clutter: narrow vertical clusters (poles, bushes) that the
    # detector must learn to reject — hallucinations on them are real FPs
    for _ in range(4 + int(rng.randint(0, 5))):
        z = rng.uniform(6.0, 45.0)
        x_max = max(0.5, 0.4 * z - 1.0)
        cl = rng.uniform(0.2, 1.2)
        cw = rng.uniform(0.2, 1.0)
        ch = rng.uniform(0.5, 2.2)
        n_pts = max(16, int(0.25 * n_obj * min(1.0, (12.0 / z) ** 2)))
        pts.append(
            _box_points(
                rng, rng.uniform(-x_max, x_max), 1.65, z, cl, cw, ch,
                rng.uniform(-np.pi, np.pi), n_pts,
            )
        )
    return pts, labels


def make_frame(idx: int, n_ground: int = 16384, n_obj: int = 1024, scene: str = "cars"):
    """Deterministic scene -> (velo (N,4) f32, labels list, image (H,W,3) u8)."""

    if scene not in SCENES:
        raise ValueError(f"scene {scene!r}: one of {SCENES}")
    rng = np.random.RandomState(1000 + idx)
    if scene.endswith("_hard"):
        flavor = "people" if scene.startswith("people") else "cars"
        pts, labels = _make_hard_frame(rng, idx, n_ground, n_obj, flavor)
        return _finish_frame(rng, pts, labels)
    # ground: uniform over the camera-visible road
    gx = rng.uniform(-30.0, 30.0, size=n_ground)
    gz = rng.uniform(2.0, 68.0, size=n_ground)
    gy = np.full_like(gx, 1.65) + rng.normal(0, 0.02, size=n_ground)
    pts = [np.stack([gx, gy, gz], axis=1)]

    labels = []
    for ob in _scene_objects(rng, idx, scene):
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
    """Write a mini KITTI object tree of ``scene`` (one of ``SCENES``) under
    ``root`` (training/ layout), with ``train.txt``, ``val.txt`` (the frames
    of ``val_frames``) and ``trainval.txt``."""

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
