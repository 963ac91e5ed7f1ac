"""KITTI calibration IO and projection math (host, numpy): the port's copy of
``sparse_pooling_tpu.data.calib``.

Parses ``calib/*.txt`` (P2, R0_rect, Tr_velo_to_cam), moves velodyne points
into the rectified camera frame, and projects camera-frame points onto the
image plane, with the reference's f32/f64 operations in its order.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class FrameCalib:
    """Calibration for one KITTI frame.

    p2: (3, 4) left color camera projection matrix.
    r0_rect: (3, 3) rectification rotation.
    tr_velo_to_cam: (3, 4) velodyne -> unrectified cam0 rigid transform.
    """

    p2: np.ndarray
    r0_rect: np.ndarray
    tr_velo_to_cam: np.ndarray

    def velo_to_rect(self) -> np.ndarray:
        """(4, 4) homogeneous velodyne -> rectified-camera transform."""
        tr = np.eye(4, dtype=np.float64)
        tr[:3, :4] = self.tr_velo_to_cam
        r0 = np.eye(4, dtype=np.float64)
        r0[:3, :3] = self.r0_rect
        return r0 @ tr


def read_calibration(path: str) -> FrameCalib:
    """Parse a KITTI object calibration file: lines of ``KEY: v v v ...``."""

    mats: dict[str, np.ndarray] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            key, _, vals = line.partition(":")
            mats[key.strip()] = np.array([float(v) for v in vals.split()], dtype=np.float64)

    def get(name: str, *alts: str) -> np.ndarray:
        for n in (name, *alts):
            if n in mats:
                return mats[n]
        raise KeyError(f"calibration key {name} missing in {path}")

    return FrameCalib(
        p2=get("P2").reshape(3, 4),
        r0_rect=get("R0_rect", "R_rect").reshape(3, 3),
        tr_velo_to_cam=get("Tr_velo_to_cam", "Tr_velo_cam").reshape(3, 4),
    )


def lidar_to_cam_frame(points: np.ndarray, calib: FrameCalib) -> np.ndarray:
    """Velodyne (N, 3+) -> rectified camera frame (N, 3), the affine map in
    the points' dtype."""

    m = calib.velo_to_rect()[:3].astype(points.dtype)
    return points[:, :3] @ m[:, :3].T + m[:, 3]


def project_to_image(points_cam: np.ndarray, p2: np.ndarray) -> np.ndarray:
    """Rectified camera-frame points (N, 3) -> pixel coords (N, 2) [u, v].

    Homogeneous divide by depth. Points at or behind the camera plane produce
    non-finite coords; callers must mask on depth > 0.
    """

    uvw = points_cam @ p2[:, :3].T.astype(points_cam.dtype) + p2[:, 3].astype(
        points_cam.dtype
    )
    with np.errstate(divide="ignore", invalid="ignore"):
        return uvw[:, :2] / uvw[:, 2:3]


def project_box3d_to_image(corners_cam: np.ndarray, p2: np.ndarray) -> np.ndarray:
    """(8, 3) box corners -> (8, 2) pixels."""

    return project_to_image(corners_cam, p2)
