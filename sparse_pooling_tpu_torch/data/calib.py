"""Camera projection (host, numpy): rectified camera-frame points onto the
image plane. Same math as ``sparse_pooling_tpu.data.calib.project_to_image``.
"""

from __future__ import annotations

import numpy as np


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
