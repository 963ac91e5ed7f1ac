"""KITTI object label IO (host, numpy): the port's copy of
``sparse_pooling_tpu.data.labels``.

Parses ``label_2/*.txt`` into structured labels, reads ground planes, and
provides the box_3d view (x, y, z, l, w, h, ry) used throughout the detector.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Sequence

import numpy as np

KITTI_CLASSES = ("Car", "Van", "Truck", "Pedestrian", "Person_sitting", "Cyclist", "Tram", "Misc", "DontCare")


@dataclasses.dataclass
class ObjectLabel:
    """One KITTI label row (reference: ``obj_utils.ObjectLabel``)."""

    type: str
    truncation: float
    occlusion: int
    alpha: float
    x1: float
    y1: float
    x2: float
    y2: float
    h: float  # box height (y extent)
    w: float  # box width (x extent)
    l: float  # box length (z extent)
    t: tuple  # (x, y, z) bottom-center in rectified cam frame
    ry: float
    score: float = 1.0

    def box_3d(self) -> np.ndarray:
        """[x, y, z, l, w, h, ry] — the box_3d encoding (avod box_3d_encoder)."""
        return np.array(
            [self.t[0], self.t[1], self.t[2], self.l, self.w, self.h, self.ry],
            dtype=np.float64,
        )


def read_labels(path: str, include_dontcare: bool = False) -> List[ObjectLabel]:
    """Parse one KITTI label file (reference: ``obj_utils.read_labels``)."""

    labels: List[ObjectLabel] = []
    if not os.path.exists(path):
        return labels
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "DontCare" and not include_dontcare:
                continue
            vals = [float(v) for v in parts[1:]]
            labels.append(
                ObjectLabel(
                    type=parts[0],
                    truncation=vals[0],
                    occlusion=int(vals[1]),
                    alpha=vals[2],
                    x1=vals[3],
                    y1=vals[4],
                    x2=vals[5],
                    y2=vals[6],
                    h=vals[7],
                    w=vals[8],
                    l=vals[9],
                    t=(vals[10], vals[11], vals[12]),
                    ry=vals[13],
                    score=vals[14] if len(vals) > 14 else 1.0,
                )
            )
    return labels


def write_labels(path: str, labels: Sequence[ObjectLabel]) -> None:
    """Write KITTI-format label/prediction rows (evaluator output format)."""

    with open(path, "w") as f:
        for ob in labels:
            f.write(
                f"{ob.type} {ob.truncation:.2f} {ob.occlusion} {ob.alpha:.6f} "
                f"{ob.x1:.6f} {ob.y1:.6f} {ob.x2:.6f} {ob.y2:.6f} "
                f"{ob.h:.6f} {ob.w:.6f} {ob.l:.6f} "
                f"{ob.t[0]:.6f} {ob.t[1]:.6f} {ob.t[2]:.6f} {ob.ry:.6f} {ob.score:.6f}\n"
            )


def filter_labels_by_class(
    labels: Sequence[ObjectLabel], classes: Sequence[str]
) -> List[ObjectLabel]:
    """Keep labels of the requested classes (reference dataset class filter).

    'Car' also accepts 'Van' as in the reference's difficulty filtering is
    NOT applied here; vans are excluded from training positives by the IoU
    bands instead. We match the reference's behavior of exact class match.
    """

    keep = set(classes)
    return [ob for ob in labels if ob.type in keep]


def labels_to_box3d_array(labels: Sequence[ObjectLabel]) -> np.ndarray:
    """(N, 7) box_3d array from labels; (0, 7) when empty."""

    if not labels:
        return np.zeros((0, 7), dtype=np.float64)
    return np.stack([ob.box_3d() for ob in labels], axis=0)


def read_ground_plane(path: str) -> np.ndarray:
    """Parse a KITTI ``planes/*.txt`` ground plane -> [a, b, c, d].

    Reference: ``obj_utils.get_road_plane``; plane satisfies
    a*x + b*y + c*z + d = 0 with the normal oriented up (-y in cam frame).
    """

    with open(path) as f:
        lines = f.read().splitlines()
    plane = np.array([float(v) for v in lines[-1].split()], dtype=np.float64)
    # normalize and orient normal upward (camera y points down)
    norm = np.linalg.norm(plane[:3])
    plane = plane / norm
    if plane[1] > 0:
        plane = -plane
    return plane


def default_ground_plane() -> np.ndarray:
    """Flat road 1.65 m below the camera (KITTI mounting height)."""

    return np.array([0.0, -1.0, 0.0, 1.65], dtype=np.float64)
