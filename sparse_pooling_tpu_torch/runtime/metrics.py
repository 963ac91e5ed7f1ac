"""KITTI AP evaluation: the numpy oracle.

The port's copy of ``sparse_pooling_tpu.runtime.metrics``: 2D / BEV / 3D
average precision and AOS with 11- or 40-point interpolation over the
easy/moderate/hard difficulty bands, per class, from KITTI-format label and
prediction txt directories. Written from the published devkit metric
definition: greedy score-descending matching against same-class ground
truth, don't-care and similar-class handling, rotated-box overlap for BEV
and 3D. The native evaluator (``native/kitti_eval``) must agree with it to
1e-12; the evaluator scores with the native one, and this module is its
twin in the tests.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Sequence

import numpy as np

from sparse_pooling_tpu_torch.data.labels import ObjectLabel, read_labels

# difficulty: (min bbox height px, max occlusion, max truncation)
DIFFICULTIES = {
    "easy": (40.0, 0, 0.15),
    "moderate": (25.0, 1, 0.30),
    "hard": (25.0, 2, 0.50),
}
# neighbor classes whose GT is ignored (not counted as FP) for a class
SIMILAR = {"Car": ("Van",), "Pedestrian": ("Person_sitting",), "Cyclist": ()}
MIN_OVERLAP = {"Car": 0.7, "Pedestrian": 0.5, "Cyclist": 0.5}


# ------------------------------------------------------------------ overlaps

def bbox2d_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[N, 4] x [M, 4] (x1, y1, x2, y2) -> [N, M]."""

    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    ix = np.maximum(
        0,
        np.minimum(a[:, None, 2], b[None, :, 2])
        - np.maximum(a[:, None, 0], b[None, :, 0]),
    )
    iy = np.maximum(
        0,
        np.minimum(a[:, None, 3], b[None, :, 3])
        - np.maximum(a[:, None, 1], b[None, :, 1]),
    )
    inter = ix * iy
    ar = lambda x: np.maximum(x[:, 2] - x[:, 0], 0) * np.maximum(x[:, 3] - x[:, 1], 0)
    union = ar(a)[:, None] + ar(b)[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def _box_corners_bev(box5: np.ndarray) -> np.ndarray:
    """[x, z, l, w, ry] -> (4, 2) footprint corners (x, z), CCW."""

    x, z, l, w, ry = box5
    lx = np.array([l / 2, l / 2, -l / 2, -l / 2])
    lz = np.array([w / 2, -w / 2, -w / 2, w / 2])
    c, s = np.cos(ry), np.sin(ry)
    return np.stack([c * lx + s * lz + x, -s * lx + c * lz + z], axis=1)


def _polygon_area(poly: np.ndarray) -> float:
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def _clip_polygon(subject: np.ndarray, clip: np.ndarray) -> np.ndarray:
    """Sutherland-Hodgman convex clip; polygons are (N, 2) arrays."""

    def inside(p, a, b):
        return (b[0] - a[0]) * (p[1] - a[1]) - (b[1] - a[1]) * (p[0] - a[0]) >= -1e-12

    def intersect(p1, p2, a, b):
        d1 = np.array([p2[0] - p1[0], p2[1] - p1[1]])
        d2 = np.array([b[0] - a[0], b[1] - a[1]])
        denom = d1[0] * d2[1] - d1[1] * d2[0]
        if abs(denom) < 1e-15:
            return p2
        t = ((a[0] - p1[0]) * d2[1] - (a[1] - p1[1]) * d2[0]) / denom
        return np.array([p1[0] + t * d1[0], p1[1] + t * d1[1]])

    # ensure clip polygon is CCW
    if _signed_area(clip) < 0:
        clip = clip[::-1]
    output = list(subject)
    for i in range(len(clip)):
        a, b = clip[i], clip[(i + 1) % len(clip)]
        input_list, output = output, []
        if not input_list:
            break
        prev = input_list[-1]
        for cur in input_list:
            if inside(cur, a, b):
                if not inside(prev, a, b):
                    output.append(intersect(prev, cur, a, b))
                output.append(cur)
            elif inside(prev, a, b):
                output.append(intersect(prev, cur, a, b))
            prev = cur
    return np.array(output) if output else np.zeros((0, 2))


def _signed_area(poly: np.ndarray) -> float:
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * (np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def rotated_overlap_bev(a5: np.ndarray, b5: np.ndarray) -> float:
    """Intersection area of two rotated BEV boxes [x, z, l, w, ry]."""

    pa = _box_corners_bev(a5)
    pb = _box_corners_bev(b5)
    inter = _clip_polygon(pa, pb)
    if len(inter) < 3:
        return 0.0
    return _polygon_area(inter)


def bev_iou(a5: np.ndarray, b5: np.ndarray) -> float:
    inter = rotated_overlap_bev(a5, b5)
    union = a5[2] * a5[3] + b5[2] * b5[3] - inter
    return inter / max(union, 1e-12)


def iou_3d(a7: np.ndarray, b7: np.ndarray) -> float:
    """Rotated 3D IoU of two box_3d [x, y, z, l, w, h, ry] (y = bottom)."""

    inter_bev = rotated_overlap_bev(a7[[0, 2, 3, 4, 6]], b7[[0, 2, 3, 4, 6]])
    y_top = max(a7[1] - a7[5], b7[1] - b7[5])  # higher bottom-of-overlap (y down)
    y_bot = min(a7[1], b7[1])
    ih = max(0.0, y_bot - y_top)
    inter = inter_bev * ih
    vol = lambda b: b[3] * b[4] * b[5]
    union = vol(a7) + vol(b7) - inter
    return inter / max(union, 1e-12)


# ------------------------------------------------------------------ evaluation

@dataclasses.dataclass
class FrameData:
    gt: List[ObjectLabel]
    det: List[ObjectLabel]


def _gt_status(ob: ObjectLabel, cls: str, diff) -> int:
    """1 = counted, 0 = ignored, -1 = irrelevant (other class)."""

    min_h, max_occ, max_trunc = diff
    if ob.type == cls:
        h = ob.y2 - ob.y1
        if ob.occlusion > max_occ or ob.truncation > max_trunc or h < min_h:
            return 0
        return 1
    if ob.type in SIMILAR.get(cls, ()) or ob.type == "DontCare":
        return 0
    return -1


def _pr_curve(frames: Sequence[FrameData], cls: str, diff, metric: str):
    """Greedy matching -> (scores, tp flags, sims, num_valid_gt).

    metric: '2d' | 'bev' | '3d'. Returns per-detection (score, is_tp,
    is_ignored, orientation_similarity) across all frames plus the positive
    count. ``sim`` is the devkit AOS contribution (1 + cos(gt.alpha -
    det.alpha)) / 2 for TPs and 0 otherwise — only meaningful for the '2d'
    matching, which is what the devkit computes AOS on.
    """

    min_ov = MIN_OVERLAP[cls]
    min_h = diff[0]
    all_scores, all_tp, all_ignored, all_sim = [], [], [], []
    n_gt = 0
    for fr in frames:
        gt_status = np.array(
            [_gt_status(g, cls, diff) for g in fr.gt], dtype=int
        ) if fr.gt else np.zeros((0,), int)
        n_gt += int((gt_status == 1).sum())
        dets = [d for d in fr.det if d.type == cls]
        if not dets:
            continue
        order = np.argsort([-d.score for d in dets], kind="stable")
        matched = np.zeros(len(fr.gt), bool)
        for di in order:
            d = dets[di]
            # devkit ignored_det semantics: a class-matched detection whose
            # 2D bbox is below the difficulty's min height is IGNORED — it
            # may still consume a GT but is never a TP and never an FP
            # (otherwise valid far/hard detections count as FPs when scoring
            # easier bands, deflating AP vs the native devkit).
            d_small = (d.y2 - d.y1) < min_h
            best_ov, best_gi = 0.0, -1
            for gi, g in enumerate(fr.gt):
                if gt_status[gi] == -1 or matched[gi]:
                    continue
                if metric == "2d":
                    ov = bbox2d_iou(
                        np.array([[d.x1, d.y1, d.x2, d.y2]]),
                        np.array([[g.x1, g.y1, g.x2, g.y2]]),
                    )[0, 0]
                elif metric == "bev":
                    ov = bev_iou(
                        np.array([d.t[0], d.t[2], d.l, d.w, d.ry]),
                        np.array([g.t[0], g.t[2], g.l, g.w, g.ry]),
                    )
                else:
                    ov = iou_3d(
                        np.array([d.t[0], d.t[1], d.t[2], d.l, d.w, d.h, d.ry]),
                        np.array([g.t[0], g.t[1], g.t[2], g.l, g.w, g.h, g.ry]),
                    )
                if ov > best_ov:
                    best_ov, best_gi = ov, gi
            if best_gi >= 0 and best_ov >= min_ov:
                matched[best_gi] = True
                if gt_status[best_gi] == 1 and not d_small:
                    all_scores.append(d.score)
                    all_tp.append(True)
                    all_ignored.append(False)
                    all_sim.append(
                        0.5 * (1.0 + np.cos(fr.gt[best_gi].alpha - d.alpha))
                    )
                else:  # matched an ignored GT, or the det itself is ignored
                    all_scores.append(d.score)
                    all_tp.append(False)
                    all_ignored.append(True)
                    all_sim.append(0.0)
            else:
                all_scores.append(d.score)
                all_tp.append(False)
                all_ignored.append(d_small)  # small unmatched det: not an FP
                all_sim.append(0.0)
    return (
        np.array(all_scores),
        np.array(all_tp, bool),
        np.array(all_ignored, bool),
        np.array(all_sim),
        n_gt,
    )


def _average_precision(
    scores, tp, ignored, n_gt, n_points: int = 11, sim=None
) -> float:
    """11/40-point interpolated AP; with ``sim`` per-detection orientation
    similarities, the precision curve becomes the devkit's AOS curve
    (cumulative similarity over detections instead of cumulative TP count),
    so the same interpolation yields Average Orientation Similarity."""

    if n_gt == 0 or len(scores) == 0:
        return 0.0
    keep = ~ignored
    scores, tp = scores[keep], tp[keep]
    order = np.argsort(-scores, kind="stable")
    tp = tp[order]
    cum_tp = np.cumsum(tp)
    cum_fp = np.cumsum(~tp)
    recall = cum_tp / n_gt
    if sim is not None:
        cum_val = np.cumsum(sim[keep][order])
    else:
        cum_val = cum_tp
    precision = cum_val / np.maximum(cum_tp + cum_fp, 1)
    ap = 0.0
    # recall points as k/N divisions, NOT linspace: linspace(0,1,11)[6] is
    # 0.6000000000000001 while 3/5 recall is 0.5999999999999999..., which
    # flips `recall >= r` at exact-fraction recalls (the C++ twin uses k/N)
    if n_points == 11:
        rs = np.arange(11) / 10.0
    else:
        rs = (np.arange(n_points) + 1.0) / n_points
    for r in rs:
        mask = recall >= r
        ap += (precision[mask].max() if mask.any() else 0.0) / len(rs)
    return float(ap)


def evaluate_frames(
    frames: Sequence[FrameData],
    classes: Sequence[str],
    n_points: int = 11,
) -> Dict[str, Dict[str, Dict[str, float]]]:
    """-> {class: {metric: {difficulty: AP}}} with metric in 2d/bev/3d/aos.

    ``aos`` is the devkit's Average Orientation Similarity: computed on the
    2D image-plane matching with each TP weighted by (1 + cos(dalpha)) / 2,
    so AOS <= AP_2d always, with equality iff every matched heading is exact.
    """

    out: Dict[str, Dict[str, Dict[str, float]]] = {}
    for cls in classes:
        out[cls] = {}
        for metric in ("2d", "bev", "3d"):
            out[cls][metric] = {}
            if metric == "2d":
                out[cls]["aos"] = {}
            for dname, diff in DIFFICULTIES.items():
                scores, tp, ign, sim, n_gt = _pr_curve(frames, cls, diff, metric)
                out[cls][metric][dname] = _average_precision(
                    scores, tp, ign, n_gt, n_points
                )
                if metric == "2d":
                    out[cls]["aos"][dname] = _average_precision(
                        scores, tp, ign, n_gt, n_points, sim=sim
                    )
    return out


def evaluate_dirs(
    gt_dir: str, det_dir: str, classes: Sequence[str], n_points: int = 11
):
    """Evaluate prediction txt dir against label txt dir (devkit-style CLI)."""

    frames = []
    for fname in sorted(os.listdir(det_dir)):
        if not fname.endswith(".txt"):
            continue
        sid = fname[:-4]
        gt = read_labels(os.path.join(gt_dir, sid + ".txt"), include_dontcare=True)
        det = read_labels(os.path.join(det_dir, fname))
        frames.append(FrameData(gt=gt, det=det))
    return evaluate_frames(frames, classes, n_points)
