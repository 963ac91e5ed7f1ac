"""Decompose a detector's IoU by box parameter: which axis costs 2D or 3D AP.

    python -m sparse_pooling_tpu_torch.experiments.analyze_2d_gap \
        <gt_dir> <pred_dir> [pred_dir2 ...] [--cls Car] [--min_score 0.1] \
        [--image_hw 375,1242]

Port of ``tools/analyze_2d_gap.py`` (numpy over KITTI label, calib and
prediction dirs; the calib dir is the label dir's sibling). Every detection
of ``--cls`` at ``--min_score`` or above is matched to the ground-truth box
of highest BEV IoU (at least 0.1, else skipped), and the tool reports

  - the matched pairs' IoU distributions per metric (``iou2d``, ``bev``,
    ``iou3d``), and
  - counterfactual IoUs with one parameter group taken from the ground
    truth: ``2d|gt_hy`` (vertical position y and height h), ``2d|gt_lw``
    (footprint), ``2d|gt_xz`` (centre), ``2d|gt_ry`` (yaw), each box
    projected into the image again and held against the GT 2D box; and
    ``3d|gt_hy``, the 3D IoU with GT's y and h.

Reading it: where ``iou3d`` trails ``bev`` and ``3d|gt_hy`` lifts it back to
``bev``, the vertical extents (y, h) cost the 3D AP; the same for 2D IoU and
``2d|gt_hy``.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List

import numpy as np

from sparse_pooling_tpu_torch.data.calib import project_to_image, read_calibration
from sparse_pooling_tpu_torch.data.labels import read_labels
from sparse_pooling_tpu_torch.runtime import metrics as M
from sparse_pooling_tpu_torch.runtime.predictions import _box_3d_to_corners_np

KEYS = ("iou2d", "bev", "iou3d", "2d|gt_hy", "2d|gt_lw", "2d|gt_xz", "2d|gt_ry", "3d|gt_hy")

# counterfactual 2D IoUs: the box_3d columns (x, y, z, l, w, h, ry) taken from GT
_GROUPS = (("2d|gt_hy", [1, 5]), ("2d|gt_lw", [3, 4]), ("2d|gt_xz", [0, 2]), ("2d|gt_ry", [6]))


def _box7(lb):
    return np.array([lb.t[0], lb.t[1], lb.t[2], lb.l, lb.w, lb.h, lb.ry])


def _bbox2d_from_box7(b, p2, hw):
    uv = project_to_image(_box_3d_to_corners_np(b[None]).reshape(-1, 3), p2).reshape(8, 2)
    h_img, w_img = hw
    return np.array([np.clip(uv[:, 0].min(), 0, w_img - 1), np.clip(uv[:, 1].min(), 0, h_img - 1),
                     np.clip(uv[:, 0].max(), 0, w_img - 1), np.clip(uv[:, 1].max(), 0, h_img - 1)])


def _iou2d(a, b):
    return M.bbox2d_iou(a[None], b[None])[0, 0]


def analyze(gt_dir, pred_dir, calib_dir, cls, min_score, hw) -> List[Dict[str, float]]:
    """One row per matched detection of ``pred_dir``: its score and every
    IoU of ``KEYS``."""

    rows = []
    for fname in sorted(os.listdir(pred_dir)):
        if not fname.endswith(".txt"):
            continue
        gts = [g for g in read_labels(os.path.join(gt_dir, fname)) if g.type == cls]
        dets = [d for d in read_labels(os.path.join(pred_dir, fname)) if d.type == cls and d.score >= min_score]
        if not gts or not dets:
            continue
        p2 = read_calibration(os.path.join(calib_dir, fname[:-4] + ".txt")).p2
        for d in dets:
            db = _box7(d)
            best_bev, best_g = 0.0, None
            for g in gts:
                ov = M.bev_iou(db[[0, 2, 3, 4, 6]], _box7(g)[[0, 2, 3, 4, 6]])
                if ov > best_bev:
                    best_bev, best_g = ov, g
            if best_g is None or best_bev < 0.1:
                continue  # aimed at no object
            gb = _box7(best_g)
            gt2d = np.array([best_g.x1, best_g.y1, best_g.x2, best_g.y2])
            rec = {"score": d.score, "bev": best_bev,
                   "iou2d": _iou2d(np.array([d.x1, d.y1, d.x2, d.y2]), gt2d), "iou3d": M.iou_3d(db, gb)}
            for tag, idxs in _GROUPS:
                cb = db.copy()
                cb[idxs] = gb[idxs]
                rec[tag] = _iou2d(_bbox2d_from_box7(cb, p2, hw), gt2d)
            cb = db.copy()
            cb[[1, 5]] = gb[[1, 5]]
            rec["3d|gt_hy"] = M.iou_3d(cb, gb)
            rows.append(rec)
    return rows


def summarize(rows) -> Dict[str, Dict[str, float]]:
    """Each key's mean, 25th percentile, median and share at 0.7 or above."""

    out = {}
    for k in KEYS:
        v = np.array([r[k] for r in rows])
        out[k] = {"mean": float(v.mean()), "p25": float(np.percentile(v, 25)),
                  "median": float(np.median(v)), "ge07": float((v >= 0.7).mean())}
    return out


def calib_dir_of(gt_dir: str) -> str:
    return os.path.join(os.path.dirname(gt_dir.rstrip("/")), "calib")


def main(argv=None):
    """Prints the table of each prediction dir; returns {pred_dir: rows}."""

    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("gt_dir")
    ap.add_argument("pred_dirs", nargs="+")
    ap.add_argument("--cls", default="Car")
    ap.add_argument("--min_score", type=float, default=0.1)
    ap.add_argument("--image_hw", default="375,1242")
    args = ap.parse_args(argv)
    hw = tuple(int(v) for v in args.image_hw.split(","))
    calib_dir = calib_dir_of(args.gt_dir)

    out = {}
    for pred_dir in args.pred_dirs:
        rows = out[pred_dir] = analyze(args.gt_dir, pred_dir, calib_dir, args.cls, args.min_score, hw)
        if not rows:
            print(f"{pred_dir}: no matched detections")
            continue
        print(f"\n== {pred_dir}  ({len(rows)} matched dets, {args.cls})")
        print(f"{'metric':>10s} {'mean':>7s} {'p25':>7s} {'median':>7s} {'>=0.7':>7s}")
        for k, s in summarize(rows).items():
            print(f"{k:>10s} {s['mean']:7.3f} {s['p25']:7.3f} {s['median']:7.3f} {s['ge07']:7.1%}")
    return out


if __name__ == "__main__":
    main()
