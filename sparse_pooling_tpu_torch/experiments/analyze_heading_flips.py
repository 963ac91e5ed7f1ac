"""Decompose orientation error: fine angle against the pi-disambiguation bit.

    python -m sparse_pooling_tpu_torch.experiments.analyze_heading_flips \
        <gt_dir> <pred_dir_a> [pred_dir_b] [--cls Car] [--min_score 0.3]

Port of ``tools/analyze_heading_flips.py`` (numpy over KITTI label and
prediction dirs). AOS drops where a detection's heading is off by about pi
even when its box is right; this splits the error of one or two prediction
dirs (e.g. two checkpoints of one run) into its two parts:

  - FINE ANGLE: |d ry| (below pi/2) between detections of dir a and their
    match in dir b, as a median in degrees;
  - FLIP BIT: the share of matched detections whose heading differs by more
    than pi/2, against the ground truth (each dir) and between the two dirs
    (checkpoint churn).

A detection matches the box of highest BEV IoU if that IoU is at least 0.5.
AOS ~ (1 - flip rate vs GT) x AP_2d.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from sparse_pooling_tpu_torch.data.labels import read_labels
from sparse_pooling_tpu_torch.runtime import metrics as M


def _bev5(lb):
    return np.array([lb.t[0], lb.t[2], lb.l, lb.w, lb.ry])


def _match(det, pool, min_iou=0.5):
    best, hit = 0.0, None
    for other in pool:
        ov = M.bev_iou(_bev5(det), _bev5(other))
        if ov > best:
            best, hit = ov, other
    return hit if best >= min_iou else None


def _heading_delta(a, b):
    return abs(((a - b) + np.pi) % (2 * np.pi) - np.pi)


def compare(gt_dir, dir_a, dir_b=None, cls="Car", min_score=0.3):
    """-> {pairs, pair_flip_rate, fine_angle_median_deg, gt_flip_rate_a,
    gt_flip_rate_b, gt_matched_a} over the frames of ``dir_a``."""

    pair_flips = pair_n = 0
    fine = []
    gt_flips = {"a": 0, "b": 0}
    gt_n = {"a": 0, "b": 0}
    for f in sorted(os.listdir(dir_a)):
        if not f.endswith(".txt"):
            continue
        a = [x for x in read_labels(os.path.join(dir_a, f)) if x.type == cls and x.score >= min_score]
        gts = [g for g in read_labels(os.path.join(gt_dir, f)) if g.type == cls]
        pools = {"a": a}
        if dir_b:
            pools["b"] = [x for x in read_labels(os.path.join(dir_b, f))
                          if x.type == cls and x.score >= min_score]
            for da in a:
                db = _match(da, pools["b"])
                if db is None:
                    continue
                pair_n += 1
                d = _heading_delta(da.ry, db.ry)
                if d > np.pi / 2:
                    pair_flips += 1
                else:
                    fine.append(d)
        for tag, dets in pools.items():
            for dd in dets:
                g = _match(dd, gts)
                if g is None:
                    continue
                gt_n[tag] += 1
                if _heading_delta(dd.ry, g.ry) > np.pi / 2:
                    gt_flips[tag] += 1
    return {
        "pairs": pair_n,
        "pair_flip_rate": pair_flips / max(pair_n, 1),
        "fine_angle_median_deg": float(np.degrees(np.median(fine))) if fine else None,
        "gt_flip_rate_a": gt_flips["a"] / max(gt_n["a"], 1),
        "gt_flip_rate_b": gt_flips["b"] / max(gt_n["b"], 1) if dir_b else None,
        "gt_matched_a": gt_n["a"],
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("gt_dir")
    ap.add_argument("pred_dir_a")
    ap.add_argument("pred_dir_b", nargs="?")
    ap.add_argument("--cls", default="Car")
    ap.add_argument("--min_score", type=float, default=0.3)
    args = ap.parse_args(argv)
    r = compare(args.gt_dir, args.pred_dir_a, args.pred_dir_b, args.cls, args.min_score)
    print(f"matched dets vs GT (dir_a): {r['gt_matched_a']}")
    print(f"pi-flip rate vs GT: a={r['gt_flip_rate_a']:.1%}"
          + (f"  b={r['gt_flip_rate_b']:.1%}" if r["gt_flip_rate_b"] is not None else ""))
    if r["pairs"]:
        print(f"cross-checkpoint pairs: {r['pairs']}, flip rate "
              f"{r['pair_flip_rate']:.1%}, fine-angle median "
              f"{r['fine_angle_median_deg']:.1f} deg")
    return r


if __name__ == "__main__":
    main()
