"""Offline preprocessing tools (host, numpy).

Port of ``sparse_pooling_tpu.runtime.preprocess`` (capability parity with
the reference's ``scripts/preprocessing`` layer):

* ``cluster_label_dimensions`` / ``cluster_dataset_labels``
  (``avod/core/label_cluster_utils.py``): k-means clustering of per-class GT
  dimensions into anchor sizes, persisted as JSON; the config presets carry
  the standard centroids, this recomputes them for custom datasets.
* ``gen_mini_batches`` (``scripts/preprocessing/gen_mini_batches.py`` +
  ``mini_batch_preprocessor.py``): per-sample anchor IoU caches. Training
  assigns its targets on the device (``ops.target_assign``) and needs no
  cache; this tool exists for determinism audits and host-side
  experimentation, writing the same per-sample [anchor_idx, max_iou, class]
  arrays the reference cached, on a pool of spawned processes like the
  original. A worker computes on the host only (the one torch call, the
  anchor encoder, takes CPU tensors), and it sees no card: its pool hides
  them before any work, as the JAX workers keep off the TPU.
"""

from __future__ import annotations

import dataclasses
import json
import multiprocessing
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from sparse_pooling_tpu_torch.configs.config import AnchorConfig, AreaExtents
from sparse_pooling_tpu_torch.data import labels as labels_mod
from sparse_pooling_tpu_torch.data.dataset import KittiDataset


# ------------------------------------------------------------ label clustering

def cluster_label_dimensions(dims: np.ndarray, num_clusters: int, seed: int = 0, iters: int = 100) -> np.ndarray:
    """K-means over (l, w, h) GT dimensions -> (num_clusters, 3) centroids."""

    rng = np.random.RandomState(seed)
    if len(dims) == 0:
        return np.zeros((0, 3))
    k = min(num_clusters, len(dims))
    centers = dims[rng.choice(len(dims), k, replace=False)]
    for _ in range(iters):
        d2 = ((dims[:, None, :] - centers[None]) ** 2).sum(-1)
        assign = d2.argmin(1)
        new = np.stack([dims[assign == c].mean(0) if (assign == c).any() else centers[c] for c in range(k)])
        if np.allclose(new, centers):
            break
        centers = new
    return centers[np.argsort(-centers[:, 0])]  # largest first, deterministic


def cluster_dataset_labels(dataset: KittiDataset, num_clusters: int = 1,
                           out_path: Optional[str] = None) -> Dict[str, List[List[float]]]:
    """Cluster GT dims per class over the dataset (LabelClusterUtils.run)."""

    per_class: Dict[str, List[List[float]]] = {c: [] for c in dataset.model_cfg.classes}
    for sid in dataset.sample_ids:
        for ob in labels_mod.read_labels(os.path.join(dataset.base, "label_2", sid + ".txt")):
            if ob.type in per_class:
                per_class[ob.type].append([ob.l, ob.w, ob.h])
    result = {cls: cluster_label_dimensions(np.array(dims), num_clusters).tolist()
              for cls, dims in per_class.items()}
    if out_path:
        with open(out_path, "w") as f:
            json.dump(result, f, indent=2)
    return result


# ------------------------------------------------------------ minibatch cache

def _gt_footprint(box_3d: np.ndarray) -> np.ndarray:
    """A GT box's BEV footprint [z0, x0, z1, x1] from its axis-aligned
    anchor form, in f32 as the reference's encoder gives it."""

    import torch

    from sparse_pooling_tpu_torch.ops.encoders import box_3d_to_anchor

    g = box_3d_to_anchor(torch.from_numpy(box_3d[None].astype(np.float32)))[0].numpy()
    return np.array([g[2] - g[5] / 2, g[0] - g[3] / 2, g[2] + g[5] / 2, g[0] + g[3] / 2])


def _hide_cards() -> None:
    """Pool initializer: the worker can never initialise CUDA."""

    os.environ["CUDA_VISIBLE_DEVICES"] = ""


def _process_sample(args) -> Tuple[str, dict]:
    (root, data_dir, sid, classes, anchor_cfg_dict, extents_dict) = args
    from sparse_pooling_tpu_torch.data import calib as calib_mod
    from sparse_pooling_tpu_torch.data import pointcloud
    from sparse_pooling_tpu_torch.data.integral_image import integral_image_2d, query_boxes_2d
    from sparse_pooling_tpu_torch.data.voxel_grid import voxelize_2d
    from sparse_pooling_tpu_torch.ops import anchors as anchor_ops

    extents = AreaExtents(**extents_dict)
    anchor_cfg = AnchorConfig(**anchor_cfg_dict)
    base = os.path.join(root, data_dir)
    cal = calib_mod.read_calibration(os.path.join(base, "calib", sid + ".txt"))
    pts = pointcloud.get_lidar_point_cloud(os.path.join(base, "velodyne", sid + ".bin"), cal)
    pts = pointcloud.filter_to_area_extents(pts, extents)
    plane_path = os.path.join(base, "planes", sid + ".txt")
    plane = (labels_mod.read_ground_plane(plane_path) if os.path.exists(plane_path)
             else labels_mod.default_ground_plane())

    anchors = anchor_ops.generate_anchors_np(anchor_cfg, extents, plane)
    # host empty-anchor filter via voxel grid + integral image (N6 path)
    vs = 0.1
    ii = integral_image_2d(voxelize_2d(pts, extents, vs).count_map())
    c0 = np.floor((anchors[:, 0] - anchors[:, 3] / 2 - extents.x_min) / vs).astype(int)
    c1 = np.ceil((anchors[:, 0] + anchors[:, 3] / 2 - extents.x_min) / vs).astype(int)
    r0 = np.floor((anchors[:, 2] - anchors[:, 5] / 2 - extents.z_min) / vs).astype(int)
    r1 = np.ceil((anchors[:, 2] + anchors[:, 5] / 2 - extents.z_min) / vs).astype(int)
    counts = query_boxes_2d(ii, np.stack([r0, c0, r1, c1], axis=1))
    keep = np.flatnonzero(counts >= anchor_cfg.density_threshold)

    # BEV IoU vs GT per class
    gt = labels_mod.read_labels(os.path.join(base, "label_2", sid + ".txt"))
    out: dict = {"anchor_indices": keep.astype(np.int32)}
    a = anchors[keep]
    ab = np.stack([a[:, 2] - a[:, 5] / 2, a[:, 0] - a[:, 3] / 2,
                   a[:, 2] + a[:, 5] / 2, a[:, 0] + a[:, 3] / 2], axis=1)
    for cls in classes:
        cls_gt = [ob for ob in gt if ob.type == cls]
        ious = np.zeros((len(keep),))
        cls_idx = np.zeros((len(keep),))
        for gi, ob in enumerate(cls_gt):
            gb = _gt_footprint(ob.box_3d())
            iy = np.maximum(0, np.minimum(ab[:, 2], gb[2]) - np.maximum(ab[:, 0], gb[0]))
            ix = np.maximum(0, np.minimum(ab[:, 3], gb[3]) - np.maximum(ab[:, 1], gb[1]))
            inter = ix * iy
            union = (ab[:, 2] - ab[:, 0]) * (ab[:, 3] - ab[:, 1]) + (gb[2] - gb[0]) * (gb[3] - gb[1]) - inter
            iou = np.where(union > 0, inter / np.maximum(union, 1e-12), 0)
            upd = iou > ious
            ious = np.where(upd, iou, ious)
            cls_idx = np.where(upd, gi, cls_idx)
        out[cls] = np.stack([ious, cls_idx], axis=1).astype(np.float32)
    return sid, out


def gen_mini_batches(dataset: KittiDataset, out_dir: str, num_workers: int = 4) -> List[str]:
    """Generate per-sample anchor-info caches (.npz) in parallel."""

    os.makedirs(out_dir, exist_ok=True)
    cfg = dataset.model_cfg
    args = [
        (dataset.cfg.root, dataset.cfg.data_dir, sid, list(cfg.classes),
         dataclasses.asdict(cfg.anchors), dataclasses.asdict(dataset.extents))
        for sid in dataset.sample_ids
    ]
    written = []
    # spawn, not fork: a forked child of a process that has initialised CUDA
    # cannot use it, and spawned workers import only what they need
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(num_workers, initializer=_hide_cards) as pool:
        for sid, data in pool.imap_unordered(_process_sample, args):
            path = os.path.join(out_dir, sid + ".npz")
            np.savez_compressed(path, **data)
            written.append(path)
    return sorted(written)
