"""KITTI dataset: sample index, per-frame loading, batching (host, numpy).

Port of ``sparse_pooling_tpu.data.dataset``: a split-file-driven sample
index whose ``load_sample`` produces everything one training step needs. The
host only reads files, places the raw image on the fixed canvas, augments
and pads to static shapes; BEV maps, sparse matrices and anchors are built on
the device (``ops.bev_device``, ``ops.sparse_build``, ``ops.anchors``).

Images decode with the native loader (``native/sample_loader``), straight
into the caller's canvas where the graph resizes them
(``image.device_resize`` and a raw image that fits the canvas). Otherwise
the raw image is resized on the host after augmentation, byte-equal to the
reference's PIL resize (``data/pil_resize.py``), and ``image_scale`` is 1.
Augmentation, subsampling and shuffling make the JAX package's numpy draws
in its order, so both packages yield equal arrays for the same tree, seed
and epoch.
"""

from __future__ import annotations

import dataclasses
import os
import zlib
from typing import Iterator, List, Optional

import numpy as np

from sparse_pooling_tpu_torch.configs.config import AreaExtents, DatasetConfig, ModelConfig
from sparse_pooling_tpu_torch.data import augmentation as aug
from sparse_pooling_tpu_torch.data import calib as calib_mod
from sparse_pooling_tpu_torch.data import labels as labels_mod
from sparse_pooling_tpu_torch.data import pointcloud
from sparse_pooling_tpu_torch.data.pil_resize import resize_bilinear
from sparse_pooling_tpu_torch.native import sample_loader as native_loader

MAX_GT_BOXES = 32


@dataclasses.dataclass
class HostSample:
    """Numpy twin of ``models.pipeline.RawSample`` plus metadata."""

    sample_id: str
    points: np.ndarray  # [P, 3] f32
    points_mask: np.ndarray  # [P] bool
    image: np.ndarray  # [Hi, Wi, 3] uint8 canvas
    p2: np.ndarray  # [3, 4] f32 canvas-scaled
    ground_plane: np.ndarray  # [4] f32
    gt_boxes_3d: np.ndarray  # [G, 7] f32
    gt_valid: np.ndarray  # [G] bool
    gt_classes: np.ndarray  # [G] int32
    image_scale: np.ndarray = None  # [2] f32 (sy, sx) canvas/raw for the in-graph resize
    raw_image_hw: tuple = (0, 0)

    NUM_ARRAYS = 9

    def as_arrays(self) -> tuple:
        """Field order matches RawSample."""

        return (
            self.points, self.points_mask, self.image, self.p2,
            self.ground_plane, self.gt_boxes_3d, self.gt_valid,
            self.gt_classes, self.image_scale,
        )


def augment_seed(seed: int, epoch: int, sid: str) -> int:
    """The per-(epoch, sample) augmentation seed; ids that are not numbers
    hash through crc32, so every sample still augments independently."""

    return (seed + epoch) * 100003 + (int(sid) if sid.isdigit() else zlib.crc32(sid.encode()))


class KittiDataset:
    """Sample index over a KITTI object tree (``<root>/<split>.txt`` and
    ``<root>/<data_dir>/{calib,velodyne,image_2,label_2,planes}``)."""

    def __init__(self, cfg: DatasetConfig, model_cfg: ModelConfig, extents: AreaExtents = AreaExtents()):
        self.cfg = cfg
        self.model_cfg = model_cfg
        self.extents = extents
        self.base = os.path.join(cfg.root, cfg.data_dir)
        split_path = os.path.join(cfg.root, cfg.split + ".txt")
        with open(split_path) as f:
            self.sample_ids: List[str] = [line.strip() for line in f if line.strip()]
        self.class_to_idx = {name: i + 1 for i, name in enumerate(model_cfg.classes)}

    def __len__(self) -> int:
        return len(self.sample_ids)

    def _path(self, folder: str, sid: str, ext: str) -> str:
        return os.path.join(self.base, folder, sid + ext)

    def _on_canvas(self, raw_hw) -> bool:
        """Whether the raw image goes on the canvas as it is, for the graph
        to resize (else the host resizes it)."""

        mc = self.model_cfg.image
        return mc.device_resize and raw_hw[0] <= mc.height and raw_hw[1] <= mc.width

    def _raw_image(self, sid: str, image_out: Optional[np.ndarray]):
        """(canvas or None, raw image, raw (h, w)): the decoded raw image
        placed top left in ``image_out`` (or a fresh zeroed canvas) where it
        stays on the canvas; else, or for an image cache hit without
        ``image_out``, the raw image alone.

        ``dataset.image_cache_dir`` keeps each decoded raw image as ``.npy``
        on first touch (written once, atomically: loader threads may race on
        a frame) and copies it from a memory map afterwards."""

        mc = self.model_cfg.image
        cache_path = None
        if self.cfg.image_cache_dir:
            cache_path = os.path.join(self.cfg.image_cache_dir, sid + ".npy")
            if os.path.exists(cache_path):
                cached = np.load(cache_path, mmap_mode="r")
                rh, rw = cached.shape[:2]
                if image_out is None or not self._on_canvas((rh, rw)):
                    return None, np.array(cached), (rh, rw)
                image_out[:rh, :rw] = cached
                return image_out, image_out[:rh, :rw], (rh, rw)
        path = self._path("image_2", sid, ".png")
        if self._on_canvas(native_loader.png_size(path)):
            canvas, (rh, rw) = native_loader.decode_png_canvas(path, mc.height, mc.width, out=image_out)
            img = canvas[:rh, :rw]
        else:
            canvas, img = None, native_loader.decode_png(path)
            rh, rw = img.shape[:2]
        if cache_path is not None:
            os.makedirs(self.cfg.image_cache_dir, exist_ok=True)
            tmp = cache_path + f".tmp{os.getpid()}.npy"
            with open(tmp, "wb") as f:
                np.save(f, np.ascontiguousarray(img))
            os.replace(tmp, cache_path)
        return canvas, img, (rh, rw)

    def load_sample(self, sid: str, augment_seed: Optional[int] = None,
                    image_out: Optional[np.ndarray] = None) -> HostSample:
        """Load + canvas-place (or host-resize) + (optionally) augment + pad
        one frame.

        ``augment_seed`` enables the deterministic flip and PCA jitter; None
        disables augmentation (evaluation). ``image_out``: an optional
        ZERO-FILLED [H, W, 3] u8 canvas the image is decoded (or resized)
        into in place (typically a row of a batch array, so assembling a
        batch copies no image bytes); the returned ``HostSample.image`` is
        then that array.
        """

        mc = self.model_cfg
        cal = calib_mod.read_calibration(self._path("calib", sid, ".txt"))
        canvas, img, raw_hw = self._raw_image(sid, image_out)
        pts = native_loader.load_points(
            self._path("velodyne", sid, ".bin"), cal.velo_to_rect(), cal.p2, raw_hw, self.extents)
        if pts is None:  # more points than the native cap: the numpy twin's full set
            pts = pointcloud.load_points_filtered(
                self._path("velodyne", sid, ".bin"), cal, raw_hw, self.extents)
        plane_path = self._path("planes", sid, ".txt")
        if os.path.exists(plane_path):
            plane = labels_mod.read_ground_plane(plane_path)
        else:
            plane = labels_mod.default_ground_plane()
        gt = labels_mod.filter_labels_by_class(
            labels_mod.read_labels(self._path("label_2", sid, ".txt")), mc.classes)

        if augment_seed is not None:
            rng = np.random.RandomState(augment_seed)
            dirty = False
            if self.cfg.aug_flip and rng.rand() < 0.5:
                img, pts, cal, gt = aug.flip_sample(img, pts, cal, gt)
                # the fused loader filtered the extents before the flip;
                # asymmetric extents (or the half-open x bound) can differ after
                pts = pointcloud.filter_to_area_extents(pts, self.extents)
                dirty = True
            if self.cfg.aug_pca_jitter:
                img = aug.pca_jitter(img, rng)
                dirty = True
            if canvas is not None and dirty:
                # img is a fresh augmented array; place it in the canvas again
                canvas[: raw_hw[0], : raw_hw[1]] = img

        # the raw image sits top left of the canvas and the graph resamples
        # it (ops.image_resize), or the host resizes it onto the canvas (the
        # graph's resize is then the identity); P2 scales with the
        # canvas/raw ratio either way
        sy = mc.image.height / raw_hw[0]
        sx = mc.image.width / raw_hw[1]
        if self._on_canvas(raw_hw):
            if canvas is None:
                canvas = np.zeros((mc.image.height, mc.image.width, 3), np.uint8)
                canvas[: raw_hw[0], : raw_hw[1]] = img
            image_scale = np.array([sy, sx], np.float32)
        else:
            resized = resize_bilinear(np.ascontiguousarray(img), mc.image.height, mc.image.width)
            if image_out is not None:
                image_out[:] = resized
                resized = image_out
            canvas = resized
            image_scale = np.ones((2,), np.float32)
        p2 = cal.p2.astype(np.float32).copy()
        p2[0] *= sx
        p2[1] *= sy

        padded, mask = pointcloud.pad_or_subsample(
            pts.astype(np.float32), mc.sparse_pool.max_points,
            seed=int(sid) if sid.isdigit() else 0,
        )

        gt_boxes = np.zeros((MAX_GT_BOXES, 7), np.float32)
        gt_valid = np.zeros((MAX_GT_BOXES,), bool)
        gt_cls = np.zeros((MAX_GT_BOXES,), np.int32)
        for i, ob in enumerate(gt[:MAX_GT_BOXES]):
            gt_boxes[i] = ob.box_3d()
            gt_valid[i] = True
            gt_cls[i] = self.class_to_idx[ob.type]

        return HostSample(
            sample_id=sid,
            points=padded,
            points_mask=mask,
            image=np.ascontiguousarray(canvas, np.uint8),
            p2=p2,
            ground_plane=plane.astype(np.float32),
            gt_boxes_3d=gt_boxes,
            gt_valid=gt_valid,
            gt_classes=gt_cls,
            image_scale=image_scale,
            raw_image_hw=raw_hw,
        )

    # ------------------------------------------------------------ iteration
    def epoch_ids(self, epoch: int) -> List[str]:
        ids = list(self.sample_ids)
        if self.cfg.shuffle:
            np.random.RandomState(self.cfg.seed + epoch).shuffle(ids)
        return ids

    def batches(self, batch_size: int, epoch: int = 0, augment: bool = True,
                rows: Optional[slice] = None) -> Iterator[tuple]:
        """Yield (stacked arrays in ``RawSample`` order, sample ids) per
        batch; drops the ragged tail batch (static shapes). With ``rows``, a
        data-parallel rank's share: only those rows of each batch are loaded
        (their augmentation seeds are per sample, so the rows equal those of
        the whole batch)."""

        ids = self.epoch_ids(epoch)
        for start in range(0, len(ids) - batch_size + 1, batch_size):
            chunk = ids[start : start + batch_size]
            if rows is not None:
                chunk = chunk[rows]
            canvas_b = self.alloc_image_batch(len(chunk))
            samples = [
                self.load_sample(
                    sid,
                    augment_seed=augment_seed(self.cfg.seed, epoch, sid) if augment else None,
                    image_out=canvas_b[j],
                )
                for j, sid in enumerate(chunk)
            ]
            yield self.stack_samples(samples, image_batch=canvas_b), chunk

    def alloc_image_batch(self, batch_size: int) -> np.ndarray:
        """Zeroed [B, H, W, 3] u8 canvas batch for ``image_out`` loading."""

        mc = self.model_cfg.image
        return np.zeros((batch_size, mc.height, mc.width, 3), np.uint8)

    def stack_samples(self, samples, image_batch=None) -> tuple:
        """HostSamples -> RawSample-ordered batch arrays. Points stack as
        bucket-length prefix slices (``pad_or_subsample`` packs valid points
        first, so the slice is lossless); the image field is not copied when
        the samples were loaded into a caller-owned ``image_batch``."""

        sp = self.model_cfg.sparse_pool
        n = max(int(s.points_mask.sum()) for s in samples)
        b = min(pointcloud.pick_bucket(n, sp.buckets, sp.max_points), samples[0].points.shape[0])
        pts = np.stack([s.points[:b] for s in samples])
        mask = np.stack([s.points_mask[:b] for s in samples])
        if image_batch is None:
            image_batch = np.stack([s.image for s in samples])
        rest = tuple(
            np.stack([s.as_arrays()[i] for s in samples]) for i in range(3, HostSample.NUM_ARRAYS)
        )
        return (pts, mask, image_batch) + rest

    def _bucket(self, stacked: tuple) -> tuple:
        """Trim the padded point arrays to the batch's point bucket."""

        pts, mask = pointcloud.trim_points_to_bucket(
            stacked[0], stacked[1], self.model_cfg.sparse_pool.buckets)
        return (pts, mask) + stacked[2:]
