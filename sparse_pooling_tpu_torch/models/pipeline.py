"""End-to-end pipeline: raw batch -> model outputs -> detections or losses.

Port of ``sparse_pooling_tpu.models.pipeline``: the packed voxelizer, the
in-graph image resize, the SHPL COO build and the quad anchor filter build
the model inputs on the device; ``forward_batch_fn`` runs the detector
(serving under ``no_grad``; ``train=True`` with path drop and dropout drawn
from a ``torch.Generator``), ``decode_batch`` the final NMS and
``loss_batch`` the training losses. Entry points take ``device`` (default
``"cuda"``) and raise when it is unavailable.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from sparse_pooling_tpu_torch import resolve_device
from sparse_pooling_tpu_torch.configs.config import AreaExtents, ModelConfig
from sparse_pooling_tpu_torch.models.detector import SparsePoolingDetector, decode_detections
from sparse_pooling_tpu_torch.models.loss import detector_loss_batch
from sparse_pooling_tpu_torch.ops import anchors as anchor_ops
from sparse_pooling_tpu_torch.ops import bev_device, sparse_build
from sparse_pooling_tpu_torch.ops.image_resize import resize_bilinear_batch


class RawSample(NamedTuple):
    """Per-batch device inputs (leading batch dim on every field)."""

    points: torch.Tensor  # [B, P, 3] f32 camera frame, zero-padded
    points_mask: torch.Tensor  # [B, P] bool
    image: torch.Tensor  # [B, Hi, Wi, 3] uint8 canvas
    p2: torch.Tensor  # [B, 3, 4] f32 canvas-scaled
    ground_plane: torch.Tensor  # [B, 4] f32
    gt_boxes_3d: torch.Tensor  # [B, G, 7] f32 padded
    gt_valid: torch.Tensor  # [B, G] bool
    gt_classes: torch.Tensor  # [B, G] int32
    image_scale: Any = None  # [B, 2] f32 (sy, sx) = canvas / raw, or None


def stack_frames(frames: Sequence[Dict[str, np.ndarray]], device="cuda") -> RawSample:
    """Stack per-frame numpy dicts (``data.synthetic_frame``) into a batched
    ``RawSample`` on ``device``."""

    dev = resolve_device(device)
    fields = {}
    for name in RawSample._fields:
        arrs = [f.get(name) for f in frames]
        fields[name] = None if arrs[0] is None else torch.from_numpy(np.stack(arrs)).to(dev)
    return RawSample(**fields)


def static_anchor_grid(cfg: ModelConfig, extents: AreaExtents, device="cuda") -> torch.Tensor:
    """Anchor grid constant [N, 8] f32 with y = 0 (filled per frame)."""

    plane0 = np.array([0.0, -1.0, 0.0, 0.0])
    grid = anchor_ops.generate_anchors_np(cfg.anchors, extents, plane0).astype(np.float32)
    return torch.from_numpy(grid).to(resolve_device(device))


def anchors_with_ground_y(anchors_static: torch.Tensor, plane: torch.Tensor) -> torch.Tensor:
    """Per-frame anchors [B, N, 8] with y on each frame's ground plane [B, 4]."""

    a, b, c, d = (plane[:, i : i + 1] for i in range(4))
    x, z = anchors_static[None, :, 0], anchors_static[None, :, 2]
    y = -(a * x + c * z + d) / b
    out = anchors_static[None].repeat(plane.shape[0], 1, 1)
    out[..., 1] = y
    return out


def make_model(cfg: ModelConfig, extents: AreaExtents = AreaExtents(), device="cuda") -> SparsePoolingDetector:
    """Build the detector on ``device`` in eval mode (parameters from
    PyTorch's default init; load ``weights.from_flax`` or
    ``weights.init_like_flax`` before use)."""

    dev = resolve_device(device)
    expected_stride = 2 ** (len(cfg.backbone.channels) - 1)
    if cfg.sparse_pool.fusion_stride != expected_stride:
        raise ValueError(
            "sparse_pool.fusion_stride must equal the encoder's final stride "
            f"2^(stages-1) = {expected_stride}, got {cfg.sparse_pool.fusion_stride}"
        )
    bh, bw = cfg.bev.padded_hw(extents)
    s = cfg.sparse_pool.fusion_stride
    for name, (h, w) in {"bev": (bh, bw), "image": (cfg.image.height, cfg.image.width)}.items():
        if h % s or w % s:
            raise ValueError(f"{name} lattice {h}x{w} not divisible by stride {s}")
    ds = cfg.backbone.decode_stride
    if ds < 1 or (ds & (ds - 1)):
        raise ValueError(f"backbone.decode_stride must be a power of 2, got {ds}")
    if ds >= cfg.sparse_pool.fusion_stride:
        raise ValueError(
            f"backbone.decode_stride {ds} must be below the encoder's final "
            f"stride {cfg.sparse_pool.fusion_stride}"
        )
    for name, st in (("bev_roi_stride", cfg.rpn.bev_roi_stride), ("img_roi_stride", cfg.rpn.img_roi_stride)):
        if st % ds:
            raise ValueError(
                f"rpn.{name}={st} must be a multiple of backbone.decode_stride={ds}"
            )
    if cfg.anchors.max_anchors % (len(cfg.anchors.sizes) * len(cfg.anchors.rotations)):
        raise ValueError(
            f"anchors.max_anchors={cfg.anchors.max_anchors} must be divisible "
            "by the class x rotation variant count"
        )
    if cfg.architecture != "avod":
        raise NotImplementedError(f"architecture {cfg.architecture!r} is not ported yet")
    return SparsePoolingDetector(cfg, extents).to(dev).eval()


def build_model_inputs_batch(
    batch: RawSample,
    anchors_static: torch.Tensor,
    path_keep: torch.Tensor,  # [B, 2]
    cfg: ModelConfig,
    extents: AreaExtents,
) -> Dict[str, Any]:
    """Batch-native input construction on the batch's device."""

    h, w = cfg.bev.grid_hw(extents)
    hp, _ = cfg.bev.padded_hw(extents)
    if not (cfg.backbone.space_to_depth and hp % 2 == 0 and w % 2 == 0):
        raise NotImplementedError("only the packed (space-to-depth) voxelizer is ported")
    bev_input, counts = bev_device.bev_maps_packed_batch(
        batch.points, batch.points_mask, batch.ground_plane, extents, cfg.bev
    )
    if cfg.image.device_resize and batch.image_scale is not None:
        image = resize_bilinear_batch(batch.image, batch.image_scale)
    else:
        image = batch.image.to(torch.float32) / 255.0
    m_bev, m_fv = sparse_build.build_coo_device(
        batch.points, batch.points_mask, batch.p2, extents, cfg.bev, cfg.image, cfg.sparse_pool
    )
    # 0/1 indicator for threshold <= 1 (the tier ranking sums this raster),
    # raw counts above
    raster = counts if cfg.anchors.density_threshold > 1 else (counts > 0).to(torch.float32)
    occupancy = bev_device.unpack_s2d_raster(raster, h)

    anchors_frame = anchors_with_ground_y(anchors_static, batch.ground_plane)
    if cfg.rpn.dense_grid or not anchor_ops.quad_supported(
        cfg.anchors, cfg.bev, extents, cfg.anchors.max_anchors, cfg.rpn.roi_quad
    ):
        raise NotImplementedError("only the quad-block anchor filter is ported")
    filtered = anchor_ops.filter_anchor_quads_grid(
        anchors_frame, occupancy, extents, cfg.bev, cfg.anchors,
        max_anchors=cfg.anchors.max_anchors, quad=cfg.rpn.roi_quad,
        density_threshold=cfg.anchors.density_threshold,
    )
    return {
        "bev_input": bev_input,
        "bev_pre_packed": True,
        "image": image,
        "m_bev": m_bev,
        "m_fv": m_fv,
        "anchors": filtered.anchors,
        "anchor_valid": filtered.valid,
        "p2": batch.p2,
        "path_keep": path_keep,
    }


def sample_path_keep(generator: Optional[torch.Generator], cfg: ModelConfig,
                     batch_size: Optional[int] = None, device=None) -> torch.Tensor:
    """Path-drop flags: keep each branch with its configured probability,
    but never drop both (a third draw revives one). [2] f32, or [B, 2] with
    ``batch_size``; drawn on ``device`` (default the generator's)."""

    n = 1 if batch_size is None else batch_size
    dev = device if device is not None else (generator.device if generator is not None else "cpu")
    if not cfg.path_drop.enabled:
        keep = torch.ones((n, 2), dtype=torch.float32, device=dev)
    else:
        u = torch.rand((n, 3), generator=generator, device=dev)
        bev = u[:, 0] < cfg.path_drop.bev_keep_prob
        img = u[:, 1] < cfg.path_drop.img_keep_prob
        neither = ~(bev | img)
        revive_bev = u[:, 2] < 0.5
        bev = bev | (neither & revive_bev)
        img = img | (neither & ~revive_bev)
        keep = torch.stack([bev, img], dim=-1).to(torch.float32)
    return keep[0] if batch_size is None else keep


def forward_batch_fn(
    model: SparsePoolingDetector,
    batch: RawSample,
    anchors_static: torch.Tensor,
    cfg: ModelConfig,
    extents: AreaExtents,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
) -> Dict[str, torch.Tensor]:
    """Batched end-to-end forward: raw inputs -> model outputs. Serving
    (``train=False``) runs under ``no_grad`` with both branches kept;
    training draws path drop, then dropout, from ``generator`` (on the
    batch's device) and keeps the graph for the backward."""

    b, dev = batch.points.shape[0], batch.points.device
    with contextlib.nullcontext() if train else torch.no_grad():
        if train:
            path_keep = sample_path_keep(generator, cfg, batch_size=b, device=dev)
        else:
            path_keep = torch.ones((b, 2), dtype=torch.float32, device=dev)
        inputs = build_model_inputs_batch(batch, anchors_static, path_keep, cfg, extents)
        return model(inputs, train=train, generator=generator)


def loss_batch(outputs, batch: RawSample, cfg: ModelConfig, extents: AreaExtents,
               generator: Optional[torch.Generator] = None, noise=None) -> Dict[str, torch.Tensor]:
    """Training losses of a batch (``models.loss.detector_loss_batch``); the
    sampling noise comes from ``generator`` unless ``noise`` is given."""

    if cfg.architecture != "avod":
        raise NotImplementedError(f"architecture {cfg.architecture!r} is not ported yet")
    return detector_loss_batch(
        outputs, batch.gt_boxes_3d, batch.gt_valid, batch.gt_classes, batch.ground_plane,
        cfg, extents, generator=generator, noise=noise,
    )


@torch.no_grad()
def decode_batch(outputs, ground_plane: torch.Tensor, cfg: ModelConfig, extents: AreaExtents):
    """Final detections: boxes_3d [B, C, K, 7], scores [B, C, K], valid."""

    if cfg.architecture != "avod":
        raise NotImplementedError(f"architecture {cfg.architecture!r} is not ported yet")
    return decode_detections(outputs, ground_plane, cfg, extents)
