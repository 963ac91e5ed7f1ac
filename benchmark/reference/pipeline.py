"""The serving pipeline in plain PyTorch: host frames -> model inputs ->
detector -> detections (the reference's ``models/pipeline.py``).

``build_model_inputs_batch`` builds the BEV maps, the image, the SHPL COO
tables and the anchor set on the batch's device, as the port's does;
``make_model`` builds the detector of the configuration's family in float32
(the configuration's compute dtype is replaced by float32), and
``set_lower`` turns every conv and dense layer into the control's lower
precision. What differs by family (the model class, the anchors, the
decode, any inputs of its own) comes from its family file
(``families/<architecture>.py``); each function takes that file's module as
``family``, and without it loads the file of ``cfg.architecture`` from this
benchmark folder.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Sequence

import numpy as np
import torch

from .config import AreaExtents, ModelConfig
from . import bev_device, sparse_build
from .image_resize import resize_bilinear_batch
from .layers import Conv, ConvTransposeSame, Dense


class RawSample(NamedTuple):
    """Per-batch device inputs (leading batch dim on every field)."""

    points: torch.Tensor  # [B, P, 3] f32 camera frame, zero-padded
    points_mask: torch.Tensor  # [B, P] bool
    image: torch.Tensor  # [B, Hi, Wi, 3] uint8 canvas
    p2: torch.Tensor  # [B, 3, 4] f32 canvas-scaled
    ground_plane: torch.Tensor  # [B, 4] f32
    image_scale: Any = None  # [B, 2] f32 (sy, sx) = canvas / raw, or None


def stack_frames(frames: Sequence[Dict[str, np.ndarray]], buckets: Sequence[int], device) -> RawSample:
    """Stack host frames into a ``RawSample``, the point arrays cut to the
    smallest capacity of ``buckets`` that holds every frame's valid points
    (valid points are a prefix of each row)."""

    n = max(int(np.asarray(f["points_mask"]).sum()) for f in frames)
    cap = next(b for b in sorted(buckets) if b >= n)
    fields = {}
    for name in RawSample._fields:
        arrs = [f.get(name) for f in frames]
        if arrs[0] is None:
            fields[name] = None
            continue
        arr = np.stack(arrs)
        if name in ("points", "points_mask"):
            arr = arr[:, :cap]
        fields[name] = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    return RawSample(**fields)


def float32_config(cfg: ModelConfig) -> ModelConfig:
    """``cfg`` computed in float32 throughout."""

    return dataclasses.replace(cfg, backbone=dataclasses.replace(cfg.backbone, compute_dtype="float32"))


def family_of(cfg: ModelConfig, family=None):
    """``family``, or the family file of ``cfg.architecture``."""

    if family is not None:
        return family
    from families import load

    return load(cfg.architecture)


def make_model(cfg: ModelConfig, extents: AreaExtents, device, family=None) -> torch.nn.Module:
    """The detector of ``cfg.architecture`` in float32, eval mode."""

    return family_of(cfg, family).MODEL(float32_config(cfg), extents).to(device).eval()


def set_lower(model: torch.nn.Module, lower) -> None:
    """Round every conv and dense layer's input and weight through ``lower``
    (a float8 dtype, or None for the float32 reference)."""

    for m in model.modules():
        if isinstance(m, (Conv, ConvTransposeSame, Dense)):
            m.lower = lower


def static_anchor_grid(cfg: ModelConfig, extents: AreaExtents, device, family=None) -> torch.Tensor:
    """Anchor grid constant [N, 8] f32 with y = 0 (filled per frame), the
    family's."""

    return torch.from_numpy(family_of(cfg, family).anchor_grid(cfg, extents)).to(device)


def anchors_with_ground_y(anchors_static: torch.Tensor, plane: torch.Tensor) -> torch.Tensor:
    """Per-frame anchors [B, N, 8] with y on each frame's ground plane [B, 4]."""

    a, b, c, d = (plane[:, i : i + 1] for i in range(4))
    x, z = anchors_static[None, :, 0], anchors_static[None, :, 2]
    y = -(a * x + c * z + d) / b
    out = anchors_static[None].repeat(plane.shape[0], 1, 1)
    out[..., 1] = y
    return out


def build_model_inputs_batch(
    batch: RawSample,
    anchors_static: torch.Tensor,
    path_keep: torch.Tensor,  # [B, 2]
    cfg: ModelConfig,
    extents: AreaExtents,
    family=None,
) -> Dict[str, Any]:
    """Batch-native input construction on the batch's device; the family's
    anchors and validity, and its own inputs."""

    family = family_of(cfg, family)
    h, w = cfg.bev.grid_hw(extents)
    hp, _ = cfg.bev.padded_hw(extents)
    # packed where the backbone packs anyway (bit-identical inputs); an odd
    # lattice with space_to_depth fails in the encoder, as in the reference
    packed = cfg.backbone.space_to_depth and hp % 2 == 0 and w % 2 == 0
    if packed:
        bev_input, counts = bev_device.bev_maps_packed_batch(
            batch.points, batch.points_mask, batch.ground_plane, extents, cfg.bev
        )
    else:
        bev_input = bev_device.bev_maps_from_points_batch(
            batch.points, batch.points_mask, batch.ground_plane, extents, cfg.bev
        )
    if cfg.image.device_resize and batch.image_scale is not None:
        image = resize_bilinear_batch(batch.image, batch.image_scale)
    else:
        image = batch.image.to(torch.float32) / 255.0
    m_bev, m_fv = sparse_build.build_coo_device(
        batch.points, batch.points_mask, batch.p2, extents, cfg.bev, cfg.image, cfg.sparse_pool
    )

    # occupancy raster: a 0/1 indicator for threshold <= 1 (the tier ranking
    # sums this raster), raw counts above
    thr = cfg.anchors.density_threshold
    if packed:
        occupancy = bev_device.unpack_s2d_raster(counts if thr > 1 else (counts > 0).to(torch.float32), h)
    elif thr <= 1:
        occupancy = (bev_input[:, :h, :, cfg.bev.height_slices] > 0).to(torch.float32)
    else:
        occupancy = bev_device.bev_counts_from_points(
            batch.points, batch.points_mask, extents, cfg.bev.voxel_size
        )

    anchors_frame = anchors_with_ground_y(anchors_static, batch.ground_plane)
    anchors, valid = family.frame_anchors(anchors_frame, occupancy, cfg, extents)
    return {
        "bev_input": bev_input,
        "bev_pre_packed": packed,
        "image": image,
        "m_bev": m_bev,
        "m_fv": m_fv,
        "anchors": anchors,
        "anchor_valid": valid,
        "p2": batch.p2,
        "path_keep": path_keep,
        **family.extra_inputs(batch, cfg, extents),
    }


def decode_batch(outputs, ground_plane: torch.Tensor, cfg: ModelConfig, extents: AreaExtents, picks=None,
                 family=None):
    """Final detections: boxes_3d [B, C, K, 7], scores [B, C, K], valid;
    ``picks`` replaces the per-class NMS."""

    return family_of(cfg, family).decode(outputs, ground_plane, cfg, extents, picks)

