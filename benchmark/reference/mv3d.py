"""MV3D as published (Chen et al., arXiv:1611.07759) with SHPL fusion, in
plain PyTorch: the reference of the port's ``models/mv3d.py``
(``architecture="mv3d"``), its front view (``ops/front_view.py``), BEV
intensity, front-view box projection and proposal lattice, computed in
float32 as the rest of this package is.

The front view: each point, in the LiDAR's axes about the camera origin (x
forward, y left, z up), lies at column index c = floor(atan2(y, x) / dtheta)
and row index r = floor(atan2(z, sqrt(x^2 + y^2)) / dphi), drawn at column
W/2 - 1 - c and row ``fv_top`` - 1 - r; a cell holds the height above the
ground plane, the distance sqrt(x^2 + y^2) and the intensity of its nearest
point, ties to the lowest point index. The BEV intensity: the intensity of
each cell's highest point, ties likewise. The head joins the three views'
crops as f0 = mean(f_BV, f_FV, f_RGB), f_l = mean over the views v of
relu(fc_l^v(f_(l-1))), l = 1..3; ``join`` passes f3 to the output heads.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import anchors as anchor_ops
from . import encoders, projection
from .backbone import VggEncoder, space_to_depth
from .bev_device import _cells
from .config import AreaExtents, ModelConfig
from .crop_resize import crop_and_resize_px_batch
from .detector import STAGE2_BOX_DIMS, Stage2Head, compute_dtype, px_scales
from .fusion import SparsePoolFusion
from .fusion_rcnn import ConvRpnHead
from .nms import top_k_nms_batch

FV_CHANNELS = 3
N_VIEWS = 3


@dataclasses.dataclass(frozen=True)
class Mv3dSettings:
    """The configuration's ``pipeline.model.mv3d`` section."""

    fv_height: int = 64
    fv_width: int = 512
    fv_azimuth_deg: float = 81.0
    fv_elevation_up_deg: float = 2.0
    fv_elevation_deg: float = 26.8
    proposal_upsample: int = 2

    @property
    def fv_steps(self) -> Tuple[float, float]:
        return (math.radians(self.fv_azimuth_deg) / self.fv_width,
                math.radians(self.fv_elevation_deg) / self.fv_height)

    @property
    def fv_top(self) -> int:
        return math.ceil(self.fv_elevation_up_deg * self.fv_height / self.fv_elevation_deg)


def settings(cfg: ModelConfig) -> Mv3dSettings:
    return getattr(cfg, "mv3d", None) or Mv3dSettings()


def proposal_stride(cfg: ModelConfig) -> int:
    return cfg.sparse_pool.fusion_stride // settings(cfg).proposal_upsample


# ---------------------------------------------------------------- inputs

def _winner(keys, values, valid, n_keys: int, largest: bool) -> torch.Tensor:
    """Per key [B, n_keys], the index of the valid point with the key's
    largest (smallest) value, the lowest index among equals; P where none."""

    bsz, p = keys.shape
    fill = -math.inf if largest else math.inf
    off = (torch.arange(bsz, device=keys.device) * (n_keys + 1))[:, None]
    ids = (torch.where(valid, keys, n_keys) + off).reshape(-1)
    vals = torch.where(valid, values.float(), fill).reshape(-1)
    best = torch.full((bsz * (n_keys + 1),), fill, device=keys.device)
    best.scatter_reduce_(0, ids, vals, reduce="amax" if largest else "amin", include_self=True)
    tie = valid.reshape(-1) & (vals == best[ids])
    idx = torch.arange(p, device=keys.device).expand(bsz, p).reshape(-1)
    win = torch.full((bsz * (n_keys + 1),), p, dtype=torch.int64, device=keys.device)
    win.scatter_reduce_(0, ids, torch.where(tie, idx, p), reduce="amin", include_self=True)
    return win.reshape(bsz, n_keys + 1)[:, :n_keys]


def _take(features: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    padded = F.pad(features, (0, 0, 0, 1))
    return torch.gather(padded, 1, index[..., None].expand(-1, -1, features.shape[-1]))


def _heights(points, ground_plane):
    gp = ground_plane[:, :, None]
    return points[..., 0] * gp[:, 0] + points[..., 1] * gp[:, 1] + points[..., 2] * gp[:, 2] + gp[:, 3]


def _cylinder(x, y, z):
    lx, ly, lz = z, -x, -y
    rho = torch.sqrt(lx * lx + ly * ly)
    return torch.atan2(ly, lx), torch.atan2(lz, rho), rho


def front_view(points, mask, ground_plane, s: Mv3dSettings) -> torch.Tensor:
    """[B, P, 4] points, [B, P] mask, [B, 4] planes -> [B, H, W, 3]."""

    h, w = s.fv_height, s.fv_width
    dtheta, dphi = s.fv_steps
    azimuth, elevation, rho = _cylinder(points[..., 0], points[..., 1], points[..., 2])
    col = w // 2 - 1 - torch.floor(azimuth / dtheta).to(torch.int64)
    row = s.fv_top - 1 - torch.floor(elevation / dphi).to(torch.int64)
    valid = mask & (row >= 0) & (row < h) & (col >= 0) & (col < w)
    win = _winner(row * w + col, rho, valid, h * w, largest=False)
    feats = torch.stack([_heights(points, ground_plane), rho, points[..., 3]], dim=-1)
    return _take(feats, win).reshape(points.shape[0], h, w, FV_CHANNELS)


def bev_intensity(points, mask, ground_plane, extents: AreaExtents, bev) -> torch.Tensor:
    """[B, H+pad, W, 1]: the intensity of each cell's highest point."""

    h, w = bev.grid_hw(extents)
    valid, row, col = _cells(points, mask, extents, bev.voxel_size, h, w)
    win = _winner(row * w + col, _heights(points, ground_plane), valid, h * w, largest=True)
    out = _take(points[..., 3:4], win).reshape(points.shape[0], h, w, 1)
    return F.pad(out, (0, 0, 0, 0, 0, bev.pad_h))


def extra_inputs(batch, cfg: ModelConfig, extents: AreaExtents) -> Dict[str, torch.Tensor]:
    return {"fv_input": front_view(batch.points, batch.points_mask, batch.ground_plane, settings(cfg)),
            "bev_intensity": bev_intensity(batch.points, batch.points_mask, batch.ground_plane, extents, cfg.bev)}


def project_to_front_view(anchors: torch.Tensor, s: Mv3dSettings) -> torch.Tensor:
    """[..., 6] anchors -> [..., 4] front-view pixel boxes [r1, c1, r2, c2]
    bounding the 8 corners, clipped to the map."""

    x, y, z = anchors[..., 0:1], anchors[..., 1:2], anchors[..., 2:3]
    hx, hy, hz = anchors[..., 3:4] / 2, anchors[..., 4:5], anchors[..., 5:6] / 2
    kw = dict(dtype=anchors.dtype, device=anchors.device)
    sx = torch.tensor([1, 1, 1, 1, -1, -1, -1, -1], **kw)
    sy = torch.tensor([0, 0, 1, 1, 0, 0, 1, 1], **kw)
    sz = torch.tensor([1, -1, 1, -1, 1, -1, 1, -1], **kw)
    azimuth, elevation, _ = _cylinder(x + sx * hx, y - sy * hy, z + sz * hz)
    dtheta, dphi = s.fv_steps
    cols = s.fv_width / 2 - 0.5 - azimuth / dtheta
    rows = s.fv_top - 0.5 - elevation / dphi
    return torch.stack([torch.clamp(rows.amin(-1), 0.0, s.fv_height - 1.0),
                        torch.clamp(cols.amin(-1), 0.0, s.fv_width - 1.0),
                        torch.clamp(rows.amax(-1), 0.0, s.fv_height - 1.0),
                        torch.clamp(cols.amax(-1), 0.0, s.fv_width - 1.0)], dim=-1)


# ---------------------------------------------------------------- anchors

def anchor_grid(cfg: ModelConfig, extents: AreaExtents) -> np.ndarray:
    """The proposal lattice [Hl*Wl*V, 8] f32, y = 0: cells row-major over
    the padded BEV map at ``proposal_stride`` cells, each cell's (size,
    rotation) variants adjacent, rotation fastest; every size class 0."""

    stride = proposal_stride(cfg)
    bh, bw = cfg.bev.padded_hw(extents)
    hl, wl = bh // stride, bw // stride
    cell = cfg.bev.voxel_size * stride
    gx, gz = np.meshgrid(extents.x_min + (np.arange(wl) + 0.5) * cell,
                         extents.z_min + (np.arange(hl) + 0.5) * cell, indexing="xy")
    n = hl * wl
    out = []
    for l, w, h in cfg.anchors.sizes:
        for rot_idx in range(len(cfg.anchors.rotations)):
            dim_x, dim_z = (l, w) if rot_idx % 2 == 0 else (w, l)
            out.append(np.stack([gx.reshape(-1), np.zeros(n), gz.reshape(-1), np.full(n, dim_x), np.full(n, h),
                                 np.full(n, dim_z), np.full(n, float(rot_idx)), np.zeros(n)], axis=1))
    return np.stack(out, axis=1).reshape(-1, 8).astype(np.float32)


def anchor_valid(occupancy: torch.Tensor, cfg: ModelConfig, extents: AreaExtents) -> torch.Tensor:
    """[B, H, W] occupancy -> [B, Hl*Wl*V]: the footprint holds at least
    ``density_threshold`` occupied cells; the lattice's padded rows never."""

    stride = proposal_stride(cfg)
    acfg = dataclasses.replace(cfg.anchors, stride=cfg.bev.voxel_size * stride)
    counts = anchor_ops.grid_occupancy_counts(occupancy, extents, cfg.bev, acfg)
    nz, nx = anchor_ops.grid_shape(acfg, extents)
    hl = cfg.bev.padded_hw(extents)[0] // stride
    counts = F.pad(counts.reshape(counts.shape[0], nz, nx, -1), (0, 0, 0, 0, 0, hl - nz))
    return (counts >= cfg.anchors.density_threshold).reshape(counts.shape[0], -1)


# ---------------------------------------------------------------- model

class DeepFusionHead(Stage2Head):
    """The stage-2 head fused deep by the mean over the views (the port's
    ``Stage2Head(fusion_type="deep", n_views=3)``), as the equations."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.join = nn.Identity()

    def forward(self, roi_views):
        b, p = roi_views[0].shape[:2]
        views = [v.reshape(b, p, -1).float() for v in roi_views]
        x = sum(views) / len(views)
        for i in range(self.n_fc):
            x = sum(torch.relu(getattr(self, f"fc{i + 1}_v{v}")(x)) for v in range(len(views))) / len(views)
        x = self.join(x)
        flip = self.flip(x) if hasattr(self, "flip") else None
        return self.cls(x), self.box_reg(x), self.orientation(x), flip


def upsample(x: torch.Tensor, factor: int) -> torch.Tensor:
    return F.interpolate(x.permute(0, 3, 1, 2), scale_factor=factor, mode="bilinear",
                         align_corners=False).permute(0, 2, 3, 1)


class Mv3d(nn.Module):
    """MV3D's serving forward, float32; parameter names are the port's."""

    def __init__(self, cfg: ModelConfig, extents: AreaExtents = AreaExtents()):
        super().__init__()
        c = cfg
        self.cfg, self.extents, self.s = cfg, extents, settings(cfg)
        dt = compute_dtype(cfg)
        bb = c.backbone
        packs = 4 if bb.space_to_depth else 1
        self.bev_encoder = VggEncoder(packs * (c.bev.num_channels + 1), bb.channels, bb.blocks, dt, bb.space_to_depth)
        self.fv_encoder = VggEncoder(packs * FV_CHANNELS, bb.channels, bb.blocks, dt, bb.space_to_depth)
        self.img_encoder = VggEncoder(packs * c.image.channels, bb.channels, bb.blocks, dt, bb.space_to_depth)
        mid = bb.channels[-1]
        sp = c.sparse_pool
        self.bev_fusion = SparsePoolFusion(mid, mid, mid, dt, sp.pool_channels, sp.accum_dtype)
        self.img_fusion = SparsePoolFusion(mid, mid, mid, dt, sp.pool_channels, sp.accum_dtype)
        self.rpn_head = ConvRpnHead(mid, c.rpn.fusion_channels, len(c.anchors.rotations) * len(c.anchors.sizes), dt)
        s2 = c.avod.roi_size
        self.stage2_head = DeepFusionHead(
            s2 * s2 * mid, c.avod.fc_layers, c.num_classes, dt, box_dim=STAGE2_BOX_DIMS[c.avod.box_rep],
            flip_head=c.avod.explicit_flip_head, fusion_type="deep", fusion_method="mean", n_views=N_VIEWS)

    def _encode(self, encoder, x, pre_packed=False):
        if encoder.space_to_depth and not pre_packed:
            x = space_to_depth(x)
        return encoder(x.float())[-1]

    def forward(self, inputs: Dict[str, Any], train: bool = False, generator=None, picks=None,
                proposals: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """``picks`` and ``proposals`` replace the RPN's NMS and the boxes
        stage 2 crops at."""

        c, ext = self.cfg, self.extents
        packed = inputs["bev_pre_packed"]
        bev_in = inputs["bev_input"]
        if packed:
            b, h2, w2, _ = bev_in.shape
            bev_in = torch.cat([bev_in.reshape(b, h2, w2, 4, -1),
                                space_to_depth(inputs["bev_intensity"])[..., None]], -1).reshape(b, h2, w2, -1)
        else:
            bev_in = torch.cat([bev_in, inputs["bev_intensity"]], -1)
        bev_mid = self._encode(self.bev_encoder, bev_in, packed)
        fv_mid = self._encode(self.fv_encoder, inputs["fv_input"])
        img_mid = self._encode(self.img_encoder, inputs["image"])
        bev_mid_f = self.bev_fusion(bev_mid, img_mid, inputs["m_bev"])
        img_mid_f = self.img_fusion(img_mid, bev_mid, inputs["m_fv"])

        objectness, offsets = self.rpn_head(upsample(bev_mid_f, self.s.proposal_upsample))
        anchors = inputs["anchors"][..., :6]
        valid = inputs["anchor_valid"]
        proposals_all = encoders.offset_to_anchor(anchors, offsets)
        scores_all = torch.where(valid, torch.softmax(objectness, dim=-1)[..., 1], -torch.inf)
        prop_bev_all = projection.project_to_bev(proposals_all, ext)
        sel = picks if picks is not None else top_k_nms_batch(
            prop_bev_all, scores_all, c.rpn.eval_nms_size, iou_threshold=c.rpn.nms_iou_thresh,
            pre_top_k=c.rpn.pre_nms_top_k)
        own_proposals = torch.gather(proposals_all, 1, sel.indices[..., None].expand(-1, -1, 6))
        proposals = own_proposals if proposals is None else proposals
        proposal_scores = torch.where(sel.valid, torch.gather(scores_all, 1, sel.indices), 0.0)

        stride = c.sparse_pool.fusion_stride
        size = (c.avod.roi_size, c.avod.roi_size)
        bev_scale, img_scale = px_scales(c, ext, proposals.device)

        def crop(feat, boxes_px):
            return crop_and_resize_px_batch(feat, (boxes_px - (stride - 1) / 2) / stride, size)

        views = [crop(bev_mid_f, projection.project_to_bev(proposals, ext) * bev_scale),
                 crop(fv_mid, project_to_front_view(proposals, self.s)),
                 crop(img_mid_f, projection.project_to_image_space(
                     proposals, inputs["p2"], (c.image.height, c.image.width)) * img_scale)]
        cls_logits, box_offsets, orientation, flip_logits = self.stage2_head(views)
        extra = {} if flip_logits is None else {"flip_logits": flip_logits}
        return {
            **extra,
            "scores_all": scores_all,
            "prop_bev_all": prop_bev_all,
            "rpn_picks": sel,
            "own_proposals": own_proposals,
            "objectness": objectness,
            "rpn_offsets": offsets,
            "anchors": inputs["anchors"],
            "anchor_valid": valid,
            "proposals": proposals,
            "proposal_scores": proposal_scores,
            "proposal_valid": sel.valid,
            "cls_logits": cls_logits,
            "box_offsets": box_offsets,
            "orientation": orientation,
        }

