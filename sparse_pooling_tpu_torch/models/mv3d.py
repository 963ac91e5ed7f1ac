"""MV3D as published (Chen et al., "Multi-View 3D Object Detection Network
for Autonomous Driving", CVPR 2017, arXiv:1611.07759), with SHPL fusion
(arXiv:1805.00715) between its BEV and image maps as the reference's MV3D
fork grafts it; serving only (drop-path and the auxiliary losses exist only
in training).

* Three views, each through a VGG encoder at half width without pool4 (the
  configuration's backbone, stride 8), no pyramid decoder: the BEV (height
  slices, density and the intensity channel, joined here), the LiDAR front
  view (``ops.front_view``) and the image.
* SHPL fusion of the BEV and image maps both ways (kernel A twice a pass).
* The proposal head (``ConvRpnHead``) on the fused BEV map upsampled
  bilinearly by ``mv3d.proposal_upsample``: every cell of that lattice
  scores its anchors (``ops.anchors.lattice_anchor_grid``), the empty ones
  masked to -inf before the top-k and the greedy NMS (shapes stay static,
  no host sync).
* Region-based fusion: each proposal's BEV rectangle, front-view rectangle
  (``projection.project_to_front_view``) and image rectangle crop
  ``avod.roi_size`` squares of the fused BEV, the front-view and the fused
  image maps (stride 8, bilinear); ``Stage2Head`` fuses them deep by the
  element-wise mean: f0 = mean of the views' crops, f_l = mean over the
  views v of H_l^v(f_(l-1)).
* Class scores, the 24-d corner regression (``box_8c``) and the flip head,
  decoded as ``models.detector.decode_detections``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sparse_pooling_tpu_torch.configs.config import AreaExtents, ModelConfig
from sparse_pooling_tpu_torch.models.backbone import VggEncoder, space_to_depth
from sparse_pooling_tpu_torch.models.detector import (STAGE2_BOX_DIMS, ConvRpnHead, Family, Stage2Head,
                                                      compute_dtype, decode_detections, detector_outputs,
                                                      px_scales, rpn_proposals, shpl_inputs)
from sparse_pooling_tpu_torch.models.fusion import SparsePoolFusion
from sparse_pooling_tpu_torch.ops import anchors as anchor_ops
from sparse_pooling_tpu_torch.ops import bev_device, projection
from sparse_pooling_tpu_torch.ops.crop_resize import crop_and_resize_px_batch
from sparse_pooling_tpu_torch.ops.front_view import FV_CHANNELS, front_view_batch
from sparse_pooling_tpu_torch.runtime.profiling import span

N_VIEWS = 3  # BEV, front view, image


def proposal_stride(cfg: ModelConfig) -> int:
    """The proposal lattice's stride in BEV cells."""

    return cfg.sparse_pool.fusion_stride // cfg.mv3d.proposal_upsample


def bev_with_intensity(bev_input: torch.Tensor, intensity: torch.Tensor, pre_packed: bool) -> torch.Tensor:
    """The BEV maps [B, H, W, C] and the intensity raster [B, H, W, 1] as
    one [B, H, W, C+1] input; packed ([B, H/2, W/2, 4C]), the packed form
    of that same input (channel = sub*(C+1) + c)."""

    if not pre_packed:
        return torch.cat([bev_input, intensity], dim=-1)
    b, h2, w2, _ = bev_input.shape
    maps = bev_input.reshape(b, h2, w2, 4, -1)
    return torch.cat([maps, space_to_depth(intensity)[..., None]], dim=-1).reshape(b, h2, w2, -1)


def upsample(x: torch.Tensor, factor: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, factor*H, factor*W, C], bilinear (half-pixel
    centres)."""

    y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=factor, mode="bilinear", align_corners=False)
    return y.permute(0, 2, 3, 1)


class Mv3d(nn.Module):
    """MV3D's serving forward, batch-native, NHWC."""

    def __init__(self, cfg: ModelConfig, extents: AreaExtents = AreaExtents()):
        super().__init__()
        c = cfg
        if c.avod.box_rep not in ("box_4c", "box_8c"):
            raise ValueError(f"unknown box_rep '{c.avod.box_rep}'")
        self.cfg, self.extents = cfg, extents
        self.dtype = dt = compute_dtype(cfg)
        bb = c.backbone
        packs = 4 if bb.space_to_depth else 1

        def encoder(channels):
            return VggEncoder(packs * channels, bb.channels, bb.blocks, dt, bb.space_to_depth)

        self.bev_encoder = encoder(c.bev.num_channels + 1)
        self.fv_encoder = encoder(FV_CHANNELS)
        self.img_encoder = encoder(c.image.channels)
        mid = bb.channels[-1]
        sp = c.sparse_pool
        self.bev_fusion = SparsePoolFusion(mid, mid, mid, dt, sp.pool_channels, sp.accum_dtype)
        self.img_fusion = SparsePoolFusion(mid, mid, mid, dt, sp.pool_channels, sp.accum_dtype)
        self.rpn_head = ConvRpnHead(mid, c.rpn.fusion_channels, len(c.anchors.rotations) * len(c.anchors.sizes), dt)
        s2 = c.avod.roi_size
        self.stage2_head = Stage2Head(
            s2 * s2 * mid, c.avod.fc_layers, c.num_classes, dt,
            box_dim=STAGE2_BOX_DIMS[c.avod.box_rep], flip_head=c.avod.explicit_flip_head,
            fusion_type=c.avod.fusion_type, fusion_method=c.avod.fusion_method, n_views=N_VIEWS,
        )
        # constants on the model's device, not built from host lists at every call
        bev_scale, img_scale = px_scales(c, extents, "cpu")
        self.register_buffer("bev_px_scale", bev_scale, persistent=False)
        self.register_buffer("img_px_scale", img_scale, persistent=False)

    def _encode(self, encoder: VggEncoder, x: torch.Tensor, pre_packed: bool = False) -> torch.Tensor:
        """The encoder's last stage (conv4, stride 8)."""

        if encoder.space_to_depth and not pre_packed:
            x = space_to_depth(x)
        return encoder(x.to(self.dtype))[-1]

    def stage2_views(self, bev_map, fv_map, img_map, proposals, p2) -> List[torch.Tensor]:
        """``avod.roi_size`` crops of the three stride-8 maps at each
        proposal's projection into its view: [B, P, S, S, C] each, BEV,
        front view, image; pixel boxes onto the map by cell-centre
        alignment."""

        c = self.cfg
        s = c.sparse_pool.fusion_stride
        size = (c.avod.roi_size, c.avod.roi_size)

        def crop(feat, boxes_px):
            return crop_and_resize_px_batch(feat, (boxes_px - (s - 1) / 2) / s, size)

        prop_bev = projection.project_to_bev(proposals, self.extents)
        prop_fv = projection.project_to_front_view(proposals, c.mv3d)
        prop_img = projection.project_to_image_space(proposals, p2, (c.image.height, c.image.width))
        return [crop(bev_map, prop_bev * self.bev_px_scale), crop(fv_map, prop_fv),
                crop(img_map, prop_img * self.img_px_scale)]

    def forward(self, inputs: Dict[str, Any], train: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """inputs (leading batch dim B): bev_input, bev_pre_packed,
        bev_intensity [B, H+pad, W, 1], fv_input [B, Hfv, Wfv, 3], image,
        m_bev / m_fv DeviceCoo, p2, anchors [B, A, 8] (the proposal lattice)
        and anchor_valid [B, A] (the non-empty ones)."""

        if train:
            raise NotImplementedError("the mv3d family serves; it has no training path")
        c = self.cfg
        ext = self.extents
        with span("detector"):
            with span("detector.encode"):
                bev_in = bev_with_intensity(inputs["bev_input"], inputs["bev_intensity"], inputs["bev_pre_packed"])
                bev_mid = self._encode(self.bev_encoder, bev_in, inputs["bev_pre_packed"])
                fv_mid = self._encode(self.fv_encoder, inputs["fv_input"])
                img_mid = self._encode(self.img_encoder, inputs["image"])
            with span("detector.fusion"):
                bev_mid_f = self.bev_fusion(bev_mid, img_mid, inputs["m_bev"])
                img_mid_f = self.img_fusion(img_mid, bev_mid, inputs["m_fv"])

            rpn = rpn_proposals(inputs, *self.rpn_head(upsample(bev_mid_f, c.mv3d.proposal_upsample)), c, ext)

            with span("detector.stage2"):
                with span("detector.stage2.crops"):
                    views = self.stage2_views(bev_mid_f, fv_mid, img_mid_f, rpn["proposals"], inputs["p2"])
                with span("detector.stage2.head"):
                    head = self.stage2_head(views, float(N_VIEWS))
            return detector_outputs(rpn, head)


def mv3d_check(cfg: ModelConfig) -> None:
    """The mv3d section is there, and its proposal lattice is the fusion
    lattice upsampled by ``mv3d.proposal_upsample`` at ``anchors.stride``."""

    if not hasattr(cfg, "mv3d"):
        raise ValueError("architecture 'mv3d' needs its mv3d section: a Mv3dModelConfig")
    s, up = cfg.sparse_pool.fusion_stride, cfg.mv3d.proposal_upsample
    if up < 1 or s % up or abs(cfg.anchors.stride - cfg.bev.voxel_size * (s // up)) > 1e-6:
        raise ValueError(
            f"mv3d.proposal_upsample={up} must divide the fusion stride {s}, and anchors.stride "
            f"({cfg.anchors.stride}) must be the proposal lattice's spacing"
        )


def mv3d_anchor_grid(cfg: ModelConfig, extents: AreaExtents) -> np.ndarray:
    """The proposal lattice [N, 8] f32 with y = 0, every size a car anchor
    (class 0)."""

    return anchor_ops.lattice_anchor_grid(cfg.anchors, cfg.bev, extents, proposal_stride(cfg),
                                          [0] * len(cfg.anchors.sizes))


def mv3d_frame_inputs(batch, anchors_frame: torch.Tensor, cfg: ModelConfig,
                      extents: AreaExtents) -> Dict[str, torch.Tensor]:
    """The SHPL inputs (``detector.shpl_inputs``); the proposal lattice
    with its empty anchors masked, the front view and the BEV intensity
    raster."""

    shared, occupancy = shpl_inputs(batch, cfg, extents)
    valid = anchor_ops.lattice_anchor_valid(occupancy, extents, cfg.bev, cfg.anchors, proposal_stride(cfg))
    with span("inputs.front_view"):
        return {
            **shared,
            "anchors": anchors_frame,
            "anchor_valid": valid,
            "fv_input": front_view_batch(batch.points, batch.points_mask, batch.ground_plane, cfg.mv3d),
            "bev_intensity": bev_device.bev_intensity_batch(
                batch.points, batch.points_mask, batch.ground_plane, extents, cfg.bev),
        }


FAMILY = Family(Mv3d, mv3d_anchor_grid, mv3d_frame_inputs, decode_detections, mv3d_check,
                frame_inputs_wait_free=True)
