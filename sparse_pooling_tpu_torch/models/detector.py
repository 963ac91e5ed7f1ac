"""The SHPL fusion detector: two VGG-pyramid branches with SHPL fusion both
ways, the crop-based RPN with top-k + greedy NMS, the stage-2 head on exact
7x7 crops, and the decode with per-class BEV NMS.

Port of ``sparse_pooling_tpu.models.detector``, eval and train: training
keeps ``train_nms_size`` proposals, detaches them where
``avod.stop_gradient_proposals``, and drops stage-2 FC activations with
``avod.keep_dropout_prob`` (a mask drawn from the caller's generator, scaled
by 1 / keep, as flax's ``nn.Dropout``). Every tensor
carries a leading batch dim; feature maps are NHWC. Implemented options are
the ones the cars preset runs (quad-filtered or per-position grouped RPN
crops on strided maps; exact stage-2 crops; early fusion; box_4c; the flip
head or the angle vector); the others raise
``NotImplementedError`` and are queued in ROADMAP.md.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import torch
from torch import nn

from sparse_pooling_tpu_torch.configs.config import AreaExtents, ModelConfig
from sparse_pooling_tpu_torch.models.backbone import VggPyramidExtractor
from sparse_pooling_tpu_torch.models.fusion import SparsePoolFusion
from sparse_pooling_tpu_torch.models.layers import Conv, Dense, avg_pool
from sparse_pooling_tpu_torch.ops import anchors as anchor_ops
from sparse_pooling_tpu_torch.ops import encoders, projection
from sparse_pooling_tpu_torch.ops.crop_resize import (
    crop_and_resize_group_einsum_px,
    crop_and_resize_px_batch,
)
from sparse_pooling_tpu_torch.ops.nms import nms_batch, top_k_nms_batch


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.backbone.compute_dtype == "bfloat16" else torch.float32


class RpnHead(nn.Module):
    """ROI-fused proposal head: 2 FCs in the compute dtype, f32 outputs."""

    def __init__(self, in_features: int, fusion_channels: int, dtype):
        super().__init__()
        self.dtype = dtype
        self.fc1 = Dense(in_features, fusion_channels, dtype=dtype)
        self.fc2 = Dense(fusion_channels, fusion_channels, dtype=dtype)
        self.objectness = Dense(fusion_channels, 2)
        self.offsets = Dense(fusion_channels, 6)

    def forward(self, rois: torch.Tensor):
        """[B, A, S, S, C] fused ROI features -> objectness [B, A, 2],
        offsets [B, A, 6]; flattened in (S, S, C) order."""

        b, a = rois.shape[:2]
        x = rois.reshape(b, a, -1)
        x = torch.relu(self.fc2(torch.relu(self.fc1(x))))
        return self.objectness(x), self.offsets(x)


class Stage2Head(nn.Module):
    """AVOD second-stage head, early fusion: mean of the view features, one
    FC stack, then cls / box / orientation (/ flip) in f32."""

    def __init__(self, in_features: int, fc_layers: Sequence[int], num_classes: int, dtype,
                 box_dim: int = 10, flip_head: bool = False):
        super().__init__()
        widths = [in_features, *fc_layers]
        for i in range(len(fc_layers)):
            self.add_module(f"fc{i + 1}", Dense(widths[i], widths[i + 1], dtype=dtype))
        self.n_fc = len(fc_layers)
        self.cls = Dense(widths[-1], num_classes + 1)
        self.box_reg = Dense(widths[-1], box_dim)
        self.orientation = Dense(widths[-1], 2)
        if flip_head:
            self.flip = Dense(widths[-1], 2)

    def forward(self, roi_views, denom, keep_prob: float = 1.0, generator=None):
        """roi_views: per-view [B, P, S, S, C]; denom [B, 1, 1] kept-branch
        count; ``keep_prob`` < 1 applies dropout after each FC."""

        b, p = roi_views[0].shape[:2]
        views = [v.reshape(b, p, -1) for v in roi_views]
        x = views[0] if len(views) == 1 else sum(views) / denom
        for i in range(self.n_fc):
            x = torch.relu(getattr(self, f"fc{i + 1}")(x))
            if keep_prob < 1.0:
                keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
                x = torch.where(keep, x / keep_prob, 0.0)
        flip = self.flip(x) if hasattr(self, "flip") else None
        return self.cls(x), self.box_reg(x), self.orientation(x), flip


class SparsePoolingDetector(nn.Module):
    """Batch-native two-branch fusion detector."""

    def __init__(self, cfg: ModelConfig, extents: AreaExtents = AreaExtents()):
        super().__init__()
        c = cfg
        if c.rpn.dense_grid:
            raise NotImplementedError("rpn.dense_grid is not ported yet")
        if c.rpn.bev_roi_stride < 2 or c.rpn.img_roi_stride < 2:
            raise NotImplementedError("exact (stride-1) RPN crops are not ported yet")
        if c.avod.bev_roi_stride > 1 or c.avod.img_roi_stride > 1:
            raise NotImplementedError("strided stage-2 crops are not ported yet")
        if c.avod.fusion_type != "early" or c.avod.fusion_method != "mean":
            raise NotImplementedError("only early mean fusion is ported")
        if c.avod.box_rep != "box_4c":
            raise NotImplementedError(f"box_rep {c.avod.box_rep!r} is not ported yet")
        self.cfg, self.extents = cfg, extents
        dt = compute_dtype(cfg)
        bb = c.backbone
        self.bev_extractor = VggPyramidExtractor(
            c.bev.num_channels, bb.channels, bb.blocks, bb.out_channels, dt,
            decode_stride=bb.decode_stride, space_to_depth=bb.space_to_depth,
        )
        self.img_extractor = VggPyramidExtractor(
            c.image.channels, bb.channels, bb.blocks, bb.out_channels, dt,
            decode_stride=bb.decode_stride, space_to_depth=bb.space_to_depth,
        )
        mid = bb.channels[-1]
        sp = c.sparse_pool
        self.bev_fusion = SparsePoolFusion(mid, mid, mid, dt, sp.pool_channels, sp.accum_dtype)
        if sp.bev_to_img:
            self.img_fusion = SparsePoolFusion(mid, mid, mid, dt, sp.pool_channels, sp.accum_dtype)
        roi_c = bb.out_channels
        if c.rpn.roi_channels and bb.out_channels > c.rpn.roi_channels:
            roi_c = c.rpn.roi_channels  # 1x1 projection of the pooled maps before the crop
            self.bev_roi_proj = Conv(bb.out_channels, roi_c, 1, dt)
            self.img_roi_proj = Conv(bb.out_channels, roi_c, 1, dt)
        s = c.rpn.proposal_roi_size
        self.rpn_head = RpnHead(s * s * roi_c, c.rpn.fusion_channels, dt)
        s2 = c.avod.roi_size
        self.stage2_head = Stage2Head(
            s2 * s2 * bb.out_channels, c.avod.fc_layers, c.num_classes, dt,
            box_dim=10, flip_head=c.avod.explicit_flip_head,
        )

    def _rpn_rois(self, feat, boxes_px_full, stride, proj, n_var, quad):
        """avg-pool to the ROI stride -> optional 1x1 projection -> grouped
        window crop (kernel C on the card)."""

        c = self.cfg
        ds = c.backbone.decode_stride
        s = c.rpn.proposal_roi_size
        k = stride // ds
        src = avg_pool(feat, k) if k > 1 else feat
        if proj is not None:
            src = proj(src)
        boxes_pooled = (boxes_px_full - (stride - 1) / 2) / stride
        b, a = boxes_pooled.shape[:2]
        patch = c.rpn.roi_patch
        if quad > 1:
            spacing = c.anchors.stride / (c.bev.voxel_size * stride)
            patch += int(math.ceil((quad - 1) * spacing))
        rois = crop_and_resize_group_einsum_px(
            src.contiguous(), boxes_pooled.reshape(b, a // n_var, n_var, 4).contiguous(),
            (s, s), patch=patch,
        )
        return rois.reshape(b, a, s, s, rois.shape[-1])

    def forward(self, inputs: Dict[str, Any], train: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """inputs (leading batch dim B): bev_input, bev_pre_packed, image
        [B, Hi, Wi, 3] f32, m_bev / m_fv DeviceCoo, p2 [B, 3, 4], anchors
        [B, A, 8], anchor_valid [B, A], path_keep [B, 2]. ``train`` selects
        the training proposals and dropout (masks from ``generator``)."""

        c = self.cfg
        ext = self.extents
        img_hw = (c.image.height, c.image.width)
        bev_keep = inputs["path_keep"][:, 0]
        img_keep = inputs["path_keep"][:, 1]

        # backbones + SHPL fusion
        bev_mid, bev_skips = self.bev_extractor.encode(
            inputs["bev_input"], pre_packed=inputs["bev_pre_packed"]
        )
        img_mid, img_skips = self.img_extractor.encode(inputs["image"])
        kb = bev_keep[:, None, None, None].to(bev_mid.dtype)
        ki = img_keep[:, None, None, None].to(img_mid.dtype)
        bev_mid_k = bev_mid * kb
        img_mid_k = img_mid * ki
        bev_mid_f = self.bev_fusion(bev_mid_k, img_mid_k, inputs["m_bev"])
        if c.sparse_pool.bev_to_img:
            img_mid_f = self.img_fusion(img_mid_k, bev_mid_k, inputs["m_fv"])
        else:
            img_mid_f = img_mid_k
        bev_feat = self.bev_extractor.decode(bev_mid_f, bev_skips) * kb
        img_feat = self.img_extractor.decode(img_mid_f, img_skips) * ki

        # RPN
        anchors = inputs["anchors"][..., :6]
        anchor_valid = inputs["anchor_valid"]
        bev_boxes = projection.project_to_bev(anchors, ext)
        img_boxes = projection.project_to_image_space(anchors, inputs["p2"], img_hw)
        grid_h, grid_w = c.bev.grid_hw(ext)
        dev = anchors.device
        bev_px_scale = torch.tensor(
            [grid_h - 1.0, grid_w - 1.0, grid_h - 1.0, grid_w - 1.0], device=dev
        )
        img_px_scale = torch.tensor(
            [img_hw[0] - 1.0, img_hw[1] - 1.0, img_hw[0] - 1.0, img_hw[1] - 1.0], device=dev
        )
        ds = c.backbone.decode_stride
        quad = (
            c.rpn.roi_quad
            if anchor_ops.quad_supported(c.anchors, c.bev, ext, c.anchors.max_anchors, c.rpn.roi_quad)
            else 1
        )
        n_var = len(c.anchors.sizes) * len(c.anchors.rotations) * quad * quad
        bev_rois = self._rpn_rois(
            bev_feat, bev_boxes * bev_px_scale, c.rpn.bev_roi_stride,
            getattr(self, "bev_roi_proj", None), n_var, quad,
        )
        img_rois = self._rpn_rois(
            img_feat, img_boxes * img_px_scale, c.rpn.img_roi_stride,
            getattr(self, "img_roi_proj", None), n_var, quad,
        )
        denom = torch.clamp_min(bev_keep + img_keep, 1.0)[:, None, None, None, None]
        rois = (bev_rois + img_rois.to(bev_rois.dtype)) / denom.to(bev_rois.dtype)

        objectness, offsets = self.rpn_head(rois)
        proposals_all = encoders.offset_to_anchor(anchors, offsets)
        scores_all = torch.softmax(objectness, dim=-1)[..., 1]
        scores_all = torch.where(anchor_valid, scores_all, -torch.inf)
        prop_bev_all = projection.project_to_bev(proposals_all, ext)
        # the selection passes no gradient: NMS runs on detached copies
        sel = top_k_nms_batch(
            prop_bev_all.detach(), scores_all.detach(),
            c.rpn.train_nms_size if train else c.rpn.eval_nms_size,
            iou_threshold=c.rpn.nms_iou_thresh, pre_top_k=c.rpn.pre_nms_top_k,
        )
        proposals = torch.gather(proposals_all, 1, sel.indices[..., None].expand(-1, -1, 6))
        proposal_scores = torch.where(sel.valid, torch.gather(scores_all, 1, sel.indices), 0.0)
        if c.avod.stop_gradient_proposals:
            proposals = proposals.detach()

        # stage 2: exact crops on the decode-stride maps
        prop_bev = projection.project_to_bev(proposals, ext)
        prop_img = projection.project_to_image_space(proposals, inputs["p2"], img_hw)
        s2 = c.avod.roi_size

        def to_feat(px):
            return (px - (ds - 1) / 2) / ds

        bev_rois2 = crop_and_resize_px_batch(bev_feat, to_feat(prop_bev * bev_px_scale), (s2, s2))
        img_rois2 = crop_and_resize_px_batch(img_feat, to_feat(prop_img * img_px_scale), (s2, s2))
        cls_logits, box_offsets, orientation, flip_logits = self.stage2_head(
            [bev_rois2.to(torch.float32), img_rois2.to(torch.float32)], denom[..., 0, 0],
            keep_prob=c.avod.keep_dropout_prob if train else 1.0, generator=generator,
        )
        extra = {} if flip_logits is None else {"flip_logits": flip_logits}
        return {
            **extra,
            "objectness": objectness,
            "rpn_offsets": offsets,
            "anchors": inputs["anchors"],
            "anchor_valid": anchor_valid,
            "proposals": proposals,
            "proposal_scores": proposal_scores,
            "proposal_valid": sel.valid,
            "cls_logits": cls_logits,
            "box_offsets": box_offsets,
            "orientation": orientation,
        }


def decode_detections(
    outputs: Dict[str, torch.Tensor],
    ground_plane: torch.Tensor,  # [B, 4]
    cfg: ModelConfig,
    extents: AreaExtents = AreaExtents(),
) -> Dict[str, torch.Tensor]:
    """Stage-2 decode + per-class BEV NMS -> boxes_3d [B, C, K, 7], scores
    [B, C, K], valid [B, C, K]."""

    if cfg.avod.box_rep != "box_4c":
        raise NotImplementedError(f"box_rep {cfg.avod.box_rep!r} is not ported yet")
    proposals = outputs["proposals"]
    plane = ground_plane[:, None, :]
    prop_box3d = encoders.anchor_to_box_3d(proposals)
    prop_4c = encoders.box_3d_to_box_4c(prop_box3d, plane)
    final_4c = encoders.offsets_to_box_4c(prop_4c, outputs["box_offsets"])
    boxes_3d = encoders.box_4c_to_box_3d(final_4c, plane)

    ry = boxes_3d[..., 6]
    if "flip_logits" in outputs:
        ry = encoders.apply_heading_flip(ry, torch.argmax(outputs["flip_logits"], dim=-1))
    else:
        theta = encoders.vector_to_angle(outputs["orientation"])
        delta = torch.remainder(ry - theta + math.pi, 2 * math.pi) - math.pi
        ry = torch.where(torch.abs(delta) > math.pi / 2, ry - torch.sign(delta) * math.pi, ry)
    boxes_3d = torch.cat([boxes_3d[..., :6], ry[..., None]], dim=-1)

    probs = torch.softmax(outputs["cls_logits"], dim=-1)
    bev_boxes = projection.project_to_bev(encoders.box_3d_to_anchor(boxes_3d), extents)
    k = cfg.avod.nms_size
    all_boxes, all_scores, all_valid = [], [], []
    for ci in range(cfg.num_classes):
        scores = torch.where(outputs["proposal_valid"], probs[..., ci + 1], -torch.inf)
        res = nms_batch(bev_boxes, scores, k, iou_threshold=cfg.avod.nms_iou_thresh)
        cls_scores = torch.where(res.valid, torch.gather(scores, 1, res.indices), 0.0)
        all_boxes.append(torch.gather(boxes_3d, 1, res.indices[..., None].expand(-1, -1, 7)))
        all_scores.append(cls_scores)
        all_valid.append(res.valid & (cls_scores > 0))
    return {
        "boxes_3d": torch.stack(all_boxes, dim=1),
        "scores": torch.stack(all_scores, dim=1),
        "valid": torch.stack(all_valid, dim=1),
    }
