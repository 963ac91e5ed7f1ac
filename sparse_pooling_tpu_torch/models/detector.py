"""The SHPL fusion detector: two VGG-pyramid branches with SHPL fusion both
ways, the crop-based RPN with top-k + greedy NMS, the stage-2 head, and the
decode with per-class BEV NMS; and what every family shares: ``Family``,
both RPN heads, the proposal step (``rpn_proposals``), ``detector_outputs``,
the stage-2 crops and the final NMS. ``top_k_nms_batch`` and ``nms_batch``
are looked up here at each call, so wrapping them reaches every family.

Port of ``sparse_pooling_tpu.models.detector``, eval and train: training
keeps ``train_nms_size`` proposals, detaches them where
``avod.stop_gradient_proposals``, and drops stage-2 FC activations with
``avod.keep_dropout_prob`` (a mask drawn from the caller's generator, scaled
by 1 / keep, as flax's ``nn.Dropout``). Every tensor carries a leading batch
dim; feature maps are NHWC. Every option of the reference's detector:

* RPN crops: strided (avg-pool to ``rpn.*_roi_stride``, an optional 1x1
  projection, then kernel C's grouped window crop, one window per filter
  unit: a position, a QxQ block with ``rpn.roi_quad``, or on the dense grid
  a GxG block of neighbour positions, ``rpn.bev_roi_group``), or exact at
  stride 1 (``crop_and_resize_px_batch`` / ``crop_and_resize_batch``);
* stage-2 crops: exact at stride 1, else one patch window per proposal from
  the map avg-pooled to ``avod.*_roi_stride``;
* the stage-2 head's fusion: ``early``, ``late`` or ``deep``, combined by
  ``mean`` or ``concat``;
* box_4c or box_8c; the flip head or the angle vector.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from sparse_pooling_tpu_torch.configs.config import AreaExtents, ModelConfig
from sparse_pooling_tpu_torch.models.backbone import VggPyramidExtractor
from sparse_pooling_tpu_torch.models import draws
from sparse_pooling_tpu_torch.models.fusion import SparsePoolFusion
from sparse_pooling_tpu_torch.models.layers import Conv, Dense, avg_pool
from sparse_pooling_tpu_torch.ops import anchors as anchor_ops
from sparse_pooling_tpu_torch.ops import bev_device, encoders, projection, sparse_build
from sparse_pooling_tpu_torch.ops.crop_resize import (
    crop_and_resize_batch,
    crop_and_resize_group_einsum_px,
    crop_and_resize_patch_einsum_px,
    crop_and_resize_px_batch,
)
from sparse_pooling_tpu_torch.ops.nms import nms_batch, top_k_nms_batch
from sparse_pooling_tpu_torch.parallel.tensor_parallel import copy_to_model, gather_from_model
from sparse_pooling_tpu_torch.runtime.profiling import span


# stage-2 regression width per ``avod.box_rep``; "offsets" is the rcnn
# family's (models/fusion_rcnn.py)
STAGE2_BOX_DIMS = {"offsets": 6, "box_4c": 10, "box_8c": 24}


class Family(NamedTuple):
    """One detector family: what ``models.pipeline`` needs of it."""

    model: type  # the nn.Module, built as model(cfg, extents)
    anchor_grid: Callable  # (cfg, extents) -> the static grid, numpy [N, 8] f32 with y = 0
    # (batch, anchors_frame, cfg, extents) -> {"anchors": [B, A, 8], "anchor_valid": [B, A], the
    # inputs the family reads beyond the image (a family that fuses by SHPL: shpl_inputs)}
    frame_inputs: Callable
    decode: Callable  # (outputs, ground_plane, cfg, extents) -> the final detections
    check: Callable = lambda cfg: None  # (cfg): raises ValueError beyond make_model's shared checks
    # frame_inputs waits on nothing on the host (no value read back, no size from the data), so
    # the input build may replay as CUDA graphs (models.pipeline.build_model_inputs_batch)
    frame_inputs_wait_free: bool = False


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.backbone.compute_dtype == "bfloat16" else torch.float32


def largest_group_divisor(nz: int, nx: int, group: int) -> int:
    """Largest g <= group dividing both dense-grid dims (any divisor: a
    configured group 4 on a 6x6 grid runs at 3)."""

    return max(d for d in range(1, group + 1) if nz % d == 0 and nx % d == 0)


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


class ConvRpnHead(nn.Module):
    """Dense RPN: 3x3 conv and ReLU in the compute dtype, then 1x1
    objectness (2R) and offsets (6R) in f32."""

    def __init__(self, in_channels: int, channels: int, anchors_per_cell: int, dtype):
        super().__init__()
        self.r = anchors_per_cell
        self.rpn_conv = Conv(in_channels, channels, 3, dtype)
        self.objectness = Conv(channels, 2 * anchors_per_cell, 1)
        self.offsets = Conv(channels, 6 * anchors_per_cell, 1)

    def forward(self, feat: torch.Tensor):
        """[B, Hf, Wf, C] -> objectness [B, Hf*Wf*R, 2], offsets [B, Hf*Wf*R, 6]:
        the layers return NHWC, so a cell's R anchors are adjacent, as the
        anchor grid lays them out."""

        x = torch.relu(self.rpn_conv(feat))
        obj, off = self.objectness(x), self.offsets(x)
        b, hf, wf = obj.shape[:3]
        n = hf * wf * self.r
        return obj.reshape(b, n, 2).float(), off.reshape(b, n, 6).float()


class Stage2Head(nn.Module):
    """AVOD second-stage head: FC stack(s), then cls / box / orientation (/
    flip) in f32. ``fusion_type`` says where two views fuse: ``early`` (one
    combine, one FC stack ``fc{i}``), ``late`` (an FC stack per view,
    ``fc{i}_v{vi}``, combined at the end) or ``deep`` (per-view FCs at every
    layer, re-combined after each); ``fusion_method`` how: ``mean`` (before
    the FCs over the kept-branch count, after an FC over the branch count:
    an FC of a zeroed input is not zero) or ``concat``. One view takes the
    early stack. ``join`` (no parameters) passes the fused features that the
    output heads read, so that a hook on it reads them.

    With a ``model_group`` (``parallel.mesh.shard_module`` sets it and cuts
    each FC to its column shard) every FC runs tensor-parallel: the full
    input in, this rank's output features, the full width gathered after it
    (``parallel.tensor_parallel``); dropout then masks the gathered width,
    so every model rank draws the same mask."""

    def __init__(self, in_features: int, fc_layers: Sequence[int], num_classes: int, dtype,
                 box_dim: int = 10, flip_head: bool = False, fusion_type: str = "early",
                 fusion_method: str = "mean", n_views: int = 1):
        super().__init__()
        self.dtype, self.n_fc, self.fusion_method = dtype, len(fc_layers), fusion_method
        self.model_group = None
        self.fusion_type = fusion_type if n_views > 1 and fusion_type in ("late", "deep") else "early"
        mult = 2 if n_views > 1 and fusion_method == "concat" else 1
        widths = [in_features, *fc_layers]
        if self.fusion_type == "early":
            widths[0] *= mult
            for i in range(self.n_fc):
                self.add_module(f"fc{i + 1}", Dense(widths[i], widths[i + 1], dtype=dtype))
            out = widths[-1]
        else:
            for i in range(self.n_fc):
                cin = widths[i] * (mult if self.fusion_type == "deep" else 1)
                for vi in range(n_views):
                    self.add_module(f"fc{i + 1}_v{vi}", Dense(cin, widths[i + 1], dtype=dtype))
            out = widths[-1] * mult
        self.join = nn.Identity()
        self.cls = Dense(out, num_classes + 1)
        self.box_reg = Dense(out, box_dim)
        self.orientation = Dense(out, 2)
        if flip_head:
            self.flip = Dense(out, 2)

    def _combine(self, views, denom):
        if len(views) == 1:
            return views[0]
        if self.fusion_method == "concat":
            return torch.cat(views, dim=-1)
        return sum(views) / denom

    def forward(self, roi_views, denom, keep_prob: float = 1.0, generator=None):
        """roi_views: per-view [B, P, S, S, C]; denom [B, 1, 1] kept-branch
        count; ``keep_prob`` < 1 applies dropout after each FC."""

        b, p = roi_views[0].shape[:2]
        views = [v.reshape(b, p, -1).to(self.dtype) for v in roi_views]

        def fc(name, x):
            if self.model_group is None:
                x = torch.relu(getattr(self, name)(x))
            else:
                x = copy_to_model(x, self.model_group)
                x = torch.relu(gather_from_model(getattr(self, name)(x), self.model_group))
            if keep_prob < 1.0:
                keep = draws.rand(x.shape, generator, x.device) < keep_prob
                x = torch.where(keep, x / keep_prob, 0.0)
            return x

        n = float(len(views))
        if self.fusion_type == "late":
            outs = []
            for vi, x in enumerate(views):
                for i in range(self.n_fc):
                    x = fc(f"fc{i + 1}_v{vi}", x)
                outs.append(x)
            x = self._combine(outs, n)
        elif self.fusion_type == "deep":
            x = self._combine(views, denom)
            for i in range(self.n_fc):
                x = self._combine([fc(f"fc{i + 1}_v{vi}", x) for vi in range(len(views))], n)
        else:
            x = self._combine(views, denom)
            for i in range(self.n_fc):
                x = fc(f"fc{i + 1}", x)
        x = self.join(x)
        flip = self.flip(x) if hasattr(self, "flip") else None
        return self.cls(x), self.box_reg(x), self.orientation(x), flip


def px_scales(cfg: ModelConfig, extents: AreaExtents, device):
    """Scales from normalised boxes to pixels: BEV boxes over the content
    grid (not the padded map), image boxes over the canvas; [4] each."""

    grid_h, grid_w = cfg.bev.grid_hw(extents)
    img_h, img_w = cfg.image.height, cfg.image.width
    return (torch.tensor([grid_h - 1.0, grid_w - 1.0] * 2, device=device),
            torch.tensor([img_h - 1.0, img_w - 1.0] * 2, device=device))


def rpn_quad(cfg: ModelConfig, extents: AreaExtents) -> int:
    """The side Q of the AVOD RPN's filter unit: ``rpn.roi_quad`` where the
    QxQ-block anchor filter applies (not on the dense grid), else 1. The
    anchor filter and the RPN crop both read it: the crop's window grows by
    the spread of a unit's positions."""

    if cfg.rpn.dense_grid or not anchor_ops.quad_supported(
            cfg.anchors, cfg.bev, extents, cfg.anchors.max_anchors, cfg.rpn.roi_quad):
        return 1
    return cfg.rpn.roi_quad


def rpn_proposals(inputs: Dict[str, Any], objectness: torch.Tensor, offsets: torch.Tensor, cfg: ModelConfig,
                  extents: AreaExtents, train: bool = False, mask: bool = True) -> Dict[str, torch.Tensor]:
    """The proposal step of every family: the RPN's ``offsets`` [B, A, 6] on
    ``inputs["anchors"]``, the softmax of ``objectness`` [B, A, 2] as the
    score (-inf at an invalid anchor with ``mask``), then the top-k and the
    greedy BEV NMS to ``rpn.train_nms_size`` (``train``) or
    ``rpn.eval_nms_size`` proposals. The selection passes no gradient: NMS
    runs on detached copies; the gathered proposals keep theirs. -> the
    RPN's outputs, in ``detector_outputs``' order."""

    proposals_all = encoders.offset_to_anchor(inputs["anchors"][..., :6], offsets)
    scores_all = torch.softmax(objectness, dim=-1)[..., 1]
    if mask:
        scores_all = torch.where(inputs["anchor_valid"], scores_all, -torch.inf)
    with span("detector.rpn_nms"):
        sel = top_k_nms_batch(
            projection.project_to_bev(proposals_all, extents).detach(), scores_all.detach(),
            cfg.rpn.train_nms_size if train else cfg.rpn.eval_nms_size,
            iou_threshold=cfg.rpn.nms_iou_thresh, pre_top_k=cfg.rpn.pre_nms_top_k,
        )
    return {
        "objectness": objectness,
        "rpn_offsets": offsets,
        "anchors": inputs["anchors"],
        "anchor_valid": inputs["anchor_valid"],
        "proposals": torch.gather(proposals_all, 1, sel.indices[..., None].expand(-1, -1, 6)),
        "proposal_scores": torch.where(sel.valid, torch.gather(scores_all, 1, sel.indices), 0.0),
        "proposal_valid": sel.valid,
    }


def detector_outputs(rpn: Dict[str, torch.Tensor], head) -> Dict[str, torch.Tensor]:
    """A forward's outputs: ``flip_logits`` first where the stage-2 head has
    one, the RPN's (``rpn_proposals``), then ``cls_logits``, ``box_offsets``
    and ``orientation``. ``head`` is ``Stage2Head``'s return."""

    cls_logits, box_offsets, orientation, flip_logits = head
    extra = {} if flip_logits is None else {"flip_logits": flip_logits}
    return {**extra, **rpn, "cls_logits": cls_logits, "box_offsets": box_offsets, "orientation": orientation}


def stage2_rois(bev_feat, img_feat, proposals, p2, cfg: ModelConfig, extents: AreaExtents,
                strides=(1, 1)):
    """``avod.roi_size`` crops of both decode-stride maps at the proposals
    [B, P, 6]: (BEV, image) ROIs [B, P, S, S, C]. At a stride of 1 the exact
    crop, pixel boxes mapped onto the ``decode_stride`` lattice by cell-centre
    alignment; above, one ``avod.roi_patch`` window per proposal from the map
    avg-pooled to that stride (``crop_and_resize_patch_einsum_px``)."""

    bev_px_scale, img_px_scale = px_scales(cfg, extents, proposals.device)
    ds = cfg.backbone.decode_stride
    s2 = (cfg.avod.roi_size, cfg.avod.roi_size)

    def crop(feat, boxes_px, stride):
        if stride <= 1:
            return crop_and_resize_px_batch(feat, (boxes_px - (ds - 1) / 2) / ds, s2)
        k = stride // ds
        src = avg_pool(feat, k) if k > 1 else feat
        return crop_and_resize_patch_einsum_px(src, (boxes_px - (stride - 1) / 2) / stride, s2,
                                               patch=cfg.avod.roi_patch)

    prop_bev = projection.project_to_bev(proposals, extents)
    prop_img = projection.project_to_image_space(proposals, p2, (cfg.image.height, cfg.image.width))
    return (crop(bev_feat, prop_bev * bev_px_scale, strides[0]),
            crop(img_feat, prop_img * img_px_scale, strides[1]))


class SparsePoolingDetector(nn.Module):
    """Batch-native two-branch fusion detector."""

    def __init__(self, cfg: ModelConfig, extents: AreaExtents = AreaExtents()):
        super().__init__()
        c = cfg
        if c.avod.box_rep not in ("box_4c", "box_8c"):
            raise ValueError(f"unknown box_rep '{c.avod.box_rep}'")
        self.cfg, self.extents = cfg, extents
        dt = compute_dtype(cfg)
        bb = c.backbone
        self.bev_extractor = VggPyramidExtractor(
            c.bev.num_channels, bb.channels, bb.blocks, bb.out_channels, dt,
            decode_stride=bb.decode_stride, space_to_depth=bb.space_to_depth, remat=bb.remat,
        )
        self.img_extractor = VggPyramidExtractor(
            c.image.channels, bb.channels, bb.blocks, bb.out_channels, dt,
            decode_stride=bb.decode_stride, space_to_depth=bb.space_to_depth, remat=bb.remat,
        )
        mid = bb.channels[-1]
        sp = c.sparse_pool
        self.bev_fusion = SparsePoolFusion(mid, mid, mid, dt, sp.pool_channels, sp.accum_dtype)
        if sp.bev_to_img:
            self.img_fusion = SparsePoolFusion(mid, mid, mid, dt, sp.pool_channels, sp.accum_dtype)
        # 1x1 projections of the pooled maps before a strided crop (the
        # make_model check keeps both views at one width)
        roi_c = bb.out_channels
        if c.rpn.roi_channels and bb.out_channels > c.rpn.roi_channels:
            for name, stride in (("bev_roi_proj", c.rpn.bev_roi_stride), ("img_roi_proj", c.rpn.img_roi_stride)):
                if stride > 1:
                    roi_c = c.rpn.roi_channels
                    self.add_module(name, Conv(bb.out_channels, roi_c, 1, dt))
        self.bev_group = 1
        if c.rpn.dense_grid and c.rpn.bev_roi_stride > 1:
            nz, nx = anchor_ops.grid_shape(c.anchors, extents)
            self.bev_group = largest_group_divisor(nz, nx, c.rpn.bev_roi_group)
            if self.bev_group != c.rpn.bev_roi_group:
                print(f"[detector] bev_roi_group={c.rpn.bev_roi_group} does not divide the "
                      f"{nz}x{nx} anchor grid; using largest divisor {self.bev_group}")
        s = c.rpn.proposal_roi_size
        self.rpn_head = RpnHead(s * s * roi_c, c.rpn.fusion_channels, dt)
        s2 = c.avod.roi_size
        self.stage2_head = Stage2Head(
            s2 * s2 * bb.out_channels, c.avod.fc_layers, c.num_classes, dt,
            box_dim=STAGE2_BOX_DIMS[c.avod.box_rep], flip_head=c.avod.explicit_flip_head,
            fusion_type=c.avod.fusion_type, fusion_method=c.avod.fusion_method, n_views=2,
        )

    def _rpn_rois(self, feat, boxes_px_full, stride, proj, n_var, quad, group=1):
        """avg-pool to the ROI stride -> optional 1x1 projection -> grouped
        window crop (kernel C on the card), one window per filter unit; with
        ``group`` > 1 (the dense grid's BEV view) a GxG block of neighbour
        positions shares one window, the boxes permuted block-major for the
        crop and back. Each window grows by the spread of its unit's
        positions."""

        c = self.cfg
        ds = c.backbone.decode_stride
        s = c.rpn.proposal_roi_size
        k = stride // ds
        src = avg_pool(feat, k) if k > 1 else feat
        if proj is not None:
            src = proj(src)
        boxes_pooled = (boxes_px_full - (stride - 1) / 2) / stride
        b, a = boxes_pooled.shape[:2]
        spread = max(quad, group) - 1
        spacing = c.anchors.stride / (c.bev.voxel_size * stride)
        patch = c.rpn.roi_patch + (int(math.ceil(spread * spacing)) if spread else 0)
        if group > 1:
            nz, nx = anchor_ops.grid_shape(c.anchors, self.extents)
            units = anchor_ops.quad_major(boxes_pooled.reshape(b, nz * nx, n_var, 4), nz, nx, group)
            rois = crop_and_resize_group_einsum_px(
                src.contiguous(), units.reshape(b, -1, group * group * n_var, 4).contiguous(),
                (s, s), patch=patch,
            )
            rois = rois.reshape(b, nz // group, nx // group, group, group, n_var, s, s, -1)
            return rois.permute(0, 1, 3, 2, 4, 5, 6, 7, 8).reshape(b, a, s, s, rois.shape[-1])
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
        with span("detector"):
            img_hw = (c.image.height, c.image.width)
            bev_keep = inputs["path_keep"][:, 0]
            img_keep = inputs["path_keep"][:, 1]

            # backbones + SHPL fusion
            with span("detector.encode"):
                bev_mid, bev_skips = self.bev_extractor.encode(
                    inputs["bev_input"], pre_packed=inputs["bev_pre_packed"]
                )
                img_mid, img_skips = self.img_extractor.encode(inputs["image"])
            kb = bev_keep[:, None, None, None].to(bev_mid.dtype)
            ki = img_keep[:, None, None, None].to(img_mid.dtype)
            bev_mid_k = bev_mid * kb
            img_mid_k = img_mid * ki
            with span("detector.fusion"):
                bev_mid_f = self.bev_fusion(bev_mid_k, img_mid_k, inputs["m_bev"])
                if c.sparse_pool.bev_to_img:
                    img_mid_f = self.img_fusion(img_mid_k, bev_mid_k, inputs["m_fv"])
                else:
                    img_mid_f = img_mid_k
            with span("detector.decode_maps"):
                bev_feat = self.bev_extractor.decode(bev_mid_f, bev_skips) * kb
                img_feat = self.img_extractor.decode(img_mid_f, img_skips) * ki

            # RPN
            anchors = inputs["anchors"][..., :6]
            bev_boxes = projection.project_to_bev(anchors, ext)
            img_boxes = projection.project_to_image_space(anchors, inputs["p2"], img_hw)
            bev_px_scale, img_px_scale = px_scales(c, ext, anchors.device)
            quad = rpn_quad(c, ext)
            n_var = len(c.anchors.sizes) * len(c.anchors.rotations) * quad * quad
            s = c.rpn.proposal_roi_size
            # strided: the grouped window crop; stride 1: exact crops, the BEV
            # view in content pixels, the image view normalised over its map
            if c.rpn.bev_roi_stride > 1:
                bev_rois = self._rpn_rois(bev_feat, bev_boxes * bev_px_scale, c.rpn.bev_roi_stride,
                                          getattr(self, "bev_roi_proj", None), n_var, quad, self.bev_group)
            else:
                bev_rois = crop_and_resize_px_batch(bev_feat, bev_boxes * bev_px_scale, (s, s))
            if c.rpn.img_roi_stride > 1:
                img_rois = self._rpn_rois(img_feat, img_boxes * img_px_scale, c.rpn.img_roi_stride,
                                          getattr(self, "img_roi_proj", None), n_var, quad)
            else:
                img_rois = crop_and_resize_batch(img_feat, img_boxes, (s, s))
            denom = torch.clamp_min(bev_keep + img_keep, 1.0)[:, None, None, None, None]
            rois = (bev_rois + img_rois.to(bev_rois.dtype)) / denom.to(bev_rois.dtype)

            rpn = rpn_proposals(inputs, *self.rpn_head(rois), c, ext, train)
            if c.avod.stop_gradient_proposals:
                rpn["proposals"] = rpn["proposals"].detach()

            with span("detector.stage2"):
                bev_rois2, img_rois2 = stage2_rois(bev_feat, img_feat, rpn["proposals"], inputs["p2"], c, ext,
                                                   (c.avod.bev_roi_stride, c.avod.img_roi_stride))
                head = self.stage2_head(
                    [bev_rois2.to(torch.float32), img_rois2.to(torch.float32)], denom[..., 0, 0],
                    keep_prob=c.avod.keep_dropout_prob if train else 1.0, generator=generator,
                )
            return detector_outputs(rpn, head)


def decode_detections(
    outputs: Dict[str, torch.Tensor],
    ground_plane: torch.Tensor,  # [B, 4]
    cfg: ModelConfig,
    extents: AreaExtents = AreaExtents(),
) -> Dict[str, torch.Tensor]:
    """Stage-2 decode + per-class BEV NMS -> boxes_3d [B, C, K, 7], scores
    [B, C, K], valid [B, C, K]."""

    proposals = outputs["proposals"]
    plane = ground_plane[:, None, :]
    prop_box3d = encoders.anchor_to_box_3d(proposals)
    if cfg.avod.box_rep == "box_8c":
        final = encoders.offsets_to_box_8c(encoders.box_3d_to_corners(prop_box3d), outputs["box_offsets"])
        boxes_3d = encoders.box_8c_to_box_3d(final)
    else:
        final_4c = encoders.offsets_to_box_4c(encoders.box_3d_to_box_4c(prop_box3d, plane),
                                              outputs["box_offsets"])
        boxes_3d = encoders.box_4c_to_box_3d(final_4c, plane)

    ry = boxes_3d[..., 6]
    if "flip_logits" in outputs:
        ry = encoders.apply_heading_flip(ry, torch.argmax(outputs["flip_logits"], dim=-1))
    else:
        theta = encoders.vector_to_angle(outputs["orientation"])
        delta = torch.remainder(ry - theta + math.pi, 2 * math.pi) - math.pi
        ry = torch.where(torch.abs(delta) > math.pi / 2, ry - torch.sign(delta) * math.pi, ry)
    boxes_3d = torch.cat([boxes_3d[..., :6], ry[..., None]], dim=-1)

    bev_boxes = projection.project_to_bev(encoders.box_3d_to_anchor(boxes_3d), extents)
    return per_class_nms(boxes_3d, bev_boxes, outputs, cfg)


def per_class_nms(boxes_3d: torch.Tensor, bev_boxes: torch.Tensor, outputs: Dict[str, torch.Tensor],
                  cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Final per-class BEV NMS of decoded boxes_3d [B, P, 7] (BEV boxes [B,
    P, 4]) on the softmax of ``cls_logits`` over the valid proposals ->
    boxes_3d [B, C, K, 7], scores [B, C, K], valid [B, C, K]."""

    with span("decode.nms"):
        probs = torch.softmax(outputs["cls_logits"], dim=-1)
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


def avod_anchor_grid(cfg: ModelConfig, extents: AreaExtents) -> np.ndarray:
    """The z-major position grid on the plane y = 0, [N, 8] f32."""

    plane0 = np.array([0.0, -1.0, 0.0, 0.0])
    return anchor_ops.generate_anchors_np(cfg.anchors, extents, plane0).astype(np.float32)


def shpl_inputs(batch, cfg: ModelConfig, extents: AreaExtents) -> Tuple[Dict[str, Any], torch.Tensor]:
    """The inputs of a family that fuses by SHPL: the BEV height-slice maps
    (``bev_input``, space-to-depth packed where the backbone packs anyway,
    ``bev_pre_packed``: bit-identical inputs) and the SHPL tables (``m_bev``,
    ``m_fv``); and the occupancy raster its anchors read, a 0/1 indicator
    for ``anchors.density_threshold`` <= 1 (the tier ranking sums it), raw
    counts above. An odd lattice with space_to_depth fails in the encoder,
    as in the reference."""

    h, w = cfg.bev.grid_hw(extents)
    hp, _ = cfg.bev.padded_hw(extents)
    packed = cfg.backbone.space_to_depth and hp % 2 == 0 and w % 2 == 0
    if packed:
        bev_input, counts = bev_device.bev_maps_packed_batch(
            batch.points, batch.points_mask, batch.ground_plane, extents, cfg.bev
        )
    else:
        bev_input = bev_device.bev_maps_from_points_batch(
            batch.points, batch.points_mask, batch.ground_plane, extents, cfg.bev
        )
    m_bev, m_fv = sparse_build.build_coo_device(
        batch.points, batch.points_mask, batch.p2, extents, cfg.bev, cfg.image, cfg.sparse_pool
    )
    thr = cfg.anchors.density_threshold
    if packed:
        occupancy = bev_device.unpack_s2d_raster(counts if thr > 1 else (counts > 0).to(torch.float32), h)
    elif thr <= 1:
        occupancy = (bev_input[:, :h, :, cfg.bev.height_slices] > 0).to(torch.float32)
    else:
        occupancy = bev_device.bev_counts_from_points(batch.points, batch.points_mask, extents, cfg.bev.voxel_size)
    return {"bev_input": bev_input, "bev_pre_packed": packed, "m_bev": m_bev, "m_fv": m_fv}, occupancy


def avod_frame_inputs(batch, anchors_frame: torch.Tensor, cfg: ModelConfig,
                      extents: AreaExtents) -> Dict[str, torch.Tensor]:
    """The SHPL inputs (``shpl_inputs``); every grid anchor with the
    occupancy as a mask (``rpn.dense_grid``), else the first
    ``anchors.max_anchors`` occupied QxQ blocks (``rpn_quad``) or
    positions."""

    shared, occupancy = shpl_inputs(batch, cfg, extents)
    thr = cfg.anchors.density_threshold
    if cfg.rpn.dense_grid:
        fp_counts = anchor_ops.grid_occupancy_counts(occupancy, extents, cfg.bev, cfg.anchors)
        return {**shared, "anchors": anchors_frame,
                "anchor_valid": (fp_counts >= thr).reshape(fp_counts.shape[0], -1)}
    quad = rpn_quad(cfg, extents)
    if quad > 1:
        anchors, valid = anchor_ops.filter_anchor_quads_grid(
            anchors_frame, occupancy, extents, cfg.bev, cfg.anchors,
            max_anchors=cfg.anchors.max_anchors, quad=quad, density_threshold=thr,
        )
    else:
        anchors, valid = anchor_ops.filter_anchor_positions_grid(
            anchors_frame, occupancy, extents, cfg.bev, cfg.anchors,
            max_anchors=cfg.anchors.max_anchors, density_threshold=thr,
        )
    return {**shared, "anchors": anchors, "anchor_valid": valid}


# the anchor filter's tier compaction waits on the host (ops/anchors._tiered_first_k)
FAMILY = Family(SparsePoolingDetector, avod_anchor_grid, avod_frame_inputs, decode_detections,
                frame_inputs_wait_free=False)
