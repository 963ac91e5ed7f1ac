"""MV3D-style fusion R-CNN, the second detector family built on SHPL.

Port of ``sparse_pooling_tpu.models.fusion_rcnn`` (the ``rcnn_cars``
preset). It differs from ``models.detector.SparsePoolingDetector`` in three
ways:

* the RPN is a dense convolution over the fused BEV mid features: every
  fusion-lattice cell scores one anchor per (size, rotation);
* the anchors are that lattice (``rcnn_anchor_grid``), all valid: no
  occupancy filter and no grouped RPN crop (kernel C is not on this path);
* stage 2 averages the exact crops of both views and regresses 6-d anchor
  offsets (``avod.box_rep="offsets"``) or the corner encodings box_4c and
  box_8c, which decode and train as the AVOD family's.

The family's losses are ``models.loss.detector_loss_batch``: the reference's
``rcnn_loss`` samples, weights and sums as the AVOD loss does, and only its
stage-2 target differs, which that function takes from ``avod.box_rep``.

Both SHPL fusions always run (kernel A twice a forward pass, A-bwd twice in
training); the family has no path drop, and its proposals keep their
gradient into stage 2 (the exact crop's box gradient, the loss targets).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from sparse_pooling_tpu_torch.configs.config import AreaExtents, ModelConfig
from sparse_pooling_tpu_torch.models.backbone import VggPyramidExtractor
from sparse_pooling_tpu_torch.models.detector import (STAGE2_BOX_DIMS, ConvRpnHead, Family, Stage2Head,
                                                      compute_dtype, decode_detections, detector_outputs,
                                                      per_class_nms, rpn_proposals, shpl_inputs, stage2_rois)
from sparse_pooling_tpu_torch.models.fusion import SparsePoolFusion
from sparse_pooling_tpu_torch.ops import anchors as anchor_ops
from sparse_pooling_tpu_torch.ops import encoders, projection
from sparse_pooling_tpu_torch.runtime.profiling import span


def rcnn_anchor_grid(cfg: ModelConfig, extents: AreaExtents) -> np.ndarray:
    """Dense fusion-lattice anchors [Hf*Wf*R, 8] f32 with y = 0 (filled per
    frame): one per cell per (size, rotation), cells row-major, the R
    variants of a cell adjacent with the rotation fastest (the conv head's
    NHWC channel order); a size's index is its class index."""

    return anchor_ops.lattice_anchor_grid(cfg.anchors, cfg.bev, extents, cfg.sparse_pool.fusion_stride,
                                          range(len(cfg.anchors.sizes)))


def rcnn_frame_inputs(batch, anchors_frame: torch.Tensor, cfg: ModelConfig,
                      extents: AreaExtents) -> Dict[str, torch.Tensor]:
    """The SHPL inputs (``detector.shpl_inputs``; no anchor reads the
    occupancy); the dense lattice grid on each frame's ground plane, every
    anchor valid."""

    shared, _ = shpl_inputs(batch, cfg, extents)
    return {**shared, "anchors": anchors_frame,
            "anchor_valid": torch.ones(anchors_frame.shape[:2], dtype=torch.bool, device=anchors_frame.device)}


class FusionRcnn(nn.Module):
    """Two-stage fusion detector, batch-native, NHWC."""

    def __init__(self, cfg: ModelConfig, extents: AreaExtents = AreaExtents()):
        super().__init__()
        c = cfg
        if c.avod.box_rep not in STAGE2_BOX_DIMS:
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
        self.img_fusion = SparsePoolFusion(mid, mid, mid, dt, sp.pool_channels, sp.accum_dtype)
        self.rpn_head = ConvRpnHead(mid, c.rpn.fusion_channels,
                                    len(c.anchors.rotations) * len(c.anchors.sizes), dt)
        s2 = c.avod.roi_size
        self.stage2_head = Stage2Head(
            s2 * s2 * bb.out_channels, c.avod.fc_layers, c.num_classes, dt,
            box_dim=STAGE2_BOX_DIMS[c.avod.box_rep], flip_head=c.avod.explicit_flip_head,
        )

    def forward(self, inputs: Dict[str, Any], train: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """inputs as ``SparsePoolingDetector.forward`` takes them, with the
        dense grid from ``rcnn_anchor_grid`` as ``anchors`` (``anchor_valid``,
        all true, is passed through unread; ``path_keep`` is not read). ``train`` selects the training
        proposals and dropout (masks from ``generator``)."""

        c = self.cfg
        ext = self.extents
        with span("detector"):
            with span("detector.encode"):
                bev_mid, bev_skips = self.bev_extractor.encode(
                    inputs["bev_input"], pre_packed=inputs["bev_pre_packed"]
                )
                img_mid, img_skips = self.img_extractor.encode(inputs["image"])
            with span("detector.fusion"):
                bev_mid_f = self.bev_fusion(bev_mid, img_mid, inputs["m_bev"])
                img_mid_f = self.img_fusion(img_mid, bev_mid, inputs["m_fv"])

            # dense conv RPN on the fused BEV mid lattice, every anchor valid
            rpn = rpn_proposals(inputs, *self.rpn_head(bev_mid_f), c, ext, train, mask=False)

            with span("detector.decode_maps"):
                bev_feat = self.bev_extractor.decode(bev_mid_f, bev_skips)
                img_feat = self.img_extractor.decode(img_mid_f, img_skips)
            # stage 2: the mean of both views' exact crops on the decoded maps
            with span("detector.stage2"):
                bev_rois, img_rois = stage2_rois(bev_feat, img_feat, rpn["proposals"], inputs["p2"], c, ext)
                rois = (bev_rois.to(torch.float32) + img_rois.to(torch.float32)) / 2.0
                head = self.stage2_head(
                    [rois], None, keep_prob=c.avod.keep_dropout_prob if train else 1.0, generator=generator,
                )
            return detector_outputs(rpn, head)


def decode_rcnn_detections(
    outputs: Dict[str, torch.Tensor],
    cfg: ModelConfig,
    extents: AreaExtents = AreaExtents(),
    ground_plane: Optional[torch.Tensor] = None,  # [B, 4]; box_4c and box_8c
) -> Dict[str, torch.Tensor]:
    """Stage-2 decode and per-class BEV NMS -> boxes_3d [B, C, K, 7], scores
    [B, C, K], valid [B, C, K]. Offsets: the proposals refined by the 6-d
    offsets, the heading from the angle vector (its side from the flip head
    where there is one); box_4c and box_8c decode as ``decode_detections``."""

    if cfg.avod.box_rep != "offsets":
        if ground_plane is None:
            raise ValueError("box_4c/box_8c decode needs ground_plane")
        return decode_detections(outputs, ground_plane, cfg, extents)
    refined = encoders.offset_to_anchor(outputs["proposals"], outputs["box_offsets"])
    ry = encoders.vector_to_angle(outputs["orientation"])
    if "flip_logits" in outputs:
        ry = encoders.apply_heading_flip(ry, torch.argmax(outputs["flip_logits"], dim=-1))
    boxes_3d = encoders.anchor_to_box_3d(refined, ry)
    return per_class_nms(boxes_3d, projection.project_to_bev(refined, extents), outputs, cfg)



FAMILY = Family(FusionRcnn, rcnn_anchor_grid, rcnn_frame_inputs,
                lambda outputs, plane, cfg, extents: decode_rcnn_detections(outputs, cfg, extents, plane),
                frame_inputs_wait_free=True)
