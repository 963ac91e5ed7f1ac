"""Detector losses for the RPN and stage 2, with in-graph minibatch sampling.

Port of ``sparse_pooling_tpu.models.loss`` (``detector_loss`` vmapped over
the batch by ``detector_loss_batch``), written batch-native: each term is
taken per frame, as the reference's vmap does, then averaged over the batch.
Implemented for the cars preset's stage-2 encoding, box_4c, with the flip
head's loss where the outputs carry ``flip_logits``; box_8c raises.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from sparse_pooling_tpu_torch.configs.config import AreaExtents, ModelConfig
from sparse_pooling_tpu_torch.ops import encoders, projection
from sparse_pooling_tpu_torch.ops.losses import weighted_smooth_l1, weighted_softmax_ce
from sparse_pooling_tpu_torch.ops.target_assign import sample_minibatch


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, ...] at idx [B, K] -> [B, K, ...]."""

    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def detector_loss_batch(
    outputs: Dict[str, torch.Tensor],  # batched model outputs [B, ...]
    gt_boxes_3d: torch.Tensor,  # [B, G, 7] padded
    gt_valid: torch.Tensor,  # [B, G] bool
    gt_classes: torch.Tensor,  # [B, G] int (1..C)
    ground_plane: torch.Tensor,  # [B, 4]
    cfg: ModelConfig,
    extents: AreaExtents = AreaExtents(),
    generator: Optional[torch.Generator] = None,
    noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """Loss terms averaged over the batch: ``total``, ``rpn_objectness``,
    ``rpn_regression``, ``cls``, ``reg``, ``orientation`` (and ``flip``), and
    the mean sampled positives ``num_rpn_pos``, ``num_s2_pos``.

    ``noise`` (RPN [B, A], stage 2 [B, P], uniform [0, 1)) fixes the
    sampling priorities; otherwise they are drawn from ``generator`` on the
    outputs' device, RPN first."""

    if cfg.avod.box_rep != "box_4c":
        raise NotImplementedError(f"box_rep {cfg.avod.box_rep!r} is not ported yet")
    mb_cfg = cfg.mini_batch
    anchors = outputs["anchors"][..., :6]
    proposals = outputs["proposals"]
    dev = anchors.device
    if noise is None:
        noise = (
            torch.rand(anchors.shape[:2], generator=generator, device=dev),
            torch.rand(proposals.shape[:2], generator=generator, device=dev),
        )
    rpn_noise, s2_noise = noise
    gt_anchors = encoders.box_3d_to_anchor(gt_boxes_3d)
    gt_bev = projection.project_to_bev(gt_anchors, extents)

    # RPN minibatch and loss
    mb = sample_minibatch(
        projection.project_to_bev(anchors, extents), outputs["anchor_valid"], gt_bev, gt_valid,
        gt_classes, rpn_noise, mb_cfg.rpn_batch_size,
        neg_iou=mb_cfg.rpn_neg_iou, pos_iou=mb_cfg.rpn_pos_iou,
    )
    obj_onehot = F.one_hot(mb.is_pos.to(torch.int64), 2).to(torch.float32)
    rpn_obj_loss = weighted_softmax_ce(_take(outputs["objectness"], mb.indices), obj_onehot, mb.weights)
    reg_targets = encoders.anchor_to_offset(_take(anchors, mb.indices), _take(gt_anchors, mb.gt_idx))
    pos_w = mb.weights * mb.is_pos.to(torch.float32)
    rpn_reg_loss = weighted_smooth_l1(_take(outputs["rpn_offsets"], mb.indices), reg_targets, pos_w)

    # stage-2 minibatch and loss
    mb2 = sample_minibatch(
        projection.project_to_bev(proposals, extents), outputs["proposal_valid"], gt_bev, gt_valid,
        gt_classes, s2_noise, min(mb_cfg.avod_batch_size, proposals.shape[1]),
        neg_iou=mb_cfg.avod_neg_iou, pos_iou=mb_cfg.avod_pos_iou,
    )
    cls_onehot = F.one_hot(mb2.cls_target, cfg.num_classes + 1).to(torch.float32)
    s2_cls_loss = weighted_softmax_ce(_take(outputs["cls_logits"], mb2.indices), cls_onehot, mb2.weights)
    sel_gt_3d = _take(gt_boxes_3d, mb2.gt_idx)
    plane = ground_plane[:, None, :]
    prop_4c = encoders.box_3d_to_box_4c(encoders.anchor_to_box_3d(_take(proposals, mb2.indices)), plane)
    gt_4c = encoders.box_3d_to_box_4c(sel_gt_3d, plane)
    pos_w2 = mb2.weights * mb2.is_pos.to(torch.float32)
    s2_reg_loss = weighted_smooth_l1(
        _take(outputs["box_offsets"], mb2.indices), encoders.box_4c_to_offsets(prop_4c, gt_4c), pos_w2
    )
    s2_ang_loss = weighted_smooth_l1(
        _take(outputs["orientation"], mb2.indices), encoders.angle_to_vector(sel_gt_3d[..., 6]), pos_w2
    )

    r, a = cfg.rpn, cfg.avod
    total = (
        r.loss_objectness_weight * rpn_obj_loss
        + r.loss_regression_weight * rpn_reg_loss
        + a.loss_cls_weight * s2_cls_loss
        + a.loss_reg_weight * s2_reg_loss
        + a.loss_ang_weight * s2_ang_loss
    )
    terms = {}
    if "flip_logits" in outputs:
        flip_onehot = F.one_hot(encoders.heading_flip_bit(sel_gt_3d[..., 6]), 2).to(torch.float32)
        flip_loss = weighted_softmax_ce(_take(outputs["flip_logits"], mb2.indices), flip_onehot, pos_w2)
        total = total + a.loss_flip_weight * flip_loss
        terms["flip"] = flip_loss
    terms.update({
        "total": total,
        "rpn_objectness": rpn_obj_loss,
        "rpn_regression": rpn_reg_loss,
        "cls": s2_cls_loss,
        "reg": s2_reg_loss,
        "orientation": s2_ang_loss,
        "num_rpn_pos": mb.is_pos.sum(-1).to(torch.float32),
        "num_s2_pos": mb2.is_pos.sum(-1).to(torch.float32),
    })
    return {k: v.mean() for k, v in terms.items()}
