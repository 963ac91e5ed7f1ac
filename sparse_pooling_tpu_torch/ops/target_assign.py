"""Minibatch sampling for the RPN and stage-2 losses, on the device.

Port of ``sparse_pooling_tpu.ops.target_assign.sample_minibatch``, batched
over frames (the reference vmaps one frame). An anchor's best GT IoU puts it
in the positive band, the negative band or neither; a fixed-size minibatch
takes positives first, then negatives, in the order of a priority
``band + 0.5 * noise``. The caller draws the noise (uniform [0, 1), one per
anchor) from its generator, so a test can feed both packages the same noise.
Ties in the priority go to the lower index, as ``lax.top_k``: a stable
descending sort, not ``torch.topk`` (uniform f32 draws over 16384 anchors
collide about a dozen times per frame).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sparse_pooling_tpu_torch.ops.iou import pairwise_iou


class MiniBatch(NamedTuple):
    indices: torch.Tensor  # [B, K] int64 into the anchor/proposal set
    weights: torch.Tensor  # [B, K] f32: 1 for a sampled positive or negative
    is_pos: torch.Tensor  # [B, K] bool
    cls_target: torch.Tensor  # [B, K] int64, 0 = background, 1..C = class
    gt_idx: torch.Tensor  # [B, K] int64 best-matching GT per entry
    max_iou: torch.Tensor  # [B, K] f32


def sample_minibatch(
    anchor_bev: torch.Tensor,  # [B, A, 4] BEV boxes [y1, x1, y2, x2]
    anchor_valid: torch.Tensor,  # [B, A] bool
    gt_bev: torch.Tensor,  # [B, G, 4]
    gt_valid: torch.Tensor,  # [B, G] bool
    gt_classes: torch.Tensor,  # [B, G] int (1..C)
    noise: torch.Tensor,  # [B, A] uniform [0, 1)
    batch_size: int,
    neg_iou=(0.0, 0.3),
    pos_iou=(0.5, 1.0),
) -> MiniBatch:
    iou = pairwise_iou(anchor_bev, gt_bev)  # [B, A, G]
    iou = torch.where(gt_valid[:, None, :], iou, -1.0)
    max_iou = torch.amax(iou, dim=-1)
    gt_idx = torch.argmax(iou, dim=-1)  # first maximum
    max_iou = torch.where(anchor_valid, max_iou, -1.0)

    is_pos = (max_iou >= pos_iou[0]) & (max_iou <= pos_iou[1])
    is_neg = (max_iou >= neg_iou[0]) & (max_iou < neg_iou[1]) & anchor_valid
    band = torch.where(is_pos, 2.0, torch.where(is_neg, 1.0, 0.0))
    priority = band + noise.to(torch.float32) * 0.5
    sel = torch.sort(priority, dim=-1, descending=True, stable=True).indices[:, :batch_size]

    sel_pos = torch.gather(is_pos, 1, sel)
    sel_neg = torch.gather(is_neg, 1, sel)
    sel_gt = torch.gather(gt_idx, 1, sel)
    cls = torch.where(sel_pos, torch.gather(gt_classes.to(torch.int64), 1, sel_gt), 0)
    return MiniBatch(
        indices=sel,
        weights=(sel_pos | sel_neg).to(torch.float32),
        is_pos=sel_pos,
        cls_target=cls,
        gt_idx=sel_gt,
        max_iou=torch.gather(max_iou, 1, sel),
    )
