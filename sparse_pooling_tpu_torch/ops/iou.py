"""Axis-aligned 2D IoU of boxes [y1, x1, y2, x2].

Port of ``sparse_pooling_tpu.ops.iou``, with leading batch dims allowed:
[..., N, 4] x [..., M, 4] -> [..., N, M].
"""

from __future__ import annotations

import torch


def area(boxes: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(boxes[..., 2] - boxes[..., 0], 0) * torch.clamp_min(
        boxes[..., 3] - boxes[..., 1], 0
    )


def pairwise_intersection(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """[..., N, 4] x [..., M, 4] -> [..., N, M] intersection areas."""

    a = boxes_a[..., :, None, :]
    b = boxes_b[..., None, :, :]
    iy = torch.clamp_min(torch.minimum(a[..., 2], b[..., 2]) - torch.maximum(a[..., 0], b[..., 0]), 0)
    ix = torch.clamp_min(torch.minimum(a[..., 3], b[..., 3]) - torch.maximum(a[..., 1], b[..., 1]), 0)
    return iy * ix


def pairwise_iou(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """[..., N, 4] x [..., M, 4] -> [..., N, M] IoU (0 where the union is 0)."""

    inter = pairwise_intersection(boxes_a, boxes_b)
    union = area(boxes_a)[..., :, None] + area(boxes_b)[..., None, :] - inter
    return torch.where(union > 0, inter / torch.clamp_min(union, 1e-12), 0.0)
