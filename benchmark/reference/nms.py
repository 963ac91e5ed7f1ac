"""Fixed-size greedy non-maximum suppression (plain PyTorch).

Port of ``sparse_pooling_tpu.ops.nms``. Conventions kept exactly:
  * always ``max_outputs`` indices plus a validity mask;
  * each step picks the first maximum of the live scores (argmax); when all
    live scores are -inf the pick is index 0 with ``valid=False``;
  * suppression where IoU > threshold (and the pick itself) sets -inf;
  * the top-k prefilter is a stable descending sort, so ties (including the
    -inf of masked anchors) keep array order as ``lax.top_k`` does.
A one-block-per-frame hand kernel is queued in ROADMAP.md.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class NmsResult(NamedTuple):
    indices: torch.Tensor  # [B, max_outputs] int64 into the input boxes
    valid: torch.Tensor  # [B, max_outputs] bool


def nms_batch(
    boxes: torch.Tensor,  # [B, N, 4] [y1, x1, y2, x2]
    scores: torch.Tensor,  # [B, N]; -inf marks invalid boxes
    max_outputs: int,
    iou_threshold: float = 0.5,
) -> NmsResult:
    """Batch-native greedy NMS."""

    b, n, _ = boxes.shape
    dev = boxes.device
    arange_n = torch.arange(n, device=dev)
    y1, x1, y2, x2 = boxes.unbind(-1)
    areas = torch.clamp_min(y2 - y1, 0) * torch.clamp_min(x2 - x1, 0)
    live = scores.to(torch.float32).clone()
    out_idx = torch.zeros((b, max_outputs), dtype=torch.int64, device=dev)
    out_valid = torch.zeros((b, max_outputs), dtype=torch.bool, device=dev)
    for i in range(max_outputs):
        best = torch.argmax(live, dim=1)  # first maximum
        bi = best[:, None]
        ok = torch.gather(live, 1, bi)[:, 0] > -torch.inf
        out_idx[:, i] = best
        out_valid[:, i] = ok
        py1, px1 = torch.gather(y1, 1, bi), torch.gather(x1, 1, bi)
        py2, px2 = torch.gather(y2, 1, bi), torch.gather(x2, 1, bi)
        inter = torch.clamp_min(torch.minimum(py2, y2) - torch.maximum(py1, y1), 0) * (
            torch.clamp_min(torch.minimum(px2, x2) - torch.maximum(px1, x1), 0)
        )
        union = torch.gather(areas, 1, bi) + areas - inter
        iou = torch.where(union > 0, inter / torch.clamp_min(union, 1e-12), 0.0)
        suppress = (iou > iou_threshold) | (arange_n[None, :] == bi)
        live = torch.where(ok[:, None] & suppress, -torch.inf, live)
    return NmsResult(out_idx, out_valid)


def top_k_nms_batch(
    boxes: torch.Tensor,  # [B, N, 4]
    scores: torch.Tensor,  # [B, N]
    max_outputs: int,
    iou_threshold: float = 0.5,
    pre_top_k: int = 1024,
) -> NmsResult:
    """Top-k prefilter then NMS; indices in the original box indexing."""

    order = torch.sort(scores, dim=1, descending=True, stable=True)
    top_scores, top_idx = order.values[:, :pre_top_k], order.indices[:, :pre_top_k]
    boxes_k = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, boxes.shape[-1]))
    sub = nms_batch(boxes_k, top_scores, max_outputs, iou_threshold)
    return NmsResult(torch.gather(top_idx, 1, sub.indices), sub.valid)
