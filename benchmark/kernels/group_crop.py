"""Kernel C (``torch.ops.spt.group_crop``, ``csrc/group_crop.cu``): the AVOD
family's grouped RPN crops."""

from __future__ import annotations

from typing import Dict

import torch

from harness.roofline import least_time, nbytes

PORT = ("sparse_pooling_tpu_torch.ops.crop_resize", "crop_and_resize_group_kernel")


def bound(images, boxes, crop_hw, patch, *_) -> Dict[str, float]:
    """Kernel C (``group_crop``): each window's distinct pixels, the boxes,
    and the [B, P, V, ch, cw, C] output; 8 operations an output value."""

    b, h, w, c = images.shape
    _, pu, v, _ = boxes.shape
    ch, cw = int(crop_hw[0]), int(crop_hw[1])
    # the unit's shared window start: the mean of its variants' sample-span
    # midpoints, clipped so the window fits (the grouped crop's definition)
    iy = torch.arange(ch, device=boxes.device, dtype=torch.float32)
    ix = torch.arange(cw, device=boxes.device, dtype=torch.float32)
    y1, x1, y2, x2 = boxes.unbind(-1)
    ys = y1[..., None] + iy * ((y2 - y1) / max(ch - 1, 1))[..., None] if ch > 1 else (0.5 * (y1 + y2))[..., None]
    xs = x1[..., None] + ix * ((x2 - x1) / max(cw - 1, 1))[..., None] if cw > 1 else (0.5 * (x1 + x2))[..., None]
    ys, xs = torch.clamp(ys, 0.0, h - 1.0), torch.clamp(xs, 0.0, w - 1.0)
    y_mid = 0.5 * (ys[..., 0] + ys[..., -1]).mean(dim=-1)
    x_mid = 0.5 * (xs[..., 0] + xs[..., -1]).mean(dim=-1)
    y0 = torch.clamp(torch.floor(y_mid - (patch - 2) / 2).to(torch.int64), 0, max(h - patch, 0))
    x0 = torch.clamp(torch.floor(x_mid - (patch - 2) / 2).to(torch.int64), 0, max(w - patch, 0))
    py, px = min(patch, h), min(patch, w)
    pix = ((torch.arange(b, device=images.device)[:, None, None, None] * h + y0[..., None, None]
            + torch.arange(py, device=images.device)[:, None]) * w + x0[..., None, None]
           + torch.arange(px, device=images.device))
    touched = torch.unique(pix).numel()
    n_out = b * pu * v * ch * cw * c
    need = touched * c * images.element_size() + nbytes(boxes) + n_out * images.element_size()
    return least_time(need, 8 * n_out)
