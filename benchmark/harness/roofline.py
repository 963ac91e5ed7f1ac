"""The least time of each hand kernel's call, from the call's own inputs.

Bytes count each input byte read once and each output byte written once; a
data-dependent input counts what these inputs need (the live points' source
cells, the windows' distinct pixels). The least time is the larger of bytes
over the HBM rate and operations over the float32 rate outside the tensor
cores (the kernels compute in f32 on the CUDA cores). Copied from the port's
``chip_smoke.py`` bounds, so that later changes to the port leave it as is.
"""

from __future__ import annotations

from typing import Dict

import torch

from .peaks import F32_FLOPS, HBM_BYTES_PER_S


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(n_bytes: float, flops: float) -> Dict[str, float]:
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return {"s": max(by_bytes, by_ops), "bytes": float(n_bytes), "flops": float(flops),
            "by": "bytes" if by_bytes >= by_ops else "flops"}


def sparse_pool_bound(src, rows, cols, vals, num_targets, *_) -> Dict[str, float]:
    """Kernel A (``sparse_pool_patch``): the live points' distinct source
    cells, the COO, and the [B, T, C] f32 output; 8C + 4 operations a live
    point (four taps' products and sums over C channels and the weight sum)."""

    b, hs, ws, c = src.shape
    soff = torch.arange(b, device=src.device)[:, None, None] * (hs * ws)
    live = (vals != 0).any(-1)
    touched = torch.unique((cols.long() + soff)[live]).numel()
    need = touched * c * src.element_size() + nbytes(rows, cols, vals) + b * int(num_targets) * c * 4
    return bound(need, int(live.sum()) * (8 * c + 4))


def group_crop_bound(images, boxes, crop_hw, patch, *_) -> Dict[str, float]:
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
    return bound(need, 8 * n_out)


BOUNDS = {"sparse_pool_patch": sparse_pool_bound, "group_crop": group_crop_bound}
