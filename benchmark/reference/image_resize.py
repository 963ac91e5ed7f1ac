"""In-graph bilinear image resize as two separable per-frame einsums.

Port of ``sparse_pooling_tpu.ops.image_resize``:

    W_axis[o, s] = max(0, 1 - |clip((o + 0.5)/scale - 0.5, 0, raw-1) - s|)

(half-pixel centres, edge clamp; raw-1 recovered as round(n/scale)-1 so the
padding beyond the raw extent gets zero weight; scale 1 is the identity).
The products stay ``torch.einsum`` (cuBLAS on the card, full f32).
"""

from __future__ import annotations

import torch


def _axis_weights(n: int, scale: torch.Tensor) -> torch.Tensor:
    """[B, n(out), n(src)] bilinear row-mixing matrix per frame."""

    o = torch.arange(n, dtype=torch.float32, device=scale.device)
    src = (o[None, :] + 0.5) / scale[:, None] - 0.5  # [B, n]
    limit = torch.round(n / scale).to(torch.int32) - 1  # raw-1, [B]
    src = torch.minimum(torch.clamp_min(src, 0.0), limit[:, None].to(torch.float32))
    s = torch.arange(n, dtype=torch.float32, device=scale.device)
    return torch.clamp_min(1.0 - torch.abs(src[:, :, None] - s[None, None, :]), 0.0)


def resize_bilinear_batch(image_u8: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] uint8 (raw content top-left) + [B, 2] (sy, sx) ->
    [B, H, W, C] f32 in [0, 1] (the /255 rides the row-mixing matrix)."""

    b, h, w, _ = image_u8.shape
    wy = _axis_weights(h, scale[:, 0]) * (1.0 / 255.0)
    wx = _axis_weights(w, scale[:, 1])
    img = image_u8.to(torch.float32)
    tmp = torch.einsum("bhs,bswc->bhwc", wy, img)
    return torch.einsum("bws,bhsc->bhwc", wx, tmp)
