"""Bilinear crop-and-resize (TF semantics), plain PyTorch forward only.

The reference's forms of the port's crops: the exact crop
(``crop_and_resize_px_batch`` / ``crop_and_resize_batch``), the grouped
window crop of the RPN (``crop_and_resize_group_einsum_px``, the port's
kernel C) and the strided stage-2 patch crop. Boxes are [y1, x1, y2, x2] in
pixel coordinates of the source map; sample grid
y = y1 + i * (y2 - y1) / (ch - 1), clipped to the map.
"""

from __future__ import annotations

import torch


def _sample_grid(boxes_px: torch.Tensor, h: int, w: int, crop_hw):
    """[..., N, 4] pixel boxes -> clipped sample coords ys [..., N, ch],
    xs [..., N, cw]."""

    ch, cw = crop_hw
    y1, x1, y2, x2 = boxes_px.unbind(-1)
    dev = boxes_px.device
    if ch > 1:
        ys = y1[..., None] + torch.arange(ch, device=dev, dtype=torch.float32) * (
            (y2 - y1)[..., None] / (ch - 1)
        )
    else:
        ys = (0.5 * (y1 + y2))[..., None]
    if cw > 1:
        xs = x1[..., None] + torch.arange(cw, device=dev, dtype=torch.float32) * (
            (x2 - x1)[..., None] / (cw - 1)
        )
    else:
        xs = (0.5 * (x1 + x2))[..., None]
    return torch.clamp(ys, 0.0, h - 1.0), torch.clamp(xs, 0.0, w - 1.0)


def _corner_geometry(ys: torch.Tensor, xs: torch.Tensor, h: int, w: int):
    """Sample coords ys [B, N, ch], xs [B, N, cw] -> the 2x2 windows' corner
    rows and columns [B, N, ch, cw] (top-left start clamped to (h-2, w-2),
    the far corner to the map) and the f32 fractions dy [B, N, ch, 1, 1],
    dx [B, N, 1, cw, 1]."""

    b, n, ch = ys.shape
    cw = xs.shape[-1]
    y0 = torch.clamp(torch.floor(ys).to(torch.int64), 0, max(h - 2, 0))
    x0 = torch.clamp(torch.floor(xs).to(torch.int64), 0, max(w - 2, 0))
    dy = (ys - y0).to(torch.float32)[:, :, :, None, None]
    dx = (xs - x0).to(torch.float32)[:, :, None, :, None]
    yg = y0[:, :, :, None].expand(b, n, ch, cw)
    xg = x0[:, :, None, :].expand(b, n, ch, cw)
    y1g, x1g = torch.clamp_max(yg + 1, h - 1), torch.clamp_max(xg + 1, w - 1)
    return (yg, xg, y1g, x1g), dy, dx


def _crop_px_forward(images: torch.Tensor, boxes_px: torch.Tensor, crop_hw) -> torch.Tensor:
    """[B, H, W, C] + [B, N, 4] pixel boxes -> [B, N, ch, cw, C]."""

    b, h, w, c = images.shape
    ch, cw = int(crop_hw[0]), int(crop_hw[1])
    n = boxes_px.shape[1]
    ys, xs = _sample_grid(boxes_px, h, w, (ch, cw))
    (y0, x0, y1, x1), dy, dx = _corner_geometry(ys, xs, h, w)
    dy, dx = dy.to(images.dtype), dx.to(images.dtype)
    flat = images.reshape(b * h * w, c)
    base = (torch.arange(b, device=images.device) * (h * w))[:, None, None, None]

    def corner(yy, xx):
        return flat[(base + yy * w + xx).reshape(-1)].reshape(b, n, ch, cw, c)

    top = corner(y0, x0) * (1 - dx) + corner(y0, x1) * dx
    bot = corner(y1, x0) * (1 - dx) + corner(y1, x1) * dx
    return top * (1 - dy) + bot * dy


def _group_starts(boxes_grouped: torch.Tensor, h: int, w: int, crop_hw, patch: int):
    """Shared window start per unit, centred on the mean of the V variants'
    sample-span midpoints and clipped so the window fits."""

    b, p, v, _ = boxes_grouped.shape
    ys, xs = _sample_grid(boxes_grouped, h, w, crop_hw)  # [B, P, V, ch|cw]
    y_mid = 0.5 * (ys[..., 0] + ys[..., -1]).mean(dim=-1)  # [B, P]
    x_mid = 0.5 * (xs[..., 0] + xs[..., -1]).mean(dim=-1)
    y_start = torch.clamp(torch.floor(y_mid - (patch - 2) / 2).to(torch.int64), 0, max(h - patch, 0))
    x_start = torch.clamp(torch.floor(x_mid - (patch - 2) / 2).to(torch.int64), 0, max(w - patch, 0))
    return ys, xs, y_start, x_start


def _tent_weights(boxes_grouped: torch.Tensor, h: int, w: int, crop_hw, patch: int):
    """f32 tent weights wy [B, P, V, ch, py], wx [B, P, V, cw, px] of each
    sample over its unit's window, and the windows' flat pixel ids
    [B, P, py, px] (frame-major over [B*H*W])."""

    b = boxes_grouped.shape[0]
    ys, xs, y_start, x_start = _group_starts(boxes_grouped, h, w, crop_hw, patch)
    py, px = min(patch, h), min(patch, w)
    dev = boxes_grouped.device
    rel_y = torch.clamp(ys - y_start[..., None, None], 0.0, py - 1.0)  # [B, P, V, ch]
    rel_x = torch.clamp(xs - x_start[..., None, None], 0.0, px - 1.0)
    wy = torch.clamp_min(1.0 - torch.abs(rel_y[..., None] - torch.arange(py, device=dev)), 0.0)
    wx = torch.clamp_min(1.0 - torch.abs(rel_x[..., None] - torch.arange(px, device=dev)), 0.0)
    oy = torch.arange(py, device=dev)[None, None, :, None]
    ox = torch.arange(px, device=dev)[None, None, None, :]
    bi = torch.arange(b, device=dev)[:, None, None, None]
    pix = (bi * h + y_start[..., None, None] + oy) * w + x_start[..., None, None] + ox
    return wy, wx, pix


def crop_and_resize_group_plain(
    images: torch.Tensor, boxes_grouped: torch.Tensor, crop_hw, patch: int = 8
) -> torch.Tensor:
    """Plain twin of kernel C: [B, H, W, C] + [B, P, V, 4] -> [B, P, V, ch, cw, C]."""

    b, h, w, c = images.shape
    _, p, v, _ = boxes_grouped.shape
    ch, cw = int(crop_hw[0]), int(crop_hw[1])
    wy, wx, pix = _tent_weights(boxes_grouped, h, w, (ch, cw), patch)
    py, px = wy.shape[-1], wx.shape[-1]
    patches = images.reshape(b * h * w, c)[pix.reshape(-1)].reshape(b, p, py, px * c)
    wy = wy.to(images.dtype).reshape(b, p, v * ch, py)
    t = torch.matmul(wy, patches).reshape(b, p, v, ch, px, c)
    return torch.einsum("bpvkl,bpvilc->bpvikc", wx.to(images.dtype), t).contiguous()  # the kernel's layout


def crop_and_resize_px_batch(images: torch.Tensor, boxes_px: torch.Tensor, crop_hw) -> torch.Tensor:
    """[B, H, W, C] + [B, N, 4] pixel boxes -> [B, N, ch, cw, C]."""

    return _crop_px_forward(images, boxes_px, (int(crop_hw[0]), int(crop_hw[1])))


def crop_and_resize_batch(images: torch.Tensor, boxes: torch.Tensor, crop_hw) -> torch.Tensor:
    """``crop_and_resize_px_batch`` of boxes normalized TF-style over the
    map's own (H - 1, W - 1)."""

    _, h, w, _ = images.shape
    scale = torch.tensor([h - 1.0, w - 1.0, h - 1.0, w - 1.0], dtype=boxes.dtype, device=boxes.device)
    return crop_and_resize_px_batch(images, boxes * scale, crop_hw)


def crop_and_resize_group_einsum_px(
    images: torch.Tensor, boxes_grouped: torch.Tensor, crop_hw, patch: int = 8
) -> torch.Tensor:
    """Group-shared window crop (the port's kernel C) -> [B, P, V, ch, cw, C]."""

    return crop_and_resize_group_plain(images, boxes_grouped, crop_hw, int(patch))


def crop_and_resize_patch_einsum_px(images: torch.Tensor, boxes_px: torch.Tensor, crop_hw,
                                    patch: int = 8) -> torch.Tensor:
    """Patch crop: one [patch, patch, C] window per box [B, N, 4]."""

    hw = (int(crop_hw[0]), int(crop_hw[1]))
    return crop_and_resize_group_plain(images, boxes_px[:, :, None], hw, int(patch))[:, :, 0]
