"""Bilinear crop-and-resize (TF semantics): the grouped RPN crop (kernel C)
and the exact stage-2 crop.

Port of the forwards of ``sparse_pooling_tpu.ops.crop_resize``:

* ``crop_and_resize_group_einsum_px`` — one window per unit of V grouped
  boxes at the group-centroid start, every variant's ch x cw grid evaluated
  inside it with tent weights. A CUDA tensor launches kernel C
  (``csrc/group_crop.cu``, several units per block, one thread per sample
  holding all C channels); a CPU tensor runs ``crop_and_resize_group_plain``,
  which keeps the reference's casts of the tent weights and of each product
  to the feature dtype.
* ``crop_and_resize_px_batch`` — exact bilinear sampling at every grid point,
  2x2 window per sample with starts clamped to (h-2, w-2); the interpolation
  fractions are cast to the feature dtype as in the reference. Plain PyTorch;
  a hand kernel is queued in ROADMAP.md.

Boxes are [y1, x1, y2, x2] in pixel coordinates of the source map; sample
grid y = y1 + i * (y2 - y1) / (ch - 1) (crop size 1 samples the centre),
clipped to the map.
"""

from __future__ import annotations

import torch

from sparse_pooling_tpu_torch import kernels


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


def crop_and_resize_px_batch(images: torch.Tensor, boxes_px: torch.Tensor, crop_hw) -> torch.Tensor:
    """[B, H, W, C] + [B, N, 4] pixel boxes -> [B, N, ch, cw, C]."""

    b, h, w, c = images.shape
    ch, cw = int(crop_hw[0]), int(crop_hw[1])
    n = boxes_px.shape[1]
    ys, xs = _sample_grid(boxes_px, h, w, (ch, cw))
    y0 = torch.clamp(torch.floor(ys).to(torch.int64), 0, max(h - 2, 0))
    x0 = torch.clamp(torch.floor(xs).to(torch.int64), 0, max(w - 2, 0))
    dy = (ys - y0).to(images.dtype)[:, :, :, None, None]  # [B, N, ch, 1, 1]
    dx = (xs - x0).to(images.dtype)[:, :, None, :, None]  # [B, N, 1, cw, 1]
    y1 = y0 + (1 if h > 1 else 0)
    x1 = x0 + (1 if w > 1 else 0)

    flat = images.reshape(b * h * w, c)
    base = (torch.arange(b, device=images.device) * (h * w))[:, None, None, None]

    def corner(yy, xx):
        lin = base + yy[:, :, :, None] * w + xx[:, :, None, :]  # [B, N, ch, cw]
        return flat[lin.reshape(-1)].reshape(b, n, ch, cw, c)

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


def crop_and_resize_group_plain(
    images: torch.Tensor, boxes_grouped: torch.Tensor, crop_hw, patch: int = 8
) -> torch.Tensor:
    """Plain twin of kernel C: [B, H, W, C] + [B, P, V, 4] -> [B, P, V, ch, cw, C]."""

    b, h, w, c = images.shape
    _, p, v, _ = boxes_grouped.shape
    ch, cw = int(crop_hw[0]), int(crop_hw[1])
    ys, xs, y_start, x_start = _group_starts(boxes_grouped, h, w, (ch, cw), patch)
    py, px = min(patch, h), min(patch, w)
    dev = images.device

    oy = torch.arange(py, device=dev)[None, None, :, None]
    ox = torch.arange(px, device=dev)[None, None, None, :]
    bi = torch.arange(b, device=dev)[:, None, None, None]
    lin = (bi * h + y_start[..., None, None] + oy) * w + x_start[..., None, None] + ox
    patches = images.reshape(b * h * w, c)[lin.reshape(-1)].reshape(b, p, py, px * c)

    rel_y = torch.clamp(ys - y_start[..., None, None], 0.0, py - 1.0)  # [B, P, V, ch]
    rel_x = torch.clamp(xs - x_start[..., None, None], 0.0, px - 1.0)
    grid_y = torch.arange(py, device=dev, dtype=torch.float32)
    grid_x = torch.arange(px, device=dev, dtype=torch.float32)
    wy = torch.clamp_min(1.0 - torch.abs(rel_y[..., None] - grid_y), 0.0)  # [B,P,V,ch,py]
    wx = torch.clamp_min(1.0 - torch.abs(rel_x[..., None] - grid_x), 0.0)  # [B,P,V,cw,px]
    wy = wy.to(images.dtype).reshape(b, p, v * ch, py)
    wx = wx.to(images.dtype)
    t = torch.matmul(wy, patches).reshape(b, p, v, ch, px, c)
    return torch.einsum("bpvkl,bpvilc->bpvikc", wx, t)


@kernels.counted
def crop_and_resize_group_kernel(
    images: torch.Tensor, boxes_grouped: torch.Tensor, crop_hw, patch: int = 8
) -> torch.Tensor:
    """Kernel C on CUDA tensors -> [B, P, V, ch, cw, C] in the image dtype."""

    what = "group_crop"
    device = kernels.require_cuda(images, boxes_grouped, what=what)
    if boxes_grouped.dtype != torch.float32:
        raise TypeError(f"{what}: boxes must be float32")
    b, h, w, c = images.shape
    bb, p, v, four = boxes_grouped.shape
    if bb != b or four != 4:
        raise ValueError(f"{what}: boxes [B, P, V, 4] required, got {tuple(boxes_grouped.shape)}")
    ch, cw = int(crop_hw[0]), int(crop_hw[1])
    dt = kernels.dtype_code(images, what)
    lib = kernels.library("group_crop")
    out = images.new_empty((b, p, v, ch, cw, c))
    # refused (invalid argument) where one unit's window and coordinates
    # exceed 48 KB of shared memory
    rc = lib.group_crop_launch(images.data_ptr(), dt, b, h, w, c, boxes_grouped.data_ptr(), p, v,
                               ch, cw, int(patch), out.data_ptr(), kernels.stream_ptr(device))
    kernels.check(lib, rc, what)
    return out


def crop_and_resize_group_einsum_px(
    images: torch.Tensor, boxes_grouped: torch.Tensor, crop_hw, patch: int = 8
) -> torch.Tensor:
    """Group-shared window crop: one [patch, patch, C] window per unit of V
    boxes -> [B, P, V, ch, cw, C]. Kernel C on a CUDA tensor, the plain
    version on a CPU tensor."""

    fn = crop_and_resize_group_kernel if images.is_cuda else crop_and_resize_group_plain
    return fn(images, boxes_grouped, crop_hw, patch)
