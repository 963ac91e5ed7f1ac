"""Bilinear crop-and-resize (TF semantics): the grouped RPN crop (kernel C)
and the exact stage-2 crop, each with its feature gradient.

Port of ``sparse_pooling_tpu.ops.crop_resize``:

* ``crop_and_resize_group_einsum_px`` — one window per unit of V grouped
  boxes at the group-centroid start, every variant's ch x cw grid evaluated
  inside it with tent weights. A CUDA tensor launches kernel C
  (``csrc/group_crop.cu``, several units per block, one thread per sample
  holding all C channels); a CPU tensor runs ``crop_and_resize_group_plain``,
  which keeps the reference's casts of the tent weights and of each product
  to the feature dtype. Its gradient (the reference's ``_group_with_vjp``)
  is the window transpose: kernel C-bwd in the same file on the card,
  ``crop_and_resize_group_bwd_plain`` on the CPU.
* ``crop_and_resize_px_batch`` — exact bilinear sampling at every grid point,
  2x2 window per sample with starts clamped to (h-2, w-2); the interpolation
  fractions are cast to the feature dtype as in the reference. Plain PyTorch
  both ways (the backward mirrors ``_crop_with_vjp``: f32 corner weights,
  one ``index_add_`` in the reference's accumulator dtype); hand kernels are
  queued in ROADMAP.md.

Only the images take a gradient: boxes that require one raise (the RPN's
anchors and the detached proposals need none; the box gradient is queued).

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


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The reference's accumulator of a feature gradient (``_acc_dtype``):
    bf16 for a bf16 map, f32 otherwise."""

    return torch.bfloat16 if dtype == torch.bfloat16 else torch.float32


def _no_box_grad(boxes: torch.Tensor, what: str) -> None:
    if boxes.requires_grad:
        raise NotImplementedError(f"{what}: the gradient of the boxes is not ported yet")


def _crop_px_forward(images: torch.Tensor, boxes_px: torch.Tensor, crop_hw) -> torch.Tensor:
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


def crop_and_resize_px_bwd_plain(grad: torch.Tensor, boxes_px: torch.Tensor, image_shape,
                                 dtype: torch.dtype) -> torch.Tensor:
    """Feature gradient of ``crop_and_resize_px_batch``, the reference's
    ``_bilinear_bwd``: each sample's f32 gradient times its four f32 corner
    weights, one ``index_add_`` into [B*H*W, C] in the reference's
    accumulator (``acc_dtype``), cast to ``dtype``."""

    b, h, w, c = image_shape
    ch, cw = grad.shape[2], grad.shape[3]
    n = boxes_px.shape[1]
    acc = acc_dtype(dtype)
    g = grad.to(torch.float32)  # [B, N, ch, cw, C]
    ys, xs = _sample_grid(boxes_px, h, w, (ch, cw))
    y0 = torch.clamp(torch.floor(ys).to(torch.int64), 0, max(h - 2, 0))
    x0 = torch.clamp(torch.floor(xs).to(torch.int64), 0, max(w - 2, 0))
    dy = (ys - y0)[:, :, :, None, None]
    dx = (xs - x0)[:, :, None, :, None]
    yg = y0[:, :, :, None].expand(b, n, ch, cw)
    xg = x0[:, :, None, :].expand(b, n, ch, cw)
    y1g, x1g = torch.clamp_max(yg + 1, h - 1), torch.clamp_max(xg + 1, w - 1)
    base = (torch.arange(b, device=g.device) * (h * w))[:, None, None, None]
    # entries frame by frame, the four corners' blocks in turn, as the
    # reference orders them (the order of a bf16 sum matters)
    corners = ((yg, xg), (yg, x1g), (y1g, xg), (y1g, x1g))
    ids = torch.stack([(base + yy * w + xx).reshape(b, -1) for yy, xx in corners], dim=1)
    weights = ((1 - dy) * (1 - dx), (1 - dy) * dx, dy * (1 - dx), dy * dx)
    vals = torch.stack([(g * wt).reshape(b, -1, c) for wt in weights], dim=1)
    out = torch.zeros(b * h * w, c, dtype=acc, device=g.device)
    out.index_add_(0, ids.reshape(-1), vals.reshape(-1, c).to(acc))
    return out.reshape(b, h, w, c).to(dtype)


class _CropPx(torch.autograd.Function):
    @staticmethod
    def forward(ctx, images, boxes_px, crop_hw):
        ctx.save_for_backward(boxes_px)
        ctx.image_shape, ctx.dtype = tuple(images.shape), images.dtype
        return _crop_px_forward(images, boxes_px, crop_hw)

    @staticmethod
    def backward(ctx, grad):
        (boxes_px,) = ctx.saved_tensors
        return crop_and_resize_px_bwd_plain(grad, boxes_px, ctx.image_shape, ctx.dtype), None, None


def crop_and_resize_px_batch(images: torch.Tensor, boxes_px: torch.Tensor, crop_hw) -> torch.Tensor:
    """[B, H, W, C] + [B, N, 4] pixel boxes -> [B, N, ch, cw, C]; the
    gradient reaches the images only."""

    _no_box_grad(boxes_px, "crop_and_resize_px_batch")
    return _CropPx.apply(images, boxes_px, (int(crop_hw[0]), int(crop_hw[1])))


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
    return torch.einsum("bpvkl,bpvilc->bpvikc", wx.to(images.dtype), t)


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


def crop_and_resize_group_bwd_plain(grad: torch.Tensor, boxes_grouped: torch.Tensor, image_shape,
                                    crop_hw, patch: int, dtype: torch.dtype,
                                    accum_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain twin of kernel C-bwd, the reference's ``_group_feature_grad``:
    the f32 window gradient of each unit (the two tent contractions
    transposed) -> one ``index_add_`` into [B*H*W, C] in ``accum_dtype``, cast
    to ``dtype``. The reference sums a bf16 map's gradient in bf16
    (``accum_dtype=torch.bfloat16``); kernel C-bwd sums in f32."""

    b, h, w, c = image_shape
    wy, wx, pix = _tent_weights(boxes_grouped, h, w, (int(crop_hw[0]), int(crop_hw[1])), patch)
    g = grad.to(torch.float32)  # [B, P, V, ch, cw, C]
    g_t = torch.einsum("bpvkl,bpvikc->bpvilc", wx, g)  # [B, P, V, ch, px, C]
    g_patches = torch.einsum("bpvij,bpvilc->bpjlc", wy, g_t)  # [B, P, py, px, C]
    out = torch.zeros(b * h * w, c, dtype=accum_dtype, device=grad.device)
    out.index_add_(0, pix.reshape(-1), g_patches.reshape(-1, c).to(accum_dtype))
    return out.reshape(b, h, w, c).to(dtype)


@kernels.counted
def crop_and_resize_group_bwd_kernel(grad: torch.Tensor, boxes_grouped: torch.Tensor, image_shape,
                                     crop_hw, patch: int, dtype: torch.dtype) -> torch.Tensor:
    """Kernel C-bwd on CUDA tensors -> the image gradient [B, H, W, C] in
    ``dtype`` (the gradient's dtype), summed in f32 and rounded once."""

    what = "group_crop_bwd"
    device = kernels.require_cuda(grad, boxes_grouped, what=what)
    b, h, w, c = (int(x) for x in image_shape)
    bb, p, v, four = boxes_grouped.shape
    ch, cw = int(crop_hw[0]), int(crop_hw[1])
    if boxes_grouped.dtype != torch.float32:
        raise TypeError(f"{what}: boxes must be float32")
    if bb != b or four != 4 or grad.shape != (b, p, v, ch, cw, c):
        raise ValueError(f"{what}: grad [B, P, V, ch, cw, C] and boxes [B, P, V, 4] required")
    if grad.dtype != dtype:
        raise TypeError(f"{what}: grad dtype {grad.dtype} differs from the image's {dtype}")
    dt = kernels.dtype_code(grad, what)
    lib = kernels.library("group_crop")
    acc = grad.new_empty((b, h, w, c), dtype=torch.float32)
    out = acc if dtype == torch.float32 else grad.new_empty((b, h, w, c))
    # refused (invalid argument) where one unit's gradients, coordinates and
    # f32 window rows of one channel group exceed 227 KB of shared memory
    rc = lib.group_crop_bwd_launch(grad.data_ptr(), dt, b, h, w, c, boxes_grouped.data_ptr(), p, v,
                                   ch, cw, int(patch), acc.data_ptr(), out.data_ptr(),
                                   kernels.stream_ptr(device))
    kernels.check(lib, rc, what)
    return out


class _GroupCrop(torch.autograd.Function):
    """Kernel C (or its twin) forward; C-bwd (or its twin, f32 sums) for the
    images' gradient. Saves the boxes, not the images."""

    @staticmethod
    def forward(ctx, images, boxes_grouped, crop_hw, patch):
        ctx.save_for_backward(boxes_grouped)
        ctx.image_shape, ctx.dtype, ctx.crop_hw, ctx.patch = (
            tuple(images.shape), images.dtype, crop_hw, patch)
        fn = crop_and_resize_group_kernel if images.is_cuda else crop_and_resize_group_plain
        return fn(images, boxes_grouped, crop_hw, patch)

    @staticmethod
    def backward(ctx, grad):
        (boxes,) = ctx.saved_tensors
        fn = crop_and_resize_group_bwd_kernel if grad.is_cuda else crop_and_resize_group_bwd_plain
        g = fn(grad.contiguous(), boxes, ctx.image_shape, ctx.crop_hw, ctx.patch, ctx.dtype)
        return g, None, None, None


def crop_and_resize_group_einsum_px(
    images: torch.Tensor, boxes_grouped: torch.Tensor, crop_hw, patch: int = 8
) -> torch.Tensor:
    """Group-shared window crop: one [patch, patch, C] window per unit of V
    boxes -> [B, P, V, ch, cw, C]. Kernel C on a CUDA tensor, the plain
    version on a CPU tensor; the gradient reaches the images only (C-bwd, or
    its twin)."""

    _no_box_grad(boxes_grouped, "crop_and_resize_group_einsum_px")
    return _GroupCrop.apply(images, boxes_grouped, (int(crop_hw[0]), int(crop_hw[1])), int(patch))
