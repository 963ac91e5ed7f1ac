"""Bilinear crop-and-resize (TF semantics): the grouped RPN crop (kernel C),
the exact crop and the strided patch crop, each with its gradients.

Port of ``sparse_pooling_tpu.ops.crop_resize``:

* ``crop_and_resize_group_einsum_px`` — one window per unit of V grouped
  boxes at the group-centroid start, every variant's ch x cw grid evaluated
  inside it with tent weights, the operator ``torch.ops.spt.group_crop``
  (backward ``torch.ops.spt.group_crop_bwd``). A CUDA tensor launches kernel C
  (``csrc/group_crop.cu``, several units per block, one thread per sample
  holding all C channels); a CPU tensor runs ``crop_and_resize_group_plain``,
  which keeps the reference's casts of the tent weights and of each product
  to the feature dtype. Its image gradient (the reference's
  ``_group_with_vjp``) is the window transpose: kernel C-bwd in the same file
  on the card, ``crop_and_resize_group_bwd_plain`` on the CPU; its box
  gradient is the reference's ``_box_grad`` at the window-clamped sample
  coordinates (``_group_coords``), plain PyTorch on both devices.
* ``crop_and_resize_px_batch`` (and ``crop_and_resize_batch``, its form for
  boxes normalized over the map) — exact bilinear sampling at every grid
  point, 2x2 window per sample with starts clamped to (h-2, w-2); the
  interpolation fractions are cast to the feature dtype as in the reference.
* ``crop_and_resize_patch_einsum_px`` — the strided stage-2 crop: one
  [patch, patch] window per box, the grouped crop's plain evaluation with
  one box a unit.

The exact and the patch crop are plain PyTorch both ways. Each equals
bilinear sampling at coordinates of its boxes, so both share the reference's
``_bilinear_bwd`` (``_Bilinear``): f32 corner weights, one ``index_add_``
in the reference's accumulator dtype for the image, and where the boxes need
it their gradient (``bilinear_box_grad``, the reference's
``_box_grad_from_corners``); hand kernels are queued in ROADMAP.md.

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


def bilinear_feature_grad(grad: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor, image_shape,
                          dtype: torch.dtype) -> torch.Tensor:
    """Image gradient of bilinear sampling at ys [B, N, ch], xs [B, N, cw],
    the feature half of the reference's ``_bilinear_bwd``: each sample's f32
    gradient [B, N, ch, cw, C] times its four f32 corner weights, one
    ``index_add_`` into [B*H*W, C] in the reference's accumulator
    (``acc_dtype``), cast to ``dtype``."""

    b, h, w, c = image_shape
    acc = acc_dtype(dtype)
    g = grad.to(torch.float32)
    corners, dy, dx = _corner_geometry(ys, xs, h, w)
    yg, xg, y1g, x1g = corners
    base = (torch.arange(b, device=g.device) * (h * w))[:, None, None, None]
    # entries frame by frame, the four corners' blocks in turn, as the
    # reference orders them (the order of a bf16 sum matters)
    blocks = ((yg, xg), (yg, x1g), (y1g, xg), (y1g, x1g))
    ids = torch.stack([(base + yy * w + xx).reshape(b, -1) for yy, xx in blocks], dim=1)
    weights = ((1 - dy) * (1 - dx), (1 - dy) * dx, dy * (1 - dx), dy * dx)
    vals = torch.stack([(g * wt).reshape(b, -1, c) for wt in weights], dim=1)
    out = torch.zeros(b * h * w, c, dtype=acc, device=g.device)
    out.index_add_(0, ids.reshape(-1), vals.reshape(-1, c).to(acc))
    return out.reshape(b, h, w, c).to(dtype)


def bilinear_box_grad(grad: torch.Tensor, images: torch.Tensor, boxes: torch.Tensor,
                      coords_fn) -> torch.Tensor:
    """Box gradient of bilinear sampling at ``coords_fn(boxes)`` (ys
    [B, N, ch], xs [B, N, cw]), the reference's ``_box_grad_from_corners``:
    the f32 corner values re-gathered, the bilinear blend chained
    analytically to each sample's fractions, then through ``coords_fn`` (its
    clips included) to the boxes."""

    b, h, w, c = images.shape
    g = grad.to(torch.float32)
    with torch.enable_grad():
        leaf = boxes.detach().requires_grad_(True)
        ys, xs = coords_fn(leaf)
    n, ch, cw = ys.shape[1], ys.shape[2], xs.shape[2]
    (y0, x0, y1, x1), dy, dx = _corner_geometry(ys.detach(), xs.detach(), h, w)
    flat = images.detach().reshape(b * h * w, c).to(torch.float32)
    base = (torch.arange(b, device=g.device) * (h * w))[:, None, None, None]

    def corner(yy, xx):
        return flat[(base + yy * w + xx).reshape(-1)].reshape(b, n, ch, cw, c)

    p00, p01, p10, p11 = corner(y0, x0), corner(y0, x1), corner(y1, x0), corner(y1, x1)
    top = p00 * (1 - dx) + p01 * dx
    bot = p10 * (1 - dx) + p11 * dx
    g_dy = torch.sum(g * (bot - top), dim=(3, 4))  # [B, N, ch]
    g_dx = torch.sum(g * ((p01 - p00) * (1 - dy) + (p11 - p10) * dy), dim=(2, 4))  # [B, N, cw]
    (g_boxes,) = torch.autograd.grad((ys, xs), leaf, (g_dy, g_dx))
    return g_boxes


class _Bilinear(torch.autograd.Function):
    """A crop that equals bilinear sampling at ``coords_fn(boxes)``:
    ``forward_fn(images, boxes)`` forward, the reference's ``_bilinear_bwd``
    backward (``bilinear_feature_grad`` and, where the boxes require it,
    ``bilinear_box_grad``)."""

    @staticmethod
    def forward(ctx, images, boxes, forward_fn, coords_fn):
        ctx.save_for_backward(images if boxes.requires_grad else None, boxes)
        ctx.image_shape, ctx.dtype, ctx.coords_fn = tuple(images.shape), images.dtype, coords_fn
        return forward_fn(images, boxes)

    @staticmethod
    def backward(ctx, grad):
        images, boxes = ctx.saved_tensors
        g_images = g_boxes = None
        if ctx.needs_input_grad[0]:
            ys, xs = ctx.coords_fn(boxes)
            g_images = bilinear_feature_grad(grad, ys, xs, ctx.image_shape, ctx.dtype)
        if ctx.needs_input_grad[1]:
            g_boxes = bilinear_box_grad(grad, images, boxes, ctx.coords_fn)
        return g_images, g_boxes, None, None


def crop_and_resize_px_batch(images: torch.Tensor, boxes_px: torch.Tensor, crop_hw) -> torch.Tensor:
    """[B, H, W, C] + [B, N, 4] pixel boxes -> [B, N, ch, cw, C]; the
    gradient reaches the images and, where they require it, the boxes."""

    _, h, w, _ = images.shape
    hw = (int(crop_hw[0]), int(crop_hw[1]))
    return _Bilinear.apply(images, boxes_px, lambda im, bx: _crop_px_forward(im, bx, hw),
                           lambda bx: _sample_grid(bx, h, w, hw))


def crop_and_resize_batch(images: torch.Tensor, boxes: torch.Tensor, crop_hw) -> torch.Tensor:
    """``crop_and_resize_px_batch`` of boxes normalized TF-style over the
    map's own (H - 1, W - 1) -> [B, N, ch, cw, C]."""

    _, h, w, _ = images.shape
    scale = torch.tensor([h - 1.0, w - 1.0, h - 1.0, w - 1.0], dtype=boxes.dtype, device=boxes.device)
    return crop_and_resize_px_batch(images, boxes * scale, crop_hw)


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


def _group_coords(boxes_grouped: torch.Tensor, h: int, w: int, crop_hw, patch: int):
    """The grouped crop's effective (window-clamped) sample coordinates,
    flattened to ys [B, P*V, ch], xs [B, P*V, cw]: the crop equals bilinear
    sampling there."""

    b, p, v, _ = boxes_grouped.shape
    ys, xs, y_start, x_start = _group_starts(boxes_grouped, h, w, crop_hw, patch)
    py, px = min(patch, h), min(patch, w)
    ys_eff = y_start[..., None, None] + torch.clamp(ys - y_start[..., None, None], 0.0, py - 1.0)
    xs_eff = x_start[..., None, None] + torch.clamp(xs - x_start[..., None, None], 0.0, px - 1.0)
    return ys_eff.reshape(b, p * v, -1), xs_eff.reshape(b, p * v, -1)


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
    # exceed 227 KB of shared memory, all a block may take
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
    ``dtype`` (the gradient's dtype): f32 partial sums added in an int64
    fixed point, rounded once, the same bits on every launch."""

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
    acc = grad.new_empty((b * h * w * c + 1,), dtype=torch.int64)  # the sums, then max |g|
    out = grad.new_empty((b, h, w, c))
    # refused (invalid argument) where one unit's gradients, coordinates and
    # f32 window rows of one channel group exceed 227 KB of shared memory
    rc = lib.group_crop_bwd_launch(grad.data_ptr(), dt, b, h, w, c, boxes_grouped.data_ptr(), p, v,
                                   ch, cw, int(patch), acc.data_ptr(), out.data_ptr(),
                                   kernels.stream_ptr(device))
    kernels.check(lib, rc, what)
    return out


# Kernels C and C-bwd as operators: the dispatcher takes the kernel for a
# CUDA tensor and the twin (C-bwd's with f32 sums) for a CPU one.
kernels.OPS.define("group_crop(Tensor images, Tensor boxes_grouped, SymInt crop_h, SymInt crop_w, "
                   "int patch) -> Tensor")
kernels.OPS.define("group_crop_bwd(Tensor grad, Tensor boxes_grouped, SymInt height, SymInt width, "
                   "SymInt crop_h, SymInt crop_w, int patch, ScalarType dtype) -> Tensor")
# the wrappers are looked up when called, so a patched module name is seen
kernels.OPS.impl("group_crop", lambda im, bx, ch, cw, patch:
                 crop_and_resize_group_kernel(im, bx, (ch, cw), patch), "CUDA")
kernels.OPS.impl("group_crop", lambda im, bx, ch, cw, patch:
                 crop_and_resize_group_plain(im, bx, (ch, cw), patch), "CPU")


def _bwd_args(grad, boxes_grouped, height, width, crop_h, crop_w, patch, dtype):
    shape = (grad.shape[0], height, width, grad.shape[-1])
    return grad, boxes_grouped, shape, (crop_h, crop_w), patch, dtype


kernels.OPS.impl("group_crop_bwd", lambda *a: crop_and_resize_group_bwd_kernel(*_bwd_args(*a)), "CUDA")
kernels.OPS.impl("group_crop_bwd", lambda *a: crop_and_resize_group_bwd_plain(*_bwd_args(*a)), "CPU")


@torch.library.register_fake("spt::group_crop", lib=kernels.OPS)
def _group_crop_fake(images, boxes_grouped, crop_h, crop_w, patch):
    b, p, v, _ = boxes_grouped.shape
    return images.new_empty((b, p, v, crop_h, crop_w, images.shape[-1]))


@torch.library.register_fake("spt::group_crop_bwd", lib=kernels.OPS)
def _group_crop_bwd_fake(grad, boxes_grouped, height, width, crop_h, crop_w, patch, dtype):
    return grad.new_empty((grad.shape[0], height, width, grad.shape[-1]), dtype=dtype)


def _group_crop_setup(ctx, inputs, output):
    """Saves the boxes, and the images only where the boxes require a
    gradient."""

    images, boxes_grouped, crop_h, crop_w, patch = inputs
    ctx.save_for_backward(images if boxes_grouped.requires_grad else None, boxes_grouped)
    ctx.image_shape, ctx.dtype, ctx.crop_hw, ctx.patch = tuple(images.shape), images.dtype, (crop_h, crop_w), patch


def _group_crop_backward(ctx, grad):
    """C-bwd (or its twin, f32 sums) for the images' gradient,
    ``bilinear_box_grad`` at ``_group_coords`` for the boxes'."""

    images, boxes = ctx.saved_tensors
    b, h, w, c = ctx.image_shape
    g_images = g_boxes = None
    if ctx.needs_input_grad[0]:
        g_images = torch.ops.spt.group_crop_bwd(grad.contiguous(), boxes, h, w, *ctx.crop_hw, ctx.patch, ctx.dtype)
    if ctx.needs_input_grad[1]:
        _, p, v, _ = boxes.shape
        ch, cw = ctx.crop_hw
        g_boxes = bilinear_box_grad(
            grad.reshape(b, p * v, ch, cw, c), images, boxes.reshape(b, p * v, 4),
            lambda bx: _group_coords(bx.reshape(b, p, v, 4), h, w, ctx.crop_hw, ctx.patch),
        ).reshape(b, p, v, 4)
    return g_images, g_boxes, None, None, None


torch.library.register_autograd("spt::group_crop", _group_crop_backward, setup_context=_group_crop_setup,
                                lib=kernels.OPS)


def crop_and_resize_group_einsum_px(
    images: torch.Tensor, boxes_grouped: torch.Tensor, crop_hw, patch: int = 8
) -> torch.Tensor:
    """Group-shared window crop: one [patch, patch, C] window per unit of V
    boxes -> [B, P, V, ch, cw, C], ``torch.ops.spt.group_crop``: kernel C on
    a CUDA tensor, the plain version on a CPU tensor; the gradient reaches
    the images (C-bwd, or its twin) and, where they require it, the boxes."""

    return torch.ops.spt.group_crop(images, boxes_grouped, int(crop_hw[0]), int(crop_hw[1]), int(patch))


def crop_and_resize_patch_einsum_px(images: torch.Tensor, boxes_px: torch.Tensor, crop_hw,
                                    patch: int = 8) -> torch.Tensor:
    """Patch crop: one [patch, patch, C] window per box [B, N, 4] (centred on
    its sample span, clipped to the map) -> [B, N, ch, cw, C], exact bilinear
    while a box spans at most patch - 2 cells. Plain PyTorch on both devices
    (``crop_and_resize_group_plain`` with one box a unit); its backward is
    ``_bilinear_bwd`` at the window-clamped coordinates, as the reference's
    ``_patch_with_vjp``."""

    _, h, w, _ = images.shape
    hw, patch = (int(crop_hw[0]), int(crop_hw[1])), int(patch)
    return _Bilinear.apply(
        images, boxes_px,
        lambda im, bx: crop_and_resize_group_plain(im, bx[:, :, None], hw, patch)[:, :, 0],
        lambda bx: _group_coords(bx[:, :, None], h, w, hw, patch),
    )
