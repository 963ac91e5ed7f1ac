"""Host bilinear image resize, byte-equal to Pillow's ``Image.resize(size,
Image.BILINEAR)`` of an RGB image (numpy only).

The JAX package resizes a raw image on the host with PIL where it does not
fit the canvas, or where ``image.device_resize`` is off
(``sparse_pooling_tpu/data/dataset.py``). The port may not import PIL, so
this module repeats Pillow's convolution resampler (``Resample.c``):

* ``precompute_coeffs``: for each output pixel the triangle filter (support
  1) over the input pixels whose centres lie within the support, the support
  and the filter's argument scaled by the reduction factor when shrinking;
  the taps normalised to sum 1, in double precision, summed in tap order;
* ``normalize_coeffs_8bpc``: each tap as a fixed point of
  ``PRECISION_BITS = 32 - 8 - 2`` fraction bits, rounded half away from zero
  (``(int)(0.5 + k * 2^22)``, ``(int)(-0.5 + ...)`` for a negative tap);
* the horizontal pass first, into an 8-bit intermediate, then the vertical
  pass; a pass runs only where its axis changes size (Pillow runs the
  horizontal one over the rows the vertical one reads: without a crop box,
  every row);
* each output ``clip8((1 << (PRECISION_BITS - 1)) + sum)``: the sum shifted
  right by ``PRECISION_BITS``, clamped to [0, 255].

Each pass is a banded product: for every tap position, one gather of the
input columns (or rows) and one multiply-add of int32 across the image. The
sums stay below 2^31 (255 * 2^22 times a tap sum of about 1), as Pillow's
``int`` accumulators do.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np

PRECISION_BITS = 32 - 8 - 2


@functools.lru_cache(maxsize=64)
def coefficients(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pillow's ``precompute_coeffs`` with the bilinear filter and
    ``normalize_coeffs_8bpc`` -> (first input index [out] int64, tap count
    [out] int64, fixed-point taps [out, ksize] int32, zero past the count)."""

    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    ss = 1.0 / filterscale
    center = (np.arange(out_size) + 0.5) * scale
    # C's (int) truncates toward zero; a negative start clamps to 0 either way
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5), in_size).astype(np.int64) - xmin
    taps = np.zeros((out_size, ksize), np.float64)
    ww = np.zeros(out_size, np.float64)
    for x in range(ksize):  # tap order, as the C loop sums them
        arg = np.abs(((x + xmin) - center + 0.5) * ss)
        w = np.where((x < xmax) & (arg < 1.0), 1.0 - arg, 0.0)
        taps[:, x] = w
        ww = ww + w
    taps = np.where(ww[:, None] != 0.0, taps / np.where(ww == 0.0, 1.0, ww)[:, None], taps)
    taps[np.arange(ksize)[None, :] >= xmax[:, None]] = 0.0
    one = float(1 << PRECISION_BITS)
    fixed = np.where(taps < 0, np.trunc(-0.5 + taps * one), np.trunc(0.5 + taps * one))
    return xmin, xmax, fixed.astype(np.int32)


def _pass(img: np.ndarray, axis: int, out_size: int) -> np.ndarray:
    """One resampling pass of a [H, W, C] uint8 image along ``axis`` (0 rows,
    1 columns) -> uint8 with ``out_size`` along it."""

    xmin, _, taps = coefficients(img.shape[axis], out_size)
    last = img.shape[axis] - 1
    acc = np.full(img.shape[:axis] + (out_size,) + img.shape[axis + 1:], 1 << (PRECISION_BITS - 1),
                  np.int32)
    shape = (-1, 1, 1) if axis == 0 else (1, -1, 1)
    for k in range(taps.shape[1]):
        idx = np.minimum(xmin + k, last)  # past the count the tap is 0
        acc += np.take(img, idx, axis=axis).astype(np.int32) * taps[:, k].reshape(shape)
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bilinear(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """[H, W, 3] uint8 -> [height, width, 3] uint8, byte-equal to
    ``np.asarray(Image.fromarray(img).resize((width, height),
    Image.BILINEAR))``."""

    if img.dtype != np.uint8 or img.ndim != 3:
        raise TypeError(f"resize_bilinear takes an [H, W, C] uint8 image, got {img.dtype} {img.shape}")
    out = img
    if width != img.shape[1]:
        out = _pass(out, 1, width)
    if height != img.shape[0]:
        out = _pass(out, 0, height)
    return out if out is not img else img.copy()
