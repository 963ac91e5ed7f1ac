"""NHWC layer wrappers over PyTorch's NCHW modules.

Each layer's ``lower`` (default None) is the control's precision: a float8
dtype rounds the layer's input and weight to it (per-tensor scale, as fp8
inference scales them) before the layer computes in its own dtype.

The port keeps the JAX package's channels-last layout at every public
function. These layers take and return [B, H, W, C] tensors; inside they run
PyTorch's conv on the ``channels_last`` NCHW view of the same memory (the
permutes are views, and cuDNN keeps the format). Each layer computes in the
dtype it was built with, as a flax layer with ``dtype`` does: it casts its
input, and its parameters where they are kept in another dtype (the trainer
keeps f32 parameters, as flax's ``param_dtype``; serving keeps them in the
compute dtype, where the cast is a no-op).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def lowered(t: torch.Tensor, lower) -> torch.Tensor:
    """``t`` rounded through ``lower`` with a per-tensor scale onto the
    format's largest finite value; ``t`` itself where ``lower`` is None."""

    if lower is None:
        return t
    amax = t.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / torch.finfo(lower).max, torch.ones_like(amax))
    return ((t.float() / scale).to(lower).float() * scale).to(t.dtype)


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class Conv(nn.Conv2d):
    """Stride-1 conv with flax "SAME" padding (odd kernels), NHWC in/out."""

    def __init__(self, cin: int, cout: int, k: int, dtype=torch.float32):
        super().__init__(cin, cout, k, padding=k // 2, dtype=dtype)
        self.compute_dtype = dtype
        self.lower = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cdt = self.compute_dtype
        y = self._conv_forward(to_nchw(lowered(x.to(cdt), self.lower)),
                               lowered(self.weight.to(cdt), self.lower), self.bias.to(cdt))
        return to_nhwc(y)


class ConvTransposeSame(nn.ConvTranspose2d):
    """flax ``nn.ConvTranspose(strides=2, padding="SAME")``, NHWC in/out.

    flax pads the dilated input (2, 1) and does not flip the kernel; PyTorch
    flips it. With the weight stored flipped (``weights.from_flax``) and no
    padding, PyTorch's output is flax's plus one trailing row and column,
    which are cut off.
    """

    def __init__(self, cin: int, cout: int, k: int = 3, stride: int = 2, dtype=torch.float32):
        if k != 3 or stride != 2:
            raise ValueError("ConvTransposeSame covers the 3x3 stride-2 upsampler only")
        super().__init__(cin, cout, k, stride=stride, padding=0, dtype=dtype)
        self.compute_dtype = dtype
        self.lower = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1], x.shape[2]
        cdt = self.compute_dtype
        y = F.conv_transpose2d(to_nchw(lowered(x.to(cdt), self.lower)),
                               lowered(self.weight.to(cdt), self.lower), self.bias.to(cdt),
                               self.stride, self.padding)
        return to_nhwc(y[:, :, : 2 * h, : 2 * w])


class Dense(nn.Linear):
    """flax ``nn.Dense`` with ``dtype`` (default f32): computes in it."""

    def __init__(self, cin: int, cout: int, dtype=torch.float32):
        super().__init__(cin, cout, dtype=dtype)
        self.compute_dtype = dtype
        self.lower = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cdt = self.compute_dtype
        return F.linear(lowered(x.to(cdt), self.lower), lowered(self.weight.to(cdt), self.lower),
                        self.bias.to(cdt))


def max_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    return to_nhwc(F.max_pool2d(to_nchw(x), k, k))


def avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    return to_nhwc(F.avg_pool2d(to_nchw(x), k, k))
