"""Seeded weights made on the device: LeCun-normal kernels truncated at two
standard deviations (fan_in = kh * kw * in; a transposed conv's from its
input channels), zero biases, all drawn in one call from one
``torch.Generator`` on the device. The port loads them with
``load_state_dict``; the reference gets the same float32 tensors."""

from __future__ import annotations

import math
from typing import Dict

import torch

TRUNC_STD = 0.87962566103423978  # std of a standard normal truncated to [-2, 2]


def _cdf(x: float) -> float:
    return (1.0 + math.erf(x / math.sqrt(2.0))) / 2.0


def fan_in(shape, transposed: bool) -> int:
    if transposed:  # ConvTranspose2d weight [in, out, kh, kw]
        return shape[0] * shape[2] * shape[3]
    return math.prod(shape[1:])


@torch.no_grad()
def seeded_state(model: torch.nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    """float32 state dict for ``model``'s parameters from ``seed``."""

    transposed = {f"{n}.weight" for n, m in model.named_modules() if isinstance(m, torch.nn.ConvTranspose2d)}
    shapes = {name: tuple(p.shape) for name, p in model.state_dict().items()}
    weights = [n for n in shapes if n.endswith("weight") and len(shapes[n]) > 1]
    total = sum(math.prod(shapes[n]) for n in weights)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    draw = torch.empty(total, dtype=torch.float32, device=device)
    draw.uniform_(2 * _cdf(-2.0) - 1, 2 * _cdf(2.0) - 1, generator=gen)
    draw = draw.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
    out, lo = {}, 0
    for name, shape in shapes.items():
        if name in weights:
            n = math.prod(shape)
            std = math.sqrt(1.0 / fan_in(shape, name in transposed)) / TRUNC_STD
            out[name] = draw[lo:lo + n].view(shape).mul_(std)
            lo += n
        else:
            out[name] = torch.zeros(shape, dtype=torch.float32, device=device)
    return out
