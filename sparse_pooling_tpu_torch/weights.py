"""Parameters: carry a flax parameter tree over, or draw a seeded init.

``from_flax`` maps the JAX package's parameter tree (nested dicts of numpy
arrays, e.g. ``jax.tree.map(np.asarray, params)``) of either detector family
(``SparsePoolingDetector`` or ``FusionRcnn``) onto the port's state dict;
module paths match by name, so whatever layers a configuration builds map
across (the late and deep stage-2 layers ``fc{i}_v{vi}`` at their widths; no
``bev_roi_proj`` / ``img_roi_proj`` where the RPN crops are stride 1; the
encoder and decoder under ``backbone.remat``, which keeps their names). It
never imports flax. Conversions:
  * conv kernels HWIO -> OIHW (the rcnn RPN's 1x1 [1, 1, C, 2R] -> [2R, C, 1, 1]);
  * dense kernels (in, out) -> (out, in); ROI features are flattened in
    NHWC (S, S, C) order on both sides, so fc1 needs no permutation;
  * ``nn.ConvTranspose`` kernels (flax does not flip, PyTorch does): flipped
    spatially and laid out (in, out, kh, kw) — see
    ``models.layers.ConvTransposeSame``.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
from torch import nn

from sparse_pooling_tpu_torch.configs.config import ModelConfig
from sparse_pooling_tpu_torch.models.backbone import PyramidDecoder


def _transposed_conv_names(cfg: ModelConfig):
    levels = PyramidDecoder(cfg.backbone.channels, 1, stop_stride=cfg.backbone.decode_stride).levels
    return {f"upconv{level + 1}" for level in levels}


def from_flax(params, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """flax parameter tree (optionally wrapped in {"params": ...}) -> state dict."""

    tree = params.get("params", params)
    upconvs = _transposed_conv_names(cfg)
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        if "kernel" in node:
            name = ".".join(path)
            k = np.asarray(node["kernel"], dtype=np.float32)
            if k.ndim == 4 and path[-1] in upconvs:
                w = k[::-1, ::-1].transpose(2, 3, 0, 1)
            elif k.ndim == 4:
                w = k.transpose(3, 2, 0, 1)
            elif k.ndim == 2:
                w = k.T
            else:
                raise ValueError(f"{name}: unexpected kernel rank {k.ndim}")
            out[f"{name}.weight"] = torch.from_numpy(np.array(w, dtype=np.float32))
            if "bias" in node:
                out[f"{name}.bias"] = torch.from_numpy(np.array(node["bias"], dtype=np.float32))
            return
        for key, child in node.items():
            walk(child, path + (key,))

    walk(tree, ())
    return out


def truncated_normal(shape, generator: torch.Generator) -> torch.Tensor:
    """Standard normal draws truncated to [-2, 2] by the inverse CDF of one
    uniform draw each (f32): ``sqrt(2) * erfinv(u)``, ``u`` uniform over
    ``(erf(-sqrt 2), erf(sqrt 2))``, as ``jax.random.truncated_normal`` and
    PyTorch's ``trunc_normal_`` before 2.13 draw them. Written out here
    because ``trunc_normal_`` of PyTorch 2.13 samples by rejection: the same
    seed then gave other weights under another PyTorch."""

    def cdf(x: float) -> float:  # the standard normal CDF, as trunc_normal_ computed it
        return (1.0 + math.erf(x / math.sqrt(2.0))) / 2.0

    draw = torch.empty(tuple(shape), dtype=torch.float32)
    draw.uniform_(2 * cdf(-2.0) - 1, 2 * cdf(2.0) - 1, generator=generator)
    return draw.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)


@torch.no_grad()
def init_like_flax(model: nn.Module, seed: int = 0) -> None:
    """Seeded init with flax's defaults: LeCun-normal kernels (truncated at
    two standard deviations, fan_in = kh*kw*in) and zero biases, drawn from
    one CPU ``torch.Generator`` in module order (``truncated_normal``: the
    same weights for a seed under any PyTorch version)."""

    gen = torch.Generator().manual_seed(seed)
    for module in model.modules():
        if not isinstance(module, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            continue
        w = module.weight
        if isinstance(module, nn.ConvTranspose2d):
            fan_in = w.shape[0] * w.shape[2] * w.shape[3]
        else:
            fan_in = math.prod(w.shape[1:])
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978  # truncation-corrected
        w.copy_(truncated_normal(w.shape, gen) * std)
        if module.bias is not None:
            module.bias.zero_()
