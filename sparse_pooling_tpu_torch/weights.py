"""Parameters: carry a flax parameter tree over, or draw a seeded init.

``from_flax`` maps the JAX package's parameter tree (nested dicts of numpy
arrays, e.g. ``jax.tree.map(np.asarray, params)``) onto the port's state
dict; module paths match by name. It never imports flax. Conversions:
  * conv kernels HWIO -> OIHW;
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


@torch.no_grad()
def init_like_flax(model: nn.Module, seed: int = 0) -> None:
    """Seeded init with flax's defaults: LeCun-normal kernels (truncated at
    two standard deviations, fan_in = kh*kw*in) and zero biases, drawn from
    one CPU ``torch.Generator`` in module order."""

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
        draw = torch.empty(w.shape, dtype=torch.float32)
        nn.init.trunc_normal_(draw, 0.0, 1.0, -2.0, 2.0, generator=gen)
        w.copy_(draw * std)
        if module.bias is not None:
            module.bias.zero_()
