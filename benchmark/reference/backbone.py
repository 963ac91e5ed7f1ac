"""VGG-pyramid feature extractors (NHWC at the public functions).

Port of ``sparse_pooling_tpu.models.backbone``: a VGG encoder (stages of 3x3
convs with 2x max-pool between; with space-to-depth the input arrives packed
2x2 into channels and the first pool is skipped) and a decoder that
upsamples with 3x3 stride-2 transposed convs, concatenates the encoder skip,
mixes with a 3x3 conv and ends in a 1x1 bottleneck, stopping at
``decode_stride``. Layer names follow the flax modules, so a flax parameter
tree maps onto the state dict by path (``weights.from_flax``). With
``remat`` (``backbone.remat``, the reference's ``nn.remat`` of the encoder
and of the decoder) each runs under ``torch.utils.checkpoint`` where autograd
records: only its inputs and outputs stay live for the backward, its inner
activations are recomputed.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .layers import Conv, ConvTransposeSame, max_pool


class VggEncoder(nn.Module):
    def __init__(self, in_channels: int, channels: Sequence[int], blocks: Sequence[int],
                 dtype=torch.bfloat16, space_to_depth: bool = False):
        super().__init__()
        self.channels, self.blocks = tuple(channels), tuple(blocks)
        self.space_to_depth = space_to_depth
        cin = in_channels
        for stage, (ch, nb) in enumerate(zip(channels, blocks)):
            for b in range(nb):
                self.add_module(f"conv{stage + 1}_{b + 1}", Conv(cin, ch, 3, dtype))
                cin = ch

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """[B, H, W, Cin] (already packed with space-to-depth) -> per-stage
        maps; the last is the mid representation."""

        skips = []
        for stage, nb in enumerate(self.blocks):
            if stage > 0 and not (stage == 1 and self.space_to_depth):
                x = max_pool(x, 2)
            for b in range(nb):
                x = torch.relu(getattr(self, f"conv{stage + 1}_{b + 1}")(x))
            skips.append(x)
        return skips


class PyramidDecoder(nn.Module):
    def __init__(self, channels: Sequence[int], out_channels: int, dtype=torch.bfloat16,
                 stop_stride: int = 1):
        super().__init__()
        self.channels = tuple(channels)
        self.stop_level = int(math.log2(stop_stride))
        if 2**self.stop_level != stop_stride:
            raise ValueError("stop_stride must be 2^k")
        cin = self.channels[-1]
        for level in self.levels:
            ch = self.channels[level]
            self.add_module(f"upconv{level + 1}", ConvTransposeSame(cin, ch, dtype=dtype))
            self.add_module(f"pyramid_fusion{level + 1}", Conv(2 * ch, ch, 3, dtype))
            cin = ch
        self.bottleneck = Conv(cin, out_channels, 1, dtype)

    @property
    def levels(self):
        return range(len(self.channels) - 2, self.stop_level - 1, -1)

    def forward(self, mid: torch.Tensor, skips: List[torch.Tensor]) -> torch.Tensor:
        x = mid
        for level in self.levels:
            x = torch.relu(getattr(self, f"upconv{level + 1}")(x))
            x = torch.cat([x, skips[level].to(x.dtype)], dim=-1)
            x = torch.relu(getattr(self, f"pyramid_fusion{level + 1}")(x))
        return self.bottleneck(x)


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, H/2, W/2, 4C], channel = ((row%2)*2 + col%2)*C + c."""

    b, h, w, c = x.shape
    if h % 2 or w % 2:
        raise ValueError(
            f"space_to_depth needs even input dims, got {h}x{w}: raise bev.pad_h "
            "(or disable backbone.space_to_depth) for odd lattices"
        )
    return x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5).reshape(
        b, h // 2, w // 2, 4 * c
    )


class VggPyramidExtractor(nn.Module):
    """Encoder + decoder of one branch; ``encode`` exposes the mid features
    so the caller can fuse across branches before ``decode``."""

    def __init__(self, in_channels: int, channels: Sequence[int], blocks: Sequence[int],
                 out_channels: int, dtype=torch.bfloat16, decode_stride: int = 1,
                 space_to_depth: bool = False, remat: bool = False):
        super().__init__()
        if space_to_depth and decode_stride < 2:
            raise ValueError(
                "space_to_depth moves the stage-1 features to stride 2, so the "
                "decoder cannot produce a stride-1 map; use decode_stride >= 2"
            )
        self.space_to_depth, self.dtype, self.remat = space_to_depth, dtype, remat
        enc_in = 4 * in_channels if space_to_depth else in_channels
        self.encoder = VggEncoder(enc_in, channels, blocks, dtype, space_to_depth)
        self.decoder = PyramidDecoder(channels, out_channels, dtype, stop_stride=decode_stride)

    def encode(self, x: torch.Tensor, pre_packed: bool = False) -> Tuple[torch.Tensor, list]:
        """``pre_packed``: the input is already [B, H/2, W/2, 4C] (the packed
        voxelizer's output)."""

        if self.space_to_depth and not pre_packed:
            x = space_to_depth(x)
        elif pre_packed and not self.space_to_depth:
            raise ValueError("pre_packed input requires space_to_depth=True")
        skips = self._run(self.encoder, x.to(self.dtype))
        return skips[-1], skips[:-1]

    def decode(self, mid: torch.Tensor, skips) -> torch.Tensor:
        return self._run(self.decoder, mid, skips)

    def _run(self, module: nn.Module, *args):
        if self.remat and torch.is_grad_enabled():
            return checkpoint(module, *args, use_reentrant=False)
        return module(*args)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mid, skips = self.encode(x)
        return self.decode(mid, skips)
