"""SHPL fusion layer: pool the other branch's mid features onto this
branch's lattice (kernel A on the card, its gradient kernel A-bwd),
concatenate, mix with a 1x1 conv.

Port of ``sparse_pooling_tpu.models.fusion.SparsePoolFusion`` (NHWC).
"""

from __future__ import annotations

import torch
from torch import nn

from sparse_pooling_tpu_torch.models.layers import Conv
from sparse_pooling_tpu_torch.ops.sparse_build import DeviceCoo
from sparse_pooling_tpu_torch.ops.sparse_pool import sparse_pool_patch_major_batch


class SparsePoolFusion(nn.Module):
    """``pool_channels`` > 0 (and below the source width) bottlenecks the
    source features with a learned 1x1 conv before pooling."""

    def __init__(self, native_channels: int, source_channels: int, out_channels: int,
                 dtype=torch.bfloat16, pool_channels: int = 0, accum_dtype: str = "float32"):
        super().__init__()
        self.dtype = dtype
        self.accum_dtype = accum_dtype
        pooled = source_channels
        if pool_channels and source_channels > pool_channels:
            self.pool_proj = Conv(source_channels, pool_channels, 1, dtype)
            pooled = pool_channels
        self.mix1x1 = Conv(native_channels + pooled, out_channels, 1, dtype)

    def forward(self, native: torch.Tensor, source: torch.Tensor, coo: DeviceCoo) -> torch.Tensor:
        """native [B, Ht, Wt, C], source [B, Hs, Ws, C] -> [B, Ht, Wt, out]."""

        b = native.shape[0]
        ht, wt = coo.target_hw
        src = source.to(self.dtype)
        if hasattr(self, "pool_proj"):
            src = self.pool_proj(src)
        pooled = sparse_pool_patch_major_batch(
            src.contiguous(), coo.rows, coo.cols, coo.vals, num_targets=ht * wt,
            divide_by_weight_sum=coo.defer_row_norm, accum_dtype=self.accum_dtype,
        )
        pooled_map = pooled.reshape(b, ht, wt, -1).to(self.dtype)
        x = torch.cat([native.to(self.dtype), pooled_map], dim=-1)
        return torch.relu(self.mix1x1(x))
