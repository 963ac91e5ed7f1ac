"""Kernel A (``torch.ops.spt.sparse_pool_patch``, ``csrc/sparse_pool_patch.cu``):
the SHPL pool of both fusion layers."""

from __future__ import annotations

from typing import Dict

import torch

from harness.roofline import least_time, nbytes

PORT = ("sparse_pooling_tpu_torch.ops.sparse_pool", "sparse_pool_patch_kernel")


def bound(src, rows, cols, vals, num_targets, *_) -> Dict[str, float]:
    """Kernel A (``sparse_pool_patch``): the live points' distinct source
    cells, the COO, and the [B, T, C] f32 output; 8C + 4 operations a live
    point (four taps' products and sums over C channels and the weight sum)."""

    b, hs, ws, c = src.shape
    soff = torch.arange(b, device=src.device)[:, None, None] * (hs * ws)
    live = (vals != 0).any(-1)
    touched = torch.unique((cols.long() + soff)[live]).numel()
    need = touched * c * src.element_size() + nbytes(rows, cols, vals) + b * int(num_targets) * c * 4
    return least_time(need, int(live.sum()) * (8 * c + 4))
