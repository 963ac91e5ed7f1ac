"""SHPL sparse cross-view pooling, plain PyTorch (the reference's kernel A).

Each point gathers one 2x2xC source window at ``cols[..., 0]``, combines the
four taps with its f32 bilinear weights and adds into its target cell; with
``divide_by_weight_sum`` each cell is divided by the sum of its points'
weights where that exceeds 1e-12. Accumulates in f32 with one ``index_add_``.
"""

from __future__ import annotations

import torch


def _gather_point_patches(src_map: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """[B, Hs, Ws, C] + corner indices [B, P, 4] -> corner values [B, P, 4, C]
    from the 2x2 window at ``cols[..., 0]`` (start clamped so it fits; a dim
    of 1 duplicates its row/column)."""

    b, hs, ws, c = src_map.shape
    c00 = cols[..., 0].to(torch.int64)
    sh, sw = (2 if hs > 1 else 1), (2 if ws > 1 else 1)
    v0 = torch.clamp(torch.div(c00, ws, rounding_mode="floor"), 0, hs - sh)
    u0 = torch.clamp(torch.remainder(c00, ws), 0, ws - sw)
    v1, u1 = v0 + sh - 1, u0 + sw - 1
    flat = src_map.reshape(b * hs * ws, c)
    base = (torch.arange(b, device=src_map.device, dtype=torch.int64) * (hs * ws))[:, None]
    idx = torch.stack(
        [base + v0 * ws + u0, base + v0 * ws + u1, base + v1 * ws + u0, base + v1 * ws + u1],
        dim=-1,
    )
    return flat[idx.reshape(-1)].reshape(b, cols.shape[1], 4, c)


def sparse_pool_patch_major_batch(
    src_map: torch.Tensor,  # [B, Hs, Ws, C]
    rows: torch.Tensor,  # [B, P] int32 target row per point
    cols: torch.Tensor,  # [B, P, 4] int32 bilinear-corner indices
    vals: torch.Tensor,  # [B, P, 4] f32 weights (0 on padding)
    num_targets: int,
    divide_by_weight_sum: bool = False,
    accum_dtype: str = "float32",
) -> torch.Tensor:
    """Point-major pooling -> [B, T, C] f32 (``accum_dtype`` is taken for
    the signature's sake: the reference always sums in f32)."""

    del accum_dtype
    b, _, _, c = src_map.shape
    patches = _gather_point_patches(src_map, cols).to(torch.float32)
    g = torch.sum(patches * vals[..., None].to(torch.float32), dim=2)  # [B, P, C]
    if divide_by_weight_sum:
        g = torch.cat([g, torch.sum(vals, dim=-1, keepdim=True).to(torch.float32)], dim=-1)
    n_ch = g.shape[-1]
    ids = (rows.to(torch.int64) + (torch.arange(b, device=rows.device) * num_targets)[:, None]).reshape(-1)
    keep = (ids >= 0) & (ids < b * num_targets)
    flat = torch.zeros(b * num_targets, n_ch, dtype=torch.float32, device=src_map.device)
    flat.index_add_(0, ids[keep], g.reshape(-1, n_ch)[keep])
    flat = flat.reshape(b, num_targets, n_ch)
    if not divide_by_weight_sum:
        return flat
    out, den = flat[..., :c], flat[..., c:]
    return torch.where(den > 1e-12, out / torch.clamp_min(den, 1e-12), 0.0)
