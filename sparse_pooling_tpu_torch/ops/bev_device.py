"""Device-side BEV voxelization straight into space-to-depth layout.

Port of ``sparse_pooling_tpu.ops.bev_device.bev_maps_packed_batch`` and
``unpack_s2d_raster``: per point, key the packed cell
``(row//2, col//2, sub = (row%2)*2 + col%2)``; the density channel comes from
a count scatter-add and each height slice from a scatter-amax. Plain PyTorch
(``index_add_`` / ``scatter_reduce_``); a hand kernel is queued in ROADMAP.md.
"""

from __future__ import annotations

import math

import torch

from sparse_pooling_tpu_torch.configs.config import AreaExtents, BevConfig


def _valid_mask(x, y, z, mask, extents: AreaExtents):
    return (
        mask
        & (x >= extents.x_min) & (x < extents.x_max)
        & (y >= extents.y_min) & (y < extents.y_max)
        & (z >= extents.z_min) & (z < extents.z_max)
    )


def bev_maps_packed_batch(
    points: torch.Tensor,  # [B, P, 3] f32
    mask: torch.Tensor,  # [B, P] bool
    ground_plane: torch.Tensor,  # [B, 4] f32
    extents: AreaExtents,
    cfg: BevConfig,
):
    """Returns ``(packed, counts)``: packed [B, (H+pad)/2, W/2, 4*(slices+1)]
    f32 (channel = sub*(slices+1) + c) and per-cell counts
    [B, (H+pad)/2, W/2, 4] f32."""

    bsz, npts = points.shape[0], points.shape[1]
    h, w = cfg.grid_hw(extents)
    hp = h + cfg.pad_h
    if hp % 2 or w % 2:
        raise ValueError(f"packed voxelizer needs even dims, got {hp}x{w}")
    h2, w2 = hp // 2, w // 2
    ns = cfg.height_slices
    dev = points.device
    x, y, z = points[..., 0], points[..., 1], points[..., 2]

    valid = _valid_mask(x, y, z, mask, extents)
    col = torch.clamp(torch.floor((x - extents.x_min) / cfg.voxel_size).to(torch.int64), 0, w - 1)
    row = torch.clamp(torch.floor((z - extents.z_min) / cfg.voxel_size).to(torch.int64), 0, h - 1)
    kd = ((row // 2) * w2 + col // 2) * 4 + (row % 2) * 2 + col % 2
    nkd = h2 * w2 * 4
    b_off = (torch.arange(bsz, device=dev, dtype=torch.int64) * (nkd + 1))[:, None]

    # density: count scatter-add (one sentinel segment per frame)
    dens_idx = (torch.where(valid, kd, nkd) + b_off).reshape(-1)
    counts = torch.zeros(bsz * (nkd + 1), dtype=torch.float32, device=dev)
    counts.index_add_(0, dens_idx, torch.ones_like(dens_idx, dtype=torch.float32))
    counts_b = counts.reshape(bsz, nkd + 1)[:, :nkd].reshape(bsz, h2, w2, 4)
    density = torch.clamp_max(
        torch.log(counts_b + 1.0) / math.log(cfg.density_log_norm), 1.0
    )[..., None]

    # height slices: per-(cell, slice) max of (height - slice bottom);
    # empty segments stay -inf and clamp to 0, as the JAX segment_max does
    gp = ground_plane[:, :, None]
    heights = x * gp[:, 0] + y * gp[:, 1] + z * gp[:, 2] + gp[:, 3] - cfg.height_lo
    slice_h = (cfg.height_hi - cfg.height_lo) / ns
    s_idx = torch.floor(heights / slice_h).to(torch.int64)
    s_valid = valid & (s_idx >= 0) & (s_idx < ns)
    rel_h = heights - s_idx.to(heights.dtype) * slice_h
    nks = nkd * ns
    s_off = (torch.arange(bsz, device=dev, dtype=torch.int64) * (nks + 1))[:, None]
    slice_lin = (torch.where(s_valid, kd * ns + s_idx, nks) + s_off).reshape(-1)
    slice_max = torch.full((bsz * (nks + 1),), -math.inf, dtype=torch.float32, device=dev)
    slice_max.scatter_reduce_(
        0, slice_lin, torch.where(s_valid, rel_h, 0.0).to(torch.float32).reshape(-1),
        reduce="amax", include_self=True,
    )
    slice_maps = (
        torch.clamp_min(slice_max.reshape(bsz, nks + 1)[:, :nks], 0.0).reshape(
            bsz, h2, w2, 4, ns
        )
        / slice_h
    )
    packed = torch.cat([slice_maps, density], dim=-1).reshape(bsz, h2, w2, 4 * (ns + 1))
    return packed, counts_b


def unpack_s2d_raster(grid: torch.Tensor, content_h: int) -> torch.Tensor:
    """[B, H2, W2, 4] packed per-cell raster -> [B, content_h, W] full-res."""

    b, h2, w2, _ = grid.shape
    full = grid.reshape(b, h2, w2, 2, 2).permute(0, 1, 3, 2, 4).reshape(b, h2 * 2, w2 * 2)
    return full[:, :content_h]
