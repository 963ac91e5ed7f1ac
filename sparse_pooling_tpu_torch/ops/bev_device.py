"""Device-side BEV voxelization: the full-resolution raster, or straight
into space-to-depth layout.

Port of ``sparse_pooling_tpu.ops.bev_device``: per point, the cell
``(row, col)`` of the BEV lattice; the density channel comes from a count
scatter-add and each height slice from a scatter-amax.
``bev_maps_from_points_batch`` writes [B, H+pad, W, slices+1];
``bev_maps_packed_batch`` keys the packed cell ``(row//2, col//2,
sub = (row%2)*2 + col%2)`` so the full raster never exists (the same values,
space-to-depth'ed); ``bev_counts_from_points`` is the anchor filter's
per-cell count raster; ``bev_occupancy_batch`` is ContFuse's (PIXOR's)
occupancy of voxels as tall as they are wide, a scatter of ones;
``bev_intensity_batch`` is MV3D's intensity channel,
the reflectance of each cell's highest point (``cell_winner``: a
scatter-amax, then the lowest index among the points that reach it). Plain
PyTorch (``index_add_`` / ``scatter_reduce_``); a hand kernel is queued in
ROADMAP.md.
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


def points_in_extents(points: torch.Tensor, mask: torch.Tensor, extents: AreaExtents) -> torch.Tensor:
    """The points [B, P, >=3] that the BEV maps count: ``mask`` [B, P] and
    inside the area extents."""

    return _valid_mask(points[..., 0], points[..., 1], points[..., 2], mask, extents)


def _cells(points, mask, extents: AreaExtents, voxel_size: float, h: int, w: int):
    """(valid [B, P], row, col [B, P] int64 clipped to the lattice)."""

    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    valid = _valid_mask(x, y, z, mask, extents)
    col = torch.clamp(torch.floor((x - extents.x_min) / voxel_size).to(torch.int64), 0, w - 1)
    row = torch.clamp(torch.floor((z - extents.z_min) / voxel_size).to(torch.int64), 0, h - 1)
    return valid, row, col


def _segment_counts(keys: torch.Tensor, valid: torch.Tensor, n_keys: int) -> torch.Tensor:
    """Points per key [B, n_keys] f32 (one sentinel segment per frame)."""

    bsz = keys.shape[0]
    off = (torch.arange(bsz, device=keys.device, dtype=torch.int64) * (n_keys + 1))[:, None]
    ids = (torch.where(valid, keys, n_keys) + off).reshape(-1)
    counts = torch.zeros(bsz * (n_keys + 1), dtype=torch.float32, device=keys.device)
    counts.index_add_(0, ids, torch.ones_like(ids, dtype=torch.float32))
    return counts.reshape(bsz, n_keys + 1)[:, :n_keys]


def cell_winner(keys: torch.Tensor, values: torch.Tensor, valid: torch.Tensor, n_keys: int,
                largest: bool) -> torch.Tensor:
    """Per key, the index of the valid point whose value is the key's
    largest (``largest``) or smallest, ties to the lowest point index:
    keys, values, valid [B, P] -> [B, n_keys] int64, P where no valid point
    has the key. Two scatter reductions, each independent of the order of
    the points."""

    bsz, p = keys.shape
    fill = -math.inf if largest else math.inf
    off = (torch.arange(bsz, device=keys.device, dtype=torch.int64) * (n_keys + 1))[:, None]
    ids = (torch.where(valid, keys, n_keys) + off).reshape(-1)
    vals = torch.where(valid, values.to(torch.float32), fill).reshape(-1)
    best = torch.full((bsz * (n_keys + 1),), fill, dtype=torch.float32, device=keys.device)
    best.scatter_reduce_(0, ids, vals, reduce="amax" if largest else "amin", include_self=True)
    on_best = valid.reshape(-1) & (vals == best[ids])
    index = torch.arange(p, device=keys.device, dtype=torch.int64).expand(bsz, p).reshape(-1)
    win = torch.full((bsz * (n_keys + 1),), p, dtype=torch.int64, device=keys.device)
    win.scatter_reduce_(0, ids, torch.where(on_best, index, p), reduce="amin", include_self=True)
    return win.reshape(bsz, n_keys + 1)[:, :n_keys]


def gather_points(features: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """features [B, P, C] at index [B, K] (P: a zero row) -> [B, K, C]."""

    padded = torch.nn.functional.pad(features, (0, 0, 0, 1))
    return torch.gather(padded, 1, index[..., None].expand(-1, -1, features.shape[-1]))


def ground_heights(points: torch.Tensor, ground_plane: torch.Tensor) -> torch.Tensor:
    """Each point's height above its frame's ground plane: [B, P]."""

    gp = ground_plane[:, :, None]
    return points[..., 0] * gp[:, 0] + points[..., 1] * gp[:, 1] + points[..., 2] * gp[:, 2] + gp[:, 3]


def _slice_maxima(points, ground_plane, valid, keys, n_keys: int, cfg: BevConfig) -> torch.Tensor:
    """Per-(key, slice) max of (height - slice bottom) over slice height
    [B, n_keys, slices] f32; empty segments stay -inf and clamp to 0, as the
    JAX segment_max does."""

    bsz = points.shape[0]
    ns = cfg.height_slices
    heights = ground_heights(points, ground_plane) - cfg.height_lo
    slice_h = (cfg.height_hi - cfg.height_lo) / ns
    s_idx = torch.floor(heights / slice_h).to(torch.int64)
    s_valid = valid & (s_idx >= 0) & (s_idx < ns)
    rel_h = heights - s_idx.to(heights.dtype) * slice_h
    nks = n_keys * ns
    off = (torch.arange(bsz, device=points.device, dtype=torch.int64) * (nks + 1))[:, None]
    lin = (torch.where(s_valid, keys * ns + s_idx, nks) + off).reshape(-1)
    smax = torch.full((bsz * (nks + 1),), -math.inf, dtype=torch.float32, device=points.device)
    smax.scatter_reduce_(0, lin, torch.where(s_valid, rel_h, 0.0).to(torch.float32).reshape(-1),
                         reduce="amax", include_self=True)
    return torch.clamp_min(smax.reshape(bsz, nks + 1)[:, :nks], 0.0).reshape(bsz, n_keys, ns) / slice_h


def _density(counts: torch.Tensor, cfg: BevConfig) -> torch.Tensor:
    return torch.clamp_max(torch.log(counts + 1.0) / math.log(cfg.density_log_norm), 1.0)


def bev_maps_from_points_batch(
    points: torch.Tensor,  # [B, P, 3] f32
    mask: torch.Tensor,  # [B, P] bool
    ground_plane: torch.Tensor,  # [B, 4] f32
    extents: AreaExtents,
    cfg: BevConfig,
) -> torch.Tensor:
    """The unpacked voxelizer: [B, H+pad, W, slices+1] f32, the height
    slices then the density, ``pad_h`` zero rows below the content."""

    bsz = points.shape[0]
    h, w = cfg.grid_hw(extents)
    valid, row, col = _cells(points, mask, extents, cfg.voxel_size, h, w)
    lin = row * w + col
    density = _density(_segment_counts(lin, valid, h * w), cfg)[..., None]
    slices = _slice_maxima(points, ground_plane, valid, lin, h * w, cfg)
    out = torch.cat([slices, density], dim=-1).reshape(bsz, h, w, cfg.height_slices + 1)
    return torch.nn.functional.pad(out, (0, 0, 0, 0, 0, cfg.pad_h))


def bev_maps_batch(points, mask, ground_plane, extents: AreaExtents, cfg: BevConfig) -> torch.Tensor:
    """Batch variant: [B, P, 3], [B, P], [B, 4] -> [B, H+pad, W, C]."""

    return bev_maps_from_points_batch(points, mask, ground_plane, extents, cfg)


def bev_counts_from_points(
    points: torch.Tensor,  # [B, P, 3]
    mask: torch.Tensor,  # [B, P]
    extents: AreaExtents,
    voxel_size: float,
) -> torch.Tensor:
    """Per-cell point counts [B, H, W] f32 (the anchor filter's occupancy
    raster where ``density_threshold`` > 1)."""

    h = int(round((extents.z_max - extents.z_min) / voxel_size))
    w = int(round((extents.x_max - extents.x_min) / voxel_size))
    valid, row, col = _cells(points, mask, extents, voxel_size, h, w)
    return _segment_counts(row * w + col, valid, h * w).reshape(points.shape[0], h, w)


def bev_maps_packed_batch(
    points: torch.Tensor,  # [B, P, 3] f32
    mask: torch.Tensor,  # [B, P] bool
    ground_plane: torch.Tensor,  # [B, 4] f32
    extents: AreaExtents,
    cfg: BevConfig,
):
    """Returns ``(packed, counts)``: packed [B, (H+pad)/2, W/2, 4*(slices+1)]
    f32 (channel = sub*(slices+1) + c; ``space_to_depth`` of
    ``bev_maps_from_points_batch``, bit for bit) and per-cell counts
    [B, (H+pad)/2, W/2, 4] f32."""

    bsz = points.shape[0]
    h, w = cfg.grid_hw(extents)
    hp = h + cfg.pad_h
    if hp % 2 or w % 2:
        raise ValueError(f"packed voxelizer needs even dims, got {hp}x{w}")
    h2, w2 = hp // 2, w // 2
    ns = cfg.height_slices
    valid, row, col = _cells(points, mask, extents, cfg.voxel_size, h, w)
    kd = ((row // 2) * w2 + col // 2) * 4 + (row % 2) * 2 + col % 2
    nkd = h2 * w2 * 4
    counts_b = _segment_counts(kd, valid, nkd).reshape(bsz, h2, w2, 4)
    slice_maps = _slice_maxima(points, ground_plane, valid, kd, nkd, cfg).reshape(bsz, h2, w2, 4, ns)
    packed = torch.cat([slice_maps, _density(counts_b, cfg)[..., None]], dim=-1)
    return packed.reshape(bsz, h2, w2, 4 * (ns + 1)), counts_b


def unpack_s2d_raster(grid: torch.Tensor, content_h: int) -> torch.Tensor:
    """[B, H2, W2, 4] packed per-cell raster -> [B, content_h, W] full-res."""

    b, h2, w2, _ = grid.shape
    full = grid.reshape(b, h2, w2, 2, 2).permute(0, 1, 3, 2, 4).reshape(b, h2 * 2, w2 * 2)
    return full[:, :content_h]


def bev_occupancy_batch(
    points: torch.Tensor,  # [B, P, >=3] f32
    mask: torch.Tensor,  # [B, P] bool
    ground_plane: torch.Tensor,  # [B, 4] f32
    extents: AreaExtents,
    cfg: BevConfig,
    height_lo: float,
    height_hi: float,
) -> torch.Tensor:
    """ContFuse's BEV occupancy (PIXOR's representation): [B, H+pad, W, N]
    f32, 1 where a valid point lies in the voxel, else 0. The N voxels of a
    cell stack ``cfg.voxel_size`` apart from ``height_lo`` above the ground
    plane: a point of height h above it is in voxel floor((h - height_lo) /
    voxel_size) where that lies in [0, N), N = round((height_hi -
    height_lo) / voxel_size); ``pad_h`` zero rows below the content."""

    bsz = points.shape[0]
    h, w = cfg.grid_hw(extents)
    n = int(round((height_hi - height_lo) / cfg.voxel_size))
    valid, row, col = _cells(points, mask, extents, cfg.voxel_size, h, w)
    level = torch.floor((ground_heights(points, ground_plane) - height_lo) / cfg.voxel_size).to(torch.int64)
    inside = valid & (level >= 0) & (level < n)
    nk = h * w * n
    off = (torch.arange(bsz, device=points.device, dtype=torch.int64) * (nk + 1))[:, None]
    ids = (torch.where(inside, (row * w + col) * n + level, nk) + off).reshape(-1)
    occ = torch.zeros(bsz * (nk + 1), dtype=torch.float32, device=points.device)
    occ.index_fill_(0, ids, 1.0)
    out = occ.reshape(bsz, nk + 1)[:, :nk].reshape(bsz, h, w, n)
    return torch.nn.functional.pad(out, (0, 0, 0, 0, 0, cfg.pad_h))


def bev_intensity_batch(
    points: torch.Tensor,  # [B, P, 4] f32, intensity last
    mask: torch.Tensor,  # [B, P] bool
    ground_plane: torch.Tensor,  # [B, 4] f32
    extents: AreaExtents,
    cfg: BevConfig,
) -> torch.Tensor:
    """MV3D's BEV intensity channel: [B, H+pad, W, 1] f32, the intensity of
    each cell's highest point above the ground plane (ties to the lowest
    point index) over the points the height maps count, 0 where the cell is
    empty; ``pad_h`` zero rows below the content."""

    bsz = points.shape[0]
    h, w = cfg.grid_hw(extents)
    valid, row, col = _cells(points, mask, extents, cfg.voxel_size, h, w)
    win = cell_winner(row * w + col, ground_heights(points, ground_plane), valid, h * w, largest=True)
    out = gather_points(points[..., 3:4], win).reshape(bsz, h, w, 1)
    return torch.nn.functional.pad(out, (0, 0, 0, 0, 0, cfg.pad_h))
