"""3D grid anchors and the QxQ-block empty-anchor filter.

Port of the main-path half of ``sparse_pooling_tpu.ops.anchors``: the anchor
grid is a host constant (z-major positions, class/rotation variants adjacent
per position); per frame, every variant's footprint occupancy comes from
strided slices of the integral image, whole QxQ position blocks are kept,
and the static cap fills by descending occupancy-count tier
(``_tiered_first_k``). Plain PyTorch; a hand kernel for the compaction is
queued in ROADMAP.md.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from sparse_pooling_tpu_torch.configs.config import AnchorConfig, AreaExtents, BevConfig


def grid_anchor_centers_xz(extents: AreaExtents, stride: float) -> np.ndarray:
    """(Nx*Nz, 2) anchor centres tiled at ``stride`` over the BEV area."""

    xs = np.arange(extents.x_min + stride / 2, extents.x_max, stride)
    zs = np.arange(extents.z_min + stride / 2, extents.z_max, stride)
    gx, gz = np.meshgrid(xs, zs, indexing="ij")
    return np.stack([gx.reshape(-1), gz.reshape(-1)], axis=1)


def generate_anchors_np(
    cfg: AnchorConfig, extents: AreaExtents, ground_plane: np.ndarray
) -> np.ndarray:
    """All grid anchors -> (N, 8) [x, y, z, dim_x, dim_y, dim_z, rot_idx,
    class_idx], z-major position order with variants adjacent."""

    centers = grid_anchor_centers_xz(extents, cfg.stride)
    nx = len(np.arange(extents.x_min + cfg.stride / 2, extents.x_max, cfg.stride))
    nz = centers.shape[0] // nx
    centers = centers.reshape(nx, nz, 2).transpose(1, 0, 2).reshape(-1, 2)
    a, b, c, d = ground_plane
    out = []
    for cls_idx, (l, w, h) in enumerate(cfg.sizes):
        for rot_idx, _ in enumerate(cfg.rotations):
            dim_x, dim_z = (l, w) if rot_idx % 2 == 0 else (w, l)
            n = centers.shape[0]
            x = centers[:, 0]
            z = centers[:, 1]
            y = -(a * x + c * z + d) / b
            out.append(
                np.stack(
                    [
                        x, y, z,
                        np.full(n, dim_x), np.full(n, h), np.full(n, dim_z),
                        np.full(n, rot_idx, dtype=np.float64),
                        np.full(n, cls_idx, dtype=np.float64),
                    ],
                    axis=1,
                )
            )
    stacked = np.stack(out, axis=1)  # [positions, cls*rot, 8]
    return stacked.reshape(-1, stacked.shape[-1])


def grid_shape(cfg: AnchorConfig, extents: AreaExtents) -> Tuple[int, int]:
    """(nz, nx) position-grid dims of the z-major anchor layout."""

    nx = len(np.arange(extents.x_min + cfg.stride / 2, extents.x_max, cfg.stride))
    nz = len(np.arange(extents.z_min + cfg.stride / 2, extents.z_max, cfg.stride))
    return nz, nx


class FilteredAnchors(NamedTuple):
    anchors: torch.Tensor  # [B, max_anchors, 8]
    valid: torch.Tensor  # [B, max_anchors] bool


def _integral_image_2d_batch(grid: torch.Tensor) -> torch.Tensor:
    ii = torch.cumsum(torch.cumsum(grid, dim=1), dim=2)
    return torch.nn.functional.pad(ii, (1, 0, 1, 0))


# Occupancy-count tier multipliers for cap-overflow prioritization, applied
# to density_threshold (descending; the last tier is every nonempty entry).
_TIER_MULTIPLIERS = (64, 16, 4)


def _tiered_first_k(counts: torch.Tensor, nonempty: torch.Tensor, k: int, threshold: int):
    """First-``k`` True entries prioritized by occupancy-count tier, array
    order within a tier. Returns (indices [B, k] (0 where invalid), valid)."""

    b, n = nonempty.shape
    dev = counts.device
    tiers = [t * threshold for t in _TIER_MULTIPLIERS]
    t_rank = sum((counts < t).to(torch.int32) for t in tiers)  # 0 = densest
    rank = torch.zeros((b, n), dtype=torch.int64, device=dev)
    offset = torch.zeros((b, 1), dtype=torch.int64, device=dev)
    for ti in range(len(tiers) + 1):
        flag = nonempty & (t_rank == ti)
        c = torch.cumsum(flag.to(torch.int64), dim=1)
        rank = torch.where(flag, offset + c, rank)
        offset = offset + c[:, -1:]
    total = offset[:, 0]

    slot = rank - 1
    boff = (torch.arange(b, dtype=torch.int64, device=dev) * k)[:, None]
    ids = torch.where(nonempty & (slot < k), boff + slot, b * k)  # sentinel
    idx_src = torch.arange(n, dtype=torch.int64, device=dev).expand(b, n)
    out = torch.zeros(b * k + 1, dtype=torch.int64, device=dev)
    out.index_add_(0, ids.reshape(-1), idx_src.reshape(-1))
    out = out[: b * k].reshape(b, k)
    valid = torch.arange(k, device=dev)[None, :] < torch.clamp_max(total, k)[:, None]
    return torch.where(valid, out, 0), valid


def _compact_positions(
    anchors: torch.Tensor,  # [B, n_pos * variants, 8] position-major
    counts: torch.Tensor,  # [B, n_pos, variants]
    max_anchors: int,
    density_threshold: int,
) -> FilteredAnchors:
    """Tier-compact whole units from per-variant footprint counts."""

    b, n_pos, variants = counts.shape
    max_pos = max_anchors // variants
    nonempty = counts >= density_threshold
    pos_nonempty = nonempty.any(dim=-1)
    pos_counts = counts.amax(dim=-1)
    pos_idx, pos_valid = _tiered_first_k(pos_counts, pos_nonempty, max_pos, density_threshold)

    poff = (torch.arange(b, dtype=torch.int64, device=counts.device) * n_pos)[:, None]
    flat_pos = (pos_idx + poff).reshape(-1)
    picked = anchors.reshape(b * n_pos, variants * anchors.shape[-1])[flat_pos].reshape(
        b, max_anchors, anchors.shape[-1]
    )
    picked_nonempty = nonempty.reshape(b * n_pos, variants)[flat_pos].reshape(
        b, max_pos, variants
    )
    valid = (picked_nonempty & pos_valid[..., None]).reshape(b, max_anchors)
    return FilteredAnchors(anchors=picked, valid=valid)


def grid_occupancy_counts(
    occupancy: torch.Tensor,  # [B, H, W]
    extents: AreaExtents,
    bev_cfg: BevConfig,
    anchor_cfg: AnchorConfig,
) -> torch.Tensor:
    """Per-position, per-variant footprint counts [B, n_pos, V] over the full
    z-major anchor grid from strided slices of the integral image. Requires
    an integer stride/voxel ratio."""

    vs = bev_cfg.voxel_size
    s_cells = anchor_cfg.stride / vs
    if abs(s_cells - round(s_cells)) > 1e-6:
        raise ValueError(
            f"anchor stride {anchor_cfg.stride} is not an integer number of "
            f"{vs} m BEV cells"
        )
    s = int(round(s_cells))
    b, h, w = occupancy.shape
    nz, nx = grid_shape(anchor_cfg, extents)

    half = anchor_cfg.stride / 2.0
    offs = []
    for l, wd, _h in anchor_cfg.sizes:
        for rot_idx, _ in enumerate(anchor_cfg.rotations):
            dim_x, dim_z = (l, wd) if rot_idx % 2 == 0 else (wd, l)
            offs.append((
                int(np.floor((half - dim_z / 2) / vs)),
                int(np.ceil((half + dim_z / 2) / vs)),
                int(np.floor((half - dim_x / 2) / vs)),
                int(np.ceil((half + dim_x / 2) / vs)),
            ))

    pad_t = max(0, -min(o[0] for o in offs))
    pad_b = max(0, (nz - 1) * s + max(o[1] for o in offs) - h)
    pad_l = max(0, -min(o[2] for o in offs))
    pad_r = max(0, (nx - 1) * s + max(o[3] for o in offs) - w)
    ii = _integral_image_2d_batch(occupancy.to(torch.float32))
    ii = torch.nn.functional.pad(
        ii[:, None], (pad_l, pad_r, pad_t, pad_b), mode="replicate"
    )[:, 0]

    def sl(r_off, c_off):
        r0 = pad_t + r_off
        c0 = pad_l + c_off
        return ii[:, r0 : r0 + (nz - 1) * s + 1 : s, c0 : c0 + (nx - 1) * s + 1 : s]

    return torch.stack(
        [sl(r1, c1) - sl(r0, c1) - sl(r1, c0) + sl(r0, c0) for (r0, r1, c0, c1) in offs],
        dim=-1,
    ).reshape(b, nz * nx, len(offs))


def quad_supported(
    anchor_cfg: AnchorConfig,
    bev_cfg: BevConfig,
    extents: AreaExtents,
    max_anchors: int,
    quad: int,
) -> bool:
    """Whether QxQ-block filtering applies (the pipeline and the detector
    must agree: the ROI-group width follows the filter's unit size)."""

    if quad <= 1:
        return False
    s_cells = anchor_cfg.stride / bev_cfg.voxel_size
    if abs(s_cells - round(s_cells)) > 1e-6:
        return False
    variants = len(anchor_cfg.sizes) * len(anchor_cfg.rotations)
    return max_anchors % (quad * quad * variants) == 0


def quad_major(x: torch.Tensor, nz: int, nx: int, quad: int) -> torch.Tensor:
    """[B, nz*nx, ...] position-major -> [B, (nz//Q)*(nx//Q), Q*Q, ...]."""

    b = x.shape[0]
    trail = tuple(x.shape[2:])
    q = quad
    xq = x.reshape(b, nz // q, q, nx // q, q, *trail)
    perm = (0, 1, 3, 2, 4) + tuple(range(5, 5 + len(trail)))
    return xq.permute(*perm).reshape(b, (nz // q) * (nx // q), q * q, *trail)


def filter_anchor_quads_grid(
    anchors: torch.Tensor,  # [B, N, 8] z-major static grid + per-frame y
    occupancy: torch.Tensor,  # [B, H, W]
    extents: AreaExtents,
    bev_cfg: BevConfig,
    anchor_cfg: AnchorConfig,
    max_anchors: int,
    quad: int,
    density_threshold: int = 1,
) -> FilteredAnchors:
    """QxQ-position-block filter: kept units are whole neighbour blocks
    (Q*Q*V anchors adjacent). Non-Q-divisible grids pad with empty
    positions, which are never kept."""

    variants = len(anchor_cfg.sizes) * len(anchor_cfg.rotations)
    counts = grid_occupancy_counts(occupancy, extents, bev_cfg, anchor_cfg)
    nz, nx = grid_shape(anchor_cfg, extents)
    b = anchors.shape[0]
    unit = quad * quad * variants
    if max_anchors % unit:
        raise ValueError(f"max_anchors {max_anchors} not divisible by unit {unit}")
    pz = (-nz) % quad
    px = (-nx) % quad
    counts_g = counts.reshape(b, nz, nx, variants)
    anchors_g = anchors.reshape(b, nz, nx, variants * anchors.shape[-1])
    if pz or px:
        counts_g = torch.nn.functional.pad(counts_g, (0, 0, 0, px, 0, pz))
        # padded positions reuse the edge anchor geometry; never kept
        anchors_g = torch.cat([anchors_g, anchors_g[:, -1:].expand(-1, pz, -1, -1)], dim=1)
        anchors_g = torch.cat([anchors_g, anchors_g[:, :, -1:].expand(-1, -1, px, -1)], dim=2)
    nzq, nxq = nz + pz, nx + px
    counts_q = quad_major(counts_g.reshape(b, nzq * nxq, variants), nzq, nxq, quad).reshape(
        b, -1, unit
    )
    anchors_q = quad_major(
        anchors_g.reshape(b, nzq * nxq, variants * anchors.shape[-1]), nzq, nxq, quad
    ).reshape(b, -1, anchors.shape[-1])
    return _compact_positions(anchors_q, counts_q, max_anchors, density_threshold)
