"""Device-side SHPL sparse-correspondence construction (elementwise f32).

Port of ``sparse_pooling_tpu.ops.sparse_build``: every point of the padded
cloud projects onto the BEV and front-view fusion lattices and carries its 4
bilinear source taps inline (point-major COO). There is no scatter and no
matmul here: the P2 projection is expanded elementwise so it stays true f32
on every backend. Row normalization is deferred into the pooling
(``DeviceCoo.defer_row_norm``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from sparse_pooling_tpu_torch.configs.config import (
    AreaExtents,
    BevConfig,
    ImageConfig,
    SparsePoolConfig,
)


@dataclasses.dataclass(frozen=True)
class DeviceCoo:
    """One pooling direction, point-major. Invalid points carry weight 0."""

    rows: torch.Tensor  # [..., P] int32 target linear index per point
    cols: torch.Tensor  # [..., P, 4] int32 source linear indices
    vals: torch.Tensor  # [..., P, 4] f32 weights
    target_hw: Tuple[int, int]
    source_hw: Tuple[int, int]
    # True: vals are raw bilinear weights and the consumer divides the pooled
    # output by the pooled weight sum (exact by linearity)
    defer_row_norm: bool = False


def _to_int32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> int32 truncating toward zero and saturating at the int32 range
    (XLA's convert semantics; a bare ``.to(int32)`` is undefined outside it)."""

    return torch.clamp(x, -2147483648.0, 2147483520.0).to(torch.int32)


def _bilinear_expand(target_idx, src_u, src_v, valid, source_hw):
    """Each (target, continuous source) pair -> 4 point-major taps in corner
    order [v0u0, v0u1, v1u0, v1u1], clamped so the 2x2 window fits."""

    sh, sw = source_hw
    u = torch.clamp(src_u, 0.0, sw - 1.0)
    v = torch.clamp(src_v, 0.0, sh - 1.0)
    u0 = torch.clamp(torch.floor(u).to(torch.int32), 0, max(sw - 2, 0))
    v0 = torch.clamp(torch.floor(v).to(torch.int32), 0, max(sh - 2, 0))
    du = u - u0
    dv = v - v0
    u1 = torch.clamp_max(u0 + 1, sw - 1)
    v1 = torch.clamp_max(v0 + 1, sh - 1)

    cols = torch.stack([v0 * sw + u0, v0 * sw + u1, v1 * sw + u0, v1 * sw + u1], dim=-1)
    w = torch.stack(
        [(1 - dv) * (1 - du), (1 - dv) * du, dv * (1 - du), dv * du], dim=-1
    )
    w = torch.where(valid[..., None], w, 0.0)
    return target_idx, cols, w.to(torch.float32)


def build_coo_device(
    points: torch.Tensor,  # [..., P, 3] f32 camera frame, zero-padded
    mask: torch.Tensor,  # [..., P] bool
    p2: torch.Tensor,  # [..., 3, 4] f32 canvas-scaled projection
    extents: AreaExtents,
    bev_cfg: BevConfig,
    img_cfg: ImageConfig,
    sp_cfg: SparsePoolConfig,
) -> Tuple[DeviceCoo, DeviceCoo]:
    """Per-frame SHPL correspondence, both directions: (M_bev<-fv, M_fv<-bev)."""

    s = float(sp_cfg.fusion_stride)
    bh_f = bev_cfg.padded_hw(extents)[0] // sp_cfg.fusion_stride
    bw_f = bev_cfg.padded_hw(extents)[1] // sp_cfg.fusion_stride
    ih_f = img_cfg.height // sp_cfg.fusion_stride
    iw_f = img_cfg.width // sp_cfg.fusion_stride

    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    valid = (
        mask
        & (x >= extents.x_min) & (x < extents.x_max)
        & (y >= extents.y_min) & (y < extents.y_max)
        & (z >= extents.z_min) & (z < extents.z_max)
    )

    bev_c = (x - extents.x_min) / bev_cfg.voxel_size / s
    bev_r = (z - extents.z_min) / bev_cfg.voxel_size / s

    def pij(i, j):
        return p2[..., i, j][..., None]

    u_n = pij(0, 0) * x + pij(0, 1) * y + pij(0, 2) * z + pij(0, 3)
    v_n = pij(1, 0) * x + pij(1, 1) * y + pij(1, 2) * z + pij(1, 3)
    depth = pij(2, 0) * x + pij(2, 1) * y + pij(2, 2) * z + pij(2, 3)
    valid = valid & (depth > 1e-3)
    safe_depth = torch.where(depth > 1e-3, depth, 1.0)
    fv_u = u_n / safe_depth / s
    fv_v = v_n / safe_depth / s
    valid = valid & (fv_u >= 0) & (fv_u <= iw_f - 1) & (fv_v >= 0) & (fv_v <= ih_f - 1)

    t_bev = (
        torch.clamp(_to_int32(bev_r), 0, bh_f - 1) * bw_f
        + torch.clamp(_to_int32(bev_c), 0, bw_f - 1)
    )
    t_fv = (
        torch.clamp(_to_int32(fv_v), 0, ih_f - 1) * iw_f
        + torch.clamp(_to_int32(fv_u), 0, iw_f - 1)
    )

    rows_b, cols_b, w_b = _bilinear_expand(t_bev, fv_u, fv_v, valid, (ih_f, iw_f))
    rows_f, cols_f, w_f = _bilinear_expand(t_fv, bev_c, bev_r, valid, (bh_f, bw_f))

    defer = bool(sp_cfg.normalize)
    m_bev = DeviceCoo(rows_b, cols_b, w_b, (bh_f, bw_f), (ih_f, iw_f), defer)
    m_fv = DeviceCoo(rows_f, cols_f, w_f, (ih_f, iw_f), (bh_f, bw_f), defer)
    return m_bev, m_fv
