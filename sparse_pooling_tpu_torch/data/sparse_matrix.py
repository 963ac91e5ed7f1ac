"""SHPL sparse cross-view correspondence builder (host, numpy).

THE novel op of the reference, host side (fork code in
``avod/datasets/kitti/kitti_utils.py`` + ``avod/core/sparse_pool_utils.py``):
every LiDAR point is observed on both the BEV lattice and the front-view
image lattice, so the scan + calibration define a sparse matrix
``M in R^(T x S)`` with bilinear weights that pools source-view features into
target-view cells: ``fused = M @ reshape(src_features, [S, C])``. The
reference materializes per-frame ``tf.SparseTensor`` COO inputs.

TPU-first redesign: COO + sparse matmul is scatter-shaped and hostile to XLA,
so alongside the COO oracle this module compiles the correspondence to a
fixed-capacity **ELL table** — for every target cell, up to K
(source index, weight) pairs, dense arrays ``src[T, K] int32, w[T, K] f32`` —
turning the device op into a dense gather + weighted sum with zero scatter
and fully static shapes (see ``sparse_pooling_tpu_torch.ops.ell_sparse_pool``).

Both directions are built per frame: M_bev<-fv and M_fv<-bev.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from sparse_pooling_tpu_torch.configs.config import AreaExtents, BevConfig, ImageConfig, SparsePoolConfig
from sparse_pooling_tpu_torch.data.calib import project_to_image


@dataclasses.dataclass
class SparseCorrespondence:
    """One pooling direction, in both COO (oracle) and ELL (device) forms.

    COO arrays are padded to a static capacity with ``nnz`` marking the valid
    prefix (padding rows/cols are 0 with weight 0).
    """

    target_hw: Tuple[int, int]
    source_hw: Tuple[int, int]
    # COO (row-normalized):
    rows: np.ndarray  # (cap,) int32 target linear index
    cols: np.ndarray  # (cap,) int32 source linear index
    vals: np.ndarray  # (cap,) float32
    nnz: int
    # ELL (row-normalized, top-K by weight):
    ell_src: np.ndarray  # (T, K) int32
    ell_w: np.ndarray  # (T, K) float32


def _bilinear_pairs(
    target_idx: np.ndarray,  # (N,) int64 linear target cell per point
    src_uv: np.ndarray,  # (N, 2) continuous source coords (u=col, v=row)
    source_hw: Tuple[int, int],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Expand each (target, continuous-source) pair into 4 bilinear entries."""

    sh, sw = source_hw
    u = np.clip(src_uv[:, 0], 0.0, sw - 1.0)
    v = np.clip(src_uv[:, 1], 0.0, sh - 1.0)
    u0 = np.clip(np.floor(u).astype(np.int64), 0, sw - 2) if sw > 1 else np.zeros_like(u, dtype=np.int64)
    v0 = np.clip(np.floor(v).astype(np.int64), 0, sh - 2) if sh > 1 else np.zeros_like(v, dtype=np.int64)
    du = u - u0
    dv = v - v0

    rows = np.repeat(target_idx, 4)
    cols = np.empty((target_idx.shape[0], 4), dtype=np.int64)
    vals = np.empty((target_idx.shape[0], 4), dtype=np.float64)
    cols[:, 0] = v0 * sw + u0
    vals[:, 0] = (1 - dv) * (1 - du)
    cols[:, 1] = v0 * sw + np.minimum(u0 + 1, sw - 1)
    vals[:, 1] = (1 - dv) * du
    cols[:, 2] = np.minimum(v0 + 1, sh - 1) * sw + u0
    vals[:, 2] = dv * (1 - du)
    cols[:, 3] = np.minimum(v0 + 1, sh - 1) * sw + np.minimum(u0 + 1, sw - 1)
    vals[:, 3] = dv * du
    return rows, cols.reshape(-1), vals.reshape(-1)


def _dedup_normalize(
    rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, target_size: int, normalize: bool
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sum duplicate (row, col) entries; optionally L1-normalize each row.

    Row normalization makes the pooled feature an average over contributing
    source pixels (the reference normalizes multi-point cells the same way).
    """

    if rows.size == 0:
        return rows.astype(np.int64), cols.astype(np.int64), vals.astype(np.float64)
    keep = vals > 1e-12
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    key = rows * np.int64(2**31) + cols  # source lattices are far below 2^31
    uniq, inv = np.unique(key, return_inverse=True)
    v = np.zeros(uniq.shape[0], dtype=np.float64)
    np.add.at(v, inv, vals)
    r = (uniq // np.int64(2**31)).astype(np.int64)
    c = (uniq % np.int64(2**31)).astype(np.int64)
    if normalize:
        row_tot = np.zeros((target_size,), dtype=np.float64)
        np.add.at(row_tot, r, v)
        v = v / row_tot[r]
    return r, c, v


def _to_ell(
    rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
    target_size: int, k: int, renormalize: bool,
) -> Tuple[np.ndarray, np.ndarray]:
    """COO -> ELL: per target row keep the top-K entries by weight."""

    ell_src = np.zeros((target_size, k), dtype=np.int32)
    ell_w = np.zeros((target_size, k), dtype=np.float32)
    if rows.size == 0:
        return ell_src, ell_w
    # sort by (row asc, weight desc) and take the first k per row
    order = np.lexsort((-vals, rows))
    r, c, v = rows[order], cols[order], vals[order]
    # rank within row
    starts = np.flatnonzero(np.diff(r, prepend=r[0] - 1))
    rank = np.arange(r.shape[0]) - np.repeat(starts, np.diff(np.append(starts, r.shape[0])))
    keep = rank < k
    ell_src[r[keep], rank[keep]] = c[keep].astype(np.int32)
    ell_w[r[keep], rank[keep]] = v[keep].astype(np.float32)
    if renormalize:
        tot = ell_w.sum(axis=1, keepdims=True)
        np.divide(ell_w, tot, out=ell_w, where=tot > 0)
    return ell_src, ell_w


def _pad_coo(
    rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, cap: int, pad_row: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    nnz = min(rows.shape[0], cap)
    if rows.shape[0] > cap:
        # keep the largest weights if over capacity (degrades gracefully),
        # re-sorted by row so the sorted-COO invariant survives
        top = np.sort(np.argsort(-vals)[:cap])
        rows, cols, vals = rows[top], cols[top], vals[top]
    # padding uses the LAST row index with weight 0 so rows stay ascending
    # (host-built COO may pass indices_are_sorted=True to sparse_pool_coo)
    r = np.full((cap,), pad_row, dtype=np.int32)
    c = np.zeros((cap,), dtype=np.int32)
    v = np.zeros((cap,), dtype=np.float32)
    r[:nnz] = rows[:nnz]
    c[:nnz] = cols[:nnz]
    v[:nnz] = vals[:nnz]
    return r, c, v, nnz


def build_correspondence(
    target_idx: np.ndarray,
    src_uv: np.ndarray,
    target_hw: Tuple[int, int],
    source_hw: Tuple[int, int],
    ell_k: int,
    coo_cap: int,
    normalize: bool = True,
) -> SparseCorrespondence:
    """Generic builder from per-point (target cell, continuous source coord)."""

    t_size = target_hw[0] * target_hw[1]
    rows, cols, vals = _bilinear_pairs(target_idx, src_uv, source_hw)
    rows, cols, vals = _dedup_normalize(rows, cols, vals, t_size, normalize)
    ell_src, ell_w = _to_ell(rows, cols, vals, t_size, ell_k, renormalize=normalize)
    r, c, v, nnz = _pad_coo(rows, cols, vals, coo_cap, pad_row=t_size - 1)
    return SparseCorrespondence(
        target_hw=target_hw, source_hw=source_hw,
        rows=r, cols=c, vals=v, nnz=nnz,
        ell_src=ell_src, ell_w=ell_w,
    )


def fusion_lattices(
    extents: AreaExtents,
    bev_cfg: BevConfig,
    img_cfg: ImageConfig,
    sp_cfg: SparsePoolConfig,
) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """(BEV fusion lattice HW, FV fusion lattice HW) at the fusion stride."""

    bh, bw = bev_cfg.padded_hw(extents)
    s = sp_cfg.fusion_stride
    return (bh // s, bw // s), (img_cfg.height // s, img_cfg.width // s)


def build_sparse_pooling_input(
    points_cam: np.ndarray,
    p2: np.ndarray,
    extents: AreaExtents,
    bev_cfg: BevConfig,
    img_cfg: ImageConfig,
    sp_cfg: SparsePoolConfig,
    image_scale: Tuple[float, float] = (1.0, 1.0),
) -> Tuple[SparseCorrespondence, SparseCorrespondence]:
    """Per-frame SHPL inputs: (M_bev<-fv, M_fv<-bev).

    ``points_cam`` must already be filtered to the image frustum and area
    extents. ``image_scale`` is (sy, sx), the factor mapping raw-image pixels
    onto the fixed network canvas (see ``ImageConfig``); the reference feeds
    raw-resolution images so its scale is identity.
    """

    (bh_f, bw_f), (ih_f, iw_f) = fusion_lattices(extents, bev_cfg, img_cfg, sp_cfg)
    coo_cap = 4 * sp_cfg.max_points

    if points_cam.shape[0] == 0:
        empty_t = np.zeros((0,), dtype=np.int64)
        empty_uv = np.zeros((0, 2), dtype=np.float64)
        m_bev = build_correspondence(empty_t, empty_uv, (bh_f, bw_f), (ih_f, iw_f), sp_cfg.ell_k, coo_cap, sp_cfg.normalize)
        m_fv = build_correspondence(empty_t, empty_uv, (ih_f, iw_f), (bh_f, bw_f), sp_cfg.ell_k, coo_cap, sp_cfg.normalize)
        return m_bev, m_fv

    s = float(sp_cfg.fusion_stride)
    # continuous BEV coords on the fusion lattice (col ~ x, row ~ z)
    bev_c = (points_cam[:, 0] - extents.x_min) / bev_cfg.voxel_size / s
    bev_r = (points_cam[:, 2] - extents.z_min) / bev_cfg.voxel_size / s
    # continuous FV coords on the fusion lattice (network canvas pixels / s)
    uv = project_to_image(points_cam[:, :3], p2)
    fv_u = uv[:, 0] * image_scale[1] / s
    fv_v = uv[:, 1] * image_scale[0] / s

    # direction 1: pool FV features into BEV cells (target = nearest BEV cell)
    t_bev = (
        np.clip(bev_r.astype(np.int64), 0, bh_f - 1) * bw_f
        + np.clip(bev_c.astype(np.int64), 0, bw_f - 1)
    )
    m_bev = build_correspondence(
        t_bev, np.stack([fv_u, fv_v], axis=1), (bh_f, bw_f), (ih_f, iw_f),
        sp_cfg.ell_k, coo_cap, sp_cfg.normalize,
    )
    # direction 2: pool BEV features into FV pixels (target = nearest FV pixel)
    t_fv = (
        np.clip(fv_v.astype(np.int64), 0, ih_f - 1) * iw_f
        + np.clip(fv_u.astype(np.int64), 0, iw_f - 1)
    )
    m_fv = build_correspondence(
        t_fv, np.stack([bev_c, bev_r], axis=1), (ih_f, iw_f), (bh_f, bw_f),
        sp_cfg.ell_k, coo_cap, sp_cfg.normalize,
    )
    return m_bev, m_fv
