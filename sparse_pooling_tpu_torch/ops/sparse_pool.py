"""SHPL sparse cross-view pooling, forward — kernel A and the ELL twin.

Port of the forward of ``sparse_pooling_tpu.ops.sparse_pool``:

* ``sparse_pool_patch_major_batch`` — the fusion layer's pool. Each point
  gathers one 2x2xC source window at ``cols[..., 0]``, combines the 4 taps
  with its f32 bilinear weights and scatter-adds into its target cell; with
  ``divide_by_weight_sum`` the weight sum rides the same scatter as channel
  C+1 and the result is divided by it where it exceeds 1e-12. On a CUDA
  tensor this launches kernel A (``csrc/sparse_pool_patch.cu``, which sorts
  the points by target row and gathers each row once instead of scattering
  per point); on a CPU tensor it runs ``sparse_pool_patch_plain``.
* ``sparse_pool_ell`` — the plain ELL pool ``out[t] = sum_k w[t,k] *
  src[idx[t,k]]``, twin of kernel B (``ops/ell_sparse_pool.py``).
"""

from __future__ import annotations

import torch

from sparse_pooling_tpu_torch import kernels


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
    )  # [B, P, 4]
    return flat[idx.reshape(-1)].reshape(b, cols.shape[1], 4, c)


def sparse_pool_patch_plain(
    src_map: torch.Tensor,  # [B, Hs, Ws, C]
    rows: torch.Tensor,  # [B, P] int32
    cols: torch.Tensor,  # [B, P, 4] int32
    vals: torch.Tensor,  # [B, P, 4] f32
    num_targets: int,
    divide_by_weight_sum: bool = False,
    accum_dtype: str = "float32",
) -> torch.Tensor:
    """Plain PyTorch twin of kernel A -> [B, T, C] f32 (accumulated in
    ``accum_dtype``)."""

    acc = getattr(torch, accum_dtype)
    b, _, _, c = src_map.shape
    patches = _gather_point_patches(src_map, cols)
    g = torch.sum(patches.to(acc) * vals[..., None].to(acc), dim=2)  # [B, P, C]
    if divide_by_weight_sum:
        g = torch.cat([g, torch.sum(vals, dim=-1, keepdim=True).to(acc)], dim=-1)
    n_ch = g.shape[-1]
    # flat ids over the batch; segment_sum drops ids outside [0, B*T)
    ids = (rows.to(torch.int64) + (torch.arange(b, device=rows.device) * num_targets)[:, None]).reshape(-1)
    keep = (ids >= 0) & (ids < b * num_targets)
    flat = torch.zeros(b * num_targets, n_ch, dtype=acc, device=src_map.device)
    flat.index_add_(0, ids[keep], g.reshape(-1, n_ch)[keep])
    flat = flat.reshape(b, num_targets, n_ch)
    if not divide_by_weight_sum:
        return flat.to(torch.float32)
    out = flat[..., :c].to(torch.float32)
    den = flat[..., c:].to(torch.float32)
    return torch.where(den > 1e-12, out / torch.clamp_min(den, 1e-12), 0.0)


@kernels.counted
def sparse_pool_patch_kernel(
    src_map: torch.Tensor,
    rows: torch.Tensor,
    cols: torch.Tensor,
    vals: torch.Tensor,
    num_targets: int,
    divide_by_weight_sum: bool = False,
    accum_dtype: str = "float32",
) -> torch.Tensor:
    """Kernel A on CUDA tensors -> [B, T, C] f32. Accumulates in f32 only."""

    what = "sparse_pool_patch"
    if accum_dtype != "float32":
        raise NotImplementedError(f"{what}: kernel accumulates in float32 only, got {accum_dtype}")
    device = kernels.require_cuda(src_map, rows, cols, vals, what=what)
    b, hs, ws, c = src_map.shape
    p = rows.shape[1]
    if rows.dtype != torch.int32 or cols.dtype != torch.int32 or vals.dtype != torch.float32:
        raise TypeError(f"{what}: rows/cols int32 and vals float32 required")
    if rows.shape != (b, p) or cols.shape != (b, p, 4) or vals.shape != (b, p, 4):
        raise ValueError(f"{what}: rows [B,P], cols/vals [B,P,4] required")
    if b * hs * ws >= 2**31 or b * max(p, num_targets) >= 2**31:
        raise ValueError(f"{what}: B*Hs*Ws, B*P and B*T must stay below 2**31")
    dt = kernels.dtype_code(src_map, what)
    lib = kernels.library("sparse_pool_patch")
    # int32 counts, offsets, slots and carries of the CSR gather; new_empty
    # takes the int32 of rows and the f32 of vals at less host cost than
    # torch.empty's keywords
    scratch = rows.new_empty(lib.sparse_pool_patch_scratch_ints(b, p, int(num_targets), c))
    out = vals.new_empty((b, int(num_targets), c))
    rc = lib.sparse_pool_patch_launch(
        src_map.data_ptr(), dt, b, hs, ws, c, rows.data_ptr(), cols.data_ptr(), vals.data_ptr(),
        p, int(num_targets), int(divide_by_weight_sum), scratch.data_ptr(), out.data_ptr(),
        kernels.stream_ptr(device),
    )
    kernels.check(lib, rc, what)
    return out


def sparse_pool_patch_major_batch(
    src_map: torch.Tensor,  # [B, Hs, Ws, C] source feature map
    rows: torch.Tensor,  # [B, P] int32 target row per point
    cols: torch.Tensor,  # [B, P, 4] int32 bilinear-corner indices
    vals: torch.Tensor,  # [B, P, 4] f32 weights (0 on padding)
    num_targets: int,
    divide_by_weight_sum: bool = False,
    accum_dtype: str = "float32",
) -> torch.Tensor:
    """Point-major pooling with one 2x2 window per point -> [B, T, C] f32.
    Kernel A on a CUDA tensor, the plain version on a CPU tensor."""

    fn = sparse_pool_patch_kernel if src_map.is_cuda else sparse_pool_patch_plain
    return fn(src_map, rows, cols, vals, int(num_targets), divide_by_weight_sum, accum_dtype)


def sparse_pool_ell(src_feat: torch.Tensor, ell_src: torch.Tensor, ell_w: torch.Tensor) -> torch.Tensor:
    """ELL sparse-dense product [S, C] x ([T, K], [T, K]) -> [T, C]: f32
    products summed over K, cast to the source dtype."""

    t, k = ell_src.shape
    g = src_feat[ell_src.reshape(-1).to(torch.int64)].reshape(t, k, -1)
    return torch.sum(g.to(torch.float32) * ell_w[..., None], dim=1).to(src_feat.dtype)
